// Parquet's host loops (counterpart of the Parquet parts of
// arrow_tpu/native/native.cpp; reference: cpp/src/parquet/ and
// cpp/src/arrow/util/rle_encoding_internal.h).
//
//   * the RLE / bit-packed hybrid of levels and dictionary indices
//     (rle_decode, rle_encode);
//   * the page walker of a flat column chunk: pq_scan_pages parses every
//     page header (the thrift compact protocol) in one call, and
//     pq_decode_flat decompresses the pages (none or snappy), decodes the
//     definition levels to validity bytes and copies PLAIN fixed-width
//     values or decodes dictionary indices, for the whole chunk in one
//     call (parquet/column_reader.cc's page loop);
//   * BYTE_ARRAY's PLAIN codec (plain_decode_byte_array,
//     plain_encode_byte_array), the min and max of binary values by
//     unsigned byte order (minmax_binary), the gather of variable-length
//     values by index (gather_var_bytes);
//   * dictionary encoding of binary values in order of first appearance,
//     a null coded as the empty value (dict_encode_binary: the writer's
//     dictionary pages).
//
// Every encoder is the reference's, step for step, so the writer's pages
// are the reference's bytes. Built with the host C++ compiler by
// arrow_tpu_torch/kernels/_build.py (host_library) and loaded with ctypes;
// plain C interface. A call releases Python's lock, so the reader decodes
// several column chunks at once on threads.

#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

#include "snappy_host.cpp"

extern "C" {

// --- the RLE / bit-packed hybrid ----------------------------------------

static inline uint64_t rle_read_varint(const uint8_t* d, int64_t len,
                                       int64_t& pos, bool& ok) {
  uint64_t v = 0;
  int shift = 0;
  while (pos < len && shift < 64) {
    uint8_t b = d[pos++];
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return v;
    shift += 7;
  }
  ok = false;
  return 0;
}

static inline void rle_write_varint(uint8_t* d, int64_t& pos, uint64_t v) {
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      d[pos++] = b | 0x80;
    } else {
      d[pos++] = b;
      return;
    }
  }
}

// Decodes num_values values of bit_width bits from data[pos:len] into out:
// the bytes consumed past pos, or -1 where the stream ends early or the
// width is not 0-64.
int64_t rle_decode(const uint8_t* data, int64_t len, int64_t pos,
                   int64_t num_values, int32_t bit_width, int64_t* out) {
  const int64_t start = pos;
  int64_t filled = 0;
  if (bit_width < 0 || bit_width > 64) return -1;  // a malformed width
  const int byte_width = (bit_width + 7) / 8;
  while (filled < num_values) {
    if (pos >= len) return -1;
    bool ok = true;
    uint64_t header = rle_read_varint(data, len, pos, ok);
    if (!ok) return -1;
    if (header & 1) {  // bit-packed groups of 8 values
      int64_t groups = static_cast<int64_t>(header >> 1);
      int64_t n = groups * 8;
      if (bit_width > 0 && groups > (len - pos) / bit_width) return -1;
      int64_t nbytes = groups * bit_width;
      if (pos + nbytes > len) return -1;
      int64_t take = n < num_values - filled ? n : num_values - filled;
      const uint8_t* src = data + pos;
      int64_t bit = 0, i = 0;
      if (bit_width <= 56) {
        // a value at a time from an 8-byte window, while one fits
        const uint64_t mask = (uint64_t{1} << bit_width) - 1;
        for (; i < take && pos + (bit >> 3) + 8 <= len; i++) {
          uint64_t w;
          std::memcpy(&w, src + (bit >> 3), 8);
          out[filled + i] = static_cast<int64_t>((w >> (bit & 7)) & mask);
          bit += bit_width;
        }
      }
      for (; i < take; i++) {
        uint64_t v = 0;
        for (int b = 0; b < bit_width; b++) {
          int64_t idx = bit + b;
          v |= static_cast<uint64_t>((src[idx >> 3] >> (idx & 7)) & 1) << b;
        }
        out[filled + i] = static_cast<int64_t>(v);
        bit += bit_width;
      }
      pos += nbytes;
      filled += take;
    } else {  // a run of one value
      int64_t count = static_cast<int64_t>(header >> 1);
      if (pos + byte_width > len) return -1;
      uint64_t v = 0;
      for (int b = 0; b < byte_width; b++)
        v |= static_cast<uint64_t>(data[pos + b]) << (8 * b);
      pos += byte_width;
      int64_t take = count < num_values - filled ? count : num_values - filled;
      for (int64_t i = 0; i < take; i++) out[filled + i] = static_cast<int64_t>(v);
      filled += take;
    }
  }
  return pos - start;
}

// The most bytes rle_encode writes for n values.
int64_t rle_max_encoded(int64_t n) { return n * 8 + 64; }

// Encodes n values of bit_width bits: a run of 8 or more equal values as
// an RLE run, the rest bit-packed in groups of 8 up to the next run of 16
// or more (a group in mid-stream borrows its pad from the run after it).
// Returns the bytes written.
int64_t rle_encode(const int64_t* values, int64_t n, int32_t bit_width,
                   uint8_t* out) {
  int64_t pos = 0;
  const int byte_width = (bit_width + 7) / 8;
  int64_t i = 0;
  while (i < n) {
    int64_t v = values[i];
    int64_t j = i + 1;
    while (j < n && values[j] == v) j++;
    if (j - i >= 8) {
      rle_write_varint(out, pos, static_cast<uint64_t>(j - i) << 1);
      for (int b = 0; b < byte_width; b++)
        out[pos++] = static_cast<uint8_t>(static_cast<uint64_t>(v) >> (8 * b));
      i = j;
      continue;
    }
    int64_t k = i;
    while (k < n) {
      int64_t v2 = values[k];
      int64_t m = k + 1;
      while (m < n && values[m] == v2) m++;
      if (m - k >= 16) break;
      k = m;
    }
    int64_t count = k - i;
    if (k < n) {
      int64_t pad = (8 - (count % 8)) % 8;
      k += pad;
      count += pad;
    }
    int64_t groups = (count + 7) / 8;
    rle_write_varint(out, pos, (static_cast<uint64_t>(groups) << 1) | 1);
    int64_t nbytes = groups * bit_width;
    uint8_t* dst = out + pos;
    if (bit_width <= 56) {
      // the low bit_width bits of each value, LSB first, a byte at a time
      // (8 values of bit_width bits fill whole bytes)
      const uint64_t mask = (uint64_t{1} << bit_width) - 1;
      uint64_t acc = 0;
      int nb = 0;
      int64_t o = 0;
      for (int64_t t = 0; t < groups * 8; t++) {
        uint64_t val = (t < count && i + t < n)
                           ? static_cast<uint64_t>(values[i + t]) : 0;
        acc |= (val & mask) << nb;
        nb += bit_width;
        while (nb >= 8) {
          dst[o++] = static_cast<uint8_t>(acc);
          acc >>= 8;
          nb -= 8;
        }
      }
    } else {
      std::memset(dst, 0, static_cast<size_t>(nbytes));
      int64_t bit = 0;
      for (int64_t t = 0; t < groups * 8; t++) {
        uint64_t val = (t < count && i + t < n)
                           ? static_cast<uint64_t>(values[i + t]) : 0;
        for (int b = 0; b < bit_width; b++) {
          if ((val >> b) & 1) {
            int64_t idx = bit + b;
            dst[idx >> 3] |= static_cast<uint8_t>(1 << (idx & 7));
          }
        }
        bit += bit_width;
      }
    }
    pos += nbytes;
    i = k;
  }
  return pos;
}

// --- BYTE_ARRAY's PLAIN codec, binary min/max, gathers ------------------

// Decodes n length-prefixed values: offsets[n + 1] and their bytes laid end
// to end in out (len - 4 * n bytes at most). The bytes written, or -1
// where the data ends early.
int64_t plain_decode_byte_array(const uint8_t* data, int64_t len, int64_t n,
                                int64_t* offsets, uint8_t* out) {
  int64_t pos = 0, op = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (pos + 4 > len) return -1;
    uint32_t ln;
    std::memcpy(&ln, data + pos, 4);
    pos += 4;
    if (pos + static_cast<int64_t>(ln) > len) return -1;
    std::memcpy(out + op, data + pos, ln);
    pos += ln;
    op += ln;
    offsets[i + 1] = op;
  }
  return op;
}

// Encodes the values marked present (all where present is null) as
// length-prefixed values: the bytes written.
int64_t plain_encode_byte_array(const uint8_t* pool, const int64_t* offsets,
                                const uint8_t* present, int64_t n,
                                uint8_t* out) {
  int64_t op = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (present && !present[i]) continue;
    uint32_t ln = static_cast<uint32_t>(offsets[i + 1] - offsets[i]);
    std::memcpy(out + op, &ln, 4);
    op += 4;
    std::memcpy(out + op, pool + offsets[i], ln);
    op += ln;
  }
  return op;
}

// The indices of the least and greatest valid values by unsigned byte
// order (the first of equal ones) in out_idx[2], -1 where none is valid:
// the count of valid values.
int64_t minmax_binary(const uint8_t* pool, const int64_t* offsets,
                      const uint8_t* valid, int64_t n, int64_t* out_idx) {
  int64_t mn = -1, mx = -1, count = 0;
  auto view = [&](int64_t i) {
    return std::string_view(reinterpret_cast<const char*>(pool) + offsets[i],
                            static_cast<size_t>(offsets[i + 1] - offsets[i]));
  };
  for (int64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) continue;
    ++count;
    if (mn < 0) {
      mn = mx = i;
      continue;
    }
    std::string_view v = view(i);
    if (v < view(mn)) mn = i;
    if (v > view(mx)) mx = i;
  }
  out_idx[0] = mn;
  out_idx[1] = mx;
  return count;
}

// Copies value ids[i] of (pool, offsets) to out[out_offsets[i]:] for each i.
void gather_var_bytes(const uint8_t* pool, const int64_t* offsets,
                      const int64_t* ids, int64_t n,
                      const int64_t* out_offsets, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t id = ids[i];
    int64_t len = offsets[id + 1] - offsets[id];
    if (len)
      std::memcpy(out + out_offsets[i], pool + offsets[id],
                  static_cast<size_t>(len));
  }
}

// --- dictionary encoding in order of first appearance -------------------
// encode -> sizes -> fill -> free.

struct DictEncodeResult {
  std::vector<int32_t> codes;
  std::vector<int32_t> uniq_offsets;  // n_unique + 1
  std::vector<uint8_t> uniq_bytes;
};

void* dict_encode_binary(const uint8_t* data, const int64_t* offsets,
                         const uint8_t* valid, int64_t n) {
  auto* res = new DictEncodeResult();
  res->codes.resize(static_cast<size_t>(n));
  res->uniq_offsets.push_back(0);
  std::unordered_map<std::string_view, int32_t> memo;
  memo.reserve(static_cast<size_t>(n < 1024 ? n : n / 4 + 16));
  for (int64_t i = 0; i < n; ++i) {
    std::string_view v;  // a null is coded as the empty value
    if (valid == nullptr || valid[i])
      v = std::string_view(reinterpret_cast<const char*>(data) + offsets[i],
                           static_cast<size_t>(offsets[i + 1] - offsets[i]));
    auto it = memo.find(v);
    if (it == memo.end()) {
      int32_t code = static_cast<int32_t>(memo.size());
      res->uniq_bytes.insert(res->uniq_bytes.end(), v.begin(), v.end());
      res->uniq_offsets.push_back(
          static_cast<int32_t>(res->uniq_bytes.size()));
      memo.emplace(v, code);  // views the caller's bytes for this call
      res->codes[i] = code;
    } else {
      res->codes[i] = it->second;
    }
  }
  return res;
}

int64_t dict_encode_n_unique(void* handle) {
  return static_cast<int64_t>(
      static_cast<DictEncodeResult*>(handle)->uniq_offsets.size() - 1);
}

int64_t dict_encode_uniq_bytes(void* handle) {
  return static_cast<int64_t>(
      static_cast<DictEncodeResult*>(handle)->uniq_bytes.size());
}

void dict_encode_fill(void* handle, int32_t* codes, int32_t* uniq_offsets,
                      uint8_t* uniq_bytes) {
  auto* res = static_cast<DictEncodeResult*>(handle);
  if (!res->codes.empty())
    std::memcpy(codes, res->codes.data(), res->codes.size() * sizeof(int32_t));
  std::memcpy(uniq_offsets, res->uniq_offsets.data(),
              res->uniq_offsets.size() * sizeof(int32_t));
  if (!res->uniq_bytes.empty())
    std::memcpy(uniq_bytes, res->uniq_bytes.data(), res->uniq_bytes.size());
}

void dict_encode_free(void* handle) {
  delete static_cast<DictEncodeResult*>(handle);
}

}  // extern "C"

// --- the page walker ------------------------------------------------------

namespace pq {

struct TC {  // a thrift compact-protocol cursor
  const uint8_t* d;
  int64_t len, pos;
  bool ok;
};

static uint64_t tc_varint(TC& r) {
  uint64_t v = 0;
  int shift = 0;
  while (r.pos < r.len && shift < 64) {
    uint8_t b = r.d[r.pos++];
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return v;
    shift += 7;
  }
  r.ok = false;
  return 0;
}

static int64_t tc_zigzag(TC& r) {
  uint64_t u = tc_varint(r);
  return static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
}

static void tc_skip(TC& r, int type);

static void tc_skip_struct(TC& r) {
  while (r.ok) {
    if (r.pos >= r.len) {
      r.ok = false;
      return;
    }
    uint8_t fh = r.d[r.pos++];
    if (fh == 0) return;
    int type = fh & 0x0F;
    if ((fh >> 4) == 0) tc_zigzag(r);  // a long-form field id
    tc_skip(r, type);
  }
}

// Moves the cursor n bytes on; a move past the end stops it (ok false).
static void tc_advance(TC& r, uint64_t n) {
  if (n > static_cast<uint64_t>(r.len - r.pos)) {
    r.pos = r.len;
    r.ok = false;
    return;
  }
  r.pos += static_cast<int64_t>(n);
}

static void tc_skip(TC& r, int type) {
  switch (type) {
    case 1: case 2: return;  // bool
    case 3: tc_advance(r, 1); return;  // byte
    case 4: case 5: case 6: tc_varint(r); return;  // i16, i32, i64
    case 7: tc_advance(r, 8); return;  // double
    case 8: {  // binary
      uint64_t n = tc_varint(r);
      if (r.ok) tc_advance(r, n);
      return;
    }
    case 9: case 10: {  // list, set
      if (r.pos >= r.len) {
        r.ok = false;
        return;
      }
      uint8_t h = r.d[r.pos++];
      uint64_t n = h >> 4;
      int et = h & 0x0F;
      if (n == 15) n = tc_varint(r);
      // every element takes a byte or more: a longer list is truncated
      if (n > static_cast<uint64_t>(r.len - r.pos)) {
        r.ok = false;
        return;
      }
      for (uint64_t i = 0; i < n && r.ok; i++) tc_skip(r, et);
      return;
    }
    case 11: {  // map
      uint64_t n = tc_varint(r);
      if (n == 0 || !r.ok) return;
      if (r.pos >= r.len || n > static_cast<uint64_t>(r.len - r.pos)) {
        r.ok = false;
        return;
      }
      uint8_t kv = r.d[r.pos++];
      for (uint64_t i = 0; i < n && r.ok; i++) {
        tc_skip(r, kv >> 4);
        tc_skip(r, kv & 0x0F);
      }
      return;
    }
    case 12: tc_skip_struct(r); return;
    default: r.ok = false; return;
  }
}

struct Page {
  int64_t ptype = -1, uncomp = 0, comp = 0;
  int64_t nvals = 0, enc = -1, nnulls = 0;
  int64_t dl_len = 0, rl_len = 0, v2_comp = 1;
};

// A struct whose wanted fields are integers or bools: field id k (1-based,
// k <= n_slots) goes to *slot[k - 1] where that is not null.
static void tc_parse_flat_struct(TC& r, int64_t** slot, int n_slots) {
  int64_t fid = 0;
  while (r.ok) {
    if (r.pos >= r.len) {
      r.ok = false;
      return;
    }
    uint8_t fh = r.d[r.pos++];
    if (fh == 0) return;
    int type = fh & 0x0F;
    int delta = fh >> 4;
    fid = delta == 0 ? tc_zigzag(r) : fid + delta;
    int64_t* dst = (fid >= 1 && fid <= n_slots) ? slot[fid - 1] : nullptr;
    if (dst && type >= 4 && type <= 6) {
      *dst = tc_zigzag(r);
    } else if (dst && (type == 1 || type == 2)) {
      *dst = type == 1 ? 1 : 0;
    } else {
      tc_skip(r, type);
    }
  }
}

static bool parse_page_header(TC& r, Page& p) {
  int64_t fid = 0;
  while (r.ok) {
    if (r.pos >= r.len) return false;
    uint8_t fh = r.d[r.pos++];
    if (fh == 0) break;
    int type = fh & 0x0F;
    int delta = fh >> 4;
    fid = delta == 0 ? tc_zigzag(r) : fid + delta;
    bool integer = type >= 4 && type <= 6;
    if (fid == 1 && integer) {
      p.ptype = tc_zigzag(r);
    } else if (fid == 2 && integer) {
      p.uncomp = tc_zigzag(r);
    } else if (fid == 3 && integer) {
      p.comp = tc_zigzag(r);
    } else if (fid == 5 && type == 12) {  // DataPageHeader
      int64_t* slots[4] = {&p.nvals, &p.enc, nullptr, nullptr};
      tc_parse_flat_struct(r, slots, 4);
    } else if (fid == 7 && type == 12) {  // DictionaryPageHeader
      int64_t* slots[2] = {&p.nvals, &p.enc};
      tc_parse_flat_struct(r, slots, 2);
    } else if (fid == 8 && type == 12) {  // DataPageHeaderV2
      int64_t* slots[7] = {&p.nvals, &p.nnulls, nullptr, &p.enc,
                           &p.dl_len, &p.rl_len, &p.v2_comp};
      tc_parse_flat_struct(r, slots, 7);
    } else {
      tc_skip(r, type);
    }
  }
  return r.ok;
}

}  // namespace pq

extern "C" {

// tab: [max_pages][10] int64, a row a page: 0 page type, 1 payload offset,
// 2 compressed length, 3 uncompressed length, 4 values, 5 encoding,
// 6 nulls, 7 definition levels' bytes, 8 repetition levels' bytes,
// 9 whether a v2 page's values are compressed. Returns the page count, or
// -1 for a malformed or truncated chunk or one of more than max_pages
// pages, or of a page whose sizes are negative or whose levels overrun it.
int64_t pq_scan_pages(const uint8_t* blob, int64_t len, int64_t expect_values,
                      int64_t max_pages, int64_t* tab) {
  pq::TC r{blob, len, 0, true};
  int64_t npages = 0, consumed = 0;
  while (consumed < expect_values && npages < max_pages) {
    pq::Page p;
    if (r.pos >= r.len) return -1;
    if (!pq::parse_page_header(r, p) || !r.ok) return -1;
    if (p.comp < 0 || p.comp > len - r.pos) return -1;
    // sizes a page header may not hold: the decoder trusts the rest
    if (p.uncomp < 0 || p.nvals < 0 || p.nnulls < 0 || p.dl_len < 0 ||
        p.rl_len < 0 || p.dl_len + p.rl_len > p.comp)
      return -1;
    int64_t* row = tab + npages * 10;
    row[0] = p.ptype;
    row[1] = r.pos;
    row[2] = p.comp;
    row[3] = p.uncomp;
    row[4] = p.nvals;
    row[5] = p.enc;
    row[6] = p.nnulls;
    row[7] = p.dl_len;
    row[8] = p.rl_len;
    row[9] = p.v2_comp;
    r.pos += p.comp;
    if (p.ptype == 0 || p.ptype == 3) consumed += p.nvals;
    npages++;
  }
  return consumed >= expect_values ? npages : -1;
}

// Decodes a flat fixed-width column chunk that pq_scan_pages scanned.
// codec: 0 none, 1 snappy. out_validity: a byte a value (1 present);
// page_kind: 0 a dictionary or other page, 1 PLAIN, 2 dictionary indices;
// totals[5]: values, present values, PLAIN bytes, indices, dictionary
// bytes. Returns 0, or -2 malformed, -3 an encoding it does not decode,
// -4 a buffer too small (or no memory for a page). Every row of `tab` is
// checked again here, so that no size reaches a resize or a memcpy
// unchecked, and no C++ exception leaves the call.
static int64_t decode_flat(const uint8_t* blob, int64_t len,
                           const int64_t* tab, int64_t n_pages, int32_t codec,
                           int32_t max_def, int32_t def_bw,
                           int32_t byte_width, uint8_t* out_validity,
                           int64_t validity_cap, uint8_t* out_plain,
                           int64_t plain_cap, int64_t* out_idx,
                           int64_t idx_cap, uint8_t* out_dict,
                           int64_t dict_cap, int64_t* page_kind,
                           int64_t* page_npresent, int64_t* totals);

int64_t pq_decode_flat(const uint8_t* blob, int64_t len, const int64_t* tab,
                       int64_t n_pages, int32_t codec, int32_t max_def,
                       int32_t def_bw, int32_t byte_width,
                       uint8_t* out_validity, int64_t validity_cap,
                       uint8_t* out_plain, int64_t plain_cap,
                       int64_t* out_idx, int64_t idx_cap,
                       uint8_t* out_dict, int64_t dict_cap,
                       int64_t* page_kind, int64_t* page_npresent,
                       int64_t* totals) {
  try {
    return decode_flat(blob, len, tab, n_pages, codec, max_def, def_bw,
                       byte_width, out_validity, validity_cap, out_plain,
                       plain_cap, out_idx, idx_cap, out_dict, dict_cap,
                       page_kind, page_npresent, totals);
  } catch (const std::exception&) {
    return -4;
  }
}

}  // extern "C"

static int64_t decode_flat(const uint8_t* blob, int64_t len,
                           const int64_t* tab, int64_t n_pages, int32_t codec,
                           int32_t max_def, int32_t def_bw,
                           int32_t byte_width, uint8_t* out_validity,
                           int64_t validity_cap, uint8_t* out_plain,
                           int64_t plain_cap, int64_t* out_idx,
                           int64_t idx_cap, uint8_t* out_dict,
                           int64_t dict_cap, int64_t* page_kind,
                           int64_t* page_npresent, int64_t* totals) {
  std::vector<uint8_t> scratch;
  std::vector<int64_t> lvl;
  int64_t vpos = 0, ppos = 0, ipos = 0, dbytes = 0, npresent_all = 0;
  for (int64_t pi = 0; pi < n_pages; pi++) {
    const int64_t* row = tab + pi * 10;
    int64_t ptype = row[0], off = row[1], comp = row[2], uncomp = row[3],
            nvals = row[4], enc = row[5], dl_len = row[7], rl_len = row[8],
            v2c = row[9];
    page_kind[pi] = 0;
    page_npresent[pi] = 0;
    if (off < 0 || comp < 0 || uncomp < 0 || nvals < 0 || dl_len < 0 ||
        rl_len < 0 || comp > len - off || dl_len + rl_len > comp)
      return -2;
    if (ptype == 2) {  // a dictionary page
      if (enc != 0 && enc != 2) return -3;
      if (uncomp > dict_cap) return -4;
      if (codec == 0) {
        if (comp > dict_cap) return -4;
        std::memcpy(out_dict, blob + off, static_cast<size_t>(comp));
        dbytes = comp;
      } else {
        int64_t n = snappy_decompress(blob + off, comp, out_dict, dict_cap);
        if (n < 0) return -2;
        dbytes = n;
      }
      continue;
    }
    if (ptype != 0 && ptype != 3) continue;  // index pages and others
    const uint8_t* body;
    int64_t body_len;
    const uint8_t* levels = nullptr;
    int64_t levels_len = 0;
    if (ptype == 3) {  // v2: the levels are never compressed
      if (rl_len > 0) return -3;
      levels = blob + off;
      levels_len = dl_len;
      const uint8_t* vsrc = blob + off + dl_len + rl_len;
      int64_t vlen = comp - dl_len - rl_len;
      if (vlen < 0) return -2;
      if (codec != 0 && v2c) {
        if (uncomp < dl_len + rl_len) return -2;
        scratch.resize(static_cast<size_t>(uncomp - dl_len - rl_len + 8));
        int64_t n = snappy_decompress(vsrc, vlen, scratch.data(),
                                      static_cast<int64_t>(scratch.size()));
        if (n < 0) return -2;
        body = scratch.data();
        body_len = n;
      } else {
        body = vsrc;
        body_len = vlen;
      }
    } else {  // v1: the whole payload is compressed
      if (codec == 0) {
        body = blob + off;
        body_len = comp;
      } else {
        scratch.resize(static_cast<size_t>(uncomp + 8));
        int64_t n = snappy_decompress(blob + off, comp, scratch.data(),
                                      static_cast<int64_t>(scratch.size()));
        if (n < 0) return -2;
        body = scratch.data();
        body_len = n;
      }
      if (max_def > 0) {
        if (body_len < 4) return -2;
        int64_t ll = static_cast<int64_t>(body[0]) |
                     (static_cast<int64_t>(body[1]) << 8) |
                     (static_cast<int64_t>(body[2]) << 16) |
                     (static_cast<int64_t>(body[3]) << 24);
        if (4 + ll > body_len) return -2;
        levels = body + 4;
        levels_len = ll;
        body += 4 + ll;
        body_len -= 4 + ll;
      }
    }
    int64_t n_present = nvals;
    if (vpos + nvals > validity_cap) return -4;
    if (max_def > 0 && levels_len > 0) {
      lvl.resize(static_cast<size_t>(nvals));
      if (rle_decode(levels, levels_len, 0, nvals, def_bw, lvl.data()) < 0)
        return -2;
      n_present = 0;
      for (int64_t i = 0; i < nvals; i++) {
        uint8_t v = lvl[i] == max_def;
        out_validity[vpos + i] = v;
        n_present += v;
      }
    } else {
      std::memset(out_validity + vpos, 1, static_cast<size_t>(nvals));
    }
    vpos += nvals;
    npresent_all += n_present;
    if (enc == 0) {  // PLAIN fixed width
      int64_t nb = n_present * static_cast<int64_t>(byte_width);
      if (nb > body_len || ppos + nb > plain_cap) return -2;
      std::memcpy(out_plain + ppos, body, static_cast<size_t>(nb));
      ppos += nb;
      page_kind[pi] = 1;
    } else if (enc == 2 || enc == 8) {  // PLAIN_ / RLE_DICTIONARY
      if (body_len < 1) return -2;
      int32_t bw = body[0];
      if (ipos + n_present > idx_cap) return -4;
      if (n_present > 0 &&
          rle_decode(body + 1, body_len - 1, 0, n_present, bw,
                     out_idx + ipos) < 0)
        return -2;
      ipos += n_present;
      page_kind[pi] = 2;
    } else {
      return -3;
    }
    page_npresent[pi] = n_present;
  }
  totals[0] = vpos;
  totals[1] = npresent_all;
  totals[2] = ppos;
  totals[3] = ipos;
  totals[4] = dbytes;
  return 0;
}
