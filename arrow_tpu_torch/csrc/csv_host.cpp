// CSV and JSON host loops (counterpart of the CSV and JSON parts of
// arrow_tpu/native/native.cpp; reference: cpp/src/arrow/csv/ chunker.cc,
// parser.cc, converter.cc and writer.cc, cpp/src/arrow/json/parser.cc).
//
//   * the tokenizers: csv_parse copies unescaped fields into a pool;
//     csv_parse_nq (no quote or escape byte in the block) and
//     csv_parse_zc (quoted fields that need no rewriting) emit (start,
//     end) pairs into the caller's bytes; each with its sizes, fill and
//     free;
//   * the bulk field parsers, strict (abort at the first failure) and
//     permissive (count failures): int64 and float64 by std::from_chars,
//     bool tokens, token matching, ISO dates and timestamps;
//   * csv_gather_bytes and csv_transpose_columns (per-column spans);
//   * the flat newline-delimited JSON tokenizer (json_parse_flat);
//   * the writer's cells: float64 as Python's repr writes it, int64,
//     QUOTE_MINIMAL quoting of strings, and the row interleave.
//
// Every loop is the reference's, step for step, so a read gives the
// reference's values (floats bit for bit) and a write its bytes. Built
// with the host C++ compiler by arrow_tpu_torch/kernels/_build.py
// (host_library) and loaded with ctypes; plain C interface. A call
// releases Python's lock, so the reader converts blocks on threads.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

// std::from_chars and std::to_chars of double: libstdc++ of GCC 11 or
// newer. An older library has no second parser here: the build fails.
#if !defined(__cpp_lib_to_chars) || __cpp_lib_to_chars < 201611L
#error "csv_host.cpp needs std::from_chars/std::to_chars for double (GCC 11+)"
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CSV hot path (reference: cpp/src/arrow/csv/ chunker.cc + parser.cc +
// converter.cc). One pass tokenizes a whole block into a flat field pool
// (unescaped bytes + offsets + per-field quoted flags + per-row field
// counts); bulk parsers then convert column strides without touching
// Python objects.
// ---------------------------------------------------------------------------

struct CsvParseResult {
  std::vector<int64_t> offsets;     // n_fields + 1
  std::vector<uint8_t> pool;        // unescaped field bytes
  std::vector<uint8_t> quoted;      // per field: started with quote char
  std::vector<int64_t> row_counts;  // fields per row (0 = empty line)
};

// SWAR span scan: first index >= i whose byte matches one of up to 4
// patterns (0 entries in `pats` beyond `npat` are ignored). The classic
// haszero trick marks the first true occurrence per word; false markers
// only ever follow a true one, so ctz of the OR is exact.
static inline uint64_t swar_haszero(uint64_t v) {
  return (v - 0x0101010101010101ULL) & ~v & 0x8080808080808080ULL;
}

static inline int64_t scan_special(const uint8_t* d, int64_t i,
                                   int64_t len, const uint64_t* pats,
                                   int npat, const bool* table) {
  while (i + 8 <= len) {
    uint64_t w;
    std::memcpy(&w, d + i, 8);
    uint64_t m = 0;
    for (int p = 0; p < npat; ++p) m |= swar_haszero(w ^ pats[p]);
    if (m) return i + (int64_t)(__builtin_ctzll(m) >> 3);
    i += 8;
  }
  while (i < len && !table[d[i]]) ++i;
  return i;
}

static inline uint64_t swar_broadcast(uint8_t c) {
  return 0x0101010101010101ULL * (uint64_t)c;
}

// Tokenize `data` (UTF-8/ASCII-compatible). Row terminators: \n, \r\n, \r.
// escape < 0 means no escape char. Matches Python csv.reader semantics:
// an entirely empty line yields a 0-field row.
void* csv_parse(const uint8_t* data, int64_t len, uint8_t delim,
                uint8_t quote, int32_t use_quote, int32_t doublequote,
                int32_t escape) {
  auto* res = new CsvParseResult();
  res->offsets.reserve(static_cast<size_t>(len / 8 + 16));
  res->pool.reserve(static_cast<size_t>(len));
  res->offsets.push_back(0);
  // span-scan tables: stop bytes for unquoted / quoted field scans
  bool stop_plain[256] = {false};
  stop_plain[delim] = stop_plain['\n'] = stop_plain['\r'] = true;
  if (escape >= 0) stop_plain[(uint8_t)escape] = true;
  bool stop_quoted[256] = {false};
  if (use_quote) stop_quoted[quote] = true;
  if (escape >= 0) stop_quoted[(uint8_t)escape] = true;
  uint64_t plain_pats[4] = {swar_broadcast(delim), swar_broadcast('\n'),
                            swar_broadcast('\r'), 0};
  int n_plain = 3;
  if (escape >= 0) plain_pats[n_plain++] = swar_broadcast((uint8_t)escape);
  uint64_t quoted_pats[2] = {swar_broadcast(quote), 0};
  int n_quoted = use_quote ? 1 : 0;
  if (escape >= 0) quoted_pats[n_quoted++] = swar_broadcast((uint8_t)escape);
  int64_t i = 0;
  while (i < len) {
    int64_t row_fields = 0;
    bool row_done = false;
    bool saw_any = false;  // any byte (incl. delimiter) on this line
    while (!row_done) {
      // one field
      bool was_quoted = false;
      if (use_quote && i < len && data[i] == quote) {
        was_quoted = true;
        saw_any = true;
        ++i;
        while (i < len) {
          int64_t run = scan_special(data, i, len, quoted_pats, n_quoted,
                                     stop_quoted);
          if (run > i) {
            res->pool.insert(res->pool.end(), data + i, data + run);
            i = run;
          }
          if (i >= len) break;
          uint8_t c = data[i];
          if (escape >= 0 && c == (uint8_t)escape) {
            if (i + 1 < len) {
              res->pool.push_back(data[i + 1]);
              i += 2;
            } else {
              res->pool.push_back(c);
              ++i;
            }
            continue;
          }
          // c == quote
          if (doublequote && i + 1 < len && data[i + 1] == quote) {
            res->pool.push_back(quote);
            i += 2;
            continue;
          }
          ++i;  // closing quote
          break;
        }
      }
      // unquoted remainder (also trailing bytes after a closing quote)
      while (i < len) {
        int64_t run = scan_special(data, i, len, plain_pats, n_plain,
                                   stop_plain);
        if (run > i) {
          res->pool.insert(res->pool.end(), data + i, data + run);
          saw_any = true;
          i = run;
        }
        if (i >= len) break;
        uint8_t c = data[i];
        if (c == delim || c == '\n' || c == '\r') break;
        // escape char: next byte literal (escape at EOF stays literal)
        if (i + 1 < len) {
          res->pool.push_back(data[i + 1]);
          i += 2;
        } else {
          res->pool.push_back(c);
          ++i;
        }
        saw_any = true;
      }
      // field terminator
      if (i < len && data[i] == delim) {
        saw_any = true;
        ++i;
        res->offsets.push_back((int64_t)res->pool.size());
        res->quoted.push_back(was_quoted ? 1 : 0);
        ++row_fields;
        continue;
      }
      // row terminator or EOF
      if (i < len && data[i] == '\r') {
        ++i;
        if (i < len && data[i] == '\n') ++i;
      } else if (i < len && data[i] == '\n') {
        ++i;
      }
      if (row_fields == 0 && !saw_any && !was_quoted) {
        // entirely empty line -> 0-field row (csv.reader yields [])
        res->row_counts.push_back(0);
      } else {
        res->offsets.push_back((int64_t)res->pool.size());
        res->quoted.push_back(was_quoted ? 1 : 0);
        res->row_counts.push_back(row_fields + 1);
      }
      row_done = true;
    }
  }
  return res;
}

// Zero-copy tokenizer for blocks with no quote/escape chars: offsets
// are emitted as (start, end) PAIRS into the caller's buffer (field k
// spans offsets[2k]..offsets[2k+1], so the bulk converters work
// unchanged with ids doubled); no pool copy is made.
void* csv_parse_nq(const uint8_t* data, int64_t len, uint8_t delim) {
  auto* res = new CsvParseResult();
  res->offsets.reserve((size_t)(len / 4 + 16));
  uint64_t pats[3] = {swar_broadcast(delim), swar_broadcast('\n'),
                      swar_broadcast('\r')};
  bool table[256] = {false};
  table[delim] = table['\n'] = table['\r'] = true;
  int64_t i = 0;
  while (i < len) {
    int64_t row_fields = 0;
    bool saw_any = false;
    while (true) {
      int64_t start = i;
      i = scan_special(data, i, len, pats, 3, table);
      if (i > start) saw_any = true;
      if (i < len && data[i] == delim) {
        res->offsets.push_back(start);
        res->offsets.push_back(i);
        ++row_fields;
        ++i;
        saw_any = true;
        continue;
      }
      // newline or EOF
      int64_t end = i;
      if (i < len && data[i] == '\r') {
        ++i;
        if (i < len && data[i] == '\n') ++i;
      } else if (i < len) {
        ++i;
      }
      if (row_fields == 0 && !saw_any) {
        res->row_counts.push_back(0);
      } else {
        res->offsets.push_back(start);
        res->offsets.push_back(end);
        res->row_counts.push_back(row_fields + 1);
      }
      break;
    }
  }
  // quoted flags: all zero, one per field
  res->quoted.assign(res->offsets.size() / 2, 0);
  return res;
}

// Zero-copy tokenizer for QUOTED blocks whose fields need no byte
// rewriting: offsets are (start, end) pairs into the caller's buffer,
// with quoted fields spanning (open+1, close) — stripping the quotes
// is pure offset arithmetic. Returns nullptr (caller falls back to the
// copying csv_parse) on the rewriting cases: a doubled quote inside a
// field, an escape char configured, or bytes between a closing quote
// and the field terminator ("ab"cd).
void* csv_parse_zc(const uint8_t* data, int64_t len, uint8_t delim,
                   uint8_t quote, int32_t doublequote, int32_t escape) {
  if (escape >= 0) return nullptr;
  auto* res = new CsvParseResult();
  res->offsets.reserve((size_t)(len / 4 + 16));
  uint64_t pats[3] = {swar_broadcast(delim), swar_broadcast('\n'),
                      swar_broadcast('\r')};
  bool table[256] = {false};
  table[delim] = table['\n'] = table['\r'] = true;
  uint64_t qpats[1] = {swar_broadcast(quote)};
  bool qtable[256] = {false};
  qtable[quote] = true;
  int64_t i = 0;
  while (i < len) {
    int64_t row_fields = 0;
    bool saw_any = false;
    while (true) {
      bool was_quoted = false;
      int64_t start = i, end;
      if (i < len && data[i] == quote) {
        was_quoted = true;
        saw_any = true;
        start = ++i;
        i = scan_special(data, i, len, qpats, 1, qtable);
        end = i;
        if (i < len) {
          if (doublequote && i + 1 < len && data[i + 1] == quote) {
            delete res;
            return nullptr;  // escaped quote needs pool rewriting
          }
          ++i;  // closing quote
          if (i < len && data[i] != delim && data[i] != '\n' &&
              data[i] != '\r') {
            delete res;
            return nullptr;  // trailing bytes after closing quote
          }
        }
      } else {
        i = scan_special(data, i, len, pats, 3, table);
        end = i;
        if (i > start) saw_any = true;
      }
      if (i < len && data[i] == delim) {
        res->offsets.push_back(start);
        res->offsets.push_back(end);
        res->quoted.push_back(was_quoted ? 1 : 0);
        ++row_fields;
        ++i;
        saw_any = true;
        continue;
      }
      if (i < len && data[i] == '\r') {
        ++i;
        if (i < len && data[i] == '\n') ++i;
      } else if (i < len) {
        ++i;
      }
      if (row_fields == 0 && !saw_any && !was_quoted) {
        res->row_counts.push_back(0);
      } else {
        res->offsets.push_back(start);
        res->offsets.push_back(end);
        res->quoted.push_back(was_quoted ? 1 : 0);
        res->row_counts.push_back(row_fields + 1);
      }
      break;
    }
  }
  return res;
}

int64_t csv_parse_n_offsets(void* handle) {
  return (int64_t)static_cast<CsvParseResult*>(handle)->offsets.size();
}

void csv_parse_sizes(void* handle, int64_t* n_fields, int64_t* n_rows,
                     int64_t* pool_bytes) {
  auto* res = static_cast<CsvParseResult*>(handle);
  *n_fields = (int64_t)res->quoted.size();
  *n_rows = (int64_t)res->row_counts.size();
  *pool_bytes = (int64_t)res->pool.size();
}

void csv_parse_fill(void* handle, int64_t* offsets, uint8_t* pool,
                    uint8_t* quoted, int64_t* row_counts) {
  auto* res = static_cast<CsvParseResult*>(handle);
  std::memcpy(offsets, res->offsets.data(),
              res->offsets.size() * sizeof(int64_t));
  if (!res->pool.empty()) {
    std::memcpy(pool, res->pool.data(), res->pool.size());
  }
  if (!res->quoted.empty()) {
    std::memcpy(quoted, res->quoted.data(), res->quoted.size());
  }
  if (!res->row_counts.empty()) {
    std::memcpy(row_counts, res->row_counts.data(),
                res->row_counts.size() * sizeof(int64_t));
  }
}

void csv_parse_free(void* handle) {
  delete static_cast<CsvParseResult*>(handle);
}

static inline std::string_view csv_field(const uint8_t* pool,
                                         const int64_t* offsets,
                                         int64_t id) {
  return std::string_view(
      reinterpret_cast<const char*>(pool) + offsets[id],
      static_cast<size_t>(offsets[id + 1] - offsets[id]));
}

static inline std::string_view csv_trim(std::string_view v) {
  size_t b = 0, e = v.size();
  while (b < e && (v[b] == ' ' || v[b] == '\t')) ++b;
  while (e > b && (v[e - 1] == ' ' || v[e - 1] == '\t')) --e;
  return v.substr(b, e - b);
}

// Parse fields ids[0..n) as int64. skip (nullable byte mask): 1 = null,
// emit 0. ok[i]=1 on success. Aborts on the first failure (callers treat
// any failure as a column-level failure); returns 0 on full success or
// the 1-based position of the first failure.
int64_t csv_parse_int64(const uint8_t* pool, const int64_t* offsets,
                        const int64_t* ids, const uint8_t* skip,
                        int64_t n, int64_t* out, uint8_t* ok) {
  for (int64_t i = 0; i < n; ++i) {
    if (skip && skip[i]) { out[i] = 0; ok[i] = 1; continue; }
    std::string_view v = csv_trim(csv_field(pool, offsets, ids[i]));
    if (!v.empty() && v.front() == '+' && v.size() > 1) v.remove_prefix(1);
    int64_t value = 0;
    auto r = std::from_chars(v.data(), v.data() + v.size(), value);
    if (r.ec == std::errc() && r.ptr == v.data() + v.size() && !v.empty()) {
      out[i] = value;
      ok[i] = 1;
    } else {
      ok[i] = 0;
      return i + 1;
    }
  }
  return 0;
}

int64_t csv_parse_float64(const uint8_t* pool, const int64_t* offsets,
                          const int64_t* ids, const uint8_t* skip,
                          int64_t n, double* out, uint8_t* ok) {
  for (int64_t i = 0; i < n; ++i) {
    if (skip && skip[i]) { out[i] = 0.0; ok[i] = 1; continue; }
    std::string_view v = csv_trim(csv_field(pool, offsets, ids[i]));
    if (!v.empty() && v.front() == '+' && v.size() > 1) v.remove_prefix(1);
    double value = 0.0;
    auto r = std::from_chars(v.data(), v.data() + v.size(), value);
    if (r.ec == std::errc() && r.ptr == v.data() + v.size() && !v.empty()) {
      out[i] = value;
      ok[i] = 1;
    } else {
      ok[i] = 0;
      return i + 1;
    }
  }
  return 0;
}

// Permissive variants: record per-field ok and keep going, returning the
// failure count — the parse-first inference path resolves failures
// against null tokens afterwards instead of prescanning every field.
int64_t csv_parse_int64p(const uint8_t* pool, const int64_t* offsets,
                         const int64_t* ids, const uint8_t* skip,
                         int64_t n, int64_t* out, uint8_t* ok) {
  int64_t failures = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (skip && skip[i]) { out[i] = 0; ok[i] = 1; continue; }
    std::string_view v = csv_trim(csv_field(pool, offsets, ids[i]));
    if (!v.empty() && v.front() == '+' && v.size() > 1) v.remove_prefix(1);
    int64_t value = 0;
    auto r = std::from_chars(v.data(), v.data() + v.size(), value);
    if (r.ec == std::errc() && r.ptr == v.data() + v.size() && !v.empty()) {
      out[i] = value;
      ok[i] = 1;
    } else {
      out[i] = 0;
      ok[i] = 0;
      ++failures;
    }
  }
  return failures;
}

int64_t csv_parse_float64p(const uint8_t* pool, const int64_t* offsets,
                           const int64_t* ids, const uint8_t* skip,
                           int64_t n, double* out, uint8_t* ok) {
  int64_t failures = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (skip && skip[i]) { out[i] = 0.0; ok[i] = 1; continue; }
    std::string_view v = csv_trim(csv_field(pool, offsets, ids[i]));
    if (!v.empty() && v.front() == '+' && v.size() > 1) v.remove_prefix(1);
    double value = 0.0;
    auto r = std::from_chars(v.data(), v.data() + v.size(), value);
    if (r.ec == std::errc() && r.ptr == v.data() + v.size() && !v.empty()) {
      out[i] = value;
      ok[i] = 1;
    } else {
      out[i] = 0.0;
      ok[i] = 0;
      ++failures;
    }
  }
  return failures;
}

// Token-set matcher with (first char, length) quick reject: most fields
// are numbers/words that share no first byte with the null spellings.
struct CsvTokenSet {
  std::unordered_set<std::string_view> set;
  bool first_ok[256] = {false};
  uint64_t len_mask = 0;  // lengths 0..63 present
  bool has_empty = false;

  void build(const uint8_t* tok_bytes, const int32_t* tok_offs, int32_t m) {
    set.reserve((size_t)m * 2);
    for (int32_t t = 0; t < m; ++t) {
      size_t tl = (size_t)(tok_offs[t + 1] - tok_offs[t]);
      const char* p = reinterpret_cast<const char*>(tok_bytes) + tok_offs[t];
      set.emplace(p, tl);
      if (tl == 0) { has_empty = true; continue; }
      first_ok[(uint8_t)p[0]] = true;
      if (tl < 64) len_mask |= (uint64_t)1 << tl;
    }
  }

  inline bool match(std::string_view v) const {
    if (v.empty()) return has_empty;
    if (!first_ok[(uint8_t)v[0]]) return false;
    if (v.size() >= 64 || !((len_mask >> v.size()) & 1)) return false;
    return set.count(v) != 0;
  }
};

// out[i] = 1 iff field ids[i] equals one of the m tokens (exact bytes).
void csv_match_tokens(const uint8_t* pool, const int64_t* offsets,
                      const int64_t* ids, int64_t n,
                      const uint8_t* tok_bytes, const int32_t* tok_offs,
                      int32_t m, uint8_t* out) {
  CsvTokenSet toks;
  toks.build(tok_bytes, tok_offs, m);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = toks.match(csv_field(pool, offsets, ids[i])) ? 1 : 0;
  }
}

// Fused bool inference: out[i]=1 where true-token, 0 where false-token;
// skipped (null) rows emit 0. Aborts at the first field in neither set;
// returns 0 on success, first-failure position + 1 otherwise.
int64_t csv_parse_bool(const uint8_t* pool, const int64_t* offsets,
                       const int64_t* ids, const uint8_t* skip, int64_t n,
                       const uint8_t* true_bytes, const int32_t* true_offs,
                       int32_t n_true, const uint8_t* false_bytes,
                       const int32_t* false_offs, int32_t n_false,
                       uint8_t* out) {
  CsvTokenSet tv, fv;
  tv.build(true_bytes, true_offs, n_true);
  fv.build(false_bytes, false_offs, n_false);
  for (int64_t i = 0; i < n; ++i) {
    if (skip && skip[i]) { out[i] = 0; continue; }
    std::string_view v = csv_field(pool, offsets, ids[i]);
    if (tv.match(v)) { out[i] = 1; continue; }
    if (fv.match(v)) { out[i] = 0; continue; }
    return i + 1;
  }
  return 0;
}

// Copy fields ids[0..n) into a dense byte buffer at out_offsets
// (precomputed int64 cumsum of lengths, zero-length where skip[i]).
// skip may be null.
void csv_gather_bytes(const uint8_t* pool, const int64_t* offsets,
                      const int64_t* ids, const uint8_t* skip, int64_t n,
                      const int64_t* out_offsets, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    if (skip && skip[i]) continue;
    int64_t id = ids[i];
    int64_t len = offsets[id + 1] - offsets[id];
    if (len) std::memcpy(out + out_offsets[i], pool + offsets[id],
                         (size_t)len);
  }
}

// Transpose the row-major token stream into per-column (start, end)
// pair-offset arrays (+ per-column quoted flags): one sequential pass
// over the field table instead of ncols column-strided passes (each
// strided pass pulls a fresh cache line per field — measured 3x the
// cost of the converters themselves). Missing fields (short rows) emit
// the (0, 0) span; callers mask them separately.
// out_offsets: ncols * (2 * n_rows) int64, column-major blocks;
// out_quoted:  ncols * n_rows u8.
void csv_transpose_columns(const int64_t* offsets, const uint8_t* quoted,
                           const int64_t* row_starts,
                           const int64_t* row_counts, int64_t n_rows,
                           int64_t ncols, int64_t id_scale,
                           int64_t* out_offsets, uint8_t* out_quoted) {
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t start = row_starts[r];
    int64_t rc = row_counts[r];
    int64_t m = rc < ncols ? rc : ncols;
    for (int64_t j = 0; j < m; ++j) {
      int64_t id = (start + j) * id_scale;
      out_offsets[j * 2 * n_rows + 2 * r] = offsets[id];
      out_offsets[j * 2 * n_rows + 2 * r + 1] = offsets[id + 1];
      out_quoted[j * n_rows + r] = quoted[start + j];
    }
    for (int64_t j = m; j < ncols; ++j) {
      out_offsets[j * 2 * n_rows + 2 * r] = 0;
      out_offsets[j * 2 * n_rows + 2 * r + 1] = 0;
      out_quoted[j * n_rows + r] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// ISO-8601 date/timestamp bulk parsers (reference: cpp/src/arrow/util/
// value_parsing.h ParseTimestampISO8601 + csv/converter.cc). Semantics
// mirror the python fallback (datetime.date/datetime.fromisoformat):
// any field the native parser is unsure about aborts the whole column
// so the caller falls back to the python path — abort is always
// correctness-safe.
// ---------------------------------------------------------------------------

static inline bool parse_digits(std::string_view v, size_t pos, int len,
                                int64_t* out) {
  if (pos + (size_t)len > v.size()) return false;
  int64_t r = 0;
  for (int i = 0; i < len; ++i) {
    uint8_t c = (uint8_t)v[pos + i];
    if (c < '0' || c > '9') return false;
    r = r * 10 + (c - '0');
  }
  *out = r;
  return true;
}

// Howard Hinnant's days_from_civil (public-domain algorithm).
static inline int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const int64_t yoe = y - era * 400;
  const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

static inline bool valid_ymd(int64_t y, int64_t m, int64_t d) {
  if (y < 1 || y > 9999 || m < 1 || m > 12 || d < 1) return false;
  static const int dim[12] = {31, 28, 31, 30, 31, 30,
                              31, 31, 30, 31, 30, 31};
  int64_t md = dim[m - 1];
  if (m == 2 && ((y % 4 == 0 && y % 100 != 0) || y % 400 == 0)) md = 29;
  return d <= md;
}

// Parse the date part (YYYY-MM-DD or YYYYMMDD); on success sets *days
// and *pos to the first unconsumed char.
static inline bool parse_iso_date_part(std::string_view v, int64_t* days,
                                       size_t* pos) {
  int64_t y, m, d;
  if (!parse_digits(v, 0, 4, &y)) return false;
  size_t p = 4;
  bool dashes = p < v.size() && v[p] == '-';
  if (dashes) ++p;
  if (!parse_digits(v, p, 2, &m)) return false;
  p += 2;
  if (dashes) {
    if (p >= v.size() || v[p] != '-') return false;
    ++p;
  }
  if (!parse_digits(v, p, 2, &d)) return false;
  p += 2;
  if (!valid_ymd(y, m, d)) return false;
  *days = days_from_civil(y, m, d);
  *pos = p;
  return true;
}

// Parse HH[:MM[:SS[.f{1,6}]]] (or compact HHMM[SS]) plus optional
// Z / +-HH[:MM[:SS]] offset; must consume the whole remainder.
static inline bool parse_iso_time_part(std::string_view v, size_t p,
                                       int64_t* micros_out) {
  int64_t hh = 0, mm = 0, ss = 0, frac = 0, off_sign = 0;
  int64_t off_hh = 0, off_mm = 0, off_ss = 0;
  if (!parse_digits(v, p, 2, &hh)) return false;
  p += 2;
  bool colons = p < v.size() && v[p] == ':';
  if (p < v.size() && v[p] != 'Z' && v[p] != '+' && v[p] != '-') {
    if (colons) ++p;
    if (!parse_digits(v, p, 2, &mm)) return false;
    p += 2;
    if (p < v.size() && ((colons && v[p] == ':') ||
                         (!colons && v[p] >= '0' && v[p] <= '9'))) {
      if (colons) ++p;
      if (!parse_digits(v, p, 2, &ss)) return false;
      p += 2;
      if (p < v.size() && (v[p] == '.' || v[p] == ',')) {
        ++p;
        int nd = 0;
        int64_t f = 0;
        while (p < v.size() && v[p] >= '0' && v[p] <= '9' && nd < 6) {
          f = f * 10 + (v[p] - '0');
          ++p;
          ++nd;
        }
        if (nd == 0) return false;
        // fromisoformat (3.11+) truncates digits beyond microseconds
        while (p < v.size() && v[p] >= '0' && v[p] <= '9') ++p;
        static const int64_t sc[7] = {0, 100000, 10000, 1000, 100, 10, 1};
        frac = f * sc[nd];
      }
    }
  }
  if (p < v.size()) {
    char c = v[p];
    // Uppercase 'Z' only: datetime.fromisoformat (the python fallback)
    // and the reference parser both reject lowercase 'z'.
    if (c == 'Z') {
      ++p;
      off_sign = 1;  // offset 0, but marks "aware"; value is UTC already
    } else if (c == '+' || c == '-') {
      off_sign = (c == '+') ? 1 : -1;
      ++p;
      if (!parse_digits(v, p, 2, &off_hh)) return false;
      p += 2;
      if (p < v.size() && v[p] == ':') {
        ++p;
        if (!parse_digits(v, p, 2, &off_mm)) return false;
        p += 2;
        if (p < v.size() && v[p] == ':') {
          ++p;
          if (!parse_digits(v, p, 2, &off_ss)) return false;
          p += 2;
        }
      } else if (parse_digits(v, p, 2, &off_mm)) {
        p += 2;
      }
      if (off_hh > 23 || off_mm > 59 || off_ss > 59) return false;
    }
  }
  if (p != v.size()) return false;
  if (hh > 23 || mm > 59 || ss > 59) return false;
  // tz offsets are validated but NOT folded: the python path subtracts
  // an epoch carrying the value's own tzinfo, so the offset cancels and
  // the wall-clock time is what lands in the column (_temporal_to_int).
  (void)off_sign;
  *micros_out = ((hh * 60 + mm) * 60 + ss) * 1000000 + frac;
  return true;
}

// Parse fields ids[0..n) as date32 days (strict date-only ISO). Same
// skip/abort contract as csv_parse_int64.
int64_t csv_parse_date32(const uint8_t* pool, const int64_t* offsets,
                         const int64_t* ids, const uint8_t* skip,
                         int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    if (skip && skip[i]) { out[i] = 0; continue; }
    std::string_view v = csv_trim(csv_field(pool, offsets, ids[i]));
    int64_t days;
    size_t p;
    if (!parse_iso_date_part(v, &days, &p) || p != v.size()) return i + 1;
    out[i] = (int32_t)days;
  }
  return 0;
}

// Parse fields ids[0..n) as ISO timestamps -> microseconds since epoch.
// Tz offsets are validated then CANCELLED (wall-clock time is stored),
// matching the python fallback, which subtracts an epoch carrying the
// value's own tzinfo. NOTE: this diverges from the reference
// (value_parsing.h ParseTimestampISO8601 folds [+-]HH:MM into the UTC
// instant); both of this engine's paths agree with each other and the
// divergence is documented in docs/PARITY.md. Separator between date
// and time may be 'T', 't' or ' '.
int64_t csv_parse_ts_micros(const uint8_t* pool, const int64_t* offsets,
                            const int64_t* ids, const uint8_t* skip,
                            int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    if (skip && skip[i]) { out[i] = 0; continue; }
    std::string_view v = csv_trim(csv_field(pool, offsets, ids[i]));
    int64_t days;
    size_t p;
    if (!parse_iso_date_part(v, &days, &p)) return i + 1;
    int64_t micros = 0;
    if (p < v.size()) {
      char c = v[p];
      if (c != 'T' && c != 't' && c != ' ') return i + 1;
      if (!parse_iso_time_part(v, p + 1, &micros)) return i + 1;
    }
    out[i] = days * 86400000000LL + micros;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Flat newline-delimited JSON tokenizer (reference: cpp/src/arrow/json/
// parser.cc on rapidjson). Fast path for machine-generated ndjson where
// every record is a flat object with the SAME keys in the SAME order;
// anything else reports !ok and the caller falls back to the python
// parser. Values land unescaped in a flat pool with a kind byte each:
//   0=null 1=false 2=true 3=number(raw text) 4=string(unescaped)
//   5=nested(raw json text)
// ---------------------------------------------------------------------------

struct JsonParseResult {
  std::vector<int64_t> offsets;     // n_fields + 1
  std::vector<uint8_t> pool;
  std::vector<uint8_t> kinds;
  std::vector<uint8_t> key_bytes;   // first row's keys, concatenated
  std::vector<int32_t> key_offsets; // ncols + 1
  int64_t n_rows = 0;
  int32_t ncols = 0;
  int32_t ok = 0;
};

static inline void json_utf8_append(std::vector<uint8_t>& pool,
                                    uint32_t cp) {
  if (cp < 0x80) {
    pool.push_back((uint8_t)cp);
  } else if (cp < 0x800) {
    pool.push_back((uint8_t)(0xC0 | (cp >> 6)));
    pool.push_back((uint8_t)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    pool.push_back((uint8_t)(0xE0 | (cp >> 12)));
    pool.push_back((uint8_t)(0x80 | ((cp >> 6) & 0x3F)));
    pool.push_back((uint8_t)(0x80 | (cp & 0x3F)));
  } else {
    pool.push_back((uint8_t)(0xF0 | (cp >> 18)));
    pool.push_back((uint8_t)(0x80 | ((cp >> 12) & 0x3F)));
    pool.push_back((uint8_t)(0x80 | ((cp >> 6) & 0x3F)));
    pool.push_back((uint8_t)(0x80 | (cp & 0x3F)));
  }
}

static inline int json_hex4(const uint8_t* d, int64_t i, int64_t len,
                            uint32_t* out) {
  if (i + 4 > len) return 0;
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k) {
    uint8_t c = d[i + k];
    v <<= 4;
    if (c >= '0' && c <= '9') v |= c - '0';
    else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
    else return 0;
  }
  *out = v;
  return 1;
}

// Unescape a JSON string starting at the opening quote; appends bytes
// to pool, returns position past the closing quote or -1.
static int64_t json_string_into(const uint8_t* d, int64_t len, int64_t i,
                                std::vector<uint8_t>& pool) {
  ++i;  // opening quote
  while (i < len) {
    int64_t run = i;
    while (run < len && d[run] != '"' && d[run] != '\\') ++run;
    if (run > i) {
      pool.insert(pool.end(), d + i, d + run);
      i = run;
    }
    if (i >= len) return -1;
    if (d[i] == '"') return i + 1;
    // escape
    ++i;
    if (i >= len) return -1;
    uint8_t e = d[i++];
    switch (e) {
      case '"': pool.push_back('"'); break;
      case '\\': pool.push_back('\\'); break;
      case '/': pool.push_back('/'); break;
      case 'b': pool.push_back('\b'); break;
      case 'f': pool.push_back('\f'); break;
      case 'n': pool.push_back('\n'); break;
      case 'r': pool.push_back('\r'); break;
      case 't': pool.push_back('\t'); break;
      case 'u': {
        uint32_t cp;
        if (!json_hex4(d, i, len, &cp)) return -1;
        i += 4;
        if (cp >= 0xD800 && cp <= 0xDBFF && i + 6 <= len &&
            d[i] == '\\' && d[i + 1] == 'u') {
          uint32_t lo;
          if (!json_hex4(d, i + 2, len, &lo)) return -1;
          if (lo >= 0xDC00 && lo <= 0xDFFF) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            i += 6;
          }
        }
        json_utf8_append(pool, cp);
        break;
      }
      default:
        return -1;
    }
  }
  return -1;
}

// Skip over a string (no unescape); returns pos past closing quote or -1.
static int64_t json_skip_string(const uint8_t* d, int64_t len,
                                int64_t i) {
  ++i;
  while (i < len) {
    if (d[i] == '\\') { i += 2; continue; }
    if (d[i] == '"') return i + 1;
    ++i;
  }
  return -1;
}

void* json_parse_flat(const uint8_t* d, int64_t len) {
  auto* res = new JsonParseResult();
  res->offsets.reserve((size_t)(len / 16 + 16));
  res->pool.reserve((size_t)len);
  res->offsets.push_back(0);
  res->key_offsets.push_back(0);
  auto fail = [&]() -> void* { res->ok = 0; return res; };
  int64_t i = 0;
  auto skip_ws = [&]() {
    while (i < len && (d[i] == ' ' || d[i] == '\t' || d[i] == '\r' ||
                       d[i] == '\n')) ++i;
  };
  std::vector<std::pair<int32_t, int32_t>> first_keys;  // span into key_bytes
  while (true) {
    skip_ws();
    if (i >= len) break;
    if (d[i] != '{') return fail();
    ++i;
    int32_t col = 0;
    skip_ws();
    if (i < len && d[i] == '}') {  // empty object row
      if (res->n_rows == 0) res->ncols = 0;
      if (res->ncols != 0) return fail();
      ++i;
      ++res->n_rows;
      continue;
    }
    while (true) {
      skip_ws();
      if (i >= len || d[i] != '"') return fail();
      // key: raw span (escaped keys -> fallback)
      int64_t kstart = i + 1;
      int64_t kend = kstart;
      while (kend < len && d[kend] != '"' && d[kend] != '\\') ++kend;
      if (kend >= len || d[kend] == '\\') return fail();
      if (res->n_rows == 0) {
        int32_t off = (int32_t)res->key_bytes.size();
        res->key_bytes.insert(res->key_bytes.end(), d + kstart, d + kend);
        res->key_offsets.push_back((int32_t)res->key_bytes.size());
        first_keys.emplace_back(off, (int32_t)(kend - kstart));
      } else {
        if (col >= res->ncols) return fail();
        auto [koff, klen] = first_keys[col];
        if (klen != (int32_t)(kend - kstart) ||
            std::memcmp(res->key_bytes.data() + koff, d + kstart,
                        (size_t)klen) != 0)
          return fail();
      }
      i = kend + 1;
      skip_ws();
      if (i >= len || d[i] != ':') return fail();
      ++i;
      skip_ws();
      if (i >= len) return fail();
      uint8_t c = d[i];
      if (c == '"') {
        i = json_string_into(d, len, i, res->pool);
        if (i < 0) return fail();
        res->kinds.push_back(4);
      } else if (c == 't') {
        if (i + 4 > len || std::memcmp(d + i, "true", 4)) return fail();
        i += 4;
        res->kinds.push_back(2);
      } else if (c == 'f') {
        if (i + 5 > len || std::memcmp(d + i, "false", 5)) return fail();
        i += 5;
        res->kinds.push_back(1);
      } else if (c == 'n') {
        if (i + 4 > len || std::memcmp(d + i, "null", 4)) return fail();
        i += 4;
        res->kinds.push_back(0);
      } else if (c == '-' || (c >= '0' && c <= '9')) {
        int64_t start = i;
        while (i < len) {
          uint8_t nc = d[i];
          if ((nc >= '0' && nc <= '9') || nc == '-' || nc == '+' ||
              nc == '.' || nc == 'e' || nc == 'E') { ++i; continue; }
          break;
        }
        res->pool.insert(res->pool.end(), d + start, d + i);
        res->kinds.push_back(3);
      } else if (c == '{' || c == '[') {
        int64_t start = i;
        int depth = 0;
        while (i < len) {
          uint8_t nc = d[i];
          if (nc == '"') {
            i = json_skip_string(d, len, i);
            if (i < 0) return fail();
            continue;
          }
          if (nc == '{' || nc == '[') ++depth;
          else if (nc == '}' || nc == ']') {
            --depth;
            if (depth == 0) { ++i; break; }
          }
          ++i;
        }
        if (depth != 0) return fail();
        res->pool.insert(res->pool.end(), d + start, d + i);
        res->kinds.push_back(5);
      } else {
        return fail();
      }
      res->offsets.push_back((int64_t)res->pool.size());
      ++col;
      skip_ws();
      if (i >= len) return fail();
      if (d[i] == ',') { ++i; continue; }
      if (d[i] == '}') { ++i; break; }
      return fail();
    }
    if (res->n_rows == 0) {
      res->ncols = col;
    } else if (col != res->ncols) {
      return fail();
    }
    ++res->n_rows;
  }
  res->ok = 1;
  return res;
}

void json_parse_sizes(void* handle, int32_t* ok, int64_t* n_rows,
                      int32_t* ncols, int64_t* pool_bytes,
                      int64_t* key_bytes) {
  auto* res = static_cast<JsonParseResult*>(handle);
  *ok = res->ok;
  *n_rows = res->n_rows;
  *ncols = res->ncols;
  *pool_bytes = (int64_t)res->pool.size();
  *key_bytes = (int64_t)res->key_bytes.size();
}

void json_parse_fill(void* handle, int64_t* offsets, uint8_t* pool,
                     uint8_t* kinds, uint8_t* key_bytes,
                     int32_t* key_offsets) {
  auto* res = static_cast<JsonParseResult*>(handle);
  std::memcpy(offsets, res->offsets.data(),
              res->offsets.size() * sizeof(int64_t));
  if (!res->pool.empty())
    std::memcpy(pool, res->pool.data(), res->pool.size());
  if (!res->kinds.empty())
    std::memcpy(kinds, res->kinds.data(), res->kinds.size());
  if (!res->key_bytes.empty())
    std::memcpy(key_bytes, res->key_bytes.data(), res->key_bytes.size());
  std::memcpy(key_offsets, res->key_offsets.data(),
              res->key_offsets.size() * sizeof(int32_t));
}

void json_parse_free(void* handle) {
  delete static_cast<JsonParseResult*>(handle);
}


// Format float64/int64 values as shortest-round-trip decimal strings
// (std::to_chars, the csv/writer.cc equivalent of the reference's
// float formatting). Output: concatenated bytes in `pool` with
// `offsets[n+1]` (offsets[0]=0); invalid rows emit empty cells.
// Returns total bytes written (pool must have >= n*32 capacity).
// The float text is Python's repr: fixed notation for decimal
// exponents -4 to 15 (to_chars picks scientific whenever shorter),
// scientific from 1e16, and ".0" after an integral value.
int64_t csv_format_f64(const double* vals, const uint8_t* valid,
                       int64_t n, uint8_t* pool, int64_t* offsets) {
  char* out = reinterpret_cast<char*>(pool);
  int64_t pos = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid || valid[i]) {
      double v = vals[i];
      if (std::isnan(v)) {
        std::memcpy(out + pos, "nan", 3);
        pos += 3;
      } else if (std::isinf(v)) {
        if (v < 0) { std::memcpy(out + pos, "-inf", 4); pos += 4; }
        else { std::memcpy(out + pos, "inf", 3); pos += 3; }
      } else {
        char* tok = out + pos;
        auto res = std::to_chars(tok, tok + 32, v);
        pos = res.ptr - out;
        // python-repr normalization: to_chars picks scientific
        // whenever shorter ("1e-04", "1e+15"); python repr keeps
        // fixed for -4 <= exponent < 16 — rewrite those in place
        char* epos = nullptr;
        for (char* c = tok; c < out + pos; ++c) {
          if (*c == 'e') { epos = c; break; }
        }
        if (epos) {
          // the exponent's digits end at the token's end (the reference
          // reads on with atoi into the pool's next, unwritten bytes, so
          // a digit left there skips this rewrite)
          int exp = 0;
          std::from_chars(epos + (epos[1] == '+' ? 2 : 1), out + pos, exp);
          if (exp >= -4 && exp < 16) {
            auto fres = std::to_chars(tok, tok + 32, v,
                                      std::chars_format::fixed);
            pos = fres.ptr - out;
            epos = nullptr;  // now fixed: fall through to '.' check
          }
        }
        if (!epos && std::fabs(v) >= 1e16) {
          // python switches to scientific at 1e16 even when fixed is
          // shorter ("843053430426600064" -> "8.430534304266001e+17")
          auto sres = std::to_chars(tok, tok + 32, v,
                                    std::chars_format::scientific);
          pos = sres.ptr - out;
        } else if (!epos) {
          bool plain = true;
          for (char* c = tok; c < out + pos; ++c) {
            if (*c == '.' || *c == 'e' || *c == 'n' || *c == 'i') {
              plain = false;
              break;
            }
          }
          if (plain) {
            out[pos++] = '.';
            out[pos++] = '0';
          }
        }
      }
    }
    offsets[i + 1] = pos;
  }
  return pos;
}

int64_t csv_format_i64(const int64_t* vals, const uint8_t* valid,
                       int64_t n, uint8_t* pool, int64_t* offsets) {
  char* out = reinterpret_cast<char*>(pool);
  int64_t pos = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid || valid[i]) {
      auto res = std::to_chars(out + pos, out + pos + 24, vals[i]);
      pos = res.ptr - out;
    }
    offsets[i + 1] = pos;
  }
  return pos;
}

// QUOTE_MINIMAL pass over a (pool, i32 offsets) string column: cells
// containing the delimiter, quotes, or newlines are wrapped with
// embedded quotes doubled; invalid cells emit empty. out_pool must
// hold 2*len(pool) + 2n bytes (csv/writer.cc quoting analogue).
int64_t csv_quote_cells(const uint8_t* pool, const int32_t* offsets,
                        const uint8_t* valid, int64_t n, uint8_t delim,
                        uint8_t* out_pool, int64_t* out_offsets) {
  int64_t pos = 0;
  out_offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid || valid[i]) {
      int32_t a = offsets[i], b = offsets[i + 1];
      bool needs = false;
      for (int32_t j = a; j < b; ++j) {
        uint8_t c = pool[j];
        if (c == delim || c == '"' || c == '\n' || c == '\r') {
          needs = true;
          break;
        }
      }
      if (!needs) {
        std::memcpy(out_pool + pos, pool + a, b - a);
        pos += b - a;
      } else {
        out_pool[pos++] = '"';
        for (int32_t j = a; j < b; ++j) {
          uint8_t c = pool[j];
          out_pool[pos++] = c;
          if (c == '"') out_pool[pos++] = '"';
        }
        out_pool[pos++] = '"';
      }
    }
    out_offsets[i + 1] = pos;
  }
  return pos;
}

// Row-major interleave of pre-formatted column cell pools into one CSV
// body: cells joined by delim, rows terminated with \r\n. Returns
// bytes written (csv/writer.cc's final assembly, minus its buffering).
int64_t csv_interleave(int64_t ncols, const int64_t* const* offsets,
                       const uint8_t* const* pools, int64_t n,
                       uint8_t delim, uint8_t* out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t c = 0; c < ncols; ++c) {
      if (c) out[pos++] = delim;
      int64_t a = offsets[c][i], b = offsets[c][i + 1];
      std::memcpy(out + pos, pools[c] + a, b - a);
      pos += b - a;
    }
    out[pos++] = '\r';
    out[pos++] = '\n';
  }
  return pos;
}

}  // extern "C"
