// Raw snappy codec on the host CPU (counterpart of the snappy codec of
// arrow_tpu/native/native.cpp; reference: cpp/src/arrow/util/
// compression_snappy.cc, the format of google/snappy's
// format_description.txt). Parquet's SNAPPY pages and io_streams'
// "snappy" codec use it.
//
// The compressor is the reference's small hash matcher, step for step (a
// 14-bit table of 4-byte windows, matches of at most 64 bytes emitted as
// copies with 2-byte offsets, literals of at most 2^32 bytes), so a buffer
// compresses to the reference's bytes. Any valid raw snappy stream
// decompresses.
//
// Built with the host C++ compiler by arrow_tpu_torch/kernels/_build.py
// (host_library) and loaded with ctypes; plain C interface.
// csrc/parquet_host.cpp includes this file for its page decoder.

#include <cstdint>
#include <cstring>

extern "C" {

// Decompresses into out[0:out_cap]: the output length, or -1 for a
// malformed stream or one whose length exceeds out_cap.
int64_t snappy_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                          int64_t out_cap) {
  int64_t ip = 0;
  uint64_t ulen = 0;
  int shift = 0;
  while (ip < in_len) {
    uint8_t b = in[ip++];
    ulen |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 63) return -1;
  }
  if (static_cast<int64_t>(ulen) > out_cap) return -1;
  const int64_t end = static_cast<int64_t>(ulen);
  int64_t op = 0;
  while (ip < in_len) {
    uint8_t tag = in[ip++];
    int t = tag & 3;
    // short literals and copies away from both ends move 16 bytes at once
    // (the bytes past the element are rewritten by the next one)
    const bool room = ip + 16 <= in_len && op + 16 <= end;
    if (t == 0 && room && (tag >> 2) < 16) {
      int64_t len = (tag >> 2) + 1;
      std::memcpy(out + op, in + ip, 16);
      ip += len;
      op += len;
      continue;
    }
    if (t == 0) {  // a literal
      int64_t len = (tag >> 2) + 1;
      if (len > 60) {
        int n = static_cast<int>(len) - 60;
        if (ip + n > in_len) return -1;
        len = 0;
        for (int i = 0; i < n; i++)
          len |= static_cast<int64_t>(in[ip++]) << (8 * i);
        len += 1;
      }
      if (ip + len > in_len || op + len > end) return -1;
      std::memcpy(out + op, in + ip, static_cast<size_t>(len));
      ip += len;
      op += len;
      continue;
    }
    int64_t len, off;
    if (t == 1) {  // a copy with a 1-byte offset
      if (ip + 1 > in_len) return -1;
      len = ((tag >> 2) & 0x7) + 4;
      off = (static_cast<int64_t>(tag & 0xE0) << 3) | in[ip++];
    } else if (t == 2) {  // a 2-byte offset
      if (ip + 2 > in_len) return -1;
      len = (tag >> 2) + 1;
      off = in[ip] | (static_cast<int64_t>(in[ip + 1]) << 8);
      ip += 2;
    } else {  // a 4-byte offset
      if (ip + 4 > in_len) return -1;
      len = (tag >> 2) + 1;
      off = static_cast<int64_t>(in[ip]) |
            (static_cast<int64_t>(in[ip + 1]) << 8) |
            (static_cast<int64_t>(in[ip + 2]) << 16) |
            (static_cast<int64_t>(in[ip + 3]) << 24);
      ip += 4;
    }
    if (off <= 0 || off > op || op + len > end) return -1;
    if (room && off >= 8 && len <= 16) {
      // two 8-byte moves, neither overlapping itself (off >= 8)
      std::memcpy(out + op, out + op - off, 8);
      std::memcpy(out + op + 8, out + op - off + 8, 8);
    } else if (off >= len) {
      std::memcpy(out + op, out + op - off, static_cast<size_t>(len));
    } else {  // the copy overlaps its own output: a repeating pattern
      for (int64_t i = 0; i < len; i++) out[op + i] = out[op - off + i];
    }
    op += len;
  }
  return op == end ? op : -1;
}

// The most bytes snappy_compress writes for n input bytes.
int64_t snappy_max_compressed(int64_t n) { return n + n / 4 + 64; }

// Compresses in[0:n] into out (snappy_max_compressed(n) bytes): the
// compressed length.
int64_t snappy_compress(const uint8_t* in, int64_t n, uint8_t* out) {
  int64_t op = 0;
  uint64_t v = static_cast<uint64_t>(n);
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      out[op++] = b | 0x80;
    } else {
      out[op++] = b;
      break;
    }
  }
  auto emit_literal = [&](int64_t from, int64_t len) {
    while (len > 0) {
      int64_t chunk = len;
      if (chunk <= 60) {
        out[op++] = static_cast<uint8_t>((chunk - 1) << 2);
      } else {
        int nb = 0;
        int64_t l = chunk - 1;
        uint8_t tmp[4];
        while (l > 0 && nb < 4) {
          tmp[nb++] = l & 0xFF;
          l >>= 8;
        }
        if (nb == 0) tmp[nb++] = 0;
        out[op++] = static_cast<uint8_t>((59 + nb) << 2);
        for (int i = 0; i < nb; i++) out[op++] = tmp[i];
      }
      std::memcpy(out + op, in + from, static_cast<size_t>(chunk));
      op += chunk;
      from += chunk;
      len -= chunk;
    }
  };
  constexpr int kHashBits = 14;
  static thread_local int64_t table[1 << kHashBits];
  for (int i = 0; i < (1 << kHashBits); i++) table[i] = -1;
  int64_t lit_start = 0;
  int64_t i = 0;
  while (i + 4 <= n) {
    uint32_t h;
    std::memcpy(&h, in + i, 4);
    uint32_t slot = (h * 0x1e35a7bdu) >> (32 - kHashBits);
    int64_t cand = table[slot];
    table[slot] = i;
    uint32_t c = 0;
    if (cand >= 0) std::memcpy(&c, in + cand, 4);
    if (cand >= 0 && i - cand < 65536 && c == h) {
      int64_t len = 4;
      while (i + len < n && in[cand + len] == in[i + len] && len < 64) len++;
      if (i > lit_start) emit_literal(lit_start, i - lit_start);
      int64_t off = i - cand;
      out[op++] = static_cast<uint8_t>(((len - 1) << 2) | 2);
      out[op++] = static_cast<uint8_t>(off & 0xFF);
      out[op++] = static_cast<uint8_t>(off >> 8);
      i += len;
      lit_start = i;
    } else {
      i++;
    }
  }
  if (lit_start < n) emit_literal(lit_start, n - lit_start);
  return op;
}

}  // extern "C"
