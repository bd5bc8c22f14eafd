// ORC's RLEv2 integer coder (counterpart of the ORC part of
// arrow_tpu/native/native.cpp; reference: liborc's RleEncoderV2 and
// RleDecoderV2).
//
//   * orc_rlev2_encode: SHORT_REPEAT runs and DIRECT literals, the
//     reference writer's subset, byte for byte;
//   * orc_rlev2_decode: SHORT_REPEAT, DIRECT, PATCHED_BASE (patch entries
//     at the closest fixed bit width, as liborc packs them) and DELTA.
//
// Built with the host C++ compiler by arrow_tpu_torch/kernels/_build.py
// (host_library) and loaded with ctypes; plain C interface.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// ORC RLEv2 encode (SHORT_REPEAT runs + DIRECT literals: the reference
// writer's always-decodable subset, byte for byte). out must hold
// 9*n + 2*(n/512+2) bytes.
// ---------------------------------------------------------------------------

static const int kOrcWidthEnc[32] = {
  1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,22,23,24,
  26,28,30,32,40,48,56,64};

int64_t orc_rlev2_encode(const int64_t* vals, int64_t n,
                         int32_t is_signed, uint8_t* out) {
  if (n == 0) return 0;
  std::vector<uint64_t> u(static_cast<size_t>(n));
  if (is_signed) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t v = vals[i];
      u[i] = (static_cast<uint64_t>(v) << 1) ^
             static_cast<uint64_t>(v >> 63);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) u[i] = static_cast<uint64_t>(vals[i]);
  }
  uint8_t* p = out;

  auto emit_direct = [&](int64_t lo, int64_t hi) {
    for (int64_t c0 = lo; c0 < hi; c0 += 512) {
      int64_t cnt = std::min<int64_t>(512, hi - c0);
      uint64_t mx = 0;
      for (int64_t k = 0; k < cnt; ++k) mx |= u[c0 + k];
      int width = mx ? 64 - __builtin_clzll(mx) : 1;
      int wc = 0;
      while (kOrcWidthEnc[wc] < width) ++wc;
      int cw = kOrcWidthEnc[wc];
      *p++ = static_cast<uint8_t>((1 << 6) | (wc << 1) |
                                  ((cnt - 1) >> 8));
      *p++ = static_cast<uint8_t>((cnt - 1) & 0xFF);
      int nb = 0;
      uint8_t cur = 0;
      for (int64_t k = 0; k < cnt; ++k) {
        uint64_t v = u[c0 + k];
        int rem = cw;
        while (rem > 0) {
          int take = rem < 8 - nb ? rem : 8 - nb;
          uint64_t bits = (v >> (rem - take)) &
                          ((1ull << take) - 1);
          cur = static_cast<uint8_t>((cur << take) | bits);
          nb += take;
          rem -= take;
          if (nb == 8) {
            *p++ = cur;
            cur = 0;
            nb = 0;
          }
        }
      }
      if (nb) *p++ = static_cast<uint8_t>(cur << (8 - nb));
    }
  };

  int64_t i = 0;
  while (i < n) {
    int64_t run = 1;
    while (i + run < n && u[i + run] == u[i]) ++run;
    if (run >= 3) {
      uint64_t v = u[i];
      int width = v ? 64 - __builtin_clzll(v) : 0;
      int nbytes = v ? (width + 7) / 8 : 1;
      int64_t left = run;
      while (left >= 3) {
        int take = static_cast<int>(std::min<int64_t>(left, 10));
        *p++ = static_cast<uint8_t>(((nbytes - 1) << 3) | (take - 3));
        for (int b = nbytes - 1; b >= 0; --b)
          *p++ = static_cast<uint8_t>(v >> (8 * b));
        left -= take;
      }
      if (left) emit_direct(i + run - left, i + run);
      i += run;
    } else {
      int64_t lo = i;
      while (i < n) {
        int64_t r2 = 1;
        while (i + r2 < n && u[i + r2] == u[i]) ++r2;
        if (r2 >= 3) break;
        i += r2;
      }
      emit_direct(lo, i);
    }
  }
  return p - out;
}

// ---------------------------------------------------------------------------
// ORC RLEv2 decode (SHORT_REPEAT / DIRECT / PATCHED_BASE / DELTA) —
// liborc RleDecoderV2 analogue. MSB-first bit packing, big-endian
// bases, zigzag for signed. Returns bytes consumed or -1 on overrun.
// ---------------------------------------------------------------------------

static const int kOrcWidth[32] = {
  1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,22,23,24,
  26,28,30,32,40,48,56,64};

// liborc getClosestFixedBits: round a bit width up to the nearest
// encodable fixed width (PATCHED_BASE patch entries are packed at
// this rounded width, not at pgw+pwidth).
static inline int orc_closest_fixed_bits(int w) {
  for (int i = 0; i < 32; ++i)
    if (kOrcWidth[i] >= w) return kOrcWidth[i];
  return 64;
}

static inline int64_t orc_varint(const uint8_t* d, int64_t len,
                                 int64_t& pos, bool* ok) {
  uint64_t v = 0; int shift = 0;
  while (true) {
    if (pos >= len) { *ok = false; return 0; }
    uint8_t b = d[pos++];
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) return (int64_t)v;
    shift += 7;
  }
}

// read `count` MSB-first bit-packed values of `width` bits.
// Byte-aligned widths take whole-byte loads; odd widths run a 64-bit
// bit-buffer extracting `width` bits per value (the previous
// bit-at-a-time loop was the ORC read hot spot — 3x liborc).
static inline bool orc_read_bits(const uint8_t* d, int64_t len,
                                 int64_t& pos, int64_t count, int width,
                                 uint64_t* out) {
  int64_t nbytes = (count * width + 7) / 8;
  if (pos + nbytes > len) return false;
  const uint8_t* src = d + pos;
  if ((width & 7) == 0) {
    int nb = width >> 3;
    for (int64_t i = 0; i < count; ++i) {
      const uint8_t* p = src + i * nb;
      uint64_t v = 0;
      for (int b = 0; b < nb; ++b) v = (v << 8) | p[b];
      out[i] = v;
    }
  } else {
    // every non-byte-aligned encodable width is <= 30 bits, so the
    // 64-bit buffer never overflows (kOrcWidth)
    uint64_t buf = 0;
    int bits = 0;
    int64_t bytep = 0;
    uint64_t mask = (1ULL << width) - 1;
    for (int64_t i = 0; i < count; ++i) {
      while (bits < width) {
        buf = (buf << 8) | src[bytep++];
        bits += 8;
      }
      out[i] = (buf >> (bits - width)) & mask;
      bits -= width;
    }
  }
  pos += nbytes;
  return true;
}

int64_t orc_rlev2_decode(const uint8_t* data, int64_t len, int64_t n,
                         int32_t signed_vals, int64_t* out) {
  int64_t pos = 0, filled = 0;
  std::vector<uint64_t> tmp;
  while (filled < n) {
    if (pos >= len) return -1;
    uint8_t h = data[pos++];
    int enc = h >> 6;
    if (enc == 0) {                         // SHORT_REPEAT
      int width = ((h >> 3) & 0x7) + 1;
      int count = (h & 0x7) + 3;
      if (pos + width > len || filled + count > n) return -1;
      uint64_t v = 0;
      for (int b = 0; b < width; ++b) v = (v << 8) | data[pos + b];
      pos += width;
      int64_t sv = (int64_t)v;
      if (signed_vals) sv = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      for (int i = 0; i < count; ++i) out[filled + i] = sv;
      filled += count;
    } else if (enc == 1) {                  // DIRECT
      int width = kOrcWidth[(h >> 1) & 0x1F];
      if (pos >= len) return -1;
      int count = (((h & 1) << 8) | data[pos++]) + 1;
      if (filled + count > n) return -1;
      tmp.resize(count);
      if (!orc_read_bits(data, len, pos, count, width, tmp.data()))
        return -1;
      for (int i = 0; i < count; ++i) {
        uint64_t v = tmp[i];
        out[filled + i] = signed_vals
            ? ((int64_t)(v >> 1) ^ -(int64_t)(v & 1))
            : (int64_t)v;
      }
      filled += count;
    } else if (enc == 3) {                  // DELTA
      int width_code = (h >> 1) & 0x1F;
      if (pos >= len) return -1;
      int count = (((h & 1) << 8) | data[pos++]) + 1;
      if (filled + count > n) return -1;
      bool ok = true;
      int64_t base = orc_varint(data, len, pos, &ok);
      if (!ok) return -1;
      if (signed_vals) base = (int64_t)((uint64_t)base >> 1) ^
                              -(int64_t)(base & 1);
      int64_t d0 = orc_varint(data, len, pos, &ok);
      if (!ok) return -1;
      d0 = (int64_t)((uint64_t)d0 >> 1) ^ -(int64_t)(d0 & 1);
      out[filled] = base;
      if (count > 1) out[filled + 1] = base + d0;
      if (count > 2) {
        if (width_code == 0) {
          for (int i = 2; i < count; ++i)
            out[filled + i] = out[filled + i - 1] + d0;
        } else {
          int width = kOrcWidth[width_code];
          tmp.resize(count - 2);
          if (!orc_read_bits(data, len, pos, count - 2, width,
                             tmp.data()))
            return -1;
          int64_t sign = d0 >= 0 ? 1 : -1;
          for (int i = 0; i < count - 2; ++i)
            out[filled + 2 + i] = out[filled + 1 + i] +
                sign * (int64_t)tmp[i];
        }
      }
      filled += count;
    } else {                                // PATCHED_BASE
      int width = kOrcWidth[(h >> 1) & 0x1F];
      if (pos + 2 >= len) return -1;
      int count = (((h & 1) << 8) | data[pos]) + 1;
      uint8_t b3 = data[pos + 1];
      uint8_t b4 = data[pos + 2];
      pos += 3;
      int bw = ((b3 >> 5) & 0x7) + 1;
      int pwidth = kOrcWidth[b3 & 0x1F];
      int pgw = ((b4 >> 5) & 0x7) + 1;
      int plen = b4 & 0x1F;
      if (pos + bw > len || filled + count > n) return -1;
      uint64_t braw = 0;
      for (int b = 0; b < bw; ++b) braw = (braw << 8) | data[pos + b];
      pos += bw;
      int64_t base;
      uint64_t sign_bit = 1ULL << (bw * 8 - 1);
      if (braw & sign_bit) base = -(int64_t)(braw & (sign_bit - 1));
      else base = (int64_t)braw;
      tmp.resize(count);
      if (!orc_read_bits(data, len, pos, count, width, tmp.data()))
        return -1;
      if (plen) {
        int ew = orc_closest_fixed_bits(pgw + pwidth);
        std::vector<uint64_t> entries(plen);
        if (!orc_read_bits(data, len, pos, plen, ew, entries.data()))
          return -1;
        int64_t p = 0;
        for (int i = 0; i < plen; ++i) {
          int64_t gap = (int64_t)(entries[i] >> pwidth);
          uint64_t patch = entries[i] &
              ((pwidth >= 64) ? ~0ULL : ((1ULL << pwidth) - 1));
          p += gap;
          if (p >= count) return -1;
          tmp[p] |= patch << width;
        }
      }
      for (int i = 0; i < count; ++i)
        out[filled + i] = base + (int64_t)tmp[i];
      filled += count;
    }
  }
  return pos;
}


}  // extern "C"
