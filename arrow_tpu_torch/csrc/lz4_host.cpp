// LZ4 block and frame codec on the host CPU (counterpart of the LZ4 block
// codec of arrow_tpu/native/native.cpp; reference: the LZ4 block and frame
// format specifications, as cpp/src/arrow/util/compression_lz4.cc writes
// Arrow IPC's LZ4_FRAME buffers).
//
// The block compressor is the reference's greedy hash matcher, step for
// step, so a block compresses to the reference's bytes. The frame layer
// writes the reference's frames (version 01, independent blocks, 4 MiB
// blocks, no checksums but the header's, an incompressible block stored
// raw); since its blocks are independent, it compresses them on several
// threads and concatenates them in order, which gives the same bytes as
// one thread. Frames with independent blocks also decompress block by
// block on several threads; linked blocks decompress in order.
//
// Built with the host C++ compiler by arrow_tpu_torch/kernels/_build.py
// (host_library) and loaded with ctypes; plain C interface.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kHashBits = 14;
constexpr uint32_t kMagic = 0x184D2204u;
constexpr int64_t kBlockMax = 4 * 1024 * 1024;  // BD 0x70

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline void write32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }

// New bytes decoded into out[hist:], or -1 for a malformed block, -2 where
// out_cap is too small. `hist` bytes of history precede the block's output
// at the start of `out` (block-linked frames).
int64_t block_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                     int64_t out_cap, int64_t hist) {
  int64_t ip = 0, op = hist;
  while (ip < in_len) {
    uint8_t token = in[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= in_len) return -1;
        b = in[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > in_len) return -1;
    if (op + lit > out_cap) return -2;
    std::memcpy(out + op, in + ip, lit);
    ip += lit;
    op += lit;
    if (ip >= in_len) break;  // the last literals
    if (ip + 2 > in_len) return -1;
    int64_t off = in[ip] | (static_cast<int64_t>(in[ip + 1]) << 8);
    ip += 2;
    if (off == 0 || off > op) return -1;
    int64_t mlen = token & 0xF;
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= in_len) return -1;
        b = in[ip++];
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > out_cap) return -2;
    for (int64_t i = 0; i < mlen; i++) out[op + i] = out[op - off + i];
    op += mlen;
  }
  return op - hist;
}

struct Block {
  int64_t pos, size;
  bool raw;
};

// The blocks of a frame after its header, or false where it is malformed.
bool scan_blocks(const uint8_t* in, int64_t n, int64_t* block_max,
                 bool* independent, std::vector<Block>* blocks) {
  if (n < 7 || read32(in) != kMagic) return false;
  uint8_t flg = in[4];
  int code = (in[5] >> 4) & 7;
  *block_max = code >= 4 ? (int64_t{1} << (2 * code + 8)) : kBlockMax;
  *independent = (flg & 0x20) != 0;
  int64_t pos = 6;
  if (flg & 0x08) pos += 8;  // content size
  if (flg & 0x01) pos += 4;  // dictionary id
  pos += 1;                  // header checksum
  bool checksums = (flg & 0x10) != 0;
  while (pos + 4 <= n) {
    uint32_t size = read32(in + pos);
    pos += 4;
    if (size == 0) break;
    bool raw = (size & 0x80000000u) != 0;
    int64_t len = size & 0x7FFFFFFFu;
    if (pos + len > n) len = n - pos;  // a truncated last block
    blocks->push_back({pos, len, raw});
    pos += len + (checksums ? 4 : 0);
  }
  return true;
}

int64_t decode_in_order(const uint8_t* in, const std::vector<Block>& blocks,
                        bool independent, uint8_t* out, int64_t out_cap) {
  int64_t op = 0;
  for (const Block& b : blocks) {
    if (b.raw) {
      if (op + b.size > out_cap) return -2;
      std::memcpy(out + op, in + b.pos, b.size);
      op += b.size;
      continue;
    }
    int64_t hist = independent ? 0 : std::min<int64_t>(op, 65536);
    int64_t r = block_decode(in + b.pos, b.size, out + op - hist,
                             out_cap - op + hist, hist);
    if (r < 0) return r;
    op += r;
  }
  return op;
}

// Runs fn(b) for every b in [0, n) on up to `threads` threads, the calling
// one among them, the blocks handed out by a shared counter. A thread that
// cannot start leaves its share to the others, and an exception in fn
// stops the work: no exception leaves this call, and so none crosses the
// C interface. Returns false where fn threw.
template <typename Fn>
bool for_blocks(int64_t n, int64_t threads, Fn fn) {
  std::atomic<int64_t> next{0};
  std::atomic<bool> failed{false};
  auto work = [&]() {
    try {
      for (int64_t b; !failed && (b = next++) < n;) fn(b);
    } catch (...) {
      failed = true;
    }
  };
  std::vector<std::thread> pool;
  try {
    int64_t nt = std::max<int64_t>(1, std::min<int64_t>(threads, n));
    pool.reserve(static_cast<size_t>(nt - 1));
    for (int64_t t = 1; t < nt; t++) pool.emplace_back(work);
  } catch (...) {
    // no more threads: the ones started and this one share the blocks
  }
  work();
  for (auto& th : pool) th.join();
  return !failed;
}

}  // namespace

extern "C" {

// Compresses n bytes into `out` (at least n + n / 8 + 64 bytes); returns
// the compressed size (the reference's lz4_block_compress).
int64_t lz4_block_compress(const uint8_t* in, int64_t n, uint8_t* out) {
  std::vector<int64_t> table(1 << kHashBits, -1);
  int64_t op = 0, anchor = 0, i = 0;
  auto emit_seq = [&](int64_t lit_from, int64_t lit_len, int64_t off,
                      int64_t mlen) {
    int64_t ml = mlen - 4;
    out[op++] = static_cast<uint8_t>(((lit_len < 15 ? lit_len : 15) << 4) |
                                     (ml < 15 ? ml : int64_t{15}));
    if (lit_len >= 15) {
      int64_t rest = lit_len - 15;
      while (rest >= 255) {
        out[op++] = 255;
        rest -= 255;
      }
      out[op++] = static_cast<uint8_t>(rest);
    }
    std::memcpy(out + op, in + lit_from, lit_len);
    op += lit_len;
    out[op++] = static_cast<uint8_t>(off & 0xFF);
    out[op++] = static_cast<uint8_t>(off >> 8);
    if (ml >= 15) {
      int64_t rest = ml - 15;
      while (rest >= 255) {
        out[op++] = 255;
        rest -= 255;
      }
      out[op++] = static_cast<uint8_t>(rest);
    }
  };
  // matches end >= 12 bytes before the end; the last 5 bytes are literals
  while (i + 12 <= n) {
    uint32_t h = read32(in + i);
    uint32_t slot = (h * 0x9E3779B1u) >> (32 - kHashBits);
    int64_t cand = table[slot];
    table[slot] = i;
    if (cand >= 0 && i - cand < 65536 && read32(in + cand) == h) {
      int64_t mlen = 4;
      while (i + mlen < n - 5 && in[cand + mlen] == in[i + mlen]) mlen++;
      emit_seq(anchor, i - anchor, i - cand, mlen);
      i += mlen;
      anchor = i;
    } else {
      i++;
    }
  }
  int64_t lit = n - anchor;
  out[op++] = static_cast<uint8_t>((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) {
    int64_t rest = lit - 15;
    while (rest >= 255) {
      out[op++] = 255;
      rest -= 255;
    }
    out[op++] = static_cast<uint8_t>(rest);
  }
  std::memcpy(out + op, in + anchor, lit);
  return op + lit;
}

// The reference's frame of n bytes: magic, FLG 0x60, BD 0x70, header
// checksum `hc`, 4 MiB blocks (each compressed, or raw with the high bit
// where compression does not shrink it), the end mark. `out` holds at
// least 11 + n + 4 * blocks bytes. Returns the frame's size, or -3 where
// memory ran out.
int64_t lz4_frame_compress(const uint8_t* in, int64_t n, uint8_t* out,
                           uint8_t hc, int32_t threads) try {
  write32(out, kMagic);
  out[4] = 0x60;
  out[5] = 0x70;
  out[6] = hc;
  int64_t op = 7;
  int64_t nblocks = (n + kBlockMax - 1) / kBlockMax;
  std::vector<std::vector<uint8_t>> comp(nblocks);
  std::vector<int64_t> sizes(nblocks);
  if (!for_blocks(nblocks, threads, [&](int64_t b) {
        int64_t len = std::min(kBlockMax, n - b * kBlockMax);
        comp[b].resize(len + len / 8 + 64);
        sizes[b] = lz4_block_compress(in + b * kBlockMax, len,
                                      comp[b].data());
      }))
    return -3;
  for (int64_t b = 0; b < nblocks; b++) {
    int64_t len = std::min(kBlockMax, n - b * kBlockMax);
    if (sizes[b] < len) {
      write32(out + op, static_cast<uint32_t>(sizes[b]));
      std::memcpy(out + op + 4, comp[b].data(), sizes[b]);
      op += 4 + sizes[b];
    } else {
      write32(out + op, static_cast<uint32_t>(len) | 0x80000000u);
      std::memcpy(out + op + 4, in + b * kBlockMax, len);
      op += 4 + len;
    }
    std::vector<uint8_t>().swap(comp[b]);
  }
  write32(out + op, 0);
  return op + 4;
} catch (...) {
  return -3;
}

// The most bytes a frame can decode to (raw blocks at their size, others
// at the frame's block maximum), -1 where it is not an LZ4 frame, -3 where
// memory ran out.
int64_t lz4_frame_bound(const uint8_t* in, int64_t n) try {
  int64_t block_max;
  bool independent;
  std::vector<Block> blocks;
  if (!scan_blocks(in, n, &block_max, &independent, &blocks)) return -1;
  int64_t total = 0;
  for (const Block& b : blocks) total += b.raw ? b.size : block_max;
  return total;
} catch (...) {
  return -3;
}

// Decodes a frame into `out`: the bytes written, -1 where it is malformed,
// -2 where out_cap is too small, -3 where memory ran out. Independent
// blocks decode on up to `threads` threads, each at its place were every
// block but the last full; where one is not, the frame decodes again in
// order.
int64_t lz4_frame_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t out_cap, int32_t threads) try {
  int64_t block_max;
  bool independent;
  std::vector<Block> blocks;
  if (!scan_blocks(in, n, &block_max, &independent, &blocks)) return -1;
  int64_t nb = static_cast<int64_t>(blocks.size());
  if (!independent || threads <= 1 || nb <= 1 ||
      (nb - 1) * block_max > out_cap) {
    return decode_in_order(in, blocks, independent, out, out_cap);
  }
  std::vector<int64_t> got(nb);
  bool ok = for_blocks(nb, threads, [&](int64_t b) {
    int64_t at = b * block_max;
    int64_t cap = std::min(block_max, out_cap - at);
    const Block& blk = blocks[b];
    if (blk.raw) {
      if (blk.size > cap) {
        got[b] = -2;
      } else {
        std::memcpy(out + at, in + blk.pos, blk.size);
        got[b] = blk.size;
      }
    } else {
      got[b] = block_decode(in + blk.pos, blk.size, out + at, cap, 0);
    }
  });
  if (!ok) return -3;
  for (int64_t b = 0; b < nb; b++) {
    if (got[b] < 0 || (b < nb - 1 && got[b] != block_max)) {
      return decode_in_order(in, blocks, independent, out, out_cap);
    }
  }
  return (nb - 1) * block_max + got[nb - 1];
} catch (...) {
  return -3;
}

}  // extern "C"
