"""Parquet's DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY
and BYTE_STREAM_SPLIT encodings (counterpart of
``arrow_tpu/io/parquet/delta.py``; reference: cpp/src/parquet/encoding.cc,
DeltaBitPackDecoder/Encoder, DeltaLengthByteArrayDecoder,
DeltaByteArrayDecoder, ByteStreamSplitDecoder, and the format's
Encodings.md). Host numpy, a miniblock at a time, bits LSB first as in the
RLE hybrid; the encoders give the reference's bytes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _uleb128(mv, pos: int) -> Tuple[int, int]:
    x = 0
    shift = 0
    while True:
        b = mv[pos]
        pos += 1
        x |= (b & 0x7F) << shift
        if not (b & 0x80):
            return x, pos
        shift += 7


def _zigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _unpack_width(mv, pos: int, count: int, bw: int
                  ) -> Tuple[np.ndarray, int]:
    """Unpack `count` LSB-first bit-packed values of `bw` bits (count is a
    multiple of 32 per the spec, so the payload is whole bytes)."""
    if bw == 0:
        return np.zeros(count, np.uint64), pos
    nbytes = (count * bw + 7) // 8
    raw = np.frombuffer(mv[pos:pos + nbytes], dtype=np.uint8)
    bits = np.unpackbits(raw, bitorder="little")[:count * bw]
    vals = bits.reshape(count, bw).astype(np.uint64)
    weights = (np.uint64(1) << np.arange(bw, dtype=np.uint64))
    return (vals * weights).sum(axis=1, dtype=np.uint64), pos + nbytes


def decode_delta_binary_packed(data, pos: int
                               ) -> Tuple[np.ndarray, int]:
    """DELTA_BINARY_PACKED → (int64 values, end position). Arithmetic is
    modulo 2^64 (uint64 wraparound), matching the spec."""
    mv = memoryview(data)
    block_size, pos = _uleb128(mv, pos)
    n_mb, pos = _uleb128(mv, pos)
    count, pos = _uleb128(mv, pos)
    first_u, pos = _uleb128(mv, pos)
    first = _zigzag(first_u)
    if count == 0:
        return np.zeros(0, np.int64), pos
    vpm = block_size // max(n_mb, 1)
    ndeltas = count - 1
    steps = np.empty(count, dtype=np.uint64)
    steps[0] = np.uint64(first % (1 << 64))
    got = 0
    with np.errstate(over="ignore"):
        while got < ndeltas:
            mdu, pos = _uleb128(mv, pos)
            min_delta = _zigzag(mdu)
            md64 = np.uint64(min_delta % (1 << 64))
            bws = bytes(mv[pos:pos + n_mb])
            pos += n_mb
            # consume every present miniblock of the block: miniblocks
            # past the needed count have bit width 0 (no payload)
            for i in range(n_mb):
                if got >= ndeltas and bws[i] == 0:
                    continue
                d, pos = _unpack_width(mv, pos, vpm, bws[i])
                take = min(vpm, ndeltas - got)
                if take > 0:
                    steps[1 + got:1 + got + take] = d[:take] + md64
                    got += take
        out = np.cumsum(steps, dtype=np.uint64)
    return out.view(np.int64), pos


def decode_delta_length_byte_array(data, pos: int, n: int
                                   ) -> Tuple[np.ndarray, bytes, int]:
    """DELTA_LENGTH_BYTE_ARRAY → (offsets[n+1], bytes, end position)."""
    lens, pos = decode_delta_binary_packed(data, pos)
    lens = lens[:n]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    body = bytes(memoryview(data)[pos:pos + total])
    return offsets, body, pos + total


def decode_delta_byte_array(data, pos: int, n: int
                            ) -> Tuple[np.ndarray, bytes]:
    """DELTA_BYTE_ARRAY (incremental front coding) → (offsets, bytes)."""
    prefix_lens, pos = decode_delta_binary_packed(data, pos)
    prefix_lens = prefix_lens[:n]
    soffs, sbytes, _ = decode_delta_length_byte_array(data, pos, n)
    out = []
    prev = b""
    for i in range(n):
        s = prev[:int(prefix_lens[i])] + \
            sbytes[int(soffs[i]):int(soffs[i + 1])]
        out.append(s)
        prev = s
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(s) for s in out), np.int64, n),
              out=offsets[1:])
    return offsets, b"".join(out)


def decode_byte_stream_split(data, n: int, width: int) -> np.ndarray:
    """BYTE_STREAM_SPLIT: byte i of value j lives at data[i*n + j];
    returns the de-interleaved raw value bytes as (n, width) uint8."""
    raw = np.frombuffer(memoryview(data)[:n * width], dtype=np.uint8)
    return np.ascontiguousarray(raw.reshape(width, n).T)


def encode_byte_stream_split(values: np.ndarray) -> bytes:
    """Inverse of decode_byte_stream_split for the writer."""
    v = np.ascontiguousarray(values)
    raw = v.view(np.uint8).reshape(len(v), v.dtype.itemsize)
    return np.ascontiguousarray(raw.T).tobytes()


def _uleb128_encode(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else (n << 1)


def _pack_width(vals: np.ndarray, bw: int) -> bytes:
    if bw == 0:
        return b""
    v = vals.astype(np.uint64)
    bits = ((v[:, None] >> np.arange(bw, dtype=np.uint64))
            & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def encode_delta_binary_packed(values: np.ndarray,
                               block_size: int = 128,
                               n_miniblocks: int = 4) -> bytes:
    """DELTA_BINARY_PACKED encoder (reference: parquet/encoding.cc
    DeltaBitPackEncoder). Modulo-2^64 delta arithmetic."""
    v = np.asarray(values, dtype=np.int64).view(np.uint64)
    count = len(v)
    vpm = block_size // n_miniblocks
    out = bytearray()
    out += _uleb128_encode(block_size)
    out += _uleb128_encode(n_miniblocks)
    out += _uleb128_encode(count)
    first = int(v[0].view(np.int64)) if count else 0
    out += _uleb128_encode(_zigzag_encode(first) & ((1 << 70) - 1))
    if count <= 1:
        return bytes(out)
    with np.errstate(over="ignore"):
        deltas = (v[1:] - v[:-1])  # uint64 wraparound
    pos = 0
    nd = len(deltas)
    while pos < nd:
        blk = deltas[pos:pos + block_size]
        # min over int64 view (signed comparison matches the spec)
        min_d = int(blk.view(np.int64).min())
        out += _uleb128_encode(_zigzag_encode(min_d) & ((1 << 70) - 1))
        with np.errstate(over="ignore"):
            adj = blk - np.uint64(min_d % (1 << 64))
        bws = []
        packed = []
        for m in range(n_miniblocks):
            mb = adj[m * vpm:(m + 1) * vpm]
            if len(mb) == 0:
                bws.append(0)
                packed.append(b"")
                continue
            mx = int(mb.max())
            bw = mx.bit_length()
            bws.append(bw)
            if len(mb) < vpm:  # pad the last miniblock to full width
                mb = np.concatenate(
                    [mb, np.zeros(vpm - len(mb), np.uint64)])
            packed.append(_pack_width(mb, bw))
        out += bytes(bws)
        for p in packed:
            out += p
        pos += block_size
    return bytes(out)
