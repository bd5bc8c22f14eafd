"""Blocked bloom filter for the hash-join pushdown (counterpart of
``arrow_tpu/compute/bloom.py``).

A block is one 32-bit word. A key's block comes from the top bits of its
hash over the join-key equality words (``kernels.hash32.hash32``, the hash
kernel on the card); its four bits in the block come from an avalanched remix of
that hash. Build scatters the bits of every live build row, query reads
one word a probe row and tests its four bits. The filter has no false
negatives, so a probe row it rejects cannot match.

The words are bit-identical to the reference's. uint32 values are carried
in int64: ``h >> s`` on a non-negative int64 is the logical shift.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from ..device.column import DeviceColumn
from ..kernels.hash32 import hash32
from .hashing import MASK32, avalanche, int64_halves
from .keys import equality_word
from .move import gather_rows

_MIN_LOG_BITS = 13   # 8 Kbit floor
_MAX_LOG_BITS = 24   # 16 Mbit cap


def log_bits_for(n_rows: int) -> int:
    """m = the next power of two >= 16 n bits, clamped."""
    m = max(int(n_rows) * 16, 1)
    return max(_MIN_LOG_BITS, min(_MAX_LOG_BITS, (m - 1).bit_length()))


def _key_hashes(key_cols: Sequence[DeviceColumn]) -> torch.Tensor:
    """uint32 hash (in int64) over the keys' equality words, each split
    into its two 32-bit halves, so both sides agree whatever their
    storage dtype."""
    words: List[torch.Tensor] = []
    for c in key_cols:
        words.extend(int64_halves(equality_word(c)))
    return hash32(words).to(torch.int64) & MASK32


def _bits(h: torch.Tensor) -> List[torch.Tensor]:
    """The four in-word bit positions of each hash."""
    h2 = avalanche(h ^ 0x9E3779B1)
    return [(h2 >> (5 * i)) & 31 for i in range(4)]


def _word_and_mask(h: torch.Tensor, log_words: int):
    """Block word index from the hash's top bits; the 4-bit in-word mask
    (bits may coincide: the blocked-bloom trade-off)."""
    word_id = h >> (32 - log_words)
    mask = torch.zeros_like(h)
    for bit in _bits(h):
        mask = mask | (1 << bit)
    return word_id, mask


class BloomFilter(NamedTuple):
    words: torch.Tensor  # (2**log_words,) uint32 values in int64
    log_words: int


def build_bloom(key_cols: Sequence[DeviceColumn], live: torch.Tensor,
                log_bits: int) -> BloomFilter:
    """Insert every live row's key.

    Dead rows scatter at flat bit -1, which wraps to the last bit of the
    last word, as the reference's scatter does (JAX normalises a negative
    index before its ``mode="drop"``): a harmless extra bit, kept so the
    words stay bit-identical."""
    log_words = log_bits - 5
    n_words = 1 << log_words
    h = _key_hashes(key_cols)
    word_id = h >> (32 - log_words)
    flat = torch.stack([word_id * 32 + b for b in _bits(h)], dim=1)
    flat = torch.where(live[:, None], flat, -1).reshape(-1)
    bitarr = torch.zeros(n_words * 32, dtype=torch.int64, device=h.device)
    bitarr[flat] = 1
    weights = 1 << torch.arange(32, dtype=torch.int64, device=h.device)
    words = (bitarr.reshape(n_words, 32) * weights).sum(dim=1)
    return BloomFilter(words, log_words)


def bloom_query(bf: BloomFilter, key_cols: Sequence[DeviceColumn],
                live: torch.Tensor) -> torch.Tensor:
    """True where the key may be in the filter; False on dead rows."""
    h = _key_hashes(key_cols)
    word_id, mask = _word_and_mask(h, bf.log_words)
    (word,) = gather_rows([bf.words], word_id)
    return ((word & mask) == mask) & live
