"""The byte-pool tier of the string predicates for large dictionaries
(counterpart of ``arrow_tpu/compute/device_strings.py``).

The host tier (``strings.py``) tests each dictionary value once in
Python, which for a dictionary of millions of values (``p_name``) is
millions of host calls. Here the dictionary becomes, once, a device byte
pool:

* ``mat``: (d, L) uint8, row i the UTF-8 bytes of value i, zero-padded;
* ``lens``: (d,) int32 byte lengths;

made by vectorised numpy (a fixed-width bytes array viewed as bytes) and
cached by dictionary and device. ``starts_with``, ``ends_with``,
``match_substring`` and the wildcard-free forms of ``match_like`` are then
2-D byte operations over the pool, giving one boolean a dictionary slot
that the codes look up, as the host tier's table is. The reference's pool
is ``jnp``, not Pallas: plain PyTorch is its port, and no kernel is
written for it.

The reference's gates hold: a dictionary of fewer than
``DEVICE_STRINGS_MIN`` values, a pattern that is not ASCII, or
``ignore_case`` over a pool that is not all ASCII (lowercasing bytes folds
case only for ASCII) returns None, and the caller uses the host tier, so
the answer is the same either way. A null dictionary slot matches
nothing. The str -> str pool transforms (``pool_transform``) are not
ported (ROADMAP.md, queue 1, item 9.8).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

# dictionaries below this size stay on the host tier (the reference's
# default gate; its environment override is not ported)
DEVICE_STRINGS_MIN = 4096
_CACHE_SIZE = 16


class BytePool(NamedTuple):
    mat: torch.Tensor              # (d, L) uint8, zero-padded rows
    lens: torch.Tensor             # (d,) int32 byte lengths
    ascii_only: bool               # every byte < 0x80
    valid: Optional[torch.Tensor]  # (d,) bool when some slot is null


# (id of the dictionary, device) -> (the dictionary, its pool); holding
# the dictionary keeps its id from being reused while it is cached
_POOLS: "OrderedDict[tuple, tuple]" = OrderedDict()


def build_pool(dictionary: Sequence, device) -> Optional[BytePool]:
    """The pool of a dictionary of str values (None for a null slot), or
    None for a dictionary that holds other values."""
    d = len(dictionary)
    if d == 0:
        return None
    has_null = None in dictionary
    strs = ["" if v is None else v for v in dictionary] if has_null \
        else dictionary
    try:
        joined = "".join(strs)
    except TypeError:
        return None
    ascii_only = joined.isascii()
    if ascii_only:
        encoded = strs
        lens = np.fromiter(map(len, strs), dtype=np.int64, count=d)
    else:
        encoded = [s.encode("utf-8") for s in strs]
        lens = np.fromiter(map(len, encoded), dtype=np.int64, count=d)
    width = max(int(lens.max()), 1)
    if d * width > (1 << 31):
        return None
    # a fixed-width bytes array is the zero-padded byte matrix
    mat = np.array(encoded, dtype=f"S{width}").view(np.uint8) \
        .reshape(d, width)
    valid = None
    if has_null:
        valid = torch.from_numpy(np.fromiter(
            (v is not None for v in dictionary), dtype=np.bool_,
            count=d)).to(device)
    return BytePool(torch.from_numpy(mat).to(device),
                    torch.from_numpy(lens.astype(np.int32)).to(device),
                    ascii_only, valid)


def dictionary_pool(dictionary: Sequence, device) -> Optional[BytePool]:
    """The cached pool of ``dictionary`` on ``device``, made on first use;
    None below the size gate or for a dictionary that is not strings."""
    if len(dictionary) < DEVICE_STRINGS_MIN:
        return None
    key = (id(dictionary), str(device))
    hit = _POOLS.get(key)
    if hit is not None and hit[0] is dictionary:
        _POOLS.move_to_end(key)
        return hit[1]
    pool = build_pool(dictionary, device)
    if pool is not None:
        _POOLS[key] = (dictionary, pool)
        while len(_POOLS) > _CACHE_SIZE:
            _POOLS.popitem(last=False)
    return pool


# --- the predicates, each (d, L) byte operations over the pool --------------

def _lower(x: torch.Tensor) -> torch.Tensor:
    """ASCII lowercase of uint8 bytes."""
    return torch.where((x >= ord("A")) & (x <= ord("Z")), x + 32, x)


def _pattern(pat: bytes, device, ci: bool) -> torch.Tensor:
    p = torch.tensor(list(pat), dtype=torch.uint8, device=device)
    return _lower(p) if ci else p


def _starts_with(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    mat, lens = pool.mat, pool.lens
    m = len(pat)
    if m > mat.shape[1]:
        return torch.zeros(mat.shape[0], dtype=torch.bool, device=mat.device)
    head = mat[:, :m]
    if ci:
        head = _lower(head)
    return (lens >= m) & (head == _pattern(pat, mat.device, ci)).all(dim=1)


def _ends_with(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    mat, lens = pool.mat, pool.lens
    m = len(pat)
    if m > mat.shape[1]:
        return torch.zeros(mat.shape[0], dtype=torch.bool, device=mat.device)
    idx = (lens[:, None].long() - m
           + torch.arange(m, device=mat.device)[None, :]) \
        .clamp(0, mat.shape[1] - 1)
    tail = torch.gather(mat, 1, idx)
    if ci:
        tail = _lower(tail)
    return (lens >= m) & (tail == _pattern(pat, mat.device, ci)).all(dim=1)


def _match_substring(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    """Some window of the value equals the pattern: the pattern's bytes
    compared with the pool shifted by 0..m-1, ANDed, then any window that
    lies inside the value."""
    mat, lens = pool.mat, pool.lens
    m = len(pat)
    d, width = mat.shape
    if m == 0:
        return torch.ones(d, dtype=torch.bool, device=mat.device)
    if m > width:
        return torch.zeros(d, dtype=torch.bool, device=mat.device)
    if ci:
        mat = _lower(mat)
    p = (pat.lower() if ci else pat)
    windows = width - m + 1
    acc = mat[:, 0:windows] == p[0]
    for j in range(1, m):
        acc &= mat[:, j:windows + j] == p[j]
    inside = torch.arange(windows, device=mat.device)[None, :] \
        <= (lens[:, None] - m)
    return (acc & inside).any(dim=1)


def _equal_string(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    return _starts_with(pool, pat, ci) & (pool.lens == len(pat))


_PREDICATES = {"starts_with": _starts_with, "ends_with": _ends_with,
               "match_substring": _match_substring,
               "equal_string": _equal_string}


def pool_predicate(name: str, col, pattern: str = "",
                   ignore_case: bool = False) -> Optional[torch.Tensor]:
    """The (d,) bool table of predicate ``name`` over the pool of ``col``'s
    dictionary, on ``col``'s device; None where a gate sends the call to
    the host tier."""
    pool = dictionary_pool(col.dictionary, col.values.device)
    if pool is None:
        return None
    try:
        pat = pattern.encode("ascii")
    except UnicodeEncodeError:
        return None
    if ignore_case and not pool.ascii_only:
        return None
    table = _PREDICATES[name](pool, pat, ignore_case)
    if pool.valid is not None:
        table = table & pool.valid
    return table
