"""The byte-pool tier of the string functions for large dictionaries
(counterpart of ``arrow_tpu/compute/device_strings.py``).

The host tier (``strings.py``) maps each dictionary value once in Python,
which for a dictionary of millions of values (``p_name``, ``c_phone``) is
millions of host calls. Here the dictionary becomes, once, a device byte
pool:

* ``mat``: (d, L) uint8, row i the UTF-8 bytes of value i, zero-padded;
* ``lens``: (d,) int32 byte lengths;

made by vectorised numpy (a fixed-width bytes array viewed as bytes) and
cached by dictionary and device. The reference's pool is ``jnp``, not
Pallas: plain PyTorch is its port, and no kernel is written for it.

* ``pool_predicate``: ``starts_with``, ``ends_with``, ``match_substring``,
  the wildcard-free forms of ``match_like`` (``equal_string``),
  ``count_substring`` (non-overlapping, as ``str.count``; the reference's
  scan over byte columns is a loop over the pool's L columns),
  ``find_substring``, ``utf8_length``, ``binary_length`` and
  ``string_is_ascii``, each a 2-D byte operation over the pool giving one
  value a dictionary slot that the codes look up, as the host tier's
  table is. A null slot takes the host tier's value for it.
* ``pool_transform``: the str -> str functions (case, reverse, the trims,
  the pads and center, and slices of step 1) map the pool to a new pool on
  the device. Its rows are then grouped by their bytes, in order of first
  appearance, by the port's grouper, so the new dictionary holds each
  value once in the host tier's order and the codes are remapped by one
  gather on the device; only the distinct rows are downloaded. A null slot
  becomes an empty value, as the reference's pool leaves it.

The reference's gates hold: a dictionary of fewer than
``DEVICE_STRINGS_MIN`` values, a pattern that is not ASCII, ``ignore_case``
over a pool that is not all ASCII (lowercasing bytes folds case only for
ASCII), ``find_substring`` and every transform over such a pool, and
``pool_transform``'s option gates return None, and the caller uses the
host tier. Where the reference's two tiers differ (``count_substring`` of
an empty pattern over non-ASCII values counts bytes in its pool), this
tier gives the host tier's answer, Python's.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import types as T
from ..device.column import DeviceColumn

# dictionaries below this size stay on the host tier (the reference's
# default gate; its environment override is not ported)
DEVICE_STRINGS_MIN = 4096
_CACHE_SIZE = 16
_MAX_POOL_BYTES = 1 << 31


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
    if d * width > _MAX_POOL_BYTES:
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
    if dictionary is None or len(dictionary) < DEVICE_STRINGS_MIN:
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


def is_pooled(dictionary: Sequence, device) -> bool:
    """Whether ``dictionary`` has a pool on ``device`` in the cache."""
    hit = _POOLS.get((id(dictionary), str(device)))
    return hit is not None and hit[0] is dictionary


def clear_pools():
    """Empties the cache of pools."""
    _POOLS.clear()


# --- the predicates, each (d, L) byte operations over the pool --------------

def _positions(mat: torch.Tensor) -> torch.Tensor:
    return torch.arange(mat.shape[1], device=mat.device)[None, :]


def _live(pool: BytePool) -> torch.Tensor:
    """(d, L) bool: the bytes inside each value."""
    return _positions(pool.mat) < pool.lens[:, None]


def _lower(x: torch.Tensor) -> torch.Tensor:
    """ASCII lowercase of uint8 bytes."""
    return torch.where((x >= ord("A")) & (x <= ord("Z")), x + 32, x)


def _pattern(pat: bytes, device, ci: bool) -> torch.Tensor:
    p = torch.tensor(list(pat), dtype=torch.uint8, device=device)
    return _lower(p) if ci else p


def _filled(pool: BytePool, value, dtype) -> torch.Tensor:
    return torch.full((pool.mat.shape[0],), value, dtype=dtype,
                      device=pool.mat.device)


def _starts_with(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    mat, lens = pool.mat, pool.lens
    m = len(pat)
    if m > mat.shape[1]:
        return _filled(pool, False, torch.bool)
    head = mat[:, :m]
    if ci:
        head = _lower(head)
    return (lens >= m) & (head == _pattern(pat, mat.device, ci)).all(dim=1)


def _ends_with(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    mat, lens = pool.mat, pool.lens
    m = len(pat)
    if m > mat.shape[1]:
        return _filled(pool, False, torch.bool)
    idx = (lens[:, None].long() - m
           + torch.arange(m, device=mat.device)[None, :]) \
        .clamp(0, mat.shape[1] - 1)
    tail = torch.gather(mat, 1, idx)
    if ci:
        tail = _lower(tail)
    return (lens >= m) & (tail == _pattern(pat, mat.device, ci)).all(dim=1)


def _windows(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    """(d, W) bool, W = L - m + 1: the window at j equals the pattern and
    lies inside the value (the pattern's bytes compared with the pool
    shifted by 0..m-1, ANDed)."""
    mat, lens = pool.mat, pool.lens
    m = len(pat)
    windows = mat.shape[1] - m + 1
    if ci:
        mat = _lower(mat)
        pat = pat.lower()
    acc = mat[:, 0:windows] == pat[0]
    for j in range(1, m):
        acc &= mat[:, j:windows + j] == pat[j]
    inside = torch.arange(windows, device=mat.device)[None, :] \
        <= (lens[:, None] - m)
    return acc & inside


def _match_substring(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    if not pat:
        return _filled(pool, True, torch.bool)
    if len(pat) > pool.mat.shape[1]:
        return _filled(pool, False, torch.bool)
    return _windows(pool, pat, ci).any(dim=1)


def _equal_string(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    return _starts_with(pool, pat, ci) & (pool.lens == len(pat))


def _utf8_length(pool: BytePool) -> torch.Tensor:
    """Characters: the live bytes that are not UTF-8 continuation bytes."""
    lead = (pool.mat & 0xC0) != 0x80
    return (lead & _live(pool)).sum(dim=1, dtype=torch.int32)


def _count_substring(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    """Non-overlapping occurrences, left to right (``str.count``): a
    window counts where no counted window covers it."""
    m = len(pat)
    if m == 0:
        # Python's count of "": one more than the characters (the
        # reference's pool counts bytes)
        return _utf8_length(pool) + 1
    if m > pool.mat.shape[1]:
        return _filled(pool, 0, torch.int32)
    hits = _windows(pool, pat, ci)
    if m == 1:
        return hits.sum(dim=1, dtype=torch.int32)
    count = _filled(pool, 0, torch.int32)
    wait = _filled(pool, 0, torch.int32)
    for j in range(hits.shape[1]):
        take = hits[:, j] & (wait == 0)
        count += take.to(torch.int32)
        wait = torch.where(take, m - 1, (wait - 1).clamp(min=0))
    return count


def _find_substring(pool: BytePool, pat: bytes, ci: bool) -> torch.Tensor:
    m = len(pat)
    if m == 0:
        return _filled(pool, 0, torch.int32)
    if m > pool.mat.shape[1]:
        return _filled(pool, -1, torch.int32)
    hits = _windows(pool, pat, ci)
    first = torch.argmax(hits.to(torch.uint8), dim=1).to(torch.int32)
    return torch.where(hits.any(dim=1), first, -1)


# name -> (the table of a pool and a pattern, the host tier's value of a
# null slot, whether it needs an all-ASCII pool)
_PATTERN_PREDICATES = {
    "starts_with": (_starts_with, False, False),
    "ends_with": (_ends_with, False, False),
    "match_substring": (_match_substring, False, False),
    "equal_string": (_equal_string, False, False),
    "count_substring": (_count_substring, 0, False),
    # byte index == character index only on ASCII
    "find_substring": (_find_substring, -1, True),
}
_PREDICATES = {
    "binary_length": (lambda pool: pool.lens, 0),
    "utf8_length": (_utf8_length, 0),
    "string_is_ascii": (
        lambda pool: ~((pool.mat >= 0x80) & _live(pool)).any(dim=1), True),
}


def pool_predicate(name: str, col, pattern: str = "",
                   ignore_case: bool = False) -> Optional[torch.Tensor]:
    """The (d,) table (bool or int32) of predicate ``name`` over the pool
    of ``col``'s dictionary, on ``col``'s device; None where a gate sends
    the call to the host tier."""
    pool = dictionary_pool(col.dictionary, col.values.device)
    if pool is None:
        return None
    if name in _PREDICATES:
        fn, null_value = _PREDICATES[name]
        table = fn(pool)
    else:
        fn, null_value, needs_ascii = _PATTERN_PREDICATES[name]
        try:
            pat = pattern.encode("ascii")
        except UnicodeEncodeError:
            return None
        if (ignore_case or needs_ascii) and not pool.ascii_only:
            return None
        table = fn(pool, pat, ignore_case)
    if pool.valid is not None:
        table = torch.where(pool.valid, table,
                            torch.tensor(null_value, dtype=table.dtype,
                                         device=table.device))
    return table


# --- the transforms: (mat, lens) -> (mat', lens') on the device --------------

# every ASCII byte b for which chr(b).isspace(): str.strip() with no
# argument strips the C0 separators \x1c-\x1f too
_WS_BYTES = tuple(b" \t\n\r\v\f\x1c\x1d\x1e\x1f")
_CASES = ("upper", "lower", "swapcase", "capitalize", "title")


def _case(mat, lens, mode):
    is_up = (mat >= 65) & (mat <= 90)
    is_lo = (mat >= 97) & (mat <= 122)
    up = torch.where(is_lo, mat - 32, mat)
    low = torch.where(is_up, mat + 32, mat)
    if mode == "upper":
        out = up
    elif mode == "lower":
        out = low
    elif mode == "swapcase":
        out = torch.where(is_lo, mat - 32, torch.where(is_up, mat + 32, mat))
    elif mode == "capitalize":
        out = torch.where(_positions(mat) == 0, up, low)
    else:
        # title: an alpha run's head goes upper, the rest lower (a byte
        # rule, Python's str.title on ASCII)
        is_alpha = is_up | is_lo
        prev = torch.zeros_like(is_alpha)
        prev[:, 1:] = is_alpha[:, :-1]
        out = torch.where(is_alpha & ~prev, up, low)
    return out, lens


def _gather_row(mat, idx, new_len):
    """mat's bytes at (row, idx), zero from new_len on."""
    idx = idx.expand(mat.shape).clamp(0, mat.shape[1] - 1)
    out = torch.gather(mat, 1, idx)
    return torch.where(_positions(mat) < new_len[:, None], out, 0)


def _reverse(mat, lens):
    return _gather_row(mat, lens[:, None].long() - 1 - _positions(mat),
                       lens), lens


def _member(mat, chars):
    m = torch.zeros(mat.shape, dtype=torch.bool, device=mat.device)
    for c in chars:
        m |= mat == c
    return m


def _trim(mat, lens, chars, left, right):
    width = mat.shape[1]
    pos = _positions(mat)
    lens64 = lens.long()
    nlead = torch.zeros_like(lens64)
    if left:
        mem = _member(mat, chars) & (pos < lens64[:, None])
        nlead = torch.cumprod(mem.to(torch.int32), dim=1).sum(dim=1)
    ntrail = torch.zeros_like(lens64)
    if right:
        # reversed rows: the padding, then the value's tail
        tail = _member(mat.flip(1), chars) | (pos < (width - lens64)[:, None])
        run = torch.cumprod(tail.to(torch.int32), dim=1).sum(dim=1)
        ntrail = (run - (width - lens64)).clamp(min=0)
    new_len = (lens64 - nlead - ntrail).clamp(min=0)
    return _gather_row(mat, pos + nlead[:, None], new_len), new_len


def _pad(mat, lens, width, pad_byte, side):
    """``str.rjust`` (left), ``str.ljust`` (right) or ``str.center``
    (CPython: the left margin is marg // 2 + (marg & width & 1)); ``mat``
    is at least ``width`` wide."""
    pos = _positions(mat)
    lens64 = lens.long()
    total = (width - lens64).clamp(min=0)
    if side == "right":
        s = torch.zeros_like(lens64)
    elif side == "left":
        s = total
    else:
        s = total // 2 + (total & width & 1)
    new_len = lens64.clamp(min=width)
    shifted = torch.gather(mat, 1, (pos - s[:, None]).clamp(
        0, mat.shape[1] - 1))
    body = (pos >= s[:, None]) & (pos < (s + lens64)[:, None])
    out = torch.where(body, shifted, torch.where(
        pos < new_len[:, None], pad_byte, 0).to(torch.uint8))
    return out, new_len


def _slice(mat, lens, start, stop):
    """v[start:stop] for start >= 0 and stop None or >= start."""
    lens64 = lens.long()
    end = lens64 if stop is None else lens64.clamp(max=stop)
    new_len = (end - lens64.clamp(max=start)).clamp(min=0)
    return _gather_row(mat, _positions(mat) + start, new_len), new_len


def pool_transform(name: str, col, options: Optional[dict] = None
                   ) -> Optional[DeviceColumn]:
    """``col`` through the str -> str transform ``name`` (a case mode,
    ``reverse``, ``trim``/``ltrim``/``rtrim``, ``lpad``/``rpad``/
    ``center`` or ``slice``) on the byte pool; None where a gate sends the
    call to the host tier."""
    options = options or {}
    pool = dictionary_pool(col.dictionary, col.values.device)
    if pool is None or not pool.ascii_only:
        return None
    mat, lens = pool.mat, pool.lens
    if name in _CASES:
        out, new_lens = _case(mat, lens, name)
    elif name == "reverse":
        out, new_lens = _reverse(mat, lens)
    elif name in ("trim", "ltrim", "rtrim"):
        if options.get("whitespace"):
            chars = _WS_BYTES
        else:
            try:
                # str.strip("") strips nothing: an empty set is a no-op
                chars = tuple(options.get("characters", "").encode("ascii"))
            except UnicodeEncodeError:
                return None
        if len(chars) > 16:
            return None
        out, new_lens = _trim(mat, lens, chars, name != "rtrim",
                              name != "ltrim")
    elif name in ("lpad", "rpad", "center"):
        width = int(options.get("width", 0))
        padding = options.get("padding", " ")
        if len(padding) != 1 or ord(padding) > 127 or width < 0:
            return None
        if width > mat.shape[1]:
            if mat.shape[0] * width > _MAX_POOL_BYTES:
                return None
            mat = torch.nn.functional.pad(mat, (0, width - mat.shape[1]))
        side = {"lpad": "left", "rpad": "right", "center": "center"}[name]
        out, new_lens = _pad(mat, lens, width, ord(padding), side)
    elif name == "slice":
        start = int(options.get("start", 0))
        stop = options.get("stop")
        if options.get("step", 1) != 1 or start < 0 or (
                stop is not None and (stop < 0 or stop < start)):
            return None
        out, new_lens = _slice(mat, lens, start, stop)
    else:
        return None
    return _pool_to_dictionary(col, out, new_lens, pool)


def _pool_to_dictionary(col, mat, lens, pool: BytePool) -> DeviceColumn:
    """``col`` with the dictionary of the new pool (mat, lens): its rows
    grouped by their bytes and length in order of first appearance (a
    null slot empty), the codes remapped on the device where two rows
    share a value, and only the distinct rows downloaded."""
    from .grouper import group_ids
    from .registry import ExecContext
    d, width = mat.shape
    lens = lens.long()
    if pool.valid is not None:
        lens = torch.where(pool.valid, lens, 0)
    mat = torch.where(_positions(mat) < lens[:, None], mat, 0)
    words = torch.nn.functional.pad(mat, (0, -width % 8)) \
        .contiguous().view(torch.int64)
    keys = [DeviceColumn(lens, None, T.int64())] + [
        DeviceColumn(words[:, i].contiguous(), None, T.int64())
        for i in range(words.shape[1])]
    g = group_ids(ExecContext(d, torch.tensor(
        d, dtype=torch.int32, device=mat.device)), keys)
    n = int(g.num_groups)
    first = g.rep_indices[:n]
    values = _decode(mat[first].cpu().numpy(), lens[first].cpu().numpy())
    if n == d:
        # every value distinct: first appearance is the slot order
        return DeviceColumn(col.values, col.validity, col.type, values)
    from .strings import slot_lookup
    return DeviceColumn(slot_lookup(col, g.group_ids.to(torch.int32)),
                        col.validity, col.type, values)


def _decode(mat: np.ndarray, lens: np.ndarray) -> tuple:
    """The ASCII rows of a zero-padded byte matrix as str values."""
    n, width = mat.shape
    vals = np.ascontiguousarray(mat).view(f"S{width}").ravel() \
        .astype(f"U{width}").tolist()
    # a fixed-width bytes value drops its trailing zero bytes: restore a
    # value that ends in "\x00"
    rows = np.arange(n)
    ends = (lens > 0) & (mat[rows, np.maximum(lens - 1, 0)] == 0)
    for i in np.flatnonzero(ends):
        vals[i] = bytes(mat[i, :lens[i]]).decode("ascii")
    return tuple(vals)
