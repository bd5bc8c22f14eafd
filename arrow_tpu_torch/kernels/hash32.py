"""xxhash32 of one or more 32-bit words per row: the wrapper of
``csrc/hash32.cu`` and its plain PyTorch version.

The kernel replaces the TPU kernel K4
(``arrow_tpu/experimental/pallas_hash.py``, ``_pallas_hash_kernel`` driven
by ``hash32_pallas``) and is bit-exact with the reference's
``arrow_tpu/compute/hashing.py`` ``hash32_words``. It is bound by memory
bandwidth: ``n * (4k + 4)`` bytes for k words a row.

Contract: ``words`` holds 1 to ``MAX_WORDS`` 1-D int32 tensors of n rows
on one device, each holding uint32 bit patterns. A plane may be strided, so
the two halves of an int64 tensor ``w`` pass as ``w.view(torch.int32)[0::2]``
(low) and ``[1::2]`` (high) without a copy. The result is a contiguous (n,)
int32 tensor holding the uint32 hash's bits. A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel or raises.

The plain version is the reference's steps from ``compute/hashing.py``,
on uint32 values carried in int64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..compute.hashing import as_bits, as_u32, combine, hash_u32_word
from . import count_launch
from ._build import library

MAX_WORDS = 16


def hash32_plain(words: Sequence[torch.Tensor]) -> torch.Tensor:
    out = hash_u32_word(as_u32(words[0]))
    for w in words[1:]:
        out = combine(out, hash_u32_word(as_u32(w)))
    return as_bits(out)


@functools.lru_cache(maxsize=None)
def _function():
    fn = library("hash32").hash32_words
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hash32(words: Sequence[torch.Tensor]) -> torch.Tensor:
    words = list(words)
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"{len(words)} word planes: hash32 takes 1 to "
                         f"{MAX_WORDS}")
    first = words[0]
    for w in words:
        if w.dtype != torch.int32 or w.dim() != 1:
            raise ValueError(f"word planes are 1-D int32 tensors, not "
                             f"{w.dtype} {tuple(w.shape)}")
        if w.shape != first.shape or w.device != first.device:
            raise ValueError("word planes must have one length and device")
    if first.device.type == "cpu":
        return hash32_plain(words)
    if first.device.type != "cuda":
        raise ValueError(f"hash32: unsupported device {first.device}")
    n = first.numel()
    out = torch.empty(n, dtype=torch.int32, device=first.device)
    if n == 0:
        return out
    k = len(words)
    planes = (ctypes.c_void_p * k)(*[w.data_ptr() for w in words])
    strides = (ctypes.c_longlong * k)(*[w.stride(0) for w in words])
    stream = torch.cuda.current_stream(first.device).cuda_stream
    err = _function()(planes, strides, k, n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hash32 launch failed: CUDA error {err}")
    count_launch(hash32)
    return out


hash32.launches = 0
