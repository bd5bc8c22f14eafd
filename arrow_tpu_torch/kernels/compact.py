"""Stable stream compaction of several columns by one keep mask: the wrapper
of ``csrc/compact.cu`` and its plain PyTorch version.

The kernel replaces the TPU kernel K2 (``arrow_tpu/compute/pallas_move.py``,
``_compact_kernel`` driven by ``compact_planes_pallas`` and
``compact_arrays_pallas``). It is bound by memory bandwidth: it must read
the mask once, each column's 32-byte sectors that hold a kept row once,
and write every output slot once: about ``n * (1 + 2 * sum of widths)``
bytes at a dense mask, ``n * (1 + sum of widths)`` at a sparse one. The
source says how it counts the mask's tiles and chains their offsets by
decoupled look-back, then moves each column through shared memory with
16-byte loads and stores.

Contract (the reference's ``direct`` movement mode): ``keep`` is a
contiguous (n,) bool tensor, ``arrays`` 1 to ``MAX_COLUMNS`` contiguous
(n,) tensors of 1, 2, 4 or 8 bytes an element on the same device. Each output
has capacity n and holds the kept rows in order, bit for bit (NaN payloads
and ``-0.0`` kept), then zeros. ``count`` is a 0-d int32 tensor on the
device, never read back here. A tensor on the CPU takes the plain version;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from . import count_launch
from ._build import library

MAX_COLUMNS = 64
WIDTHS = (1, 2, 4, 8)
# the fewest rows a tile of csrc/compact.cu has (256 threads x 16 rows)
TILE_ROWS = 4096


def compact_plain(keep: torch.Tensor, arrays: Sequence[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    count = keep.sum(dtype=torch.int32)
    rows = torch.nonzero(keep).flatten()
    outs = []
    for a in arrays:
        out = torch.zeros_like(a)
        out[:rows.numel()] = a[rows]
        outs.append(out)
    return outs, count


@functools.lru_cache(maxsize=None)
def _function():
    fn = library("compact").compact_columns
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(keep: torch.Tensor, arrays: Sequence[torch.Tensor]):
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise ValueError(f"keep must be a 1-D bool tensor, not "
                         f"{keep.dtype} {tuple(keep.shape)}")
    if not 1 <= len(arrays) <= MAX_COLUMNS:
        raise ValueError(f"{len(arrays)} columns: compact takes 1 to "
                         f"{MAX_COLUMNS}")
    for a in arrays:
        if a.shape != keep.shape:
            raise ValueError(f"column {tuple(a.shape)} does not match the "
                             f"mask {tuple(keep.shape)}")
        if a.element_size() not in WIDTHS or a.is_complex():
            raise ValueError(f"compact moves elements of {WIDTHS} bytes, "
                             f"not {a.dtype}")
        if a.device != keep.device:
            raise ValueError(f"column on {a.device}, mask on {keep.device}")


def compact(keep: torch.Tensor, arrays: Sequence[torch.Tensor]
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    arrays = list(arrays)
    _check(keep, arrays)
    if keep.device.type == "cpu":
        return compact_plain(keep, arrays)
    if keep.device.type != "cuda":
        raise ValueError(f"compact: unsupported device {keep.device}")
    if not (keep.is_contiguous() and all(a.is_contiguous() for a in arrays)):
        raise ValueError("compact takes contiguous tensors")
    n = keep.numel()
    outs = [torch.empty_like(a) for a in arrays]
    if n == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=keep.device)
    if n >= 1 << 31:
        raise ValueError(f"{n} rows: compact takes fewer than 2**31")
    k = len(arrays)
    src = (ctypes.c_void_p * k)(*[a.data_ptr() for a in arrays])
    dst = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int * k)(*[a.element_size() for a in arrays])
    count = torch.empty((), dtype=torch.int32, device=keep.device)
    # zeroed 64-bit words: the tile counter, one status word a count tile,
    # one int a move tile (both tiles at least TILE_ROWS rows)
    scratch = torch.zeros(1 + 2 * ((n + TILE_ROWS - 1) // TILE_ROWS),
                          dtype=torch.int64, device=keep.device)
    stream = torch.cuda.current_stream(keep.device).cuda_stream
    err = _function()(keep.data_ptr(), n, src, dst, widths, k,
                      scratch.data_ptr(), count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"compact launch failed: CUDA error {err}")
    count_launch(compact)
    return outs, count


compact.launches = 0
