"""Grouped sum by int32 group id: the wrapper of ``csrc/grouped_sum.cu``
and its plain PyTorch version.

The kernel replaces the TPU kernels K1
(``arrow_tpu/experimental/pallas_agg.py``, ``_kernel_ff``/``_kernel_f32``
driven by ``grouped_sum_pallas``) and K3 (``arrow_tpu/compute/pallas_move.py``,
``_gsum_kernel`` driven by ``grouped_sum_pallas``). It is bound by memory
bandwidth: it reads each value and group id once. The source says how its
design keeps the partial sums out of device memory.

Contract: ``values`` is a contiguous (n,) f64 or f32 tensor, ``gids`` an
(n,) int32 tensor with ids in ``[0, num_segments)`` (dead rows carry the
value 0), and ``1 <= num_segments <= MAX_SEGMENTS``. The result is
(num_segments,) in the value dtype; f32 is summed in f64 and rounded once.
The kernel adds in an order fixed by the input, so one input gives the
same bits on every run; the plain version adds in row order.
An id outside ``[0, num_segments)`` is undefined behaviour: the kernel
drops its row and the plain version raises; no caller produces one.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import count_launch
from ._build import library

MAX_SEGMENTS = 1024


def grouped_sum_plain(values: torch.Tensor, gids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, gids.long(), values.double())
    return out.to(values.dtype)


_THREADS = 256  # a block of the first pass; each thread takes 4 rows a step


@functools.lru_cache(maxsize=None)
def _functions():
    lib = library("grouped_sum")
    fns = {torch.float64: lib.grouped_sum_f64,
           torch.float32: lib.grouped_sum_f32}
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.grouped_sum_wave.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.grouped_sum_wave.restype = ctypes.c_int
    return fns, lib.grouped_sum_wave


@functools.lru_cache(maxsize=None)
def _wave(device_index: int, num_segments: int, f32: bool) -> int:
    """Blocks resident at once on the card for this many slots."""
    with torch.cuda.device(device_index):
        blocks = ctypes.c_int(0)
        err = _functions()[1](num_segments, int(f32), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"grouped_sum occupancy query failed: CUDA error "
                           f"{err}")
    return blocks.value


def grouped_sum(values: torch.Tensor, gids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    if not 1 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"num_segments {num_segments} outside "
                         f"[1, {MAX_SEGMENTS}]")
    if values.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"unsupported value dtype {values.dtype}")
    if gids.dtype != torch.int32:
        raise ValueError(f"group ids must be int32, not {gids.dtype}")
    if values.dim() != 1 or gids.shape != values.shape:
        raise ValueError(f"values {tuple(values.shape)} and group ids "
                         f"{tuple(gids.shape)} must be equal 1-D shapes")
    if values.device.type == "cpu" and gids.device.type == "cpu":
        return grouped_sum_plain(values, gids, num_segments)
    if values.device.type != "cuda" or gids.device != values.device:
        raise ValueError(f"values on {values.device} and group ids on "
                         f"{gids.device}: both must lie on one CUDA device")
    if not (values.is_contiguous() and gids.is_contiguous()):
        raise ValueError("values and group ids must be contiguous")
    n = values.numel()
    if not n:
        return torch.zeros(num_segments, dtype=values.dtype,
                           device=values.device)
    # one wave at most; the partials of each block, summed in block order
    blocks = min(_wave(values.device.index, num_segments,
                       values.dtype == torch.float32),
                 -(-max(n // 4, 1) // _THREADS))
    partials = torch.empty(blocks * num_segments, dtype=torch.float64,
                           device=values.device)
    out = torch.empty(num_segments, dtype=torch.float64, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _functions()[0][values.dtype](
        values.data_ptr(), gids.data_ptr(), n, num_segments, blocks,
        partials.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"grouped_sum launch failed: CUDA error {err}")
    count_launch(grouped_sum)
    return out.to(values.dtype)


grouped_sum.launches = 0
