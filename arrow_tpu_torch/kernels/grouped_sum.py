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
An id outside ``[0, num_segments)`` is undefined behaviour: the kernel
drops its row and the plain version raises; no caller produces one.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import library

MAX_SEGMENTS = 1024


def grouped_sum_plain(values: torch.Tensor, gids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, gids.long(), values.double())
    return out.to(values.dtype)


@functools.lru_cache(maxsize=None)
def _functions():
    lib = library("grouped_sum")
    fns = {torch.float64: lib.grouped_sum_f64,
           torch.float32: lib.grouped_sum_f32}
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


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
    out = torch.zeros(num_segments, dtype=torch.float64,
                      device=values.device)
    n = values.numel()
    if n:
        fn = _functions()[values.dtype]
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(values.data_ptr(), gids.data_ptr(), n, num_segments,
                     out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"grouped_sum launch failed: CUDA error {err}")
        grouped_sum.launches += 1
    return out.to(values.dtype)


grouped_sum.launches = 0
