"""Start-up probe: the wrapper of ``csrc/probe.cu`` (``y = x * 2``) and its
plain PyTorch version. It replaces the TPU compile probe K5
(``arrow_tpu/platform_check.py``, ``_probe``); ``platform_check.self_check``
launches it once. A tensor on the CPU takes the plain version; a CUDA
tensor launches the kernel or raises."""

from __future__ import annotations

import ctypes
import functools

import torch

from . import count_launch
from ._build import library


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


@functools.lru_cache(maxsize=None)
def _function():
    fn = library("probe").probe_double
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def probe(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe takes a contiguous float32 tensor")
    if x.device.type == "cpu":
        return probe_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe: unsupported device {x.device}")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _function()(x.data_ptr(), y.data_ptr(), x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"probe launch failed: CUDA error {err}")
    count_launch(probe)
    return y


probe.launches = 0
