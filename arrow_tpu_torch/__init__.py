"""arrow_tpu_torch: the columnar query engine of ``arrow_tpu`` on PyTorch and
an NVIDIA H100.

Columns live as padded tensors on the card with byte validity masks, plans
run eagerly as PyTorch operations, and the kernels that the TPU engine
wrote in Pallas are hand-written CUDA for Hopper (``csrc/``, bound with
``ctypes``). The package imports ``torch`` and ``numpy`` only.

Entry points run on the card: ``device=None`` means ``"cuda"``, and where
CUDA is absent they raise instead of running on the CPU. Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels on the
CPU.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises RuntimeError for a CUDA device when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev
