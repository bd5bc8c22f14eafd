"""Start-up self-check (counterpart of ``arrow_tpu/platform_check.py``
``self_check``).

Records the torch, CUDA and nvcc versions, the card's name and power
limit, then builds the kernels and launches the probe kernel (K5's
counterpart) once, in this process, and checks its result. On a machine
without CUDA it reports ``kind: "cpu"`` and launches nothing.
"""

from __future__ import annotations

import subprocess
from typing import Any, Dict

import torch


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the cards as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def self_check() -> Dict[str, Any]:
    result: Dict[str, Any] = {"torch": torch.__version__,
                              "cuda": torch.version.cuda}
    if not torch.cuda.is_available():
        result["kind"] = "cpu"
        return result
    from .kernels import _build
    from .kernels.probe import probe

    result.update(kind="gpu", device=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count(),
                  card=card_name_and_power_limit(),
                  nvcc=_build.nvcc_version())
    result["build_seconds"] = _build.build_all()
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device="cuda").reshape(8, 128)
    y = probe(x)
    torch.cuda.synchronize()
    if not torch.equal(y, x * 2.0):
        raise RuntimeError("probe kernel returned a wrong result")
    result["probe"] = "ok"
    return result
