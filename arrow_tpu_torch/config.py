"""Build and runtime facts and the environment's knobs (counterpart of
``arrow_tpu/config.py``; reference: cpp/src/arrow/config.h BuildInfo and
RuntimeInfo, docs/source/cpp/env_vars.rst). The device facts come from
torch: whether CUDA is there, how many cards, the backend."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["BuildInfo", "RuntimeInfo", "build_info", "runtime_info",
           "env_options"]

# the ARROW_TPU_* variables the port reads, and what each sets
_ENV_KNOBS = {
    "ARROW_TPU_CHUNK_ROWS": "stream a plan's source in chunks of this many "
                            "rows (acero/chunked.py)",
    "ARROW_TPU_REQUIRE_CHUNKED": "1: refuse a plan that cannot stream",
    "ARROW_TPU_STATE_ROWS": "the chunked group state's capacity",
    "ARROW_TPU_OTEL_EXPORT": "export each query's spans as OTLP/JSON to "
                             "this file or http(s) URL (utils/otel.py)",
    "ARROW_DEFAULT_MEMORY_POOL": "the default pool's backend name",
}


@dataclass(frozen=True)
class BuildInfo:
    """What this install supports (config.h BuildInfo)."""
    version: str
    compute_functions: int
    with_cuda: bool
    torch_version: str
    cuda_version: Optional[str]


@dataclass(frozen=True)
class RuntimeInfo:
    """The runtime found (config.h RuntimeInfo): the backend, ``"cuda"``
    or ``"cpu"``, and its device count."""
    backend: str
    num_devices: int
    x64_enabled: bool


def build_info() -> BuildInfo:
    import torch
    from .compute.registry import function_registry
    return BuildInfo(version="0.1.0",
                     compute_functions=len(function_registry()),
                     with_cuda=torch.backends.cuda.is_built(),
                     torch_version=torch.__version__,
                     cuda_version=torch.version.cuda)


def runtime_info() -> RuntimeInfo:
    """64-bit types are always on: torch has no switch that narrows
    them, where JAX's ``jax_enable_x64`` does."""
    import torch
    if torch.cuda.is_available():
        return RuntimeInfo("cuda", torch.cuda.device_count(), True)
    return RuntimeInfo("cpu", 1, True)


def env_options() -> Dict[str, Optional[str]]:
    """The engine's environment variables and their values (None: not
    set)."""
    return {k: os.environ.get(k) for k in _ENV_KNOBS}
