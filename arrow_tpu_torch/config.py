"""Build and runtime facts and the environment's knobs (counterpart of
``arrow_tpu/config.py``; reference: cpp/src/arrow/config.h BuildInfo and
RuntimeInfo, docs/source/cpp/env_vars.rst). The device facts come from
torch: whether CUDA is there, how many cards, the backend."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["BuildInfo", "RuntimeInfo", "GlobalOptions", "build_info",
           "runtime_info", "env_options", "initialize", "global_options"]

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


@dataclass
class GlobalOptions:
    """Process-wide defaults (config.h GlobalOptions), set with
    ``initialize``. The port honours ``bloom_mode``: its hash joins read it
    (``auto``, the default: the bloom where the probe side has at least 4x
    the build side's rows; ``always``; ``never``). It refuses the other
    three: its dataset scan reads the fragments in order as it uploads
    them, so it has no IO pool for ``io_threads`` or ``fragment_readahead``
    to size, and ``movement_mode`` chooses among the reference's TPU data
    movement paths, where the port has one."""
    io_threads: Optional[int] = None
    fragment_readahead: Optional[int] = None
    bloom_mode: Optional[str] = None       # auto|always|never
    movement_mode: Optional[str] = None    # auto|sort|direct|scatter


_GLOBAL = GlobalOptions()

_BLOOM_MODES = ("auto", "always", "never")
_REFUSED = {
    "io_threads": "the port's dataset scan has no IO thread pool",
    "fragment_readahead": "the port's dataset scan reads no fragment ahead",
    "movement_mode": "the port has one data movement path (the reference's "
                     "movement modes exist to work around the TPU)",
}


def initialize(options: Optional[GlobalOptions] = None) -> None:
    """arrow::Initialize: make ``options`` the process's defaults (None
    changes nothing). Raises NotImplementedError for an option the port
    does not honour and ValueError for an unknown ``bloom_mode``, and then
    changes nothing."""
    global _GLOBAL
    if options is None:
        return
    for name, why in _REFUSED.items():
        if getattr(options, name) is not None:
            raise NotImplementedError(f"GlobalOptions.{name}: {why}")
    if options.bloom_mode not in (None,) + _BLOOM_MODES:
        raise ValueError(f"bloom_mode must be one of {_BLOOM_MODES}, not "
                         f"{options.bloom_mode!r}")
    _GLOBAL = options


def global_options() -> GlobalOptions:
    return _GLOBAL


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
