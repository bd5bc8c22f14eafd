"""Builds the CUDA sources in ``arrow_tpu_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/arrow_tpu_torch/lib<name>-<hash>.so``
at the root of the checkout, and is loaded with ``ctypes``. No source
includes PyTorch's headers, so a build takes seconds. The hash covers the
source, the shared headers and the flags, so a changed source builds anew
and an unchanged one is built once. The first call of any kernel builds
every source that lacks its library, one ``nvcc`` process per source, all
started together. A failed build raises :class:`BuildError` with the
compiler's output.

A host source, ``csrc/<name>.cpp`` (the LZ4 codec of the IPC and Feather
files), compiles with the host C++ compiler into
``build/arrow_tpu_torch/lib<name>-<hash>.so`` the same way
(``host_library``), at its first use and apart from the CUDA sources;
without a compiler it raises :class:`BuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arrow_tpu_torch"
# -Xptxas -v reports each kernel's registers and shared memory in BUILD_LOG
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the host C++ compiler's flags (``host_library``)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# compiler output of the builds made by this process, by source name
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    pass


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise BuildError("nvcc not found: the CUDA kernels build only on a "
                     "machine with the CUDA toolkit")


def nvcc_version() -> str:
    """Last line of ``nvcc --version`` (the release and build)."""
    out = subprocess.run([nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the seconds spent."""
    t0 = time.perf_counter()
    todo = [(src, library_path(src)) for src in sources()]
    todo = [(src, out) for src, out in todo if not out.exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    try:
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise BuildError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(CSRC /
                                                         f"{name}.cu")))
    return lib


def host_compiler() -> str:
    """Path of the host C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on
    PATH."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise BuildError("no host C++ compiler (g++ or c++) on PATH")


def host_library_path(name: str) -> Path:
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, built
    with the host C++ compiler on first use."""
    key = f"host:{name}"
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    out = host_library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [host_compiler(), *HOST_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cpp")], capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"{name}.cpp:\n{BUILD_LOG[name]}")
        os.replace(tmp, out)
    lib = _LIBS[key] = ctypes.CDLL(str(out))
    return lib
