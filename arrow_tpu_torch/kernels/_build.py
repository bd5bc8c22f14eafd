"""Builds the CUDA sources in ``arrow_tpu_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/arrow_tpu_torch/lib<name>-<hash>.so``
at the root of the checkout, and is loaded with ``ctypes``. No source
includes PyTorch's headers, so a build takes seconds. The hash covers the
source, the shared headers and the flags, so a changed source builds anew
and an unchanged one is built once. The first call of any kernel builds
every source that lacks its library, one ``nvcc`` process per source, all
started together. A failed build raises :class:`BuildError` with the
first failed compiler's exit status and every failed compiler's output.

A host source, ``csrc/<name>.cpp`` (the LZ4 codec of the IPC and Feather
files, the snappy codec, Parquet's host loops, the ODBC driver), compiles
with the host C++ compiler into ``build/arrow_tpu_torch/lib<name>-<hash>.so``
the same way (``host_library``, or ``host_library_file`` for a library
another program loads), at its first use and apart from the CUDA sources;
its hash also covers the sources of ``csrc`` it includes. Without a
compiler it raises :class:`BuildError`.

One process of a machine builds a library at a time: the build and its
``os.replace`` into place run under an exclusive ``flock`` of the
library's lock file in ``build/arrow_tpu_torch/``, and a process that
waited on it loads the library that the first one built (the test
suite's workers start together on an empty ``build/``). A failed build's
:class:`BuildError` carries the compiler's exit status and its output.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
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
_HOST_LOCK = threading.Lock()  # one thread builds a host library


class BuildError(RuntimeError):
    """A library that could not be built: ``returncode`` is the
    compiler's exit status (None where no compiler ran) and ``output`` its
    output."""

    def __init__(self, message: str, returncode=None, output: str = ""):
        super().__init__(message)
        self.returncode = returncode
        self.output = output


@contextlib.contextmanager
def _build_lock(name: str):
    """An exclusive lock of ``BUILD_DIR/<name>.lock`` across the processes
    of this machine, held while the block runs."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


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
    if all(out.exists() for _, out in todo):
        return 0.0
    with _build_lock("cuda"):
        _build_missing(todo)
    return time.perf_counter() - t0


def _build_missing(todo) -> None:
    """Compile the sources of ``todo`` whose library is missing."""
    todo = [(src, out) for src, out in todo if not out.exists()]
    if not todo:
        return
    compiler = nvcc()
    procs = []
    try:
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs.append((src, out, tmp, subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed, status = [], None
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                status = proc.returncode if status is None else status
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise BuildError("nvcc failed:\n" + "\n".join(failed), status,
                         "\n".join(failed))


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


def _included(src: Path):
    """``src`` and the sources of ``csrc`` it includes (``#include
    "..."``), each once, depth first."""
    seen, todo = [], [src]
    while todo:
        p = todo.pop()
        if p in seen or not p.exists():
            continue
        seen.append(p)
        todo.extend(CSRC / inc for inc in re.findall(
            r'#include\s+"([^"]+)"', p.read_text()))
    return seen


def host_library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for p in _included(CSRC / f"{name}.cpp"):
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.cpp``, built
    with the host C++ compiler on first use (by one thread of one process
    of the machine; the others wait for it and load its library)."""
    key = f"host:{name}"
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _HOST_LOCK:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        lib = _LIBS[key] = ctypes.CDLL(str(host_library_file(name)))
    return lib


def host_library_file(name: str) -> Path:
    """The library of the host source ``csrc/<name>.cpp``, built with the
    host C++ compiler where it is missing (under the machine's build lock
    of it), unloaded: for a library another program loads, as a driver
    manager loads the ODBC driver."""
    out = host_library_path(name)
    if not out.exists():
        with _build_lock(out.name):
            if not out.exists():
                _compile_host(name, out)
    return out


def _compile_host(name: str, out: Path) -> None:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [host_compiler(), *HOST_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cpp")], capture_output=True, text=True)
    except OSError as exc:
        raise BuildError(f"{name}.cpp: the compiler did not start: "
                         f"{exc}") from exc
    BUILD_LOG[name] = log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{name}.cpp: the compiler exited with status "
                         f"{proc.returncode}:\n{log}", proc.returncode, log)
    os.replace(tmp, out)
