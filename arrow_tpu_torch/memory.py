"""Memory pools, allocation statistics and the card's allocator facts
(counterpart of ``arrow_tpu/memory.py``; reference:
cpp/src/arrow/memory_pool.h:109 ``MemoryPool`` with its
bytes_allocated/max_memory/num_allocations statistics, and pyarrow's
``total_allocated_bytes``), with the reference's proxy, logging and
capped pools over a parent pool (memory_pool.h:184-218).

Device memory belongs to PyTorch's caching allocator, read through
``device_memory_stats`` under the reference's key names. Host memory that
a pool hands out (``MemoryPool.allocate``) is counted by that pool until
the Buffer is collected.

The accounting never takes its lock from a finalizer. A finalizer runs
wherever a garbage collection happens to run, which may be inside the
accounting's own critical section on the same thread; the reference's
finalizer takes the lock there and deadlocks. Here a finalizer only
appends to a deque (atomic under the GIL, no lock), and every allocation
and every reading of the statistics drains that deque under the lock.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import weakref
from typing import Optional


class MemoryPool:
    """A tracked host allocator (memory_pool.h:109's statistics)."""

    def __init__(self, backend_name: str = "system"):
        self._lock = threading.Lock()
        self._freed = collections.deque()   # byte counts of collected Buffers
        self._bytes = 0
        self._max = 0
        self._num_allocs = 0
        self._backend = backend_name

    def allocate(self, size: int):
        """A mutable Buffer of ``size`` zeroed bytes, counted until it is
        collected."""
        import numpy as np
        from .buffer import Buffer
        buf = Buffer(np.zeros(size, dtype=np.uint8))
        self._record_alloc(size)
        weakref.finalize(buf, self._freed.append, size)
        return buf

    def _drain(self) -> None:
        # under self._lock
        while self._freed:
            self._bytes -= self._freed.popleft()

    def _record_alloc(self, nbytes: int) -> None:
        with self._lock:
            self._drain()
            self._bytes += nbytes
            self._num_allocs += 1
            self._max = max(self._max, self._bytes)

    def _stats(self):
        with self._lock:
            self._drain()
            return self._bytes, self._max, self._num_allocs

    def bytes_allocated(self) -> int:
        return self._stats()[0]

    def max_memory(self) -> int:
        return self._stats()[1]

    def num_allocations(self) -> int:
        return self._stats()[2]

    @property
    def backend_name(self) -> str:
        return self._backend

    def release_unused(self) -> None:
        """memory_pool.h ReleaseUnused: numpy frees eagerly."""

    def __repr__(self):
        b, m, k = self._stats()
        return (f"<MemoryPool {self._backend} allocated={b} max={m} "
                f"allocs={k}>")


class _ChildPool(MemoryPool):
    """A pool that counts its allocations in its parent too."""

    def __init__(self, kind: str, parent: MemoryPool):
        super().__init__(f"{kind}[{parent.backend_name}]")
        self.parent = parent

    def allocate(self, size: int):
        buf = super().allocate(size)
        self.parent._record_alloc(size)
        weakref.finalize(buf, self.parent._freed.append, size)
        return buf


class ProxyMemoryPool(_ChildPool):
    """Forwards to a parent pool, keeping its own statistics
    (memory_pool.h:218)."""

    def __init__(self, parent: MemoryPool):
        super().__init__("proxy", parent)


class LoggingMemoryPool(_ChildPool):
    """Prints every allocation and free (memory_pool.h:184)."""

    def __init__(self, parent: Optional[MemoryPool] = None, sink=None):
        super().__init__("logging", parent or default_memory_pool())
        self._sink = sink or sys.stderr

    def allocate(self, size: int):
        print(f"Allocate: size = {size}", file=self._sink)
        buf = super().allocate(size)
        weakref.finalize(buf, print, f"Free: size = {size}",
                         file=self._sink)
        return buf


class CappedMemoryPool(_ChildPool):
    """Raises MemoryError where the live bytes would pass ``cap``."""

    def __init__(self, cap: int, parent: Optional[MemoryPool] = None):
        super().__init__("capped", parent or default_memory_pool())
        self.cap = int(cap)

    def allocate(self, size: int):
        live = self.bytes_allocated()
        if live + size > self.cap:
            raise MemoryError(f"allocation of {size} bytes exceeds pool "
                              f"cap {self.cap} (live: {live})")
        return super().allocate(size)


_default_pool = MemoryPool(os.environ.get("ARROW_DEFAULT_MEMORY_POOL",
                                          "system"))


def default_memory_pool() -> MemoryPool:
    return _default_pool


def system_memory_pool() -> MemoryPool:
    return _default_pool


def supported_memory_backends():
    return ["system"]


def log_memory_allocations(enable: bool = True) -> None:
    """Swaps the default pool for a logging one over it, or back."""
    global _default_pool
    if enable and not isinstance(_default_pool, LoggingMemoryPool):
        _default_pool = LoggingMemoryPool(_default_pool)
    elif not enable and isinstance(_default_pool, LoggingMemoryPool):
        _default_pool = _default_pool.parent


def total_allocated_bytes() -> int:
    """Live host bytes of the default pool's allocations."""
    return _default_pool.bytes_allocated()


def device_memory_stats(device=None) -> dict:
    """The card's allocator statistics under the reference's key names
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
    ``peak_bytes_reserved``, ``num_allocs``, ``bytes_limit``), from
    ``torch.cuda.memory_stats``; empty where CUDA is absent."""
    import torch
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda" if device is None else device)
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "peak_bytes_reserved": s.get("reserved_bytes.all.peak", 0),
            "num_allocs": s.get("allocation.all.allocated", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}
