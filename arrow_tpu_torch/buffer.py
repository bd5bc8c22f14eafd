"""Host memory buffers (counterpart of ``arrow_tpu/buffer.py``; reference:
cpp/src/arrow/buffer.h:52). A Buffer is an immutable view over contiguous
bytes held as a numpy uint8 array."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np


class Buffer:
    __slots__ = ("_data", "__weakref__")

    def __init__(self, data: Union[bytes, bytearray, memoryview, np.ndarray]):
        if isinstance(data, np.ndarray):
            arr = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        else:
            arr = np.frombuffer(bytes(data) if isinstance(data, bytearray)
                                else data, dtype=np.uint8)
        self._data = arr

    @property
    def size(self) -> int:
        return self._data.size

    def __len__(self) -> int:
        return self._data.size

    def to_numpy(self) -> np.ndarray:
        return self._data

    def view(self, dtype) -> np.ndarray:
        return self._data.view(dtype)

    def to_pybytes(self) -> bytes:
        return self._data.tobytes()

    def slice(self, offset: int, length: Optional[int] = None) -> "Buffer":
        end = self.size if length is None else offset + length
        return Buffer(self._data[offset:end])

    def equals(self, other: "Buffer") -> bool:
        return (self.size == other.size
                and bool(np.array_equal(self._data, other._data)))

    def __repr__(self) -> str:
        return f"Buffer({self.size} bytes)"

    @property
    def address(self) -> int:
        """The address of the first byte in host memory."""
        return self._data.ctypes.data

    def hex(self) -> bytes:
        return self.to_pybytes().hex().encode()

    @property
    def is_cpu(self) -> bool:
        """A Buffer always lies in host memory (the card's columns are
        torch tensors, not Buffers)."""
        return True

    @property
    def is_mutable(self) -> bool:
        return self._data.flags.writeable

    @property
    def parent(self):
        return None

    @property
    def device(self):
        """The CPU: a Buffer lies in host memory."""
        from .device import Device
        return Device()

    @property
    def device_type(self):
        from .device import DeviceAllocationType
        return DeviceAllocationType.CPU

    @property
    def memory_manager(self):
        from .device import default_cpu_memory_manager
        return default_cpu_memory_manager()


def as_buffer(obj) -> Buffer:
    return obj if isinstance(obj, Buffer) else Buffer(obj)


def allocate_buffer(nbytes: int) -> Buffer:
    return Buffer(np.zeros(nbytes, dtype=np.uint8))
