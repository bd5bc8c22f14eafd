"""Device-resident columns and batches (``column.py``); the kinds of
memory a host container reports (``DeviceAllocationType``), and the
devices and their memory managers (``Device``, ``MemoryManager``;
reference: device.h). Departure: a card is ``DeviceAllocationType.CUDA``
(the reference answers ``EXT_DEV`` for its accelerator)."""


class DeviceAllocationType:
    """Where a buffer's memory lives (device.h DeviceAllocationType); a
    host container of the port is always CPU memory."""
    CPU = 1
    CUDA = 2
    CUDA_HOST = 3
    OPENCL = 4
    VULKAN = 7
    METAL = 8
    VPI = 9
    ROCM = 10
    ROCM_HOST = 11
    EXT_DEV = 12
    CUDA_MANAGED = 13
    ONEAPI = 14
    WEBGPU = 15
    HEXAGON = 16


class Device:
    """A compute device (reference: device.h:43): the port's devices are
    torch devices. ``type_name`` is torch's (``"cpu"`` or ``"cuda"``),
    ``device_id`` its index (0 where torch gives none)."""

    def __init__(self, device=None):
        import torch
        self._d = torch.device("cpu" if device is None else device)

    @property
    def type_name(self) -> str:
        return self._d.type

    @property
    def device_id(self) -> int:
        return 0 if self._d.index is None else self._d.index

    @property
    def is_cpu(self) -> bool:
        return self.type_name == "cpu"

    @property
    def device_type(self) -> int:
        """CPU, CUDA for a card, EXT_DEV for any other torch device."""
        if self.is_cpu:
            return DeviceAllocationType.CPU
        if self.type_name == "cuda":
            return DeviceAllocationType.CUDA
        return DeviceAllocationType.EXT_DEV

    def __repr__(self):
        return f"<Device {self.type_name}:{self.device_id}>"


class MemoryManager:
    """The memory of one device (reference: device.h:179)."""

    def __init__(self, device: Device):
        self.device = device

    @property
    def is_cpu(self) -> bool:
        return self.device.is_cpu

    def __repr__(self):
        return f"<MemoryManager {self.device!r}>"


def default_cpu_memory_manager() -> MemoryManager:
    return MemoryManager(Device())
