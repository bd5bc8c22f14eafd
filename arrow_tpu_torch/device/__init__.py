"""Device-resident columns and batches (``column.py``), and the kinds of
memory a host container reports (``DeviceAllocationType``, reference:
device.h)."""


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
