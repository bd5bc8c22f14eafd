"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version. Sources live in ``arrow_tpu_torch/csrc``; ``_build`` compiles
them with ``nvcc`` on first use and loads them with ``ctypes``."""
