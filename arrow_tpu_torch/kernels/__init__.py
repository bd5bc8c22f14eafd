"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version. Sources live in ``arrow_tpu_torch/csrc``; ``_build`` compiles
them with ``nvcc`` on first use and loads them with ``ctypes``.

A wrapper launches on the current stream of its tensors' device and does
not switch the current device per call: the tensors must lie on the current
device (with one card they always do), else the launch fails and the
wrapper raises."""
