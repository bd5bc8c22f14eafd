"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version. Sources live in ``arrow_tpu_torch/csrc``; ``_build`` compiles
them with ``nvcc`` on first use and loads them with ``ctypes``.

A wrapper launches on the current stream of its tensors' device and does
not switch the current device per call: the tensors must lie on the current
device (with one card they always do), else the launch fails and the
wrapper raises."""

import threading

_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, exactly under threads: plans run
    on several threads at once, as a Flight server's handlers run them,
    and ``+= 1`` on an attribute is a read and a write the interpreter may
    switch threads between."""
    with _COUNT_LOCK:
        wrapper.launches += 1
