"""Test-process settings for the port's test files (``tests/test_torch_*.py``;
the card-only tests do not use them). Each file imports the two fixtures
below by name, which is how pytest finds them there.

* torch runs one intra-op thread. The suite runs one pytest-xdist worker
  a core, and each worker's torch would otherwise start a pool of a
  thread a core: six such pools on eight cores spin against each other,
  and phase 3h's temporal oracle case took 153 s under six workers
  against 1.4 s alone.
* The cyclic garbage collector is off while a port test module runs
  (its module fixtures and its tests); the young generations are
  collected after each test and everything at the module's end, and the
  collector is then left as it was found. The JAX package's host memory
  accounting (``arrow_tpu/memory.py``) takes plain ``threading.Lock``s,
  and a collection that starts while one is held (at any bytecode of
  ``_register_root`` or ``MemoryPool._record_alloc``) runs the
  ``weakref.finalize`` callbacks of dead arrays, which take the same
  lock in the same thread: the worker hangs for good (seen in
  ``test_torch_join_types.py`` building the reference's tables). The
  collections made here run where no such lock is held. The JAX package
  and its own test files run as they would alone.
"""

import gc

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def gc_off_in_module():
    was_enabled = gc.isenabled()
    gc.disable()
    yield
    gc.collect()
    if was_enabled:
        gc.enable()


@pytest.fixture(autouse=True)
def collect_after_test(gc_off_in_module):
    yield
    gc.collect(1)
