"""The port's device lineitem generator (arrow_tpu_torch/io/tpch_device.py)
against the JAX package's: bit-identical in every column, padding rows
included, with the same row count, types and dictionaries."""

import numpy as np
import pytest

from arrow_tpu.io.tpch_device import q1_device_batch as jax_q1_device_batch
from arrow_tpu_torch.io.tpch_device import q1_device_batch
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


@pytest.mark.parametrize("seed", [0, 3])
def test_q1_device_batch_bit_identical(seed):
    jb, jn = jax_q1_device_batch(0.002, seed=seed)
    tb, tn = q1_device_batch(0.002, seed=seed, device="cpu")
    assert tn == jn == int(6_001_215 * 0.002)
    assert int(tb.row_count) == int(jb.row_count) == jn
    assert tb.capacity == jb.capacity
    assert tb.schema.names == jb.schema.names
    for f, jc, tc in zip(tb.schema.fields, jb.columns, tb.columns):
        want = np.asarray(jc.values)
        got = tc.values.numpy()
        assert got.dtype == want.dtype, f.name
        assert got.tobytes() == want.tobytes(), f.name
        assert int(f.type.id) == int(jc.type.id), f.name
        assert tc.validity is None and jc.validity is None
        if jc.dictionary is None:
            assert tc.dictionary is None, f.name
        else:
            assert list(tc.dictionary) == jc.dictionary.to_pylist(), f.name
