"""The whole Q3 slice of the port against the JAX package.

Q3 runs through ``q3_device_plan`` at SF 0.01 and 0.05 (tables made on the
device) and through ``q3_plan`` over the JAX package's
``tpch.customer/orders/lineitem_table(0.01)``, uploaded and carried across
as numpy (15, 9 and 7 columns, dictionary strings included). Keys and row
order must be exact, revenue within rtol 1e-9 (the sums are
reassociated). The three device tables must be bit-identical to the JAX
generator's, padding included."""

import numpy as np
import pytest
import torch

from arrow_tpu.device.column import upload_table
from arrow_tpu.io import tpch
from arrow_tpu.io.tpch_device import q3_device_plan as jax_q3_device_plan
from arrow_tpu.io.tpch_queries import q3_plan as jax_q3_plan
from arrow_tpu_torch.io.tpch_device import q3_device_plan
from arrow_tpu_torch.io.tpch_queries import q3_plan

from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

RTOL = 1e-9


@pytest.mark.parametrize("sf", [0.01, 0.05])
def test_q3_device_plan_matches_jax(sf):
    jplan, jn = jax_q3_device_plan(sf)
    want = jplan.to_table().to_pydict()
    plan, n = q3_device_plan(sf, device="cpu")
    got = plan.to_table().to_pydict()
    assert n == jn
    assert len(got["l_orderkey"]) == 10
    assert_tables_match(got, want, RTOL)


def test_q3_plan_over_carried_tables():
    tables = [tpch.customer_table(0.01), tpch.orders_table(0.01),
              tpch.lineitem_table(0.01)]
    want = jax_q3_plan(*tables).to_table().to_pydict()
    got = q3_plan(*[carry_across(upload_table(t)) for t in tables]) \
        .to_table().to_pydict()
    assert len(got["l_orderkey"]) == 10
    assert_tables_match(got, want, RTOL)


def test_q3_device_plan_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        q3_device_plan(0.01)


def _sources(decl):
    if decl.factory_name == "table_source":
        return [decl.options]
    return [o for d in decl.inputs for o in _sources(d)]


@pytest.mark.parametrize("seed", [0, 5])
def test_q3_device_tables_bit_identical(seed):
    jplan, _ = jax_q3_device_plan(0.01, seed=seed)
    plan, _ = q3_device_plan(0.01, seed=seed, device="cpu")
    jbatches = [o._device_batch for o in _sources(jplan)]
    batches = [o.batch for o in _sources(plan)]
    assert [b.schema.names for b in batches] == \
        [b.schema.names for b in jbatches]
    assert [b.schema.names[0] for b in batches] == \
        ["l_orderkey", "o_orderkey", "c_custkey"]
    for tb, jb in zip(batches, jbatches):
        assert int(tb.row_count) == int(jb.row_count)
        assert tb.capacity == jb.capacity
        for f, tc, jc in zip(tb.schema.fields, tb.columns, jb.columns):
            want = np.asarray(jc.values)
            got = tc.values.numpy()
            assert got.dtype == want.dtype, f.name
            assert got.tobytes() == want.tobytes(), f.name
            assert int(f.type.id) == int(jc.type.id), f.name
            assert tc.validity is None and jc.validity is None
            if jc.dictionary is None:
                assert tc.dictionary is None, f.name
            else:
                assert list(tc.dictionary) == jc.dictionary.to_pylist()
