"""``chip_smoke.py``'s phase 3f at SF 0.01 on the CPU: the typed lineitem and
part (``chip_smoke.typed_tables``: uint32 keys, int8 line numbers, int16
quantities, decimal128(12, 2) prices, an f32 tax, a timestamp[s] ship date,
a date64 commit date, 1% null suppliers) and the three typed plans (typed
Q1, the uint32 join, the null-keyed top-k), each

* against the JAX package running the same plan over the same typed
  values (integers, decimals, keys, counts, order and validity exact,
  floats within rtol 1e-9), and
* against ``chip_smoke``'s numpy oracle for it, as phase 3f holds the
  port on the card.

The typed tables themselves come from the port's registered functions;
their values are held against plain numpy of the source columns.
"""

import decimal

import jax.numpy as jnp
import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu.acero as jacero
from arrow_tpu import types as RT
from arrow_tpu.device.column import DeviceBatch as JaxBatch
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import download_table

import chip_smoke
from arrow_tpu_torch.io import tpch
from arrow_tpu_torch.io.tpch_device import q1_device_batch
from arrow_tpu_torch.types import TypeId
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

SF = 0.01


@pytest.fixture(scope="module")
def typed():
    lineitem, _ = q1_device_batch(SF, device="cpu")
    part = tpch.part_table(SF, device="cpu")
    return lineitem, part, chip_smoke.typed_tables(lineitem, part)


def _ref_type(t):
    if t.id in (TypeId.DICTIONARY, TypeId.STRING):
        return RT.string()
    if t.is_decimal:
        return RT.decimal128(t.precision, t.scale)
    if t.id == TypeId.TIMESTAMP:
        return RT.timestamp(t.unit, t.tz)
    return at.api.type_for_alias(repr(t))


def _to_reference(batch):
    """A port DeviceBatch as a reference host Table over the same stored
    values, validity and dictionaries."""
    cols, fields = [], []
    for f, c in zip(batch.schema.fields, batch.columns):
        rt = _ref_type(f.type)
        v = c.values.numpy()
        if f.type.is_unsigned_integer:
            v = v.view(np.dtype(f"uint{8 * v.itemsize}"))
        cols.append(JaxDeviceColumn(
            jnp.asarray(v),
            None if c.validity is None else jnp.asarray(c.validity.numpy()),
            rt, None if c.dictionary is None
            else at.array(list(c.dictionary), RT.string())))
        fields.append(RT.field(f.name, rt))
    return download_table(JaxBatch(RT.schema(fields), cols,
                                   jnp.asarray(int(batch.row_count),
                                               jnp.int32)))


def test_typed_tables_hold_the_source_values(typed):
    lineitem, part, t = typed
    n = int(lineitem.row_count)
    c = chip_smoke.typed_columns(t)
    src = {f.name: col.values[:n].numpy()
           for f, col in zip(lineitem.schema.fields, lineitem.columns)}
    types = {f.name: repr(f.type) for f in t["lineitem"].schema.fields}
    assert types == {
        "l_orderkey": "int64", "l_partkey": "uint32", "l_suppkey": "uint32",
        "l_linenumber": "int8", "l_quantity": "int16",
        "l_extendedprice": "decimal128(12, 2)",
        "l_discount": "decimal128(12, 2)", "l_tax": "float32",
        "l_returnflag": repr(lineitem.column("l_returnflag").type),
        "l_linestatus": repr(lineitem.column("l_linestatus").type),
        "l_shipdate": "timestamp[s]", "l_commitdate": "date64"}
    np.testing.assert_array_equal(c["l_partkey"], src["l_partkey"])
    np.testing.assert_array_equal(c["l_linenumber"], src["l_linenumber"])
    np.testing.assert_array_equal(c["l_quantity"], src["l_quantity"])
    np.testing.assert_array_equal(c["l_extendedprice"],
                                  np.round(src["l_extendedprice"] * 100))
    np.testing.assert_array_equal(c["l_discount"],
                                  np.round(src["l_discount"] * 100))
    np.testing.assert_array_equal(c["l_tax"],
                                  src["l_tax"].astype(np.float32))
    np.testing.assert_array_equal(c["l_shipdate"],
                                  src["l_shipdate"].astype(np.int64) * 86400)
    np.testing.assert_array_equal(
        c["l_commitdate"], src["l_commitdate"].astype(np.int64) * 86_400_000)
    valid = c["l_suppkey:valid"]
    assert 0.005 < 1 - valid.mean() < 0.02
    np.testing.assert_array_equal(c["l_suppkey"][valid],
                                  src["l_suppkey"][valid])
    np.testing.assert_array_equal(c["p_partkey"],
                                  part.column("p_partkey").values[
                                      :int(part.row_count)].numpy())


def _same(got, want):
    assert list(got) == list(want)
    for name in want:
        a, b = got[name], want[name]
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0), name
            else:
                assert x == y and type(x) is type(y), (name, x, y)


@pytest.mark.parametrize("path", chip_smoke.TYPED_PATHS,
                         ids=lambda p: p.name)
def test_typed_plan_matches_reference_and_oracle(typed, path):
    _, _, t = typed
    got = path.build(t).to_table().to_pydict()
    assert len(next(iter(got.values()))) > 0
    ref = {k: _to_reference(b) for k, b in t.items()}
    want = path.build(ref, jacero).to_table().to_pydict()
    _same(got, want)
    path.check(chip_smoke.typed_columns(t), got)


def test_typed_q1_types(typed):
    """Sums and means take the reference's types: the int16 sum int64,
    the decimal sums decimal128(38, s), the decimal mean a decimal of its
    input type, the f32 sum and the int16 mean f64."""
    from arrow_tpu_torch.acero.exec import execute_declaration
    _, _, t = typed
    out = execute_declaration(chip_smoke.typed_q1(t))
    types = {f.name: repr(f.type) for f in out.schema.fields}
    assert types == {
        "l_returnflag": types["l_returnflag"],
        "l_linestatus": types["l_linestatus"], "sum_qty": "int64",
        "sum_base_price": "decimal128(38, 2)",
        "sum_disc_price": "decimal128(38, 4)",
        "avg_disc": "decimal128(12, 2)", "sum_tax": "float64",
        "avg_qty": "float64", "count_order": "int64"}
    result = chip_smoke.typed_q1(t).to_table().to_pydict()
    assert all(isinstance(v, decimal.Decimal)
               for v in result["sum_disc_price"])


@pytest.mark.parametrize("path,column", zip(
    chip_smoke.TYPED_PATHS, ("count_order", "lines", "l_orderkey")),
    ids=lambda p: getattr(p, "name", p))
def test_typed_oracle_rejects_a_wrong_result(typed, path, column):
    """Each oracle's check fails on a result off by one in one row."""
    _, _, t = typed
    got = path.build(t).to_table().to_pydict()
    bad = dict(got)
    bad[column] = [got[column][0] + 1] + list(got[column][1:])
    with pytest.raises(AssertionError):
        path.check(chip_smoke.typed_columns(t), bad)
