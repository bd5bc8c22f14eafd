"""``chip_smoke.py``'s phase 3h at SF 0.01 on the CPU: the temporal and
string functions over Q1's lineitem, the typed lineitem of phase 3f, part
(20,000 ``p_name`` values: the byte pool) and customer, path by path:

* against ``chip_smoke``'s oracles for the path, as phase 3h holds the
  port on the card (numpy's datetime64 units and Python's ``datetime``,
  ``str`` and ``re`` over the distinct inputs; numpy joins and groups);
* against the JAX package: every call of ``temporal_fields`` and of
  ``strings_pool`` through the reference's function (its eager pool
  tier where it takes the call) over the same columns, and
  ``temporal_plan`` and ``strings_plan`` through both packages' plans.
  Values, codes, dictionaries, validity and order exact; revenue within
  rtol 1e-9;
* ``strings_plan`` run twice gives the same bits, and Q22's slice of
  ``c_phone`` takes the byte pool.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu.acero as jacero
import arrow_tpu.compute.extra_kernels  # noqa: F401 - registers its names
from arrow_tpu import types as RT
from arrow_tpu.compute import registry as jax_registry
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn

import chip_smoke
from arrow_tpu_torch.compute import device_strings
from arrow_tpu_torch.compute.elementwise import _and_validity
from arrow_tpu_torch.io import tpch
from arrow_tpu_torch.io.tpch_device import q1_device_batch

from test_torch_q1 import assert_tables_match
from test_torch_typed_plans import _ref_type, _to_reference
from test_torch_types import type_name
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

SF = 0.01


@pytest.fixture(scope="module")
def phase():
    lineitem, _ = q1_device_batch(SF, device="cpu")
    tables = {"lineitem": lineitem}
    for name in ("part", "customer", "orders"):
        tables[name] = getattr(tpch, f"{name}_table")(SF, device="cpu")
    typed = chip_smoke.typed_tables(lineitem, tables["part"])
    return tables, chip_smoke.strings_inputs_all(tables, typed)


def _ref_col(col):
    """A port column as a reference DeviceColumn over the same stored
    values, validity and dictionary."""
    v = col.values.numpy()
    return JaxDeviceColumn(
        jnp.asarray(v),
        None if col.validity is None else jnp.asarray(col.validity.numpy()),
        RT.dictionary(RT.int32(), RT.string()) if col.dictionary is not None
        else _ref_type(col.type),
        None if col.dictionary is None
        else at.array(list(col.dictionary), RT.string()))


def _reference(fn, cols, n, **options):
    """The reference's eager call: its pool transform where the ``pre``
    hook takes it, else its function."""
    f = jax_registry.get_function(fn)
    rcols = [_ref_col(c) for c in cols]
    if f.pre is not None:
        hit = f.pre(rcols, [], dict(options))
        if hit is not None:
            return hit
    return f.impl(jax_registry.ExecContext(cols[0].capacity, jnp.asarray(n)),
                  *rcols, **options)


def _assert_same(got, want, n):
    g, w = got.values[:n].numpy(), np.asarray(want.values)[:n]
    if w.dtype.kind in "iu":
        g, w = g.astype(np.int64), w.astype(np.int64)
    np.testing.assert_array_equal(g, w)
    if want.validity is None:
        assert got.validity is None or bool(got.validity[:n].all())
    else:
        np.testing.assert_array_equal(got.validity[:n].numpy(),
                                      np.asarray(want.validity)[:n])
    if want.dictionary is not None:
        assert got.dictionary == tuple(want.dictionary.to_pylist())
    else:
        assert type_name(got.type) == type_name(want.type)


@pytest.mark.parametrize("path", chip_smoke.STRING_PATHS,
                         ids=lambda p: p.name)
def test_path_matches_its_oracle(phase, path):
    tables, h = phase
    if path.verify is None:
        check = path.run(h, chip_smoke.CardCheck())
        assert len(check.labels) > 100
        assert check.failures() == []
        return
    li = tables["lineitem"]
    cols = {"temporal_plan": chip_smoke._host_columns(li, [
        "l_shipdate", "l_commitdate", "l_receiptdate", "l_orderkey",
        "l_extendedprice"]),
        "strings_plan": chip_smoke.strings_plan_columns(li, h["strings"])}
    assert path.verify(cols[path.name], path.run(h, None))


_TEMPORAL_FNS = sorted({fn for fn, _, _ in chip_smoke.temporal_calls()})


@pytest.mark.parametrize("fn", _TEMPORAL_FNS)
def test_temporal_fields_match_jax(phase, fn):
    """Every call of ``fn`` in ``temporal_calls()``, in both packages."""
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    _, h = phase
    cols, n = h["temporal"]["cols"], h["temporal"]["n"]
    ctx = ExecContext(cols["date32"].capacity, torch.tensor(n))
    calls = [c for c in chip_smoke.temporal_calls() if c[0] == fn]
    assert calls
    for _, names, opts in calls:
        args = [cols[k] for k in names]
        got = get_function(fn).impl(ctx, *args, **opts)
        want = _reference(fn, args, n, **opts)
        _assert_same(got, want, n)
        valid = _and_validity(*(c.validity for c in args))
        if valid is not None:
            assert torch.equal(got.validity[:n], valid[:n])


_STRING_CALLS = chip_smoke.string_calls()


@pytest.mark.parametrize("fn,name,options", _STRING_CALLS,
                         ids=[f"{f}-{c}-{i}" for i, (f, c, _) in
                              enumerate(_STRING_CALLS)])
def test_strings_pool_calls_match_jax(phase, fn, name, options):
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    _, h = phase
    s = h["strings"]
    table, column = chip_smoke.STRING_COLUMNS[name]
    batch = s[table]
    col, n = batch.column(column), int(batch.row_count)
    got = get_function(fn).impl(ExecContext(batch.capacity,
                                            batch.row_count), col, **options)
    _assert_same(got, _reference(fn, [col], n, **options), n)


def test_product_of_brand_container_and_sep_matches_jax(phase):
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    _, h = phase
    part = h["strings"]["part"]
    cols = [part.column(k) for k in ("p_brand", "p_container", "sep")]
    n = int(part.row_count)
    got = get_function("binary_join_element_wise").impl(
        ExecContext(part.capacity, part.row_count), *cols)
    _assert_same(got, _reference("binary_join_element_wise", cols, n), n)
    assert len(got.dictionary) == 45 * 40


def test_temporal_plan_matches_jax(phase):
    tables, _ = phase
    li = tables["lineitem"]
    got = chip_smoke.temporal_plan(li).to_table().to_pydict()
    want = chip_smoke.temporal_plan(_to_reference(li), jacero).to_table() \
        .to_pydict()
    assert len(got["l_year"]) > 100
    assert_tables_match(got, want)


@pytest.mark.parametrize("key", ["type", "mfgr_container"])
def test_strings_plan_matches_jax(phase, key):
    tables, h = phase
    li = tables["lineitem"]
    got = chip_smoke.strings_plan(li, h["strings"], key).to_table().to_pydict()
    ref = {"lineitem": _to_reference(li),
           "part": _to_reference(h["strings"]["part"])}
    want = chip_smoke.strings_plan(ref["lineitem"], ref, key, jacero) \
        .to_table().to_pydict()
    g = dict(zip(got["key"], got["revenue"]))
    w = dict(zip(want["key"], want["revenue"]))
    assert sorted(g) == sorted(w) and len(g) > 3
    for k, v in w.items():
        assert g[k] == pytest.approx(v, rel=1e-9, abs=0)
    again = chip_smoke.strings_plan(li, h["strings"], key).to_table().to_pydict()
    assert np.array_equal(np.array(again["revenue"]).view(np.int64),
                          np.array(got["revenue"]).view(np.int64))


# At SF 0.01 the only customer without orders whose balance is above the
# mean has country code 24, which Q22's default codes leave out.
_Q22_CODES = {"codes": ("13", "31", "23", "29", "30", "18", "17", "24")}


def test_pool_and_host_tiers_and_q22_on_the_pool(phase, monkeypatch):
    """At SF 0.01 customer has 1,500 phone numbers: the gate is lowered
    below them, as SF10's 1.5M pass it."""
    tables, h = phase
    assert chip_smoke.pool_and_host_tiers(h["strings"]) == [True, True]
    q22 = next(q for q in chip_smoke.FULL if q.name == "Q22")
    monkeypatch.setattr(device_strings, "DEVICE_STRINGS_MIN", 1_000)
    device_strings.clear_pools()
    got = chip_smoke.suite_plan(q22, tables, _Q22_CODES).to_table().to_pydict()
    phone = tables["customer"].column("c_phone").dictionary
    assert device_strings.is_pooled(phone, torch.device("cpu"))
    c = {"customer": chip_smoke._host_columns(
        tables["customer"], ["c_custkey", "c_phone", "c_acctbal"]),
        "orders": chip_smoke._host_columns(tables["orders"], ["o_custkey"])}
    want, rows = q22.oracle(tables, c, **_Q22_CODES)
    assert rows > 0
    chip_smoke.check_result("Q22", got, want)
