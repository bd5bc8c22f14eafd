"""Scalar aggregates (``compute/aggregate.py``) and the ``keys=[]``
aggregate node of the port against the JAX package.

* ``sum``, ``mean``, ``count``, ``count_all``, ``min`` and ``max`` over the
  same numpy columns through both packages' registered functions: f64 and
  int64 with nulls, int32 under a row mask (a folded filter), date32 and
  bool (min/max), an empty input and an all-null one. Value, validity and
  result type must match; floats within rtol 1e-9.
* The node: one row at the block capacity, value and validity at row 0;
  a filter below it folds into it as a row mask, so no row moves; an
  empty filter window gives nulls; the null options (``skip_nulls``,
  ``min_count``, count modes) give the reference's results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import acero as jacero
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.compute.registry import get_function as jax_get_function
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import upload_table
from arrow_tpu.table import Table
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch import types as TT
from arrow_tpu_torch.acero.exec import _segment_fns, execute_declaration
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.device.column import BLOCK, DeviceColumn

from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

N = 1000
_TYPES = {"f64": (np.float64, at.float64(), TT.float64()),
          "int64": (np.int64, at.int64(), TT.int64()),
          "int32": (np.int32, at.int32(), TT.int32()),
          "date32": (np.int32, at.date32(), TT.date32()),
          "bool": (np.bool_, at.bool_(), TT.bool_())}
# (values dtype, null share, live rows, folded-filter row mask)
_CASES = {"f64_nulls": ("f64", 0.2, N, False),
          "int64_nulls": ("int64", 0.1, N, False),
          "int32_masked": ("int32", 0.0, N, True),
          "date32": ("date32", 0.1, N, False),
          "bool_masked": ("bool", 0.1, N, True),
          "empty": ("f64", 0.0, 0, False),
          "all_null": ("int64", 1.0, N, False)}
_FUNCTIONS = ("sum", "mean", "count", "count_all", "min", "max")


def _inputs(case):
    kind, null_share, live, masked = _CASES[case]
    rng = np.random.default_rng(sorted(_CASES).index(case))
    dtype = _TYPES[kind][0]
    if kind == "f64":
        values = rng.normal(0.0, 1e4, N)
    elif kind == "bool":
        values = rng.random(N) < 0.5
    else:
        values = rng.integers(8000, 11000, N).astype(dtype)
    valid = rng.random(N) >= null_share
    values = np.where(valid, values, np.zeros((), dtype)).astype(dtype)
    mask = (rng.random(N) < 0.4) & (np.arange(N) < live) if masked else None
    return kind, values, valid, live, mask


def _run(case, fn):
    """(JAX result, port result) of scalar ``fn`` over one case."""
    kind, values, valid, live, mask = _inputs(case)
    _, jtype, ttype = _TYPES[kind]
    jctx = JaxExecContext(N, jnp.int32(live))
    tctx = ExecContext(N, torch.tensor(live, dtype=torch.int32))
    if mask is not None:
        jctx.row_mask_ = jnp.asarray(mask)
        tctx.row_mask_ = torch.from_numpy(mask)
    jcol = JaxDeviceColumn(jnp.asarray(values), jnp.asarray(valid), jtype)
    tcol = DeviceColumn(torch.from_numpy(values), torch.from_numpy(valid),
                        ttype)
    want = jax_get_function(fn).impl(jctx, jcol)
    got = get_function(fn).impl(tctx, *([] if fn == "count_all"
                                        else [tcol]))
    return want, got


def _applies(fn, case):
    """sum and mean take numbers only; min, max and the counts also take
    date32 and bool."""
    return fn not in ("sum", "mean") or \
        _CASES[case][0] not in ("date32", "bool")


@pytest.mark.parametrize("fn,case", [
    (fn, case) for fn in _FUNCTIONS for case in _CASES if _applies(fn, case)])
def test_scalar_aggregate_matches_jax(fn, case):
    want, got = _run(case, fn)
    assert got.value.shape == () and got.valid.shape == ()
    assert bool(got.valid) == bool(want.valid)
    assert int(got.type.id) == int(want.type.id)
    w = np.asarray(want.value)
    g = got.value.numpy()
    assert g.dtype == w.dtype
    np.testing.assert_allclose(g, w, rtol=1e-9, atol=0, equal_nan=True)
    if case in ("empty", "all_null") and fn not in ("count", "count_all"):
        assert not bool(got.valid)


def _scalar_table(rng):
    n = 900
    x = rng.normal(50.0, 20.0, n)
    return Table.from_pydict({
        "k": at.array(np.arange(n), at.int64()),
        "x": at.array([None if rng.random() < 0.1 else float(v) for v in x],
                      at.float64()),
        "q": at.array(rng.integers(1, 51, n), at.int64())})


def _scalar_plan(mod, batch, lo, hi):
    f = mod.field
    return mod.Declaration.from_sequence([
        mod.Declaration("table_source", mod.TableSourceNodeOptions(batch)),
        mod.Declaration("filter", mod.FilterNodeOptions(
            (f("k") >= lo) & (f("k") < hi))),
        mod.Declaration("project", mod.ProjectNodeOptions(
            [f("x") * 2.0, f("q"), f("x")], ["x2", "q", "x"])),
        mod.Declaration("aggregate", mod.AggregateNodeOptions(
            [("x2", "sum", None, "s"), ("x", "mean", None, "m"),
             ("x", "count", None, "c"), ([], "count_all", None, "n"),
             ("q", "min", None, "lo"), ("q", "max", None, "hi"),
             ("q", "sum", None, "qs")], keys=[]))])


@pytest.mark.parametrize("window", [(0, 900), (100, 400), (500, 500)],
                         ids=["all", "some", "none"])
def test_scalar_aggregate_node_matches_jax(window):
    table = _scalar_table(np.random.default_rng(window[0]))
    want = _scalar_plan(jacero, table, *window).to_table().to_pydict()
    got = _scalar_plan(tacero, carry_across(upload_table(table)),
                       *window).to_table().to_pydict()
    assert len(got["s"]) == 1
    assert_tables_match(got, want)
    if window[0] == window[1]:
        assert got["s"] == [None] and got["c"] == [0] and got["n"] == [0]


def test_scalar_aggregate_output_layout():
    """One live row at the block capacity: value and validity at row 0,
    zeros behind them; the filter folds into the aggregate, so no row
    moves."""
    table = _scalar_table(np.random.default_rng(5))
    batch = carry_across(upload_table(table))
    plan = _scalar_plan(tacero, batch, 100, 400)
    chain = []
    cur = plan
    while cur.factory_name != "table_source":
        chain.append(cur)
        cur = cur.inputs[0]
    assert len(_segment_fns(list(reversed(chain)))) == 1
    out = execute_declaration(plan)
    assert int(out.row_count) == 1
    for c in out.columns:
        assert c.capacity == BLOCK
        assert bool(c.validity[0]) and not c.validity[1:].any()
        assert not c.values[1:].any()
    assert out.column("n").values.dtype == torch.int64
    assert out.column("s").values.dtype == torch.float64


@pytest.mark.parametrize("fn,opts", [
    ("sum", {"skip_nulls": False}), ("mean", {"min_count": 0}),
    ("min", {"skip_nulls": False}), ("count", {"mode": "all"})])
def test_scalar_aggregate_options_raise(fn, opts):
    """These options raised until the aggregates were ported (ROADMAP.md
    queue 1, item 9.7); the plan now runs them and gives the reference's
    table, over a column with nulls and over an empty filter window."""
    table = _scalar_table(np.random.default_rng(6))
    batch = carry_across(upload_table(table))

    def plan(mod, t, hi):
        return mod.Declaration.from_sequence([
            mod.Declaration("table_source", mod.TableSourceNodeOptions(t)),
            mod.Declaration("filter", mod.FilterNodeOptions(
                mod.field("k") < hi)),
            mod.Declaration("aggregate", mod.AggregateNodeOptions(
                [("x", fn, opts, "out")], keys=[]))])

    for hi in (900, 0):
        got = plan(tacero, batch, hi).to_table().to_pydict()
        assert_tables_match(got, plan(jacero, table, hi).to_table()
                            .to_pydict())
