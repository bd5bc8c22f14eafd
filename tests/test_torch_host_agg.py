"""The host-tier grouped aggregates (``arrow_tpu_torch/acero/host_agg.py``)
against the JAX package's on the same inputs: ``list``, ``distinct`` and
``pivot_wider`` and their ``hash_`` forms, groups in order of first
appearance (``tests/test_pivot_casts.py``'s and ``tests/test_acero.py``'s
cases, and larger ones from a seed), mixed with device aggregates, over a
plan's output as well as a table source, and the exact host fallback for
targets that exist on the device only as codes (wide decimals, nested
columns)."""

import decimal
import importlib

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu.acero as jacero
from arrow_tpu.compute.registry import ArrowInvalid as JInvalid
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.compute.registry import ArrowInvalid

from test_torch_host_table import carry_table
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

ttable = importlib.import_module("arrow_tpu_torch.table")


def both_group_by(data, keys, aggs, **kw):
    """(port result, reference result) of ``table(data).group_by(keys)
    .aggregate(aggs)``, as dicts."""
    ref = at.table(data) if isinstance(data, dict) else data
    want = ref.group_by(keys).aggregate(aggs).to_pydict()
    got = carry_table(ref).group_by(keys).aggregate(
        aggs, device="cpu").to_pydict()
    return got, want


def both_plan(make, ref):
    """``make(module, source)`` through both packages, as dicts."""
    want = make(jacero, jacero.Declaration(
        "table_source", jacero.TableSourceNodeOptions(ref))).to_table()
    got = make(tacero, tacero.Declaration(
        "table_source", tacero.TableSourceNodeOptions(carry_table(ref)))
    ).to_table(device="cpu")
    return got.to_pydict(), want.to_pydict()


@pytest.mark.parametrize("case", [
    ({"v": [1, None, 1, None, 5], "g": [1, 1, 2, 2, 1]}, [("v", "list")]),
    ({"v": ["x", "y", "x"], "g": [1, 1, 2]}, [("v", "list")]),
    ({"v": [1, None, 1, 2, 2], "g": [1, 1, 1, 2, 2]}, [("v", "distinct")]),
    ({"v": [1, None, 1, 2, 2], "g": [1, 1, 1, 2, 2]},
     [("v", "distinct", {"mode": "all"})]),
    ({"v": [1.0, 2.0, 3.0, 4.0], "g": [1, 1, 2, 2]},
     [("v", "sum"), ("v", "list")]),
    ({"k": ["a", "b", "a", "b"], "v": [1.0, 2.0, 3.0, 4.0],
      "g": [1, 1, 2, 2]},
     [(["k", "v"], "pivot_wider", {"key_names": ["a", "b"]})]),
    ({"k": ["a"], "v": [1.0], "g": [1]},
     [(["k", "v"], "pivot_wider", {"key_names": ["a", "b"]})]),
    ({"k": ["a", "zz"], "v": [1.0, 2.0], "g": [1, 1]},
     [(["k", "v"], "pivot_wider", {"key_names": ["a"]})]),
], ids=["list", "list strings", "distinct", "distinct all", "mixed",
        "pivot_wider", "pivot missing key", "pivot unexpected key"])
def test_reference_cases(case):
    data, aggs = case
    got, want = both_group_by(data, "g", aggs)
    assert got == want


def test_scalar_pivot_wider_no_keys():
    got, want = both_group_by({"k": ["a", "b"], "v": [1.0, 2.0]}, [],
                              [(["k", "v"], "pivot_wider",
                                {"key_names": ["a", "b"]})])
    assert got == want == {"k_v_pivot_wider": [{"a": 1.0, "b": 2.0}]}


@pytest.mark.parametrize("opts", [{"key_names": ["a"]},
                                  {"key_names": ["a"],
                                   "unexpected_key_behavior": "raise"}])
def test_pivot_wider_errors_as_the_reference(opts):
    data = {"k": ["a", "a"] if "unexpected_key_behavior" not in opts
            else ["a", "zz"], "v": [1.0, 2.0], "g": [1, 1]}
    with pytest.raises(JInvalid):
        at.table(data).group_by("g").aggregate(
            [(["k", "v"], "pivot_wider", opts)])
    with pytest.raises(ArrowInvalid):
        ttable.table(data).group_by("g").aggregate(
            [(["k", "v"], "pivot_wider", opts)], device="cpu")


def test_null_and_nan_keys_group_apart():
    """``tests/test_acero.py``'s case: None and NaN keys are two groups."""
    ref = at.Table.from_arrays(
        [at.array([None, float("nan"), None, float("nan"), 1.0]),
         at.array([1, 2, 3, 4, 5])], names=["k", "v"])
    got, want = both_plan(lambda m, s: m.Declaration.from_sequence([
        s, m.Declaration("aggregate", m.AggregateNodeOptions(
            [("v", "hash_list", None, "s")], keys=["k"]))]), ref)
    assert repr(got) == repr(want)
    assert got["s"] == [[1, 3], [2, 4], [5]]


@pytest.mark.parametrize("seed", [0, 1])
def test_larger_inputs_from_a_seed(seed):
    """Two string and integer keys, nulls in keys and values, list,
    distinct (both modes) and pivot_wider beside sum and count, over a
    filter (the host aggregate's input runs as a plan first)."""
    rng = np.random.default_rng(seed)
    n = 3000
    k1 = [None if rng.random() < 0.05 else f"k{int(v)}"
          for v in rng.integers(0, 7, n)]
    k2 = [int(v) for v in rng.integers(0, 4, n)]
    v = [None if rng.random() < 0.1 else int(x)
         for x in rng.integers(0, 20, n)]
    pk = [["a", "b", "c"][int(i)] for i in rng.integers(0, 3, n)]
    f = [float(x) for x in rng.standard_normal(n)]
    ref = at.table({"k1": k1, "k2": k2, "v": v, "f": f, "pk": pk,
                    "row": list(range(n))})

    def make(m, s):
        return m.Declaration.from_sequence([
            s, m.Declaration("filter", m.FilterNodeOptions(
                m.field("f") > -1.0)),
            m.Declaration("aggregate", m.AggregateNodeOptions(
                [("v", "hash_list", None, "lst"),
                 ("v", "hash_distinct", None, "dst"),
                 ("v", "hash_distinct", {"mode": "all"}, "dst_all"),
                 ("f", "hash_sum", None, "s"),
                 ("v", "hash_count", None, "c")],
                keys=["k1", "k2"]))])
    got, want = both_plan(make, ref)
    assert list(got) == list(want)
    for name in want:
        if name == "s":
            np.testing.assert_allclose(got[name], want[name], rtol=1e-9)
        else:
            assert got[name] == want[name], name

    def pivot(m, s):
        return m.Declaration.from_sequence([
            s, m.Declaration("aggregate", m.AggregateNodeOptions(
                [(["pk", "row"], "hash_pivot_wider",
                  {"key_names": ["a", "b", "c"]}, "p")], keys=["row"]))])
    got, want = both_plan(pivot, ref)
    assert got == want


def test_segmented_host_aggregate():
    ref = at.table({"seg": [2, 1, 2, 1], "k": [1, 1, 2, 1],
                    "v": [1.0, 2.0, 3.0, 4.0]})
    got, want = both_plan(lambda m, s: m.Declaration.from_sequence([
        s, m.Declaration("aggregate", m.AggregateNodeOptions(
            [("v", "hash_list", None, "l"), ("v", "hash_sum", None, "s")],
            keys=["k"], segment_keys=["seg"]))]), ref)
    assert got == want


BIG = decimal.Decimal("12345678901234567890.12")


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "count",
                                "count_distinct", "first", "last",
                                "product"])
def test_wide_decimal_targets_run_on_the_host(fn):
    """A numeric aggregate of a decimal wider than 18 digits (codes on the
    device) is re-run exactly on the host tier, as in the reference."""
    vals = [BIG, decimal.Decimal("-1.50"), None, decimal.Decimal("0.04"),
            BIG, decimal.Decimal("2.00")]
    ref = at.Table.from_arrays([at.array([1, 1, 2, 2, 1, 2]),
                                at.array(vals, at.decimal128(38, 2))],
                               names=["k", "d"])
    try:
        want = ref.group_by("k").aggregate([("d", fn)]).to_pydict()
    except decimal.InvalidOperation:
        # the product overflows the context's precision in both
        with pytest.raises(decimal.InvalidOperation):
            carry_table(ref).group_by("k").aggregate([("d", fn)],
                                                     device="cpu")
        return
    got = carry_table(ref).group_by("k").aggregate(
        [("d", fn)], device="cpu").to_pydict()
    assert repr(got) == repr(want)


@pytest.mark.parametrize("fn", ["count", "first", "last"])
def test_nested_targets_run_on_the_host(fn):
    ref = at.Table.from_arrays([at.array([1, 2, 1, 2]), at.array(
        [[1], None, [2, 3], []])], names=["k", "l"])
    got, want = both_group_by(ref, "k", [("l", fn)])
    assert got == want


def test_mixed_aggregate_keeps_the_device_aggregates():
    """The device aggregates of a mixed aggregate run through a table
    source of the columns they read; their groups zip with the host
    ones."""
    ref = at.table({"g": ["x", "y", "x", "z", "y"], "v": [1, 2, 3, 4, 5],
                    "w": [1.5, 2.5, 3.5, 4.5, 5.5]})
    got, want = both_group_by(ref, "g", [("w", "mean"), ("v", "list"),
                                         ("v", "max"), ("w", "distinct")])
    assert got == want
    assert got["g"] == ["x", "y", "z"]
