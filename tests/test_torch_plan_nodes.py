"""The plan nodes of the port beyond the 22 TPC-H plans, against the JAX
package: the same ``Declaration`` tree through both over the same tables
(the JAX package's host tables, uploaded and carried across as numpy, so
padding rows ride along). Keys, counts, validity, row order and type ids
exact, floats within rtol 1e-9.

* Hash joins with a residual filter, all eight types: the data and
  predicates of the reference's ``tests/test_join_residual.py``, a seeded
  random case with duplicate and null keys and a filter that reads both
  sides and a name on both, and the refusal of dictionary keys over two
  dictionaries.
* ``union`` of dictionary columns over different dictionaries, of
  inputs with padding rows inside (filters), ``sorted_merge`` with both
  null placements.
* ``asofjoin`` with by-keys and without, tolerances negative, zero and
  positive, ties in ``on``, null by-keys (the reference's
  ``tests/test_asof_merge.py``), and ``chip_smoke.py``'s numpy oracle.
* The segmented aggregate (``test_acero.py::test_segmented_aggregation``)
  and the sinks (``test_acero.py::test_sink_node_family`` but
  ``consuming_sink``, which needs a host Table and raises).
* Q21 in TPC-H's residual spelling against ``q21_plan`` in both
  packages, and ``chip_smoke.py``'s phase 3e oracles against the port.
"""

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu.acero as jacero
from arrow_tpu.device.column import upload_table
from arrow_tpu.table import Table
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.acero.exec import execute_declaration
from arrow_tpu_torch.device.column import batch_from_numpy

import chip_smoke
from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
              "left semi", "left anti", "right semi", "right anti")
_JAX_TYPES = {"int32": at.int32(), "int64": at.int64(),
              "float64": at.float64(), "string": at.string(),
              "date32": at.date32()}


def _src(mod, t):
    return mod.Declaration("table_source", mod.TableSourceNodeOptions(t))


def _both(make, *tables):
    """``make(module, *sources)`` through the JAX package and the port;
    returns (port result, reference result, reference type ids, port type
    ids)."""
    jd = make(jacero, *[_src(jacero, t) for t in tables])
    want_tbl = jd.to_table()
    ported = [carry_across(upload_table(t)) for t in tables]
    td = make(tacero, *[_src(tacero, b) for b in ported])
    got = td.to_table().to_pydict()
    out = execute_declaration(td)
    return (got, want_tbl.to_pydict(),
            [int(f.type.id) for f in want_tbl.schema],
            [int(f.type.id) for f in out.schema.fields])


def _check(make, *tables):
    got, want, want_ids, got_ids = _both(make, *tables)
    assert_tables_match(got, want)
    assert got_ids == want_ids
    return got


def _table(spec):
    """{name: (type name, values with None for null)}."""
    return Table.from_pydict({n: at.array(list(v), _JAX_TYPES[t])
                              for n, (t, v) in spec.items()})


# --- residual joins ---------------------------------------------------------

_LEFT = _table({"k": ("int64", [1, 1, 2, 3, 4, None, 2]),
                "lx": ("int64", [5, 15, 10, 9, 1, 3, 30]),
                "ln": ("string", ["a", "b", "c", "d", "e", "f", "g"])})
_RIGHT = _table({"k": ("int64", [1, 2, 2, 5, None]),
                 "rx": ("int64", [10, 20, 5, 7, 8]),
                 "rn": ("string", ["p", "q", "r", "s", "t"])})
_PREDICATES = {
    "lx < rx": lambda m: m.field("lx") < m.field("rx"),
    "lx + rx >= 25": lambda m: (m.field("lx") + m.field("rx")) >= 25,
    "always false": lambda m: m.field("lx") < -1000,
    "always true": lambda m: m.field("lx") < 10**9,
}


def _residual_join(jt, predicate, **kw):
    def make(mod, left, right):
        return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
            jt, left_keys=["k"], right_keys=["k"],
            output_suffix_for_left="_l", output_suffix_for_right="_r",
            filter=predicate(mod), **kw), inputs=[left, right])
    return make


@pytest.mark.parametrize("predicate", list(_PREDICATES))
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_residual_join_matches_jax(jt, predicate):
    _check(_residual_join(jt, _PREDICATES[predicate]), _LEFT, _RIGHT)


def test_residual_null_predicate_rejects():
    left = _table({"k": ("int64", [1, 1]), "lx": ("int64", [1, 2])})
    right = _table({"k": ("int64", [1]), "rx": ("int64", [None])})
    got = _check(_residual_join("left outer", _PREDICATES["lx < rx"]),
                 left, right)
    assert got["rx"] == [None, None]


def _random_sides(seed, n_probe=400, n_build=150):
    rng = np.random.default_rng(seed)

    def keys(n):
        return [int(v) if ok else None for v, ok in
                zip(rng.integers(0, 40, n), rng.random(n) >= 0.1)]

    left = _table({"k": ("int64", keys(n_probe)),
                   "x": ("float64", rng.normal(0.0, 10.0, n_probe)),
                   "lv": ("int32", rng.integers(0, 9, n_probe))})
    right = _table({"k": ("int64", keys(n_build)),
                    "x": ("float64", [float(v) if ok else None for v, ok in
                                      zip(rng.normal(0.0, 10.0, n_build),
                                          rng.random(n_build) >= 0.1)]),
                    "rv": ("int32", rng.integers(0, 9, n_build))})
    return left, right


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_residual_join_random_matches_jax(jt):
    """Duplicate and null keys on both sides; ``x`` is a name on both
    sides, and the filter reads the left one (the right one, with its
    nulls, is only carried)."""
    left, right = _random_sides(JOIN_TYPES.index(jt))

    def predicate(m):
        return (m.field("x") > 0.0) | (m.field("lv") < m.field("rv"))

    got = _check(_residual_join(jt, predicate), left, right)
    assert len(next(iter(got.values()))) > 0


@pytest.mark.parametrize("jt", ["inner", "left semi", "full outer"])
def test_residual_join_pre_chains_and_outputs(jt):
    """Filters and projects above both inputs run first, and output
    lists narrow the result."""
    left, right = _random_sides(30)

    def make(mod, l_src, r_src):
        lhs = mod.Declaration.from_sequence([l_src, mod.Declaration(
            "filter", mod.FilterNodeOptions(mod.field("lv") < 7))])
        rhs = mod.Declaration.from_sequence([r_src, mod.Declaration(
            "project", mod.ProjectNodeOptions(
                [mod.field("k"), mod.field("rv") * 2],
                ["rk", "rv2"]))])
        return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
            jt, left_keys=["k"], right_keys=["rk"], left_output=["x", "k"],
            right_output=["rv2"],
            filter=mod.field("lv") * 2 != mod.field("rv2")),
            inputs=[lhs, rhs])

    _check(make, left, right)


def test_residual_join_refuses_two_key_dictionaries():
    left = _table({"k": ("string", ["a", "b", "c"]),
                   "lx": ("int64", [1, 2, 3])})
    right = _table({"k": ("string", ["c", "a"]), "rx": ("int64", [1, 2])})
    make = _residual_join("inner", _PREDICATES["lx < rx"])
    with pytest.raises(Exception, match="dictionar"):
        make(jacero, _src(jacero, left), _src(jacero, right)).to_table()
    with pytest.raises(ValueError, match="share one dictionary"):
        make(tacero, _src(tacero, carry_across(upload_table(left))),
             _src(tacero, carry_across(upload_table(right)))).to_table().to_pydict()


# --- union and sorted_merge -------------------------------------------------

def _union_inputs(seed, n):
    rng = np.random.default_rng(seed)
    words = ["ash", "birch", "cedar", "elm", "fir", "oak", "yew"]
    return _table({
        "w": ("string", [words[i] if ok else None for i, ok in zip(
            rng.integers(seed, seed + 4, n), rng.random(n) >= 0.1)]),
        "x": ("int64", rng.integers(-5, 5, n)),
        "f": ("float64", [float(v) if ok else None for v, ok in zip(
            rng.normal(size=n), rng.random(n) >= 0.2)])})


def _filtered(mod, src, predicate):
    return mod.Declaration.from_sequence([src, mod.Declaration(
        "filter", mod.FilterNodeOptions(predicate))])


def test_union_matches_jax():
    """Three inputs whose dictionaries differ; two are filtered, so their
    live rows end before their padding does."""
    tables = [_union_inputs(s, n) for s, n in ((0, 700), (2, 300),
                                               (3, 1500))]

    def make(mod, a, b, c):
        return mod.Declaration("union", mod.UnionNodeOptions(), inputs=[
            _filtered(mod, a, mod.field("x") > 0), b,
            _filtered(mod, c, mod.field("x") < 2)])

    got = _check(make, *tables)
    assert len(got["w"]) > 1000 and None in got["w"]


@pytest.mark.parametrize("placement", ["at_end", "at_start"])
def test_sorted_merge_matches_jax(placement):
    a, b = _union_inputs(0, 500), _union_inputs(2, 400)

    def make(mod, l_src, r_src):
        keys = [("f", "descending"), ("x", "ascending")]
        inputs = [mod.Declaration.from_sequence([s, mod.Declaration(
            "order_by", mod.OrderByNodeOptions(keys, placement))])
            for s in (l_src, r_src)]
        return mod.Declaration("sorted_merge", mod.SortedMergeNodeOptions(
            keys, placement), inputs=inputs)

    got = _check(make, a, b)
    nulls = [i for i, v in enumerate(got["f"]) if v is None]
    assert nulls == (list(range(len(got["f"]) - len(nulls), len(got["f"])))
                     if placement == "at_end" else list(range(len(nulls))))


# --- asofjoin ---------------------------------------------------------------

def _asof(by, tolerance):
    def make(mod, left, right):
        return mod.Declaration("asofjoin", mod.AsofJoinNodeOptions(
            left_on="t", left_by=by, right_on="t", right_by=by,
            tolerance=tolerance), inputs=[left, right])
    return make


def test_asof_basic_matches_jax():
    left = _table({"t": ("int64", [1, 5, 10, 15]),
                   "k": ("string", ["a", "a", "b", "a"]),
                   "lv": ("int64", [1, 2, 3, 4])})
    right = _table({"t": ("int64", [0, 4, 8, 12]),
                    "k": ("string", ["a", "a", "b", "b"]),
                    "rv": ("int64", [10, 20, 30, 40])})
    got = _check(_asof(["k"], -100), left, right)
    assert got["rv"] == [10, 20, 30, 20]


def _asof_tables(seed, null_keys):
    """Few distinct times, so that many right rows tie on (k, t); int32
    by-keys, some null."""
    rng = np.random.default_rng(seed)
    n_l, n_r = 300, 200

    def keys(n):
        return [int(v) if ok else None for v, ok in zip(
            rng.integers(0, 4, n), rng.random(n) >= (0.1 * null_keys))]

    left = _table({"t": ("int64", rng.integers(0, 30, n_l)),
                   "k": ("int32", keys(n_l)),
                   "lv": ("int64", np.arange(n_l))})
    right = _table({"t": ("int64", rng.integers(0, 30, n_r)),
                    "k": ("int32", keys(n_r)),
                    "rv": ("int64", np.arange(n_r)),
                    "rf": ("float64", [float(v) if ok else None
                                       for v, ok in zip(rng.normal(size=n_r),
                                                        rng.random(n_r) > .2)])})
    return left, right


@pytest.mark.parametrize("tolerance", [-3, 0, 5])
@pytest.mark.parametrize("by", [["k"], []], ids=["by", "no_by"])
def test_asof_matches_jax(by, tolerance):
    left, right = _asof_tables(tolerance + 10, null_keys=True)
    got = _check(_asof(by, tolerance), left, right)
    assert any(v is not None for v in got["rv"])


def test_asof_ties_follow_the_right_input_order():
    """Among right rows with equal by-key and ``on``, the last in the
    right input wins: against ``chip_smoke.asof_oracle`` (numpy), with
    ties on every (k, t)."""
    left, right = _asof_tables(3, null_keys=False)
    got = _check(_asof(["k"], -4), left, right)
    lt = {n: np.array(left.column(n).to_pylist()) for n in ("t", "k")}
    rt = {n: np.array(right.column(n).to_pylist()) for n in ("t", "k")}
    match = chip_smoke.asof_oracle(lt["k"], lt["t"], rt["k"], rt["t"], -4)
    want = [int(m) if m >= 0 else None for m in match]
    assert got["rv"] == want
    assert len(set(zip(rt["k"], rt["t"]))) < len(rt["t"]) // 2


# --- the segmented aggregate and the sinks ---------------------------------

def test_segmented_aggregate_matches_jax():
    t = _table({"seg": ("int64", [1, 1, 2, 2, 2]),
                "k": ("string", ["a", "b", "a", "a", "b"]),
                "v": ("float64", [1.0, 2.0, 3.0, 4.0, 5.0])})

    def make(mod, src):
        return mod.Declaration.from_sequence([src, mod.Declaration(
            "aggregate", mod.AggregateNodeOptions(
                [("v", "sum", None, "s")], keys=["k"],
                segment_keys=["seg"]))])

    got = _check(make, t)
    assert got["seg"] == [1, 1, 2, 2] and got["s"] == [1.0, 2.0, 7.0, 5.0]


def test_segmented_aggregate_after_a_filter_matches_jax():
    """A filter below the segmented aggregate runs on its own (the
    aggregate ends the chain); keys of two kinds; segments unsorted in
    the input."""
    rng = np.random.default_rng(9)
    n = 800
    t = _table({"seg": ("string", [("x", "w", "v")[i]
                                   for i in rng.integers(0, 3, n)]),
                "k": ("int32", rng.integers(0, 6, n)),
                "v": ("float64", rng.normal(size=n)),
                "c": ("int64", rng.integers(0, 100, n))})

    def make(mod, src):
        return mod.Declaration.from_sequence([
            src,
            mod.Declaration("filter", mod.FilterNodeOptions(
                mod.field("c") > 20)),
            mod.Declaration("aggregate", mod.AggregateNodeOptions(
                [("v", "sum", None, "s"), ("c", "max", None, "cmax"),
                 ([], "count_all", None, "n")], keys=["k"],
                segment_keys=["seg"]))])

    got = _check(make, t)
    assert got["seg"] == sorted(got["seg"])


_SINK_TABLE = _table({"k": ("int64", [3, 1, 2, 5, 4, None, 2]),
                      "v": ("float64", [1., 2., 3., 4., 5., 6., 7.])})


@pytest.mark.parametrize("name", ["sink", "table_sink", "order_by_sink",
                                  "select_k_sink"])
def test_sink_matches_jax(name):
    def make(mod, src):
        options = {"sink": lambda: mod.SinkNodeOptions(),
                   "table_sink": lambda: mod.TableSinkNodeOptions(),
                   "order_by_sink": lambda: mod.OrderBySinkNodeOptions(
                       [("k", "descending")], "at_start"),
                   "select_k_sink": lambda: mod.SelectKSinkNodeOptions(
                       3, [("k", "ascending")])}[name]()
        return mod.Declaration.from_sequence([src, mod.Declaration(
            name, options)])

    got = _check(make, _SINK_TABLE)
    if name == "order_by_sink":
        assert got["k"] == [None, 5, 4, 3, 2, 2, 1]
    if name == "select_k_sink":
        assert got["k"] == [1, 2, 2]


def _host_node(mod, tbl_mod, name):
    """``name``'s node over a host table of ``mod``'s package: (the
    result as a dict, what the node handed on)."""
    t = tbl_mod.table({"k": [3, 1, 2, 5, 4], "a": [10, None, 30, 40, 50],
                       "b": [1, 2, None, 4, 5]})
    src = _src(mod, t)
    seen = []
    if name == "consuming_sink":
        class Consumer:
            def __call__(self, rb):
                seen.append(rb.to_pydict())

            def finish(self):
                seen.append("finished")
        decl = mod.Declaration.from_sequence([src, mod.Declaration(
            name, mod.ConsumingSinkNodeOptions(Consumer()))])
    elif name == "pivot_longer":
        decl = mod.Declaration(name, mod.PivotLongerNodeOptions(
            [(["x"], ["a", None]), (["y"], ["b", "a"])], ["which"],
            ["v1", "v2"]), [src])
    else:
        reader = tbl_mod.RecordBatchReader.from_batches(
            t.schema, t.to_batches(max_chunksize=2))
        decl = mod.Declaration("filter", mod.FilterNodeOptions(
            mod.field("k") > 1), [mod.Declaration(
                name, mod.RecordBatchReaderSourceNodeOptions(reader))])
    return decl.to_table(**({} if mod is jacero else {"device": "cpu"})
                         ).to_pydict(), seen


@pytest.mark.parametrize("name", ["consuming_sink", "pivot_longer",
                                  "record_batch_reader_source"])
def test_host_table_nodes_raise(name):
    """The nodes that take or give a host Table, which raised naming item
    11 before the host boundary, run over a host Table and match the
    reference: its result, and the batches a consuming sink hands on."""
    import importlib
    jtable = importlib.import_module("arrow_tpu.table")
    ttable = importlib.import_module("arrow_tpu_torch.table")
    got, got_seen = _host_node(tacero, ttable, name)
    want, want_seen = _host_node(jacero, jtable, name)
    assert got == want
    assert got_seen == want_seen
    if name == "consuming_sink":
        assert got_seen[-1] == "finished" and got_seen[0] == got


# --- Q21 in TPC-H's own spelling -------------------------------------------

def test_q21_residual_spelling_matches_q21_plan():
    """The EXISTS / NOT EXISTS pair as residual semi and anti joins gives
    the port's and the reference's ``q21_plan`` answer at SF 0.005."""
    from arrow_tpu.io import tpch as jax_tpch
    from arrow_tpu.io import tpch_queries as jax_queries
    from arrow_tpu_torch.io import tpch
    from arrow_tpu_torch.io import tpch_queries

    names = ("supplier", "lineitem", "orders", "nation")
    jt = jax_tpch.generate(0.005)
    tt = tpch.generate(0.005, device="cpu")
    want = jax_queries.q21_plan(*(jt[k] for k in names)).to_table() \
        .to_pydict()
    got = tpch_queries.q21_residual_plan(*(tt[k] for k in names)).to_table().to_pydict()
    assert len(got["s_name"]) > 0
    assert_tables_match(got, want)
    assert got == tpch_queries.q21_plan(*(tt[k] for k in names)).to_table().to_pydict()


# --- chip_smoke.py's phase 3e oracles --------------------------------------

@pytest.fixture(scope="module")
def smoke_tables():
    """The tables phase 3e uses, at SF 0.01."""
    from arrow_tpu_torch.io import tpch
    from arrow_tpu_torch.io.tpch_device import q1_device_batch
    t = tpch.generate(0.01, device="cpu")
    t["lineitem"], _ = q1_device_batch(0.01, device="cpu")
    return t, chip_smoke._full_columns(t)


@pytest.mark.parametrize("path", chip_smoke.NODE_PATHS, ids=lambda p: p.name)
def test_chip_smoke_node_path_oracle_matches_port(path, smoke_tables):
    t, cols = smoke_tables
    result = chip_smoke.node_path_run(path, path.build(t))()
    line = path.check(t, cols, result)
    assert isinstance(line, str) and line


def test_chip_smoke_general_sum_inputs(smoke_tables):
    """Q15's sum on the general path, as phase 3e repeats it: the sorted
    segment sum equals the row-order sum of the live rows."""
    from arrow_tpu_torch.compute.move import segment_sum
    v, g, live, nseg = chip_smoke.general_sum_inputs(smoke_tables[0][
        "lineitem"])
    assert nseg > 1024 and 0 < int(live.sum()) < v.numel()
    want = np.zeros(nseg)
    np.add.at(want, g.numpy()[live.numpy()], v.numpy()[live.numpy()])
    np.testing.assert_allclose(segment_sum(v, g, nseg, live).numpy(), want,
                               rtol=1e-9, atol=1e-6)
