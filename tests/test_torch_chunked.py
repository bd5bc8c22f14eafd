"""Chunked (streaming) execution of the port against the JAX package.

Every case of the reference's ``tests/test_chunked.py``: each plan's data,
made from a seed, goes through the reference's ``maybe_execute_chunked``
(or ``to_table`` under ``ARROW_TPU_CHUNK_ROWS``) over an ``at.table`` and
through the port's over the same data carried across as a CPU
DeviceBatch, at the same ``chunk_rows``, with ``device="cpu"``. The port's
chunked result must equal the reference's chunked result, and the port's
whole-table result. Tolerance: keys, counts, validity and row order exact;
floats within rtol 1e-9 (the chunked sums reassociate at chunk
boundaries). A streamed join's output is chunk-major, so it is held
against the whole-table join as a set of rows.

Beyond the reference's cases: every aggregate of ``_SUPPORTED_AGGS`` with
its options, the fallback warning and ``ARROW_TPU_REQUIRE_CHUNKED`` for
each reason a plan does not stream (the reason held against the
reference's), ``merge_states`` of two states against one state over both
inputs, the chunk source's chunks (shared dictionaries, the last chunk
padded), a host source refused on the CPU unless ``device="cpu"`` is
named, the same bits on a second run, and the new modules' imports.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import acero as ja
from arrow_tpu.acero import chunked as jchunked
from arrow_tpu.device.column import upload_table
from arrow_tpu.io import tpch as jtpch
from arrow_tpu.io import tpch_queries as jq
import arrow_tpu_torch.acero as ta
from arrow_tpu_torch.acero import chunked
from arrow_tpu_torch.acero.chunked import (_ChunkedGroupBy, _ChunkSource,
                                           _norm_aggs, maybe_execute_chunked)
from arrow_tpu_torch.acero.exec import last_plan_metrics
from arrow_tpu_torch.device.column import download
from arrow_tpu_torch.io import tpch_queries as tq
from arrow_tpu_torch.table import Table as TTable

from test_torch_q1 import assert_tables_match, carry_across
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

RTOL = 1e-9
REPO = pathlib.Path(__file__).resolve().parent.parent


def make_table(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    return at.table({
        "k": [f"k{int(v)}" for v in rng.integers(0, 37, n)],
        "g": [int(v) for v in rng.integers(0, 11, n)],
        "i": [None if m else int(v) for m, v in
              zip(rng.random(n) < 0.08, rng.integers(-1000, 1000, n))],
        "f": [None if m else float(v) for m, v in
              zip(rng.random(n) < 0.08, rng.normal(size=n))],
        "b": [bool(v) for v in rng.random(n) < 0.5],
    })


@pytest.fixture(scope="module")
def table():
    """make_table() in both packages: (at.table, port CPU batch)."""
    t = make_table()
    return t, carry_across(upload_table(t))


def src(mod, t):
    return mod.Declaration("table_source", mod.TableSourceNodeOptions(t))


def check(make, tables, chunk_rows):
    """``make(module, *sources)`` chunked in both packages and whole in the
    port; returns the port's chunked result after holding it against
    both."""
    jd = make(ja, *[src(ja, t) for t, _ in tables])
    want = jchunked.maybe_execute_chunked(jd, chunk_rows)
    assert want is not None, "the reference fell back"
    td = make(ta, *[src(ta, b) for _, b in tables])
    got = maybe_execute_chunked(td, chunk_rows, "cpu")
    assert got is not None, chunked.LAST_FALLBACK_REASON
    assert last_plan_metrics.source.n_chunks > 1
    assert_tables_match(got, want.to_pydict(), RTOL)
    assert_tables_match(got, td.to_table().to_pydict(), RTOL)
    return got


def aggregate(mod, aggs, keys=()):
    return ("aggregate", mod.AggregateNodeOptions(aggs, keys=list(keys)))


def agg_plan(aggs, keys=()):
    def make(mod, s):
        return mod.Declaration.from_sequence(
            [s, mod.Declaration(*aggregate(mod, aggs, keys))])
    return make


def test_grouped_agg_exact_ints(table):
    check(agg_plan([("i", "hash_sum", None, "s"),
                    ("i", "hash_min", None, "mn"),
                    ("i", "hash_max", None, "mx"),
                    ("i", "hash_count", None, "c"),
                    (None, "hash_count_all", None, "ca"),
                    ("b", "hash_any", None, "any_b"),
                    ("b", "hash_all", None, "all_b")], ["k"]),
          [table], 700)


def test_grouped_agg_floats_and_stats(table):
    check(agg_plan([("f", "hash_sum", None, "s"),
                    ("f", "hash_mean", None, "m"),
                    ("f", "hash_variance", None, "v"),
                    ("f", "hash_stddev", None, "sd")], ["k"]),
          [table], 700)


def test_grouped_first_last_one_min_max(table):
    check(agg_plan([("i", "hash_first", None, "fst"),
                    ("i", "hash_last", None, "lst"),
                    ("k", "hash_min_max", None, "k_mm"),
                    ("k", "hash_first", None, "k_first")], ["g"]),
          [table], 600)


def test_every_supported_aggregate_with_options(table):
    """Each name of ``_SUPPORTED_AGGS`` (``one`` and ``product`` over
    floats too), the count modes, first/last with ``skip_nulls=False``,
    ``min_count`` and ``ddof``."""
    aggs = [("f", "hash_product", None, "p"),
            ("i", "hash_one", None, "one"),
            ("i", "hash_count", {"mode": "only_null"}, "c_null"),
            ("i", "hash_count", {"mode": "all"}, "c_all"),
            ("i", "hash_first", {"skip_nulls": False}, "fst_n"),
            ("f", "hash_last", {"skip_nulls": False}, "lst_n"),
            ("f", "hash_min", None, "f_mn"),
            ("f", "hash_max", {"skip_nulls": False}, "f_mx"),
            ("i", "hash_sum", {"skip_nulls": False}, "s_n"),
            ("i", "hash_mean", {"min_count": 200}, "m_200"),
            ("f", "hash_variance", {"ddof": 1}, "v1"),
            ("b", "hash_any", {"min_count": 1}, "any1"),
            ("b", "hash_all", None, "all_b")]
    names = {a[1][5:] for a in aggs} | {"sum", "count_all", "min_max",
                                        "stddev", "max", "min", "last",
                                        "first", "count", "mean"}
    assert names >= chunked._SUPPORTED_AGGS
    check(agg_plan(aggs, ["g"]), [table], 900)


def test_two_key_groupby(table):
    check(agg_plan([("i", "hash_sum", None, "s"),
                    ("i", "hash_product", None, "p")], ["k", "g"]),
          [table], 900)


def test_scalar_agg_no_keys(table):
    check(agg_plan([("i", "sum", None, "s"), ("i", "min", None, "mn"),
                    ("i", "max", None, "mx"), ("i", "count", None, "c"),
                    (None, "count_all", None, "ca")]), [table], 512)


def test_filter_project_before_aggregate(table):
    def make(mod, s):
        return mod.Declaration.from_sequence([
            s,
            mod.Declaration("filter", mod.FilterNodeOptions(
                mod.field("g") > 3)),
            mod.Declaration("project", mod.ProjectNodeOptions(
                [mod.field("k"), mod.field("i"), mod.field("i") * 2],
                ["k", "i", "i2"])),
            mod.Declaration(*aggregate(mod, [
                ("i2", "hash_sum", None, "s"),
                ("i", "hash_count", None, "c")], ["k"]))])
    check(make, [table], 800)


def order_plan(keys, null_placement="at_end", fetch=None):
    def make(mod, s):
        nodes = [s, mod.Declaration("order_by", mod.OrderByNodeOptions(
            keys, null_placement=null_placement))]
        if fetch is not None:
            nodes.append(mod.Declaration("fetch",
                                         mod.FetchNodeOptions(*fetch)))
        return mod.Declaration.from_sequence(nodes)
    return make


def test_order_by_exact(table):
    check(order_plan([("g", "ascending"), ("i", "descending")]), [table],
          777)


def test_order_by_with_nulls_at_start(table):
    check(order_plan([("i", "ascending")], "at_start"), [table], 640)


def test_topk_device_resident(table):
    check(order_plan([("i", "descending"), ("g", "ascending")],
                     fetch=(0, 25)), [table], 1000)


def test_topk_with_offset(table):
    check(order_plan([("f", "ascending")], fetch=(10, 40)), [table], 1000)


def test_fetch_only(table):
    def make(mod, s):
        return mod.Declaration.from_sequence([
            s, mod.Declaration("filter", mod.FilterNodeOptions(
                mod.field("g") >= 2)),
            mod.Declaration("fetch", mod.FetchNodeOptions(100, 500))])
    check(make, [table], 600)


def test_fetch_past_the_end_gives_the_empty_schema(table):
    """A fetch whose offset passes every row gives the middle ops' columns,
    empty, as the reference's empty table does."""
    def make(mod, s):
        return mod.Declaration.from_sequence([
            s, mod.Declaration("filter", mod.FilterNodeOptions(
                mod.field("g") >= 2)),
            mod.Declaration("project", mod.ProjectNodeOptions(
                [mod.field("k"), mod.field("i") * 2], ["k", "i2"])),
            mod.Declaration("fetch", mod.FetchNodeOptions(10**6, 5))])
    t, b = table
    want = jchunked.maybe_execute_chunked(make(ja, src(ja, t)), 600)
    assert want.num_rows == 0
    got = maybe_execute_chunked(make(ta, src(ta, b)), 600,
                                "cpu").to_pydict()
    assert last_plan_metrics.source.n_chunks > 1
    assert got == {name: [] for name in want.schema.names} == \
        {"k": [], "i2": []}


def filter_project(mod, s):
    return mod.Declaration.from_sequence([
        s, mod.Declaration("filter", mod.FilterNodeOptions(
            mod.field("i") > 0)),
        mod.Declaration("project", mod.ProjectNodeOptions(
            [mod.field("k"), mod.field("i") + mod.field("g")],
            ["k", "ig"]))])


def test_passthrough_filter_project(table):
    check(filter_project, [table], 450)


@pytest.fixture(scope="module")
def join_sides():
    rng = np.random.default_rng(3)
    n = 4000
    left = at.table({"key": [int(v) for v in rng.integers(0, 300, n)],
                     "lv": [float(v) for v in rng.normal(size=n)]})
    right = at.table({"key": [int(v) for v in rng.integers(0, 200, 350)],
                      "rv": [int(v) for v in rng.integers(0, 9, 350)]})
    return [(t, carry_across(upload_table(t))) for t in (left, right)]


def _rows(out):
    return sorted(zip(*[[(v is None, 0 if v is None else v) for v in col]
                        for col in out.values()]))


@pytest.mark.parametrize("join_type", ["inner", "left outer", "left semi",
                                       "left anti"])
def test_streamed_probe_join(join_type, join_sides):
    def make(mod, left, right):
        return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
            join_type, left_keys=["key"], right_keys=["key"]),
            inputs=[left, right])
    jd = make(ja, *[src(ja, t) for t, _ in join_sides])
    want = jchunked.maybe_execute_chunked(jd, 512).to_pydict()
    td = make(ta, *[src(ta, b) for _, b in join_sides])
    got = maybe_execute_chunked(td, 512, "cpu").to_pydict()
    # chunk-major in both packages, in the same order
    assert_tables_match(got, want, RTOL)
    whole = td.to_table().to_pydict()
    assert list(got) == list(whole)
    assert _rows(got) == _rows(whole)


def test_join_then_aggregate():
    rng = np.random.default_rng(4)
    n = 3000
    left = at.table({"key": [int(v) for v in rng.integers(0, 50, n)],
                     "q": [int(v) for v in rng.integers(1, 100, n)]})
    right = at.table({"key": list(range(50)),
                      "grp": [f"g{i % 7}" for i in range(50)]})

    def make(mod, lsrc, rsrc):
        return mod.Declaration.from_sequence([
            mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
                "inner", left_keys=["key"], right_keys=["key"]),
                inputs=[lsrc, rsrc]),
            mod.Declaration(*aggregate(mod, [
                ("q", "hash_sum", None, "s"),
                (None, "hash_count_all", None, "n")], ["grp"]))])
    check(make, [(t, carry_across(upload_table(t))) for t in (left, right)],
          640)


def _distinct_keys(n=3000):
    t = at.table({"k": list(range(n)), "v": [1] * n})
    return t, carry_across(upload_table(t))


def test_state_overflow_raises(monkeypatch):
    t, b = _distinct_keys()
    monkeypatch.setenv("ARROW_TPU_STATE_ROWS", "256")
    plan = agg_plan([("v", "hash_sum", None, "s")], ["k"])
    with pytest.raises(Exception, match="state capacity"):
        jchunked.maybe_execute_chunked(plan(ja, src(ja, t)), 500)
    with pytest.raises(ValueError, match="exceeded the group-state "
                       r"capacity \(256\)"):
        maybe_execute_chunked(plan(ta, src(ta, b)), 500, "cpu")


def test_large_state_many_groups(monkeypatch):
    # more groups than one chunk holds, but within the state bound
    n = 6000
    rng = np.random.default_rng(7)
    t = at.table({"k": [int(v) for v in rng.integers(0, 1500, n)],
                  "v": [int(v) for v in rng.integers(0, 10, n)]})
    monkeypatch.setenv("ARROW_TPU_STATE_ROWS", "2048")
    check(agg_plan([("v", "hash_sum", None, "s")], ["k"]),
          [(t, carry_across(upload_table(t)))], 512)


def test_env_var_enables_chunking(monkeypatch):
    t = make_table(1200)
    b = carry_across(upload_table(t))
    plan = agg_plan([("i", "hash_sum", None, "s")], ["g"])
    jd, td = plan(ja, src(ja, t)), plan(ta, src(ta, b))
    monkeypatch.setenv("ARROW_TPU_CHUNK_ROWS", "300")
    want = jd.to_table().to_pydict()
    last_plan_metrics.reset()
    via_env = td.to_table(device="cpu").to_pydict()
    assert last_plan_metrics.source.n_chunks == 4
    monkeypatch.delenv("ARROW_TPU_CHUNK_ROWS")
    assert_tables_match(via_env, want, RTOL)
    assert_tables_match(via_env, td.to_table().to_pydict(), RTOL)


def test_single_chunk_falls_back():
    t = make_table(100)
    plan = agg_plan([("i", "hash_sum", None, "s")], ["g"])
    assert jchunked.maybe_execute_chunked(plan(ja, src(ja, t)), 1000) is None
    td = plan(ta, src(ta, carry_across(upload_table(t))))
    assert maybe_execute_chunked(td, 1000, "cpu") is None
    assert chunked.LAST_FALLBACK_REASON is None


# --- TPC-H shapes (the BASELINE configs that motivated chunking) -----------

SF = 0.005


@pytest.fixture(scope="module")
def tpch_tables():
    tables = {"customer": jtpch.customer_table(SF),
              "orders": jtpch.orders_table(SF),
              "lineitem": jtpch.lineitem_table(SF)}
    return {k: (t, carry_across(upload_table(t))) for k, t in tables.items()}


@pytest.mark.parametrize("query", ["q1", "q6"])
def test_q1_q6_chunked_matches_whole(query, tpch_tables):
    jd = getattr(jq, f"{query}_plan")(tpch_tables["lineitem"][0])
    td = getattr(tq, f"{query}_plan")(tpch_tables["lineitem"][1])
    want = jchunked.maybe_execute_chunked(jd, 8192).to_pydict()
    got = maybe_execute_chunked(td, 8192, "cpu")
    assert last_plan_metrics.source.n_chunks == 4
    assert_tables_match(got, want, RTOL)
    assert_tables_match(got, td.to_table().to_pydict(), RTOL)


def test_q3_chunked_matches_whole(tpch_tables):
    names = ("customer", "orders", "lineitem")
    jd = jq.q3_plan(*[tpch_tables[k][0] for k in names])
    td = tq.q3_plan(*[tpch_tables[k][1] for k in names])
    want = jchunked.maybe_execute_chunked(jd, 8192).to_pydict()
    got = td.to_table(chunk_rows=8192, device="cpu").to_pydict()
    assert chunked.LAST_FALLBACK_REASON is None
    assert last_plan_metrics.source.n_chunks == 4
    assert len(got["revenue"]) == 10
    assert_tables_match(got, want, RTOL)
    assert_tables_match(got, td.to_table().to_pydict(), RTOL)


class TestStreamingReader:
    """``Declaration.to_reader`` yields a RecordBatch a chunk for a
    terminal-free plan while the plan still runs (reference:
    DeclarationToReader)."""

    def test_streams_incrementally(self):
        rng = np.random.default_rng(0)
        n = 300_000
        t = at.table({"x": [int(v) for v in rng.integers(0, 1000, n)],
                      "y": rng.standard_normal(n)})

        def make(mod, s):
            return mod.Declaration.from_sequence([
                s, mod.Declaration("filter", mod.FilterNodeOptions(
                    mod.field("x") < 500)),
                mod.Declaration("project", mod.ProjectNodeOptions(
                    [mod.field("x"), mod.field("y") * 2.0], ["x", "y2"]))])
        want = [rb.to_pydict() for rb in
                make(ja, src(ja, t)).to_reader(chunk_rows=65536)]
        td = make(ta, src(ta, carry_across(upload_table(t))))
        reader = td.to_reader(chunk_rows=65536, device="cpu")
        first = next(reader)
        # the first batch comes before the source's later chunks are cut
        assert last_plan_metrics.source.n_chunks == 5
        got = [first] + list(reader)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert_tables_match(g, w, RTOL)
        assert_tables_match(TTable.from_batches(got),
                            td.to_table().to_pydict(), RTOL)

    def test_terminal_plans_fall_back(self):
        t = at.table({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
        plan = agg_plan([("v", "hash_sum", None, "s")], ["k"])
        want = list(plan(ja, src(ja, t)).to_reader())
        got = list(plan(ta, src(ta, carry_across(upload_table(t))))
                   .to_reader(device="cpu"))
        assert sum(b.num_rows for b in want) == 2
        assert len(got) == 1
        assert_tables_match(got[0], want[0].to_pydict(), RTOL)


# --- beyond the reference's cases ----------------------------------------

def _reasons():
    """(expected reason, plan maker, chunk_rows) for each reason a plan
    does not stream."""
    def over(*nodes):
        def make(mod, s, other):
            return mod.Declaration.from_sequence(
                [s] + [mod.Declaration(f, o(mod)) for f, o in nodes])
        return make

    def join(jt, **kw):
        def make(mod, s, other):
            return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
                jt, left_keys=["g"], right_keys=["g"], **kw),
                inputs=[s, other])
        return make

    def union(mod, s, other):
        return mod.Declaration("union", mod.UnionNodeOptions(),
                               inputs=[s, s])

    def order(mod):
        return mod.OrderByNodeOptions([("g", "ascending")])

    def flt(mod):
        return mod.FilterNodeOptions(mod.field("g") > 1)

    def agg(mod, fn="hash_sum", segment=False):
        kw = {"segment_keys": ["g"]} if segment else {"keys": ["g"]}
        return mod.AggregateNodeOptions([("i", fn, None, "x")], **kw)

    def residual(mod, s, other):
        return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
            "inner", left_keys=["g"], right_keys=["g"],
            output_suffix_for_right="_r",
            filter=mod.field("i") < mod.field("rv")), inputs=[s, other])

    return {
        "segmented aggregate": over(
            ("aggregate", lambda m: agg(m, segment=True))),
        "hashjoin type 'right outer'": join("right outer"),
        "hashjoin residual filter": residual,
        "unsupported node 'union'": union,
        "node 'filter' after terminal": over(("order_by", order),
                                             ("filter", flt)),
        "aggregate after terminal": over(("order_by", order),
                                         ("aggregate", agg)),
        "order_by after terminal": over(("order_by", order),
                                        ("order_by", order)),
        "fetch in unsupported position": over(
            ("fetch", lambda m: m.FetchNodeOptions(0, 10)),
            ("filter", flt)),
        "aggregate function set not chunkable": over(
            ("aggregate", lambda m: agg(m, "hash_count_distinct"))),
    }


REASONS = _reasons()


def _reason_plan(mod, reason, t, other):
    return REASONS[reason](mod, src(mod, t), src(mod, other))


@pytest.fixture(scope="module")
def small_sides():
    rng = np.random.default_rng(9)
    left = make_table(3000, seed=5)
    right = at.table({"g": list(range(11)),
                      "rv": [int(v) for v in rng.integers(-500, 500, 11)]})
    return [(t, carry_across(upload_table(t))) for t in (left, right)]


@pytest.mark.parametrize("reason", list(REASONS))
def test_fallback_warns_or_raises(reason, small_sides, monkeypatch):
    (jt, tt), (jo, to) = small_sides
    jchunked.maybe_execute_chunked(_reason_plan(ja, reason, jt, jo), 700)
    assert jchunked.LAST_FALLBACK_REASON == reason
    td = _reason_plan(ta, reason, tt, to)
    with pytest.warns(UserWarning, match="chunked execution unavailable"
                      rf" \({reason}\); falling back to whole-table upload"):
        got = td.to_table(chunk_rows=700, device="cpu").to_pydict()
    assert chunked.LAST_FALLBACK_REASON == reason
    assert_tables_match(got, td.to_table().to_pydict(), RTOL)
    monkeypatch.setenv("ARROW_TPU_REQUIRE_CHUNKED", "1")
    with pytest.raises(ValueError, match="chunked execution unavailable"):
        td.to_table(chunk_rows=700, device="cpu").to_pydict()


def test_merge_states_equals_one_state(table):
    """Two states, each over half of the chunks, merged: the state of one
    aggregate that consumed every chunk."""
    _, b = table
    opts = ta.AggregateNodeOptions([("f", "hash_sum", None, "s"),
                                    ("i", "hash_first", None, "fst"),
                                    ("i", "hash_last", None, "lst"),
                                    ("k", "hash_min_max", None, "mm"),
                                    (None, "hash_count_all", None, "n")],
                                   keys=["g", "k"])
    chunks = list(_ChunkSource(ta.TableSourceNodeOptions(b), 700,
                               torch.device("cpu")))
    one, left, right = (_ChunkedGroupBy(opts, _norm_aggs(opts), 2048)
                        for _ in range(3))
    for i, c in enumerate(chunks):
        one.consume(c)
        (left if i < 4 else right).consume(c)
    left.state = left.merge_states(left.state, right.state)
    merged, whole = download(left.finalize()), download(one.finalize())
    assert_tables_match(merged, whole, RTOL)


def test_partial_fields_name_the_state_layout(table):
    """``_partial_fields`` lists each aggregate's partial arrays in the
    state, with their storage dtypes."""
    from arrow_tpu_torch import dtypes
    _, b = table
    opts = ta.AggregateNodeOptions(
        [(t, f"hash_{f}", None, f"{f}_{t}") for f in sorted(
            chunked._SUPPORTED_AGGS) for t in ("i", "f", "b", "k")
         if f not in ("sum", "product", "mean", "variance", "stddev")
         or t in ("i", "f", "b")], keys=["g"])
    gb = _ChunkedGroupBy(opts, _norm_aggs(opts), 2048)
    gb.consume(next(iter(_ChunkSource(ta.TableSourceNodeOptions(b), 700,
                                      torch.device("cpu")))))
    fields = {f.name: c.values.dtype
              for f, c in zip(gb.state.schema.fields, gb.state.columns)}
    for a in gb.aggs:
        layout = chunked._partial_fields(a, a.vname)
        assert sorted(a.prefix + s for s, _ in layout) == \
            sorted(n for n in fields if n.startswith(a.prefix))
        assert all(fields[a.prefix + s] == dtypes.STORAGE[d]
                   for s, d in layout), a.fname


def test_chunk_source_shares_dictionaries_and_pads(table):
    _, b = table
    source = _ChunkSource(ta.TableSourceNodeOptions(b), 700,
                          torch.device("cpu"))
    assert (source.n_chunks, source.capacity) == (8, 1024)
    chunks = list(source)
    k = b.column("k")
    assert all(c.column("k").dictionary is k.dictionary for c in chunks)
    assert all(c.capacity == 1024 for c in chunks)
    assert [int(c.row_count) for c in chunks] == [700] * 7 + [100]
    last = chunks[-1]
    for name in b.schema.names:
        col, src_col = last.column(name), b.column(name)
        assert torch.equal(col.values[:100], src_col.values[4900:5000])
        assert not col.values[100:].any()
        if col.validity is not None:
            assert not col.validity[100:].any()
    # a full chunk inside the buffer is a view, not a copy
    assert chunks[0].column("g").values.data_ptr() == \
        b.column("g").values.data_ptr()


def test_host_source_refuses_the_cpu_unless_asked(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    _, b = table
    plan = filter_project(ta, src(ta, b))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan.to_table(chunk_rows=700).to_pydict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(plan.to_reader(chunk_rows=700))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan.to_batches(chunk_rows=700)


def test_to_batches_streams_as_to_table_does(table):
    """``to_batches`` takes ``to_table``'s ``chunk_rows`` and ``device``:
    the same streamed run, as one batch."""
    _, b = table
    plan = filter_project(ta, src(ta, b))
    batches = plan.to_batches(chunk_rows=700, device="cpu")
    assert last_plan_metrics.source.n_chunks == 8
    assert len(batches) == 1
    assert_tables_match(batches[0], plan.to_table(device="cpu").to_pydict(), RTOL)
    assert last_plan_metrics.source is None


def test_repeat_runs_give_the_same_bits(table):
    _, b = table
    td = agg_plan([("f", "hash_sum", None, "s"),
                   ("f", "hash_variance", None, "v")], ["k"])(ta, src(ta, b))
    first = maybe_execute_chunked(td, 700, "cpu").to_pydict()
    second = maybe_execute_chunked(td, 700, "cpu").to_pydict()
    for name in ("s", "v"):
        a = np.array([np.nan if x is None else x for x in first[name]])
        c = np.array([np.nan if x is None else x for x in second[name]])
        assert a.tobytes() == c.tobytes()


@pytest.mark.parametrize("module", ["acero/chunked.py",
                                    "acero/query_context.py", "cancel.py",
                                    "compute/options.py", "api.py", "sql.py",
                                    "gandiva.py", "substrait.py",
                                    "dataset.py", "errors.py",
                                    "io_streams.py", "fs.py", "feather.py",
                                    "io/feather_v1.py", "utils/lz4frame.py",
                                    "ipc/__init__.py", "ipc/fb.py",
                                    "ipc/schema_fb.py", "ipc/message.py",
                                    "ipc/reader_writer.py",
                                    "ipc/compat.py", "io/caching.py",
                                    "io/parquet/reader.py",
                                    "io/parquet/writer.py",
                                    "io/parquet/encryption.py",
                                    "utils/snappy.py",
                                    "utils/aes_ctypes.py", "io/csv.py",
                                    "io/csv_host.py", "io/json.py",
                                    "io/orc.py", "io/host_arrays.py",
                                    "array/validate.py",
                                    "array/builder.py", "pretty.py",
                                    "compare.py", "fs_s3.py", "fs_gcs.py",
                                    "fs_azure.py", "fs_hdfs.py",
                                    "utils/tdigest.py",
                                    "device/__init__.py", "extension.py",
                                    "compat_names.py", "c_data.py",
                                    "interchange.py", "tensor.py",
                                    "array/array.py", "table.py",
                                    "types.py"])
def test_new_modules_import_neither_jax_nor_the_reference(module):
    """fs.py imports fsspec only inside the fsspec adapters, when one is
    made (ImportError where fsspec is absent, as in the reference); a
    pandas method imports pandas when it is called, never at module
    level."""
    tree = ast.parse((REPO / "arrow_tpu_torch" / module).read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            top = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            top = [node.module or ""]
        else:
            continue
        assert "pandas" not in [n.split(".")[0] for n in top]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            if name == "fsspec" and module == "fs.py" and \
                    node not in tree.body:
                continue
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "arrow_tpu", "pyarrow", "flatbuffers",
                "fsspec", "cryptography"), name
