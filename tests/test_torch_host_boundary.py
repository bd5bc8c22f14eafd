"""The host boundary of the port (``device/column.py``'s upload and
download, ``io/tpch.py``'s host Tables, ``acero``'s host sources and
sinks, streaming from a host Table) against the JAX package on the same
inputs.

* ``upload_table``/``download_table`` against the reference's upload of
  the same Table, carried across by its buffers: codes, validity,
  dictionary values and their order, for strings with nulls,
  dictionaries, decimal128(38), fixed-size binary, list and struct
  passthrough (``tests/test_passthrough.py``'s cases);
* the eight TPC-H host Tables equal to the reference's, and their upload
  bit for bit the makers' DeviceBatches;
* the 22 TPC-H plans from host Tables at SF 0.005 against the reference's
  ``to_table()``, schema included;
* the source factories, ``consuming_sink`` and ``pivot_longer``
  (``tests/test_acero.py``'s and ``tests/test_pivot_casts.py``'s cases);
* a chunked run from a host Table against the reference's at the same
  ``chunk_rows``, every chunk sharing one dictionary a column;
* the card refused to be given up: without ``device="cpu"`` a host
  source, an upload and an eager call raise where there is no card.
"""

import decimal
import importlib

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu.acero as jacero
from arrow_tpu.acero import chunked as jchunked
from arrow_tpu.device.column import (download_table as j_download_table,
                                     upload_table as j_upload_table)
from arrow_tpu.io import tpch as jax_tpch
from arrow_tpu.io import tpch_queries as jax_queries
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.acero.chunked import _ChunkSource
from arrow_tpu_torch.acero.exec import last_plan_metrics
from arrow_tpu_torch.array.array import array
from arrow_tpu_torch.device.column import download_table, upload_table
from arrow_tpu_torch.io import tpch, tpch_queries

import test_torch_tpch_full
import test_torch_tpch_suite
from test_torch_host_table import carry_table, port_schema, port_type
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

ttable = importlib.import_module("arrow_tpu_torch.table")
SF = 0.005


# --- upload and download against the reference's ----------------------------

BIG = decimal.Decimal("12345678901234567890.123")


def _boundary_tables():
    """name -> reference Table, the cases of the boundary's
    representations."""
    rng = np.random.default_rng(5)
    words = ["b", "a", "", "ccc", "a"]
    strs = [None if rng.random() < 0.25 else words[i]
            for i in rng.integers(0, 5, 40)]
    return {
        "strings with nulls": at.table({
            "s": at.array(strs, at.string()),
            "ls": at.array(strs, at.large_string()),
            "b": at.array([None if v is None else v.encode() for v in strs],
                          at.binary())}),
        "all-null strings": at.table({"s": at.array([None] * 5,
                                                    at.string())}),
        "dictionary": at.table({"d": at.array(
            strs, at.dictionary(at.int32(), at.string()))}),
        "decimal128(38)": at.table({
            "d": at.array([BIG, decimal.Decimal("-1.5"), None, BIG],
                          at.decimal128(38, 3)),
            "i": at.array([1, 2, 3, 4])}),
        "decimal256(76)": at.table({"d": at.array(
            [decimal.Decimal(10) ** 50 + decimal.Decimal("0.25"), None,
             -(decimal.Decimal(10) ** 50)], at.decimal256(76, 2))}),
        "decimal128(12)": at.table({"d": at.array(
            [decimal.Decimal("-0.01"), None, decimal.Decimal("12.34")],
            at.decimal128(12, 2))}),
        "fixed-size binary": at.table({
            "f": at.array([b"abc", b"def", b"abc", None],
                          at.fixed_size_binary(3)),
            "v": at.array([1.0, 2.0, 3.0, 4.0])}),
        "list": at.table({"k": at.array([1, 2, 3]),
                          "v": at.array([[1, 2], [3], [4, 5]])}),
        "struct": at.table({"k": at.array([3, 1, 2]), "s": at.array(
            [{"a": 1}, {"a": 2}, None], at.struct([("a", at.int64())]))}),
        "map": at.table({"k": at.array([1, 2, 3]), "m": at.array(
            [[("x", 1)], [("y", 2)], [("z", 3)]],
            at.map_(at.string(), at.int64()))}),
        "numbers": at.table({
            "u": at.array([1, None, 2 ** 64 - 1], at.uint64()),
            "t": at.array([True, None, False]),
            "f": at.array([1.5, float("nan"), None], at.float32()),
            "ts": at.array([1, None, -5], at.timestamp("ns"))}),
    }


@pytest.mark.parametrize("case", list(_boundary_tables()))
def test_upload_matches_reference(case):
    ref = _boundary_tables()[case]
    want = j_upload_table(ref)
    got = upload_table(carry_table(ref), device="cpu")
    assert got.capacity == want.capacity
    assert int(got.row_count) == int(want.row_count)
    for f, g, w in zip(ref.schema, got.columns, want.columns):
        assert g.type == port_type(w.type), f.name
        np.testing.assert_array_equal(
            g.values.numpy().astype(np.int64) if g.values.dtype != torch.bool
            and g.values.is_floating_point() is False else g.values.numpy(),
            np.asarray(w.values).astype(np.int64)
            if not np.asarray(w.values).dtype.kind in "fb"
            else np.asarray(w.values), err_msg=f.name)
        assert (g.validity is None) == (w.validity is None), f.name
        if g.validity is not None:
            np.testing.assert_array_equal(g.validity.numpy(),
                                          np.asarray(w.validity))
        assert (g.dictionary is None) == (w.dictionary is None), f.name
        if g.dictionary is not None:
            gd = g.dictionary.to_pylist() if hasattr(
                g.dictionary, "to_pylist") else list(g.dictionary)
            assert repr(gd) == repr(w.dictionary.to_pylist()), f.name
    back = download_table(got)
    assert back.schema.equals(port_schema(ref.schema))
    assert repr(back.to_pydict()) == \
        repr(j_download_table(want).to_pydict()) == repr(ref.to_pydict())


@pytest.mark.parametrize("case", ["small blocks", "colliding hashes"])
def test_string_encoding_matches_reference(case, monkeypatch):
    """The string encoder's codes and dictionary against the reference's
    upload, with its blocks cut to a few rows each, or with a hash that
    maps many values to one code (the exact re-coding of shared
    hashes)."""
    from arrow_tpu_torch.device import column
    if case == "small blocks":
        monkeypatch.setattr(column, "_ENCODE_BLOCK_BYTES", 64)
    else:
        monkeypatch.setattr(column, "_row_hash",
                            lambda w: (w[:, 0] % 3).astype(np.uint64))
    rng = np.random.default_rng(11)
    alphabet = np.array(list("abcé\u4e2d"))
    words = ["".join(rng.choice(alphabet, k))
             for k in rng.integers(0, 20, 30)] + ["x" * 300, "", "ab", "ba"]
    strs = [None if rng.random() < 0.2 else words[i]
            for i in rng.integers(0, len(words), 400)]
    ref = at.table({"s": at.array(strs, at.string()),
                    "b": at.array([None if v is None else v.encode()
                                   for v in strs], at.binary())})
    want = j_upload_table(ref)
    got = upload_table(carry_table(ref), device="cpu")
    for g, w in zip(got.columns, want.columns):
        n = len(strs)
        np.testing.assert_array_equal(g.values.numpy()[:n],
                                      np.asarray(w.values)[:n])
        assert list(g.dictionary) == w.dictionary.to_pylist()


def test_passthrough_columns_ride_plans():
    """``tests/test_passthrough.py``'s cases: nested, fixed-size binary and
    wide decimal columns move through filter, sort, fetch and group-by as
    codes, and come back whole."""
    tables = _boundary_tables()

    def run(mod, t, *nodes, **kw):
        decl = mod.Declaration.from_sequence([mod.Declaration(
            "table_source", mod.TableSourceNodeOptions(t))] + [
            mod.Declaration(n, o) for n, o in nodes])
        return decl.to_table(**kw).to_pylist()

    for case, nodes in (
            ("list", [("filter", "k > 1")]),
            ("struct", [("order_by", [("k", "ascending")])]),
            ("map", [("fetch", (1, 2))]),
            ("decimal128(38)", [("filter", "i > 2")]),
            ("decimal128(38)", [("order_by", [("d", "ascending")])]),
            ("fixed-size binary", [("order_by", [("f", "descending")])]),
            ("fixed-size binary", [("aggregate", (["f"], "v"))])):
        ref = tables[case]
        outs = []
        for mod, t, kw in ((jacero, ref, {}),
                           (tacero, carry_table(ref), {"device": "cpu"})):
            opts = []
            for n, o in nodes:
                if n == "filter":
                    name, op, v = o.split()
                    opts.append((n, mod.FilterNodeOptions(
                        mod.field(name) > int(v))))
                elif n == "order_by":
                    opts.append((n, mod.OrderByNodeOptions(o)))
                elif n == "fetch":
                    opts.append((n, mod.FetchNodeOptions(*o)))
                else:
                    opts.append((n, mod.AggregateNodeOptions(
                        [(o[1], "hash_sum", None, "s")], keys=o[0])))
            outs.append(run(mod, t, *opts, **kw))
        assert repr(outs[0]) == repr(outs[1]), case


# --- the TPC-H host Tables ---------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    """(the reference's tables, the port's host Tables, the port's device
    batches) at SF 0.005."""
    return (jax_tpch.generate(SF), tpch.generate_host(SF),
            tpch.generate(SF, device="cpu"))


@pytest.mark.parametrize("name", tpch.TABLES)
def test_host_tables_match_reference_and_makers(name, tables):
    jt, ht, bt = tables
    assert ht[name].schema.equals(port_schema(jt[name].schema))
    assert ht[name].to_pydict() == jt[name].to_pydict()
    up = upload_table(ht[name], device="cpu")
    made = bt[name]
    assert up.schema.names == made.schema.names
    assert (up.capacity, int(up.row_count)) == \
        (made.capacity, int(made.row_count))
    for f, a, b in zip(made.schema.fields, up.columns, made.columns):
        assert a.type == b.type, f.name
        assert a.values.dtype == b.values.dtype, f.name
        assert torch.equal(a.values, b.values), f.name
        assert (a.validity is None) == (b.validity is None), f.name
        assert a.dictionary == b.dictionary, f.name


def _plan_args():
    """plan -> (its tables in argument order, its parameters)."""
    out = {"q1_plan": (("lineitem",), None),
           "q3_plan": (("customer", "orders", "lineitem"), None),
           "q4_plan": (("orders", "lineitem"), None),
           "q13_plan": (("customer", "orders"), None)}
    out.update({q: (names, None) for q, names in
                test_torch_tpch_suite.QUERIES.items()})
    out.update(test_torch_tpch_full.QUERIES)
    return out


PLANS = _plan_args()


def test_all_22_plans_are_held():
    assert len(PLANS) == 22


@pytest.mark.parametrize("query", list(PLANS))
def test_plan_from_host_tables_matches_reference(query, tables):
    jt, ht, bt = tables
    names, params = PLANS[query]
    kw = params(bt) if params else {}
    want = getattr(jax_queries, query)(*(jt[k] for k in names),
                                       **kw).to_table()
    got = getattr(tpch_queries, query)(*(ht[k] for k in names),
                                       **kw).to_table(device="cpu")
    assert isinstance(got, ttable.Table)
    assert got.schema.equals(port_schema(want.schema)), query
    assert_tables_match(got, want.to_pydict())


def test_a_source_is_uploaded_once(tables):
    """A repeated run reuses the upload kept a column: the same tensors
    and dictionaries."""
    _, ht, _ = tables
    opts = tacero.TableSourceNodeOptions(ht["orders"])
    first = opts.upload("cpu")
    assert all(a is b for a, b in zip(first.columns,
                                      opts.upload("cpu").columns))
    other = tacero.TableSourceNodeOptions(ht["orders"]).upload("cpu")
    assert all(a is b for a, b in zip(first.columns, other.columns))
    narrowed = opts.select(["o_orderkey", "o_orderstatus"]).upload("cpu")
    assert narrowed.column("o_orderstatus") is first.column("o_orderstatus")


def test_release_uploads_frees_a_tables_columns():
    """``release_uploads`` drops a Table's cached uploads (the next source
    uploads anew, with equal values), and a dropped Table's entries go
    with it."""
    import gc
    import weakref
    from arrow_tpu_torch.acero import source_cache
    tbl = ttable.table({"s": ["b", None, "a", "b"], "x": [1, 2, 3, 4]})
    first = tacero.TableSourceNodeOptions(tbl).upload("cpu")
    assert all(c in source_cache._uploads for c in tbl.columns)
    tacero.release_uploads(tbl)
    assert not any(c in m for c in tbl.columns
                   for m in (source_cache._prepared, source_cache._uploads))
    again = tacero.TableSourceNodeOptions(tbl).upload("cpu")
    for a, b in zip(first.columns, again.columns):
        assert a is not b and torch.equal(a.values, b.values)
        assert a.dictionary == b.dictionary
    refs = [weakref.ref(c) for c in tbl.columns]
    del tbl, first, again
    gc.collect()
    assert all(r() is None for r in refs)


# --- source factories, sinks, pivot_longer -------------------------------------

_FACTORIES = ("table_source", "source", "record_batch_source",
              "exec_batch_source", "array_vector_source", "named_table")


@pytest.mark.parametrize("factory", _FACTORIES)
def test_source_factories_match_reference(factory):
    t = at.table({"x": [1, 2, 3, 4], "s": ["a", None, "b", "a"]})
    outs = []
    for mod, tbl, kw in ((jacero, t, {}),
                         (tacero, carry_table(t), {"device": "cpu"})):
        src = mod.TableSourceNodeOptions(tbl if factory != "record_batch_source"
                                         else tbl.to_batches()[0])
        outs.append(mod.Declaration("filter", mod.FilterNodeOptions(
            mod.field("x") > 1), [mod.Declaration(factory, src)]).to_table(
                **kw).to_pydict())
    assert outs[0] == outs[1] == {"x": [2, 3, 4], "s": [None, "b", "a"]}


def test_record_batch_reader_source_matches_reference():
    """``tests/test_acero.py``'s case, over batches with strings and
    nulls: the reference's result; the port's reader is drained once, so
    a second run gives the same."""
    t = at.table({"x": [1, 2, 3, 4, 5], "s": ["a", None, "b", "a", None]})
    outs = []
    for mod, tmod, tbl, kw in ((jacero, at, t, {}),
                               (tacero, ttable, carry_table(t),
                                {"device": "cpu"})):
        reader = tmod.RecordBatchReader.from_batches(tbl.schema,
                                                     tbl.to_batches(2))
        d = mod.Declaration("filter", mod.FilterNodeOptions(
            mod.field("x") > 1), [mod.Declaration(
                "record_batch_reader_source",
                mod.RecordBatchReaderSourceNodeOptions(reader))])
        outs.append(d.to_table(**kw).to_pydict())
    assert outs[0] == outs[1] == {"x": [2, 3, 4, 5],
                                  "s": [None, "b", "a", None]}
    assert d.to_table(device="cpu").to_pydict() == outs[1]


def _sink_outputs(mod, tbl, **kw):
    """``tests/test_acero.py``'s sink plans, each output as a pydict; the
    consuming sink's batches joined, then "finished"."""
    src = mod.Declaration("table_source", mod.TableSourceNodeOptions(tbl))
    outs = {}
    for name, opts in (
            ("sink", mod.SinkNodeOptions()),
            ("table_sink", mod.SinkNodeOptions()),
            ("order_by_sink", mod.OrderBySinkNodeOptions(
                [("k", "descending")])),
            ("select_k_sink", mod.SelectKSinkNodeOptions(
                3, [("k", "ascending")]))):
        outs[name] = mod.Declaration.from_sequence(
            [src, mod.Declaration(name, opts)]).to_table(**kw).to_pydict()
    seen = []

    class Consumer:
        def __call__(self, rb):
            seen.append(rb.to_pydict())

        def finish(self):
            seen.append("finished")

    mod.Declaration.from_sequence([src, mod.Declaration(
        "consuming_sink", mod.ConsumingSinkNodeOptions(Consumer()))]
    ).to_table(**kw)
    assert seen[-1] == "finished"
    outs["consuming_sink"] = {k: sum((b[k] for b in seen[:-1]), [])
                              for k in tbl.column_names}
    return outs


def test_sink_family_matches_reference():
    """``tests/test_acero.py``'s sink cases, through both packages."""
    t = at.table({"k": [3, 1, 2, 5, 4], "v": [1., 2., 3., 4., 5.]})
    want = _sink_outputs(jacero, t)
    assert _sink_outputs(tacero, carry_table(t), device="cpu") == want
    assert want["order_by_sink"]["k"] == [5, 4, 3, 2, 1]
    assert want["select_k_sink"]["k"] == [1, 2, 3]


@pytest.mark.parametrize("case", ["basic", "null measurements"])
def test_pivot_longer_matches_reference(case):
    """``tests/test_pivot_casts.py``'s cases."""
    if case == "basic":
        data = {"time": [1, 2], "left_temp": [10, 15], "right_temp": [20, 18]}
        args = ([(["left"], ["left_temp"]), (["right"], ["right_temp"])],
                ["location"], ["temp"])
    else:
        data = {"time": [0], "ax1": [1], "ay1": [2], "bx1": [3], "ay2": [4]}
        args = ([(["a", "x"], ["ax1", None]), (["a", "y"], ["ay1", "ay2"]),
                 (["b", "x"], ["bx1", None])], ["a/b", "x/y"], ["f1", "f2"])
    t = at.table(data)
    outs = []
    for mod, tbl, kw in ((jacero, t, {}),
                         (tacero, carry_table(t), {"device": "cpu"})):
        r = mod.Declaration("pivot_longer", mod.PivotLongerNodeOptions(
            *args), [mod.Declaration("table_source",
                                     mod.TableSourceNodeOptions(tbl))]
                            ).to_table(**kw)
        outs.append((r.column_names, r.to_pydict()))
    assert outs[0] == outs[1]


# --- streaming from a host Table ------------------------------------------------

@pytest.mark.parametrize("query", ["q1_plan", "q6_plan"])
def test_chunked_run_from_a_host_table_matches_reference(query, tables):
    jt, ht, _ = tables
    rows = 4096
    want = jchunked.maybe_execute_chunked(
        getattr(jax_queries, query)(jt["lineitem"]), rows).to_pydict()
    plan = getattr(tpch_queries, query)(ht["lineitem"])
    got = plan.to_table(chunk_rows=rows, device="cpu")
    assert last_plan_metrics.source.n_chunks == -(-ht["lineitem"].num_rows
                                                  // rows)
    assert_tables_match(got, want)
    whole = getattr(tpch_queries, query)(ht["lineitem"]).to_table(
        device="cpu")
    assert_tables_match(got, whole.to_pydict())


def test_chunks_share_one_dictionary(tables):
    _, ht, _ = tables
    opts = tacero.TableSourceNodeOptions(ht["lineitem"])
    chunks = list(_ChunkSource(opts, 5000, torch.device("cpu")))
    assert len(chunks) == 7
    for name in ("l_returnflag", "l_shipmode"):
        first = chunks[0].column(name).dictionary
        assert all(c.column(name).dictionary is first for c in chunks)
    assert sum(int(c.row_count) for c in chunks) == ht["lineitem"].num_rows


def test_to_reader_and_to_batches_give_record_batches(tables):
    _, ht, _ = tables
    plan = tacero.Declaration.from_sequence([
        tacero.Declaration("table_source",
                           tacero.TableSourceNodeOptions(ht["orders"])),
        tacero.Declaration("filter", tacero.FilterNodeOptions(
            tacero.field("o_totalprice") > 100000.0))])
    whole = plan.to_table(device="cpu")
    batches = list(plan.to_reader(chunk_rows=2000, device="cpu"))
    assert len(batches) == 4
    assert all(isinstance(b, ttable.RecordBatch) for b in batches)
    assert ttable.Table.from_batches(batches).to_pydict() == \
        whole.to_pydict()
    assert [b.to_pydict() for b in plan.to_batches(device="cpu")] == \
        [whole.to_pydict()]


# --- the card is the default ------------------------------------------------

def test_the_cpu_is_refused_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    import arrow_tpu_torch.compute as pc
    t = ttable.table({"x": [1, 2, 3]})
    plan = tacero.Declaration("table_source",
                              tacero.TableSourceNodeOptions(t))
    for run in (plan.to_table, lambda: plan.to_table(chunk_rows=2),
                lambda: upload_table(t),
                lambda: pc.filter(array([1, 2]), array([True, False])),
                lambda: pc.add(array([1]), 1),
                lambda: t.filter(array([True, False, True])),
                lambda: t.group_by("x").aggregate([("x", "sum")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    assert plan.to_table(device="cpu").to_pydict() == {"x": [1, 2, 3]}


def test_chip_smoke_phase_3l_on_cpu():
    """``chip_smoke.py``'s phase 3l at SF 0.005 on the CPU: every path
    against its oracle and the makers' batches (no launches here)."""
    import chip_smoke
    launches, host = chip_smoke.phase_host(sf=SF, device="cpu")
    assert launches == {} and set(host) == {
        "lineitem", "orders", "customer", "part", "supplier", "partsupp",
        "nation", "region"}


def test_chip_smoke_phase_3m_on_cpu():
    """``chip_smoke.py``'s phase 3m over phase 3l's Tables at SF 0.005 on
    the CPU: every path against its numpy or Python oracle (no launches
    here)."""
    import chip_smoke
    _, host = chip_smoke.phase_host(sf=SF, device="cpu")
    launches, nested = chip_smoke.phase_host_tier(host, device="cpu")
    assert launches == {}
    assert len(nested["list<double>"]) == host["orders"].num_rows
