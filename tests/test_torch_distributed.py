"""The port's distribution (``arrow_tpu_torch/parallel``,
``acero/dist_exec.py``) against the JAX package's.

The port runs in four gloo ranks on the CPU (``torch_dist_ranks.Ranks``,
spawned once for the module), a few cases also on three (ragged shards);
the reference runs in this process on ``make_mesh(4)`` (``make_mesh(3)``)
of ``tests/conftest.py``'s eight CPU devices. Both get the same tables,
made from a seed with numpy (the reference's tests' tables). Keys, counts,
validity and row order are exact, floats within rtol 1e-9; every rank
holds the same result; each case gives the same float bits on a second
run; ``EXCHANGE_COUNTS`` equal the reference's on every plan case, so a
plan that silently ran locally fails. The cases are the reference's
``tests/test_parallel.py``, ``test_distributed_plan.py`` and
``test_dist_join_types.py``. Where the reference leaves a low-level
join's rows in its devices' order (for its caller to restore), the port's
come in the single-rank order: they are held against the reference's
local join in order and against its distributed join as sorted rows.
"""

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu.acero as jacero
from arrow_tpu.acero import dist_exec as jdist
from arrow_tpu.device.column import upload_table
from arrow_tpu.parallel import distributed as jpar
from arrow_tpu.types import TypeId
from arrow_tpu_torch.parallel import distributed as tpar

from test_torch_q1 import assert_tables_match
from torch_dist_ranks import PLANS, RAGGED, WORLD, Ranks
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

_TYPE_NAMES = {TypeId.BOOL: "bool", TypeId.INT32: "int32",
               TypeId.INT64: "int64", TypeId.DOUBLE: "float64",
               TypeId.DATE32: "date32", TypeId.DICTIONARY: "dictionary",
               TypeId.STRING: "string"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(str(tmp_path_factory.mktemp("ranks")), WORLD)
    yield r
    r.close()


_MESHES = {}


def mesh(size=WORLD):
    if size not in _MESHES:
        _MESHES[size] = jpar.make_mesh(size)
    return _MESHES[size]


def spec(table):
    """A reference Table as the ranks' column spec: its upload's values,
    validity and dictionary, as numpy."""
    b = upload_table(table)
    return ([(f.name, _TYPE_NAMES[f.type.id], np.asarray(c.values),
              None if c.validity is None else np.asarray(c.validity),
              None if c.dictionary is None else c.dictionary.to_pylist())
             for f, c in zip(b.schema.fields, b.columns)],
            int(b.row_count))


def agreed(results, key="result"):
    """Rank 0's result, after checking every rank holds the same and each
    repeated its bits."""
    first = results[0][key]
    for r in results:
        assert r[key] == first or _same_bits(r[key], first)
        assert r.get("repeat", True), "a second run gave other float bits"
    return first


def _same_bits(a, b):
    return {k: [repr(v) for v in c] for k, c in a.items()} == \
        {k: [repr(v) for v in c] for k, c in b.items()}


def _sorted_rows(d, names=None):
    names = names or list(d)
    return sorted(zip(*(d[n] for n in names)),
                  key=lambda r: tuple((v is None, v if v is not None else 0)
                                      for v in r))


# --- tables of the reference's tests -----------------------------------------

def plan_table(n=6000, seed=1):
    """``test_distributed_plan.py``'s ``make_table``."""
    rng = np.random.default_rng(seed)
    return at.table({
        "k": [f"k{int(v)}" for v in rng.integers(0, 29, n)],
        "g": [int(v) for v in rng.integers(0, 13, n)],
        "i": [None if m else int(v) for m, v in
              zip(rng.random(n) < 0.07, rng.integers(-500, 500, n))],
        "f": [None if m else float(v) for m, v in
              zip(rng.random(n) < 0.07, rng.normal(size=n))],
    })


def join_type_tables(seed=7, nl=403, nr=211):
    """``test_dist_join_types.py``'s ``_tables``."""
    rng = np.random.default_rng(seed)
    lkey = rng.integers(0, 60, nl)
    rkey = rng.integers(20, 90, nr)
    left = at.table({
        "k": at.array(lkey.astype(np.int64)),
        "lx": at.array(rng.normal(size=nl)),
        "tag": at.array([f"l{i % 11}" for i in range(nl)]),
    })
    right = at.table({
        "k": at.array(rkey.astype(np.int64)),
        "ry": at.array(rng.normal(size=nr)),
    })
    return left, right


def null_key_tables():
    left = at.table({
        "k": at.array([1, None, 2, None, 3, 2], at.int64()),
        "v": at.array([10.0, 20.0, 30.0, 40.0, 50.0, 60.0]),
    })
    right = at.table({
        "k": at.array([2, None, 3, 4], at.int64()),
        "w": at.array([1.5, 2.5, 3.5, 4.5]),
    })
    return left, right


def keyed_tables(seed, n, n_keys, n_build, build_keys, v_range=True):
    rng = np.random.default_rng(seed)
    left = at.table({"key": [int(v) for v in rng.integers(0, n_keys, n)],
                     "v": list(range(n)) if v_range else
                     [int(v) for v in rng.integers(0, 50, n)]})
    if build_keys == "unique":
        bk = list(range(n_build))
    else:
        bk = [int(v) for v in rng.integers(0, build_keys, n_build)]
    right = at.table({"key": bk, "w": list(range(n_build)) if v_range
                      else [i % 5 for i in range(n_build)]})
    return left, right


# --- the partition hash ------------------------------------------------------

@pytest.mark.parametrize("n_parts", [2, 3, 4, 7, 8])
def test_partition_ids_bit_exact(n_parts):
    """The splitmix64 partition of one and two key words, bit for bit with
    the reference's, over words at and above 2**63 and both null words."""
    import jax.numpy as jnp
    rng = np.random.default_rng(n_parts)
    words = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    words[:8] = [0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1,
                 tpar.NULL_GROUP_WORD, tpar.NULL_JOIN_WORD % 2**64]
    other = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    for ws in ([words], [words, other]):
        want = np.asarray(jpar.partition_ids([jnp.asarray(w) for w in ws],
                                             n_parts))
        got = tpar.partition_ids([torch.from_numpy(w.view(np.int64))
                                  for w in ws], n_parts).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# --- shards and the exchange -------------------------------------------------

@pytest.mark.parametrize("size", [WORLD, RAGGED])
def test_shard_round_trip(ranks, size):
    """Each rank's range is the reference's shard of the same table, and
    the ranks' parts gathered give the table back."""
    t = plan_table(1001, seed=2)
    out = ranks.run("shard_case", spec(t), size=size)
    counts = np.asarray(jpar.shard_table(mesh(size), t).row_count).tolist()
    assert [o["range"][1] for o in out] == counts
    assert [o["range"][0] for o in out] == [sum(counts[:r])
                                            for r in range(size)]
    for o in out:
        assert o["back"] == t.to_pydict()


@pytest.mark.parametrize("size", [WORLD, RAGGED])
def test_device_shards_are_slices(size):
    """A rank's shard made on the device by row range is bit for bit its
    slice of the whole table (lineitem and Q3's three tables)."""
    from arrow_tpu_torch.io.tpch_device import (q1_device_batch,
                                                q3_device_tables, shard_rows)
    whole = {"lineitem15": q1_device_batch(0.002, device="cpu"),
             **q3_device_tables(0.002, device="cpu")}
    for r in range(size):
        parts = {"lineitem15": q1_device_batch(
            0.002, device="cpu", rows=shard_rows(whole["lineitem15"][1], r,
                                                 size)),
            **q3_device_tables(0.002, device="cpu", shard=(r, size))}
        for name, (part, n) in parts.items():
            batch, n_whole = whole[name]
            start, stop = shard_rows(n_whole, r, size)
            assert n == n_whole and int(part.row_count) == stop - start
            for a, b in zip(part.columns, batch.columns):
                assert a.dictionary == b.dictionary
                assert torch.equal(a.values[:stop - start],
                                   b.values[start:stop])


def test_exchange_rows_order(ranks):
    """Every row reaches the rank its id names, ordered by source rank and
    then in source order; validity and dictionaries survive the packing."""
    t = plan_table(3001, seed=3)
    out = ranks.run("exchange_case", spec(t), "g")
    rows = t.to_pydict()
    for r, got in enumerate(out):
        idx = [i for i in range(t.num_rows) if rows["g"][i] % WORLD == r]
        assert got == {k: [v[i] for i in idx] for k, v in rows.items()}


# --- grouped aggregation -----------------------------------------------------

def _groupby_tables():
    rng = np.random.default_rng(0)
    n = 5000
    floats = at.table({
        "k": [f"g{int(v)}" for v in rng.integers(0, 37, n)],
        "v": [None if m else float(v) for m, v in
              zip(rng.random(n) < 0.1, rng.normal(size=n))],
    })
    rng = np.random.default_rng(1)
    n = 2000
    multikey = at.table({
        "a": [None if m else int(v) for m, v in
              zip(rng.random(n) < 0.05, rng.integers(0, 5, n))],
        "b": [f"s{int(v)}" for v in rng.integers(0, 4, n)],
        "v": [float(v) for v in rng.normal(size=n)],
    })
    return {
        "string_keys": (floats, ["k"], [("v", "sum", "v_sum"),
                                        ("v", "mean", "v_mean"),
                                        ("v", "count", "v_count"),
                                        ("v", "min", "v_min"),
                                        ("v", "max", "v_max")]),
        "multikey_nulls": (multikey, ["a", "b"], [("v", "count", "n"),
                                                  ("v", "sum", "s")]),
    }


@pytest.mark.parametrize("size", [WORLD, RAGGED])
@pytest.mark.parametrize("case", ["string_keys", "multikey_nulls"])
def test_distributed_groupby(ranks, case, size):
    t, keys, aggs = _groupby_tables()[case]
    want = jpar.distributed_groupby(
        mesh(size), jpar.shard_table(mesh(size), t), keys,
        [jpar.DistAggSpec(*a) for a in aggs]).to_pydict()
    got = agreed(ranks.run("call_case", "distributed_groupby", [spec(t)],
                           (keys, [tpar.DistAggSpec(*a) for a in aggs]),
                           size=size))
    assert_tables_match(got, want)


def test_distributed_q1(ranks):
    from arrow_tpu.io import tpch, tpch_queries
    li = tpch.lineitem_table(0.002)
    want = jpar.distributed_q1(mesh(), li).to_pydict()
    got = agreed(ranks.run("call_case", "distributed_q1", [spec(li)]))
    assert_tables_match(got, want)
    assert_tables_match(got, tpch_queries.q1_plan(li).to_table().to_pydict())


# --- joins, sort, broadcast, salting -----------------------------------------

def _local_join(left, right, lk, rk, jt):
    """The reference's single-device join with the low-level functions'
    output naming."""
    return jacero.Declaration("hashjoin", jacero.HashJoinNodeOptions(
        jt, left_keys=lk, right_keys=rk, output_suffix_for_left="_l",
        output_suffix_for_right="_r"), inputs=[
            jacero.Declaration("table_source",
                               jacero.TableSourceNodeOptions(t))
            for t in (left, right)]).to_table().to_pydict()


def _join_inputs(case):
    if case == "int_keys":
        return keyed_tables(5, 900, 50, 60, "unique"), ["key"]
    if case == "string_keys":
        return (at.table({"k": [f"x{i % 11}" for i in range(300)],
                          "lv": list(range(300))}),
                at.table({"k": [f"x{i}" for i in range(11)],
                          "rv": list(range(11))})), ["k"]
    return join_type_tables(seed=11), ["k"]


@pytest.mark.parametrize("case,jt", [("int_keys", "inner"),
                                     ("string_keys", "inner"),
                                     ("duplicates", "full outer"),
                                     ("duplicates", "right anti")])
def test_distributed_join_batches(ranks, case, jt):
    (left, right), keys = _join_inputs(case)
    got = agreed(ranks.run("call_case", "distributed_join_batches",
                           [spec(left), spec(right)], (keys, keys, jt)))
    assert_tables_match(got, _local_join(left, right, keys, keys, jt))
    ref = jpar.distributed_join_tables(mesh(), left, right, keys, keys,
                                       jt).to_pydict()
    assert list(got) == list(ref)
    assert _sorted_rows(got) == _sorted_rows(ref)


def test_distributed_join_with_pre_fns(ranks):
    """``left_pre_fns`` (the executor's lowered filter) run on each rank's
    probe rows before the exchange: the reference's single-device join of
    the filtered probe side, in order."""
    left, right = join_type_tables(seed=9)
    got = agreed(ranks.run("pre_fns_case", spec(left), spec(right)))
    filtered = jacero.Declaration.from_sequence([
        jacero.Declaration("table_source",
                           jacero.TableSourceNodeOptions(left)),
        jacero.Declaration("filter", jacero.FilterNodeOptions(
            jacero.field("lx") > 0.0))]).to_table()
    assert_tables_match(got, _local_join(filtered, right, ["k"], ["k"],
                                         "inner"))


@pytest.mark.parametrize("size", [WORLD, RAGGED])
@pytest.mark.parametrize("placement", ["at_end", "at_start"])
def test_distributed_sort_batch(ranks, placement, size):
    """Two keys, nulls and ties: the reference's order exactly (each
    device's rows arrive by source device, so ties keep the input
    order)."""
    t = plan_table(2500, seed=4)
    keys = [("f", "descending"), ("g", "ascending")]
    want = jpar.distributed_sort_table(mesh(size), t, keys,
                                       null_placement=placement).to_pydict()
    got = agreed(ranks.run("call_case", "distributed_sort_batch", [spec(t)],
                           (keys, placement), size=size))
    assert_tables_match(got, want)


def test_distributed_sort_by_dictionary(ranks):
    """A string key sorts by value on every rank (ranked dictionary), as
    the reference's plan does."""
    t = plan_table(2500, seed=5)
    keys = [("k", "ascending"), ("i", "descending")]
    want = jacero.Declaration.from_sequence([
        jacero.Declaration("table_source", jacero.TableSourceNodeOptions(t)),
        jacero.Declaration("order_by", jacero.OrderByNodeOptions(keys)),
    ]).to_table().to_pydict()
    got = agreed(ranks.run("call_case", "distributed_sort_batch", [spec(t)],
                           (keys,)))
    assert_tables_match(got, want)


def test_broadcast_join(ranks):
    rng = np.random.default_rng(4)
    keys = [7 if v < 90 else int(v) for v in rng.integers(0, 100, 1500)]
    left = at.table({"key": keys, "lv": list(range(1500))})
    right = at.table({"key": list(range(100)),
                      "rv": [i * 10 for i in range(100)]})
    want = jpar.broadcast_join_tables(mesh(), left, right, ["key"], ["key"],
                                      "inner").to_pydict()
    got = agreed(ranks.run("call_case", "broadcast_join_batches",
                           [spec(left), spec(right)], (["key"], ["key"])))
    assert_tables_match(got, want)


def test_salted_join(ranks):
    """The reference's skewed join: one key holds about half the probe
    rows. The salted join gives the plain join's rows, in the plain join's
    order; the reference's rows match as a set (its output keeps the
    suffixed salt columns, the port drops them); salting takes the hot
    key's rows off one rank."""
    rng = np.random.default_rng(3)
    n = 2000
    keys = np.where(rng.random(n) < 0.5, 7, rng.integers(0, 100, n))
    left = at.table({"k": at.array(keys.astype(np.int64)),
                     "v": at.array(np.arange(n, dtype=np.int64))})
    right = at.table({"k": at.array(np.arange(100, dtype=np.int64)),
                      "w": at.array(np.arange(100, dtype=np.float64))})
    specs = [spec(left), spec(right)]
    plain = ranks.run("call_case", "distributed_join_batches", specs,
                      (["k"], ["k"]))
    salted = ranks.run("call_case", "salted_join_batches", specs,
                       (["k"], ["k"]),
                       kwargs={"hot_threshold": 200, "n_salts": 8})
    got = agreed(salted)
    assert got == agreed(plain)
    ref = jpar.salted_join_tables(mesh(), left, right, ["k"], ["k"],
                                  hot_threshold=200, n_salts=8).to_pydict()
    names = ["k_l", "v", "k_r", "w"]
    assert [n for n in ref if not n.startswith("__salt__")] == list(got)
    assert _sorted_rows(got, names) == _sorted_rows(ref, names)
    hot_share = max(p["received"] for p in plain) / n
    salted_share = max(p["received"] for p in salted) / n
    assert hot_share >= 0.5 > salted_share


# --- the Table-level entry points ---------------------------------------------

def blob(table):
    """A reference Table as IPC stream bytes, which the ranks read with the
    port's ``ipc``."""
    from arrow_tpu import ipc
    return ipc.serialize_table(table)


def table_run(ranks, fn, tables, *args, size=WORLD, **kwargs):
    """``parallel.<fn>`` over host Tables on every rank: rank 0's result
    and schema, after checking that every rank holds the same and
    repeated its bits."""
    out = ranks.run("table_case", fn, [blob(t) for t in tables], args,
                    kwargs, size=size)
    for r in out:
        assert r["schema"] == out[0]["schema"]
    return agreed(out), out[0]["schema"], out


@pytest.mark.parametrize("size", [WORLD, RAGGED])
def test_shard_table(ranks, size):
    """Each rank uploads its range of a host Table, the reference's shard
    of it; the string column's dictionary is the same on every rank."""
    t = plan_table(1001, seed=2)
    out = ranks.run("table_case", "shard_table", [blob(t)], size=size)
    counts = np.asarray(jpar.shard_table(mesh(size), t).row_count).tolist()
    assert [o["range"][1] for o in out] == counts
    assert [o["range"][0] for o in out] == [sum(counts[:r])
                                            for r in range(size)]
    assert {o["range"][2] for o in out} == {t.num_rows}
    whole = t.to_pydict()
    for o in out:
        start, n, _ = o["range"]
        assert o["result"] == {k: v[start:start + n]
                               for k, v in whole.items()}


@pytest.mark.parametrize("size", [WORLD, RAGGED])
@pytest.mark.parametrize("jt", tpar.JOIN_TYPES)
def test_distributed_join_tables(ranks, jt, size):
    """All eight join types of two host Tables with duplicate keys on both
    sides and a string column: the reference's columns, names and types;
    its rows as sorted rows (it leaves them in its devices' order), and
    the reference's single-device join's rows in order."""
    left, right = join_type_tables(seed=13)
    got, schema, _ = table_run(ranks, "distributed_join_tables",
                               [left, right], ["k"], ["k"], jt, size=size)
    ref = jpar.distributed_join_tables(mesh(size), left, right, ["k"],
                                       ["k"], jt)
    assert [n for n, _ in schema] == ref.schema.names
    assert [t for _, t in schema] == [repr(_port_type(f.type))
                                      for f in ref.schema.fields]
    want = ref.to_pydict()
    assert _sorted_rows(got) == _sorted_rows(want)
    assert_tables_match(got, _local_join(left, right, ["k"], ["k"], jt))


def _port_type(t):
    from test_torch_host_table import port_type
    return port_type(t)


@pytest.mark.parametrize("jt", ["inner", "left outer", "full outer",
                                "right anti"])
def test_distributed_join_tables_null_keys(ranks, jt):
    left, right = null_key_tables()
    got, _, _ = table_run(ranks, "distributed_join_tables", [left, right],
                          ["k"], ["k"], jt)
    want = jpar.distributed_join_tables(mesh(), left, right, ["k"], ["k"],
                                        jt).to_pydict()
    assert list(got) == list(want)
    assert _sorted_rows(got) == _sorted_rows(want)


def test_distributed_join_tables_one_to_many(ranks):
    """A 1:N join (each probe row matches 20 build rows) against a numpy
    oracle. The port sizes each rank's output from its match count; the
    reference truncates at ``ndev`` x its probe capacity (ROADMAP.md §3,
    reference defects the port does not copy), so its result is short."""
    rng = np.random.default_rng(17)
    n, keys, reps = 3000, 30, 20
    lk = rng.integers(0, keys, n)
    left = at.table({"k": at.array(lk.astype(np.int64)),
                     "v": at.array(np.arange(n, dtype=np.int64))})
    rk = np.repeat(np.arange(keys, dtype=np.int64), reps)
    right = at.table({"k": at.array(rk),
                      "w": at.array(np.arange(keys * reps) * 0.5)})
    got, _, _ = table_run(ranks, "distributed_join_tables", [left, right],
                          ["k"], ["k"], "inner")
    # the single-rank order: probe rows in order, each one's matches in
    # build order
    probe = np.repeat(np.arange(n), reps)
    build = (lk[:, None] * reps + np.arange(reps)).reshape(-1)
    want = {"k_l": lk[probe].tolist(), "v": probe.tolist(),
            "k_r": rk[build].tolist(), "w": (build * 0.5).tolist()}
    assert got == want
    ref = jpar.distributed_join_tables(mesh(), left, right, ["k"], ["k"],
                                       "inner")
    assert ref.num_rows < n * reps


@pytest.mark.parametrize("size", [WORLD, RAGGED])
@pytest.mark.parametrize("placement", ["at_end", "at_start"])
def test_distributed_sort_table(ranks, placement, size):
    """Two keys with nulls and ties: the reference's order exactly."""
    t = plan_table(2500, seed=6)
    keys = [("f", "descending"), ("g", "ascending")]
    want = jpar.distributed_sort_table(mesh(size), t, keys,
                                       null_placement=placement)
    got, schema, _ = table_run(ranks, "distributed_sort_table", [t], keys,
                               placement, size=size)
    assert [n for n, _ in schema] == want.schema.names
    assert_tables_match(got, want.to_pydict())


def test_distributed_sort_table_by_a_string(ranks):
    """A string key sorts by value, as the reference's order_by does."""
    t = plan_table(2500, seed=8)
    keys = [("k", "descending"), ("i", "ascending")]
    want = jacero.Declaration.from_sequence([
        jacero.Declaration("table_source", jacero.TableSourceNodeOptions(t)),
        jacero.Declaration("order_by", jacero.OrderByNodeOptions(keys)),
    ]).to_table().to_pydict()
    got, _, _ = table_run(ranks, "distributed_sort_table", [t], keys)
    assert_tables_match(got, want)


@pytest.mark.parametrize("size", [WORLD, RAGGED])
@pytest.mark.parametrize("jt", ["inner", "left outer"])
def test_broadcast_join_tables(ranks, jt, size):
    """A skewed probe side against a small build side with a missing key:
    the reference's rows in its order, names and types."""
    rng = np.random.default_rng(4)
    keys = [7 if v < 90 else int(v) for v in rng.integers(0, 104, 1500)]
    left = at.table({"key": keys, "lv": list(range(1500)),
                     "tag": [f"t{i % 7}" for i in range(1500)]})
    right = at.table({"key": list(range(100)),
                      "rv": [i * 10 for i in range(100)]})
    want = jpar.broadcast_join_tables(mesh(size), left, right, ["key"],
                                      ["key"], jt)
    got, schema, _ = table_run(ranks, "broadcast_join_tables",
                               [left, right], ["key"], ["key"], jt,
                               size=size)
    assert [n for n, _ in schema] == want.schema.names
    assert_tables_match(got, want.to_pydict())


@pytest.mark.parametrize("jt", ["right outer", "full outer", "left semi"])
def test_broadcast_join_tables_refuses_other_types(jt):
    left, right = null_key_tables()
    with pytest.raises(NotImplementedError):
        jpar.broadcast_join_tables(mesh(), left, right, ["k"], ["k"], jt)
    with pytest.raises(NotImplementedError):
        tpar.broadcast_join_tables(None, left, right, ["k"], ["k"], jt)


@pytest.mark.parametrize("size", [WORLD, RAGGED])
def test_salted_join_tables(ranks, size):
    """Half the probe rows on one key: the salted join's rows are the
    reference's as a set (less its suffixed salt columns, which the port
    drops) and the port's plain distributed join's in order; salting takes
    the hot key's rows off one rank. The reference's defaults of
    hot_threshold and n_salts apply."""
    rng = np.random.default_rng(5)
    n = 2000
    keys = np.where(rng.random(n) < 0.5, 7, rng.integers(0, 100, n))
    left = at.table({"k": at.array(keys.astype(np.int64)),
                     "v": at.array(np.arange(n, dtype=np.int64))})
    right = at.table({"k": at.array(np.arange(100, dtype=np.int64)),
                      "w": at.array(np.arange(100, dtype=np.float64)),
                      "s": at.array([f"s{i % 3}" for i in range(100)])})
    plain, _, plain_out = table_run(ranks, "distributed_join_tables",
                                    [left, right], ["k"], ["k"], size=size)
    got, schema, salted_out = table_run(
        ranks, "salted_join_tables", [left, right], ["k"], ["k"],
        size=size, hot_threshold=200)
    assert got == plain
    ref = jpar.salted_join_tables(mesh(size), left, right, ["k"], ["k"],
                                  hot_threshold=200).to_pydict()
    names = [nm for nm, _ in schema]
    assert [nm for nm in ref if not nm.startswith("__salt__")] == names
    assert _sorted_rows(got, names) == _sorted_rows(ref, names)
    hot_share = max(p["received"] for p in plain_out) / n
    salted_share = max(p["received"] for p in salted_out) / n
    assert hot_share >= 0.5 > salted_share


def test_salted_join_tables_defaults(ranks):
    """Without hot_threshold, the reference's default (4x a rank's share,
    at least 64) finds no hot key in a mild skew: the plain join."""
    left, right = keyed_tables(6, 1200, 40, 40, "unique")
    got, _, _ = table_run(ranks, "salted_join_tables", [left, right],
                          ["key"], ["key"])
    want = jpar.salted_join_tables(mesh(), left, right, ["key"],
                                   ["key"]).to_pydict()
    assert list(got) == list(want)
    assert _sorted_rows(got) == _sorted_rows(want)


# --- plans: the reference's test_distributed_plan.py -------------------------

def _run_plan(ranks, plan_name, tables, size=WORLD, single_device=False,
              **kw):
    """(port result, port counts, reference result, reference counts). The
    reference's result is its mesh run's, or its single-device run's where
    ``single_device`` (its counts are its mesh run's either way)."""
    out = ranks.run("plan_case", plan_name, [spec(t) for t in tables], kw,
                    size=size)
    got = agreed(out)
    plan = PLANS[plan_name](jacero, *tables, **kw)
    jdist.reset_exchange_counts()
    want = plan.to_table(mesh=mesh(size)).to_pydict()
    counts = dict(jdist.EXCHANGE_COUNTS)
    if single_device:
        want = plan.to_table().to_pydict()
    return got, out[0]["counts"], want, counts


PLAN_CASES = [("spmd_groupby", {}), ("spmd_filter_project_groupby", {}),
              ("spmd_scalar_agg", {}), ("spmd_float_aggs", {}),
              ("spmd_two_string_keys", {}), ("groupby_sum_by_k", {}),
              ("order_by_two_keys", {}),
              ("order_by_nulls", {"placement": "at_start"}),
              ("order_by_nulls", {"placement": "at_end"}),
              ("order_by_string_fetch", {})]


@pytest.mark.parametrize("plan_name,kw", PLAN_CASES,
                         ids=[f"{b}-{'-'.join(k.values())}" if k else b
                              for b, k in PLAN_CASES])
def test_plan_matches_reference(ranks, plan_name, kw):
    got, counts, want, want_counts = _run_plan(ranks, plan_name,
                                               [plan_table()], **kw)
    assert counts == want_counts
    assert_tables_match(got, want)


@pytest.mark.parametrize("plan_name", ["spmd_groupby", "order_by_two_keys"])
def test_plan_on_ragged_shards(ranks, plan_name):
    got, counts, want, want_counts = _run_plan(ranks, plan_name,
                                               [plan_table(5003, seed=8)],
                                               size=RAGGED)
    assert counts == want_counts
    assert_tables_match(got, want)


def test_group_of_one_runs_locally(ranks):
    """On a group of one rank the plan runs locally, as the reference's
    does on one device: nothing counted, the single-device result."""
    out = ranks.run("plan_case", "spmd_groupby", [spec(plan_table())],
                    size=1)
    assert out[0]["counts"] == {k: 0 for k in out[0]["counts"]}
    assert_tables_match(agreed(out),
                        PLANS["spmd_groupby"](jacero,
                                              plan_table()).to_table()
                        .to_pydict())


@pytest.mark.parametrize("case", ["exchange", "multimatch", "left_outer"])
def test_join_plan_matches_reference(ranks, case):
    """The reference's join plans. In the 1:N case its mesh run at four
    devices loses rows (``distributed_join_tables`` sizes each device's
    output for unique build keys, ``ndev`` x its probe capacity, and
    truncates past it): the port is held to its single-device result."""
    if case == "exchange":
        tables = keyed_tables(5, 4000, 100, 100, "unique", v_range=False)
        plan_name, kw = "join_then_sum", {}
    elif case == "multimatch":
        tables = keyed_tables(9, 3000, 40, 200, 40)
        plan_name, kw = "join_suffixed", {}
    else:
        tables = keyed_tables(13, 2500, 200, 90, 120)
        plan_name, kw = "join_suffixed", {"jt": "left outer"}
    got, counts, want, want_counts = _run_plan(
        ranks, plan_name, tables, single_device=case == "multimatch", **kw)
    assert counts == want_counts
    assert counts["join_exchange"] >= 1
    assert_tables_match(got, want)


@pytest.mark.parametrize("query", ["q1", "q6", "q3"])
def test_tpch_plan_at_sf001(ranks, query):
    """The reference's Q1, Q6 (the SPMD spine) and Q3 (a join exchange)
    over its SF 0.01 tables."""
    from arrow_tpu.io import tpch, tpch_queries
    names = {"q1": ("lineitem",), "q6": ("lineitem",),
             "q3": ("customer", "orders", "lineitem")}[query]
    tables = [getattr(tpch, f"{n}_table")(0.01) for n in names]
    out = ranks.run("tpch_spec_case", query, [spec(t) for t in tables])
    got = agreed(out)
    jdist.reset_exchange_counts()
    want = getattr(tpch_queries, f"{query}_plan")(*tables).to_table(
        mesh=mesh()).to_pydict()
    assert out[0]["counts"] == dict(jdist.EXCHANGE_COUNTS)
    assert_tables_match(got, want)


# --- the join types: the reference's test_dist_join_types.py -----------------

JOIN_TYPES = ["inner", "left outer", "left semi", "left anti",
              "right semi", "right anti", "right outer", "full outer"]


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_type_matches_reference(ranks, jt):
    got, counts, want, want_counts = _run_plan(
        ranks, "join_type", join_type_tables(), jt=jt)
    assert counts == want_counts
    assert counts["join_exchange"] >= 1, f"{jt} ran locally"
    assert_tables_match(got, want, float_rtol=1e-12)


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_type_null_keys(ranks, jt):
    got, counts, want, want_counts = _run_plan(
        ranks, "join_type", null_key_tables(), jt=jt)
    assert counts == want_counts
    assert_tables_match(got, want)


def test_fused_pre_chain_engages(ranks):
    got, counts, want, want_counts = _run_plan(
        ranks, "fused_pre_join", join_type_tables(seed=9))
    assert counts == want_counts
    assert counts["join_fused_pre"] >= 1
    assert_tables_match(got, want)


@pytest.mark.parametrize("jt", ["inner", "right outer", "full outer"])
def test_join_then_aggregate(ranks, jt):
    got, counts, want, want_counts = _run_plan(
        ranks, "join_type_then_sum", join_type_tables(seed=3), jt=jt)
    assert counts == want_counts
    assert counts["join_exchange"] >= 1
    assert_tables_match(got, want)


@pytest.mark.parametrize("jt", ["inner", "full outer"])
def test_join_type_on_ragged_shards(ranks, jt):
    got, counts, want, want_counts = _run_plan(
        ranks, "join_type", join_type_tables(seed=5), size=RAGGED, jt=jt)
    assert counts == want_counts
    assert_tables_match(got, want)


# --- chip_smoke.py's phase 3k ------------------------------------------------

def test_chip_smoke_phase_3k_on_cpu():
    """Phase 3k of ``chip_smoke.py`` at SF 0.005 on the CPU: its four
    ranks, every path against its single-rank run and oracle, the
    ``EXCHANGE_COUNTS`` it reckons and the skewed joins' spread; with
    phase 3l's host Tables, Q1 and Q3 split by rank and the Table-level
    entry points against their numpy oracles (launch counts and the NCCL
    exchange need the card)."""
    import chip_smoke
    from arrow_tpu_torch.io import tpch
    from arrow_tpu_torch.io.tpch_device import q1_device_batch
    t = tpch.generate(0.005, device="cpu")
    t["lineitem"], _ = q1_device_batch(0.005, device="cpu")
    host = chip_smoke.phase_host(sf=0.005, device="cpu")[1]
    launches = chip_smoke.phase_dist(t, sf=0.005, device="cpu", host=host)
    assert set(launches) == {f"3k {name}" for name in [
        "Q1", "distributed_q1", "Q3", "order_by", "broadcast",
        "partitioned", "salted", "Q9-style", "Q1 host split",
        "Q3 host split"] + [f"join {jt}" for jt in chip_smoke.JOIN_TYPES]
        + list(chip_smoke.TABLE_PATHS)}


# --- the mesh ----------------------------------------------------------------

def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is initialized in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.make_mesh(device="cpu")


def test_shard_source_refuses_a_local_run():
    from arrow_tpu_torch.acero import Declaration, TableSourceNodeOptions
    from arrow_tpu_torch.device.column import batch_from_numpy
    b = batch_from_numpy([("x", "int64", np.arange(5), None, None)], 5,
                         device="cpu")
    shard = tpar.ShardBatch(b.schema, b.columns, b.row_count, 0, 10)
    with pytest.raises(ValueError, match="distributed=True"):
        Declaration("table_source", TableSourceNodeOptions(shard)).to_table().to_pydict()
