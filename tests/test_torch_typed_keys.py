"""Keys, joins, aggregates and compaction over the new types, against the
JAX package.

* Sorts and groupings by each type: uint64 values at and above 2**63
  (they order last, as unsigned values), f16 NaN and -0.0, decimals and
  timestamps.
* Joins of uint32 to uint32 (the direct path, its ``"u"`` kind), uint32 to
  int32 and int64 to uint64 (the grouper path, where an int64 -1 and a
  uint64 2**64 - 1 share one equality word, as in the reference), with the
  bloom words bit-identical to the reference's for every key type.
* The sum, mean, min, max and count types and values of every input type,
  grouped and scalar.
* The compaction's plain version at 2 bytes an element (int16, uint16,
  f16 with NaN payloads and -0.0).

The two faults that showed once the types existed have their tests in
``test_torch_type_faults.py``.
"""

import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu.acero as jacero
from arrow_tpu import types as RT
from arrow_tpu.compute import bloom as jax_bloom
from arrow_tpu.device.column import DeviceBatch as JaxBatch
from arrow_tpu.device.column import download_table
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.compute import bloom, join
from arrow_tpu_torch.device.column import DeviceBatch
from arrow_tpu_torch.kernels.compact import compact, compact_plain
from arrow_tpu_torch.types import Field, Schema
from test_torch_types import CAP, N, TYPES, column_pair
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

KEY_TYPES = ("bool", "int8", "int16", "uint8", "uint16", "uint32", "uint64",
             "float16", "float32", "date64", "timestamp[s]", "time32[ms]",
             "duration[ns]", "decimal128(12, 2)")


def _pool(name, seed, n=N):
    """A few distinct values of type ``name`` (its edges among them), so
    groups and join matches repeat."""
    port, ref = column_pair(name, seed)
    distinct = np.asarray(ref.values)[:6]
    if name == "uint64":
        distinct = np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 5,
                             2 ** 64 - 1], dtype=np.uint64)
    if name == "float16":
        distinct = np.array([np.nan, -0.0, 0.0, 1.5, -2.0, np.inf],
                            dtype=np.float16)
    rng = np.random.default_rng(seed)
    return distinct[rng.integers(0, len(distinct), n)]


def _tables(cols):
    """{name: (type name, values, seed)} -> (port DeviceBatch, reference
    Table), nulls at random."""
    pcols, rcols, fields, rfields = [], [], [], []
    for name, (tname, values, seed) in cols.items():
        p, r = column_pair(tname, seed, values=values)
        pcols.append(p)
        rcols.append(r)
        fields.append(Field(name, TYPES[tname][0]))
        rfields.append(RT.field(name, TYPES[tname][1]))
    pb = DeviceBatch(Schema(fields), pcols, torch.tensor(N, dtype=torch.int32))
    rb = JaxBatch(RT.schema(rfields), rcols, jnp.asarray(N, jnp.int32))
    return pb, download_table(rb)


def _same(got, want):
    assert list(got) == list(want)
    for name in want:
        a, b = got[name], want[name]
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            if isinstance(y, float) and np.isnan(y):
                assert isinstance(x, float) and np.isnan(x), name
            elif isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=0), name
            else:
                assert x == y and type(x) is type(y), (name, x, y)


def _run(make, *tables):
    want = make(jacero, *[t[1] for t in tables]).to_table().to_pydict()
    got = make(tacero, *[t[0] for t in tables]).to_table().to_pydict()
    return got, want


def _src(mod, t):
    return mod.Declaration("table_source", mod.TableSourceNodeOptions(t))


@pytest.mark.parametrize("placement", ["at_end", "at_start"])
@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("name", KEY_TYPES)
def test_sort_by_each_type(name, order, placement):
    tabs = _tables({"k": (name, _pool(name, 2), 3),
                    "i": ("int32", np.arange(N, dtype=np.int32), 4)})

    def make(mod, t):
        return mod.Declaration("order_by", mod.OrderByNodeOptions(
            [("k", order), ("i", "ascending")], null_placement=placement),
            inputs=[_src(mod, t)])
    got, want = _run(make, tabs)
    _same(got, want)


@pytest.mark.parametrize("name", KEY_TYPES)
def test_group_by_each_type(name):
    tabs = _tables({"k": (name, _pool(name, 6), 7),
                    "v": ("int64", np.arange(N, dtype=np.int64), 8)})

    def make(mod, t):
        return mod.Declaration("aggregate", mod.AggregateNodeOptions(
            [("v", "hash_sum", None, "s"), ("v", "hash_count", None, "c")],
            keys=["k"]), inputs=[_src(mod, t)])
    got, want = _run(make, tabs)
    _same(got, want)


_AGG_TYPES = ("bool", "int8", "int16", "int32", "uint8", "uint16", "uint32",
              "uint64", "float16", "float32", "float64",
              "decimal128(12, 2)", "decimal64(9, 3)")


@pytest.mark.parametrize("name", _AGG_TYPES)
def test_grouped_aggregate_types(name):
    """hash_sum, hash_mean, hash_min, hash_max and hash_count of every
    input type: the reference's result types and values."""
    keys = np.random.default_rng(9).integers(0, 5, N).astype(np.int32)
    _, ref = column_pair(name, 11)
    vals = np.asarray(ref.values)[:N]
    if name.startswith("float"):
        vals = np.where(np.isfinite(vals), vals, 1.0).astype(vals.dtype)
    tabs = _tables({"k": ("int32", keys, 12), "v": (name, vals, 13)})
    aggs = [("v", f"hash_{f}", None, f) for f in
            ("sum", "mean", "min", "max", "count")]

    def make(mod, t):
        return mod.Declaration("order_by", mod.OrderByNodeOptions(
            [("k", "ascending")]), inputs=[mod.Declaration(
                "aggregate", mod.AggregateNodeOptions(aggs, keys=["k"]),
                inputs=[_src(mod, t)])])
    got, want = _run(make, tabs)
    _same(got, want)
    if name.startswith("decimal"):
        assert all(isinstance(x, decimal.Decimal) for x in got["mean"]
                   if x is not None)


@pytest.mark.parametrize("name", _AGG_TYPES)
def test_scalar_aggregate_types(name):
    _, ref = column_pair(name, 14)
    vals = np.asarray(ref.values)[:N]
    if name.startswith("float"):
        vals = np.where(np.isfinite(vals), vals, 1.0).astype(vals.dtype)
    tabs = _tables({"v": (name, vals, 15)})
    aggs = [("v", f, None, f) for f in ("sum", "mean", "min", "max",
                                        "count")]

    def make(mod, t):
        return mod.Declaration("aggregate", mod.AggregateNodeOptions(aggs),
                               inputs=[_src(mod, t)])
    got, want = _run(make, tabs)
    _same(got, want)


# --- joins ------------------------------------------------------------------

def _join(mod, probe, build, join_type="inner"):
    return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
        join_type, left_keys=["pk"], right_keys=["bk"]),
        inputs=[_src(mod, probe), _src(mod, build)])


def _join_tables(pk_type, bk_type, pk, bk):
    probe = _tables({"pk": (pk_type, pk, 21),
                     "pv": ("int32", np.arange(N, dtype=np.int32), 22)})
    build = _tables({"bk": (bk_type, bk, 23),
                     "bv": ("int16", np.arange(N, dtype=np.int16), 24)})
    return probe, build


_JOIN_CASES = {
    "uint32-uint32": ("uint32", "uint32",
                      [0, 1, 2 ** 31, 2 ** 32 - 1, 77]),
    "uint32-int32": ("uint32", "int32", [0, 1, 2 ** 31, 2 ** 32 - 1, 77]),
    "int64-uint64": ("int64", "uint64", [0, 1, -1, 2 ** 63 - 1, 5]),
    "uint64-uint64": ("uint64", "uint64", [0, 1, 2 ** 63, 2 ** 64 - 1, 5]),
    "int8-int64": ("int8", "int64", [0, 1, -1, -128, 127]),
    "uint16-uint8": ("uint16", "uint8", [0, 1, 255, 200, 7]),
}


def _key_values(tname, pool, seed):
    dt = np.asarray(column_pair(tname, 1)[1].values).dtype
    if tname == "int32":
        pool = [p if p < 2 ** 31 else p - 2 ** 32 for p in pool]
    if tname == "uint64":
        pool = [p % 2 ** 64 for p in pool]
    arr = np.array(pool, dtype=object)
    idx = np.random.default_rng(seed).integers(0, len(pool), N)
    return np.array([int(x) for x in arr[idx]]).astype(dt) \
        if dt != np.uint64 else np.array([int(x) for x in arr[idx]],
                                         dtype=np.uint64)


@pytest.mark.parametrize("join_type", ["inner", "left outer", "right semi",
                                       "full outer"])
@pytest.mark.parametrize("case", sorted(_JOIN_CASES))
def test_typed_joins_match_reference(case, join_type):
    pt, bt, pool = _JOIN_CASES[case]
    probe, build = _join_tables(pt, bt, _key_values(pt, pool, 25),
                                _key_values(bt, pool, 26))
    got, want = _run(lambda mod, p, b: _join(mod, p, b, join_type),
                     probe, build)
    _same(got, want)
    if join_type == "inner":
        assert len(got["pk"]) > 0


def test_unsigned_join_kinds():
    """uint32 to uint32 joins directly, uint32 to int32 through the
    grouper."""
    u32 = column_pair("uint32", 1)[0]
    i32 = column_pair("int32", 1)[0]
    assert join._direct_key_kind(u32) == "u"
    assert join._use_direct_single_key([u32], [u32])
    assert not join._use_direct_single_key([u32], [i32])


@pytest.mark.parametrize("name", KEY_TYPES)
def test_is_in_on_each_type(name):
    """``is_in`` over a value set taken from the column (the unsigned
    values at and above 2**31 and 2**63 among them), each value converted
    to the column's dtype, as the reference's expression evaluates it.
    (Evaluated as an expression: the reference's plan executor keys its
    compiled filters by the expression's text, which leaves out the value
    set, so two such plans in one process share the first one's set.)"""
    from arrow_tpu.device.column import upload_table
    pool = _pool(name, 51)
    port, ref = _tables({"k": (name, pool, 52)})
    picks = [v.item() for v in pool[:3]]
    if name == "bool":
        picks = [True]
    elif name.startswith("float"):
        picks = [float(v) for v in picks if not np.isnan(v)]
    got = tacero.Expression.call("is_in", tacero.field("k"),
                                 value_set=picks).evaluate(port)
    want = jacero.Expression.call("is_in", jacero.field("k"),
                                  value_set=picks).evaluate(
                                      upload_table(ref))
    np.testing.assert_array_equal(got.values.numpy()[:N],
                                  np.asarray(want.values)[:N])
    live = got.values.numpy()[:N] & port.column("k").validity.numpy()[:N]
    assert live.any()


@pytest.mark.parametrize("name", KEY_TYPES + ("int64", "float64",
                                              "timestamp[ns]"))
def test_bloom_words_bit_identical(name):
    p, r = column_pair(name, 31)
    live = np.random.default_rng(32).random(CAP) < 0.8
    live &= p.validity.numpy()
    lb = bloom.log_bits_for(CAP)
    got = bloom.build_bloom([p], torch.from_numpy(live), lb)
    want = jax_bloom.build_bloom([r], jnp.asarray(live), lb)
    np.testing.assert_array_equal(got.words.numpy().astype(np.uint32),
                                  np.asarray(want.words))
    q, s = column_pair(name, 33)
    qlive = np.random.default_rng(34).random(CAP) < 0.9
    np.testing.assert_array_equal(
        bloom.bloom_query(got, [q], torch.from_numpy(qlive)).numpy(),
        np.asarray(jax_bloom.bloom_query(want, [s], jnp.asarray(qlive))))


# --- compaction at 2 bytes -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.int16, torch.float16, "uint16"])
def test_compact_plain_at_two_bytes(dtype):
    """Kept rows in order, bit for bit (f16 NaN payloads and -0.0 kept),
    zeros behind; ``compact`` takes 2-byte columns."""
    rng = np.random.default_rng(41)
    n = 5000
    bits = rng.integers(0, 1 << 16, n).astype(np.uint16)
    bits[:4] = [0x7E01, 0xFE00, 0x8000, 0x7C00]  # NaN payloads, -0.0, inf
    keep = rng.random(n) < 0.4
    keep[:4] = True
    store = torch.int16 if dtype == "uint16" else dtype
    col = torch.from_numpy(bits.view(np.int16).copy()).view(store)
    other = torch.arange(n, dtype=torch.int64)
    for fn in (compact_plain, compact):
        (out, out_other), count = fn(torch.from_numpy(keep), [col, other])
        k = int(keep.sum())
        assert int(count) == k
        got = out.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got[:k], bits[keep])
        assert not got[k:].any()
        np.testing.assert_array_equal(out_other[:k].numpy(),
                                      np.nonzero(keep)[0])
