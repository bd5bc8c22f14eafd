"""The port's host data model (``arrow_tpu_torch/buffer.py``,
``utils/bits.py``, ``array/``, ``table.py``, ``compute/host_concat.py``)
against the JAX package's on the same inputs.

For every type of the port's ``types.py``, values made from a seed with
numpy, with nulls, go through both packages' ``array()``: the same
buffers byte for byte (validity, offsets, data, children, dictionary) and
the same ``to_pylist``, whole, sliced and sliced again; ``ChunkedArray``,
``RecordBatch`` and ``Table`` likewise; and ``tests/test_array.py``'s
cases, inference included. The helper ``carry_table`` brings a reference
Table across by its buffers as numpy (the port may not import the
reference); the next test files import it.
"""

import datetime
import decimal
import importlib
import random

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch.types as PT
from arrow_tpu_torch.array.array import Array, array
from arrow_tpu_torch.array.data import ArrayData
from arrow_tpu_torch.buffer import Buffer
from arrow_tpu_torch.utils import bits

from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

ttable = importlib.import_module("arrow_tpu_torch.table")
jtable = importlib.import_module("arrow_tpu.table")
N = 23


# --- carrying the reference's values across ----------------------------------

def port_type(rt):
    """The port's type of a reference type."""
    tid = int(rt.id)
    T = at.TypeId
    if tid in (T.TIMESTAMP,):
        return PT.timestamp(rt.unit, rt.tz)
    if tid == T.TIME32:
        return PT.time32(rt.unit)
    if tid == T.TIME64:
        return PT.time64(rt.unit)
    if tid == T.DURATION:
        return PT.duration(rt.unit)
    if tid in (T.DECIMAL32, T.DECIMAL64, T.DECIMAL128, T.DECIMAL256):
        return PT.DecimalType(rt.precision, rt.scale, PT.TypeId(tid))
    if tid == T.FIXED_SIZE_BINARY:
        return PT.fixed_size_binary(rt.byte_width)
    if tid in (T.LIST, T.LARGE_LIST):
        vf = rt.value_field
        f = PT.Field(vf.name, port_type(vf.type), vf.nullable)
        return PT.list_(f) if tid == T.LIST else PT.large_list(f)
    if tid == T.FIXED_SIZE_LIST:
        vf = rt.value_field
        return PT.fixed_size_list(PT.Field(vf.name, port_type(vf.type),
                                           vf.nullable), rt.list_size)
    if tid == T.STRUCT:
        return PT.struct([PT.Field(f.name, port_type(f.type), f.nullable)
                          for f in rt.fields])
    if tid == T.MAP:
        return PT.map_(port_type(rt.key_type), port_type(rt.item_type))
    if tid == T.DICTIONARY:
        return PT.dictionary(port_type(rt.index_type),
                             port_type(rt.value_type))
    if tid == T.RUN_END_ENCODED:
        return PT.run_end_encoded(port_type(rt.run_end_type),
                                  port_type(rt.value_type))
    return PT.DataType(PT.TypeId(tid))


def port_schema(rs):
    return PT.Schema([PT.Field(f.name, port_type(f.type), f.nullable)
                      for f in rs])


def carry_data(rd) -> ArrayData:
    """A reference ArrayData as the port's, by its buffers as numpy."""
    return ArrayData(
        port_type(rd.type), rd.length,
        [None if b is None else Buffer(np.array(b.to_numpy()))
         for b in rd.buffers],
        [carry_data(c) for c in rd.children], rd._null_count, rd.offset,
        None if rd.dictionary is None else carry_data(rd.dictionary))


def carry_array(ra) -> Array:
    return Array(carry_data(ra.data))


def carry_table(rt):
    """A reference Table (or RecordBatch) as the port's Table, chunk by
    chunk."""
    if isinstance(rt, jtable.RecordBatch):
        rt = jtable.Table.from_batches([rt])
    return ttable.Table(port_schema(rt.schema), [
        ttable.ChunkedArray([carry_array(c) for c in col.chunks],
                            port_type(col.type)) for col in rt.columns])


def assert_same_data(pd, rd, where=""):
    """Byte for byte: type, length, offset, null count, every buffer,
    children and dictionary."""
    assert pd.type == port_type(rd.type), where
    assert (pd.length, pd.offset, pd.null_count) == \
        (rd.length, rd.offset, rd.null_count), where
    assert len(pd.buffers) == len(rd.buffers), where
    for i, (a, b) in enumerate(zip(pd.buffers, rd.buffers)):
        assert (a is None) == (b is None), (where, i)
        if a is not None:
            assert a.to_pybytes() == b.to_pybytes(), (where, i)
    assert len(pd.children) == len(rd.children), where
    for c, d in zip(pd.children, rd.children):
        assert_same_data(c, d, where + "/child")
    assert (pd.dictionary is None) == (rd.dictionary is None), where
    if pd.dictionary is not None:
        assert_same_data(pd.dictionary, rd.dictionary, where + "/dict")


# --- the type set, with values from a seed -----------------------------------

def _nulls(rng, vals, share=0.2):
    return [None if rng.random() < share else v for v in vals]


def _ints(lo, hi):
    return lambda rng: [int(v) for v in rng.integers(lo, hi, N)]


def _floats(rng):
    v = rng.standard_normal(N)
    v[3] = np.nan
    v[5] = -0.0
    return [float(x) for x in v]


def _strings(rng):
    words = ["", "a", "bc", "Δδ", "hello", "x y"]
    return [words[i] for i in rng.integers(0, len(words), N)]


def _bytes(rng):
    return [bytes(rng.integers(0, 256, int(k)).astype(np.uint8))
            for k in rng.integers(0, 5, N)]


def _decimals(scale, digits):
    def make(rng):
        r = random.Random(int(rng.integers(0, 2 ** 31)))
        return [decimal.Decimal(r.randrange(-10 ** digits + 1, 10 ** digits)
                                ).scaleb(-scale) for _ in range(N)]
    return make


def _dates(rng):
    return [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(d))
            for d in rng.integers(-5000, 20000, N)]


def _times(unit):
    per = {"s": 1, "ms": 1000, "us": 10 ** 6, "ns": 10 ** 9}[unit]
    return lambda rng: [int(v) for v in rng.integers(0, 86400 * per, N)]


TYPES = {
    "null": (lambda: at.null(), lambda rng: [None] * N),
    "bool": (lambda: at.bool_(),
             lambda rng: [bool(v) for v in rng.integers(0, 2, N)]),
    "int8": (lambda: at.int8(), _ints(-128, 128)),
    "int16": (lambda: at.int16(), _ints(-2 ** 15, 2 ** 15)),
    "int32": (lambda: at.int32(), _ints(-2 ** 31, 2 ** 31)),
    "int64": (lambda: at.int64(), _ints(-2 ** 62, 2 ** 62)),
    "uint8": (lambda: at.uint8(), _ints(0, 256)),
    "uint16": (lambda: at.uint16(), _ints(0, 2 ** 16)),
    "uint32": (lambda: at.uint32(), _ints(0, 2 ** 32)),
    "uint64": (lambda: at.uint64(), _ints(0, 2 ** 63)),
    "float16": (lambda: at.float16(), _floats),
    "float32": (lambda: at.float32(), _floats),
    "float64": (lambda: at.float64(), _floats),
    "string": (lambda: at.string(), _strings),
    "large_string": (lambda: at.large_string(), _strings),
    "binary": (lambda: at.binary(), _bytes),
    "large_binary": (lambda: at.large_binary(), _bytes),
    "fixed_size_binary": (lambda: at.fixed_size_binary(3),
                          lambda rng: [bytes(rng.integers(0, 256, 3).astype(
                              np.uint8)) for _ in range(N)]),
    "date32": (lambda: at.date32(), _dates),
    "date64": (lambda: at.date64(), _dates),
    "timestamp[s]": (lambda: at.timestamp("s"), _ints(-10 ** 9, 10 ** 9)),
    "timestamp[ms]": (lambda: at.timestamp("ms"), _ints(-10 ** 12, 10 ** 12)),
    "timestamp[us]": (lambda: at.timestamp("us"), _ints(-10 ** 15, 10 ** 15)),
    "timestamp[ns]": (lambda: at.timestamp("ns"), _ints(-10 ** 18, 10 ** 18)),
    "timestamp[us, UTC]": (lambda: at.timestamp("us", "UTC"),
                           _ints(0, 10 ** 15)),
    "time32[s]": (lambda: at.time32("s"), _times("s")),
    "time32[ms]": (lambda: at.time32("ms"), _times("ms")),
    "time64[us]": (lambda: at.time64("us"), _times("us")),
    "time64[ns]": (lambda: at.time64("ns"), _times("ns")),
    "duration[s]": (lambda: at.duration("s"), _ints(-10 ** 9, 10 ** 9)),
    "duration[ns]": (lambda: at.duration("ns"), _ints(-10 ** 18, 10 ** 18)),
    "month_interval": (lambda: at.month_interval(), _ints(-1000, 1000)),
    "decimal32(7, 2)": (lambda: at.decimal32(7, 2), _decimals(2, 7)),
    "decimal64(15, 3)": (lambda: at.decimal64(15, 3), _decimals(3, 15)),
    "decimal128(12, 2)": (lambda: at.decimal128(12, 2), _decimals(2, 12)),
    "decimal128(38, 5)": (lambda: at.decimal128(38, 5), _decimals(5, 37)),
    "decimal256(60, 4)": (lambda: at.decimal256(60, 4), _decimals(4, 59)),
    "list<int64>": (lambda: at.list_(at.int64()),
                    lambda rng: [_nulls(rng, [int(x) for x in rng.integers(
                        0, 9, int(k))]) for k in rng.integers(0, 4, N)]),
    "large_list<string>": (lambda: at.large_list(at.string()),
                           lambda rng: [_strings(rng)[:int(k)] for k in
                                        rng.integers(0, 4, N)]),
    "fixed_size_list<int32>[2]": (
        lambda: at.fixed_size_list(at.int32(), 2),
        lambda rng: [[int(x) for x in rng.integers(0, 99, 2)]
                     for _ in range(N)]),
    "struct": (lambda: at.struct([("a", at.int64()), ("b", at.string())]),
               lambda rng: [{"a": int(a), "b": b} for a, b in zip(
                   rng.integers(0, 9, N), _nulls(rng, _strings(rng)))]),
    "map<string, int64>": (lambda: at.map_(at.string(), at.int64()),
                           lambda rng: [[(f"k{j}", int(v)) for j, v in
                                         enumerate(rng.integers(0, 9,
                                                                int(k)))]
                                        for k in rng.integers(0, 3, N)]),
    "dictionary<int32, string>": (
        lambda: at.dictionary(at.int32(), at.string()), _strings),
}


def type_values(name, seed=0):
    """(reference type, Python values with nulls) of a type of ``TYPES``."""
    rng = np.random.default_rng(seed)
    make_type, make_values = TYPES[name]
    return make_type(), _nulls(rng, make_values(rng))


@pytest.mark.parametrize("name", list(TYPES))
def test_array_matches_reference(name):
    rt, vals = type_values(name)
    ref = at.array(vals, rt)
    got = array(vals, port_type(rt))
    assert_same_data(got.data, ref.data, name)
    assert got.to_pylist() == ref.to_pylist() or \
        repr(got.to_pylist()) == repr(ref.to_pylist())
    assert got.null_count == ref.null_count and len(got) == len(ref)
    assert got.equals(carry_array(ref))


@pytest.mark.parametrize("name", list(TYPES))
def test_slices_match_reference(name):
    rt, vals = type_values(name, seed=1)
    ref = at.array(vals, rt).slice(3, 15).slice(2, 9)
    got = array(vals, port_type(rt)).slice(3, 15).slice(2, 9)
    assert (got.offset, len(got), got.null_count) == \
        (ref.offset, len(ref), ref.null_count)
    assert repr(got.to_pylist()) == repr(ref.to_pylist())
    assert repr(carry_array(ref).to_pylist()) == repr(ref.to_pylist())
    assert repr(got[4]) == repr(ref[4])


@pytest.mark.parametrize("name", list(TYPES))
def test_chunked_and_concat_match_reference(name):
    rt, vals = type_values(name, seed=2)
    chunks = [vals[:7], vals[7:8], vals[8:]]
    ref = at.chunked_array([at.array(c, rt) for c in chunks], rt)
    got = ttable.ChunkedArray([array(c, port_type(rt)) for c in chunks],
                              port_type(rt))
    assert (len(got), got.null_count, got.num_chunks) == \
        (len(ref), ref.null_count, ref.num_chunks)
    assert repr(got.to_pylist()) == repr(ref.to_pylist())
    assert_same_data(got.combine().data, ref.combine().data, name)
    assert repr(got.slice(5, 6).to_pylist()) == \
        repr(ref.slice(5, 6).to_pylist())


def _both_tables(seed=3):
    names = ["int64", "float64", "string", "dictionary<int32, string>",
             "decimal128(38, 5)", "list<int64>", "struct", "date32",
             "bool", "fixed_size_binary"]
    cols = {}
    for i, name in enumerate(names):
        rt, vals = type_values(name, seed + i)
        cols[f"c{i}"] = (rt, vals)
    ref = at.table({k: at.array(v, rt) for k, (rt, v) in cols.items()})
    got = ttable.table({k: array(v, port_type(rt))
                        for k, (rt, v) in cols.items()})
    return got, ref


def test_table_and_record_batch_match_reference():
    got, ref = _both_tables()
    assert got.schema.equals(port_schema(ref.schema))
    assert (got.num_rows, got.num_columns, got.column_names) == \
        (ref.num_rows, ref.num_columns, ref.column_names)
    assert repr(got.to_pydict()) == repr(ref.to_pydict())
    assert got.equals(carry_table(ref))
    assert repr(got.select(["c2", "c0"]).to_pydict()) == \
        repr(ref.select(["c2", "c0"]).to_pydict())
    assert repr(got.slice(4, 9).to_pydict()) == \
        repr(ref.slice(4, 9).to_pydict())
    gb, rb = got.to_batches(5), ref.to_batches(5)
    assert [b.num_rows for b in gb] == [b.num_rows for b in rb]
    for a, b in zip(gb, rb):
        for ca, cb in zip(a.columns, b.columns):
            assert_same_data(ca.data, cb.data)
    again = ttable.Table.from_batches(gb)
    assert again.equals(got) and again.column("c0").num_chunks == 5
    combined = again.combine_chunks()
    assert combined.column("c1").num_chunks == 1
    for ca, cb in zip(combined.columns, ref.combine_chunks().columns):
        assert_same_data(ca.chunks[0].data, cb.chunks[0].data)
    rbatch = ttable.record_batch({"x": [1, None], "y": ["a", "b"]})
    want = jtable.record_batch({"x": [1, None], "y": ["a", "b"]})
    assert rbatch.to_pydict() == want.to_pydict()
    assert rbatch.to_pylist() == want.to_pylist()
    assert rbatch.slice(1).to_pydict() == want.slice(1).to_pydict()
    reader = ttable.RecordBatchReader.from_batches(got.schema, gb)
    assert reader.read_all().equals(got)


def test_reference_array_cases():
    """``tests/test_array.py``'s cases, inference included."""
    assert array([1, None, 3, -5]).type == PT.int64()
    assert array([1, None, 3, -5]).null_count == 1
    assert array([1.5, 2]).type == PT.float64()
    assert array([True, None]).type == PT.bool_()
    assert array(["x"]).type == PT.string()
    assert array([b"x"]).type == PT.binary()
    assert array([None, None]).type == PT.null()
    assert array([[1]]).type == PT.list_(PT.int64())
    assert array([{"a": 1}]).type == PT.struct([("a", PT.int64())])
    assert array([decimal.Decimal("1.25")]).type == PT.decimal128(38, 2)
    assert array([datetime.datetime(2021, 6, 1)]).type == \
        PT.timestamp("us")
    assert array([datetime.date(2021, 6, 1)]).type == PT.date32()
    assert array([datetime.timedelta(1)]).type == PT.duration("us")
    arr = np.arange(10, dtype=np.int32)
    a = array(arr)
    assert a.type == PT.int32()
    np.testing.assert_array_equal(a.to_numpy(), arr)
    s = array([1, None, 3, 4, 5]).slice(1, 3)
    assert s.to_pylist() == [None, 3, 4] and s.null_count == 1
    assert s.slice(1).to_pylist() == [3, 4]
    assert array(["", "abc", None, "Δδ"]).to_pylist() == \
        ["", "abc", None, "Δδ"]
    assert array([b"\x00\xff", None], PT.binary()).to_pylist() == \
        [b"\x00\xff", None]
    assert array(["x", None], PT.large_string()).to_pylist() == ["x", None]
    assert array([b"abcd", None], PT.fixed_size_binary(4)).to_pylist() == \
        [b"abcd", None]
    assert array([decimal.Decimal("-0.01")], PT.decimal128(9, 2)
                 ).to_pylist() == [decimal.Decimal("-0.01")]
    ts = datetime.datetime(2021, 6, 1, 12, 30, 15, 123456)
    assert array([ts]).to_pylist() == [ts]
    m = array([[("k1", 1), ("k2", 2)], None], PT.map_(PT.string(),
                                                      PT.int64()))
    assert m.to_pylist() == [[("k1", 1), ("k2", 2)], None]
    deep = array([[[1], [None]], None], PT.list_(PT.list_(PT.int64())))
    assert deep.to_pylist() == [[[1], [None]], None]
    d = array(["a", "b", "a", None, "c"],
              PT.dictionary(PT.int32(), PT.string()))
    assert d.dictionary.to_pylist() == ["a", "b", "c"]
    assert d.indices.to_pylist() == [0, 1, 0, None, 2]
    ca = ttable.chunked_array([[1, 2], [3, None]], PT.int64())
    assert ca.slice(1, 2).to_pylist() == [2, 3]
    assert ca.combine().to_pylist() == [1, 2, 3, None]
    t = ttable.table({"x": [1, 2, 3], "y": ["a", None, "c"]})
    assert t.slice(1, 1).to_pydict() == {"x": [2], "y": [None]}
    assert [b.num_rows for b in t.to_batches(2)] == [2, 1]
    assert ttable.table({"x": [1, None]}).equals(
        ttable.table({"x": [1, None]}))
    assert not ttable.table({"x": [1, None]}).equals(
        ttable.table({"x": [1, 2]}))
    sliced = ttable.ChunkedArray([array([1, 2, 3, 4]).slice(1, 2),
                                  array([9, None]).slice(1)])
    assert sliced.combine().to_pylist() == [2, 3, None]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 1000])
def test_bitmaps_match_reference(n):
    from arrow_tpu.utils import bits as jbits
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.5
    assert bits.pack_bits(mask).tobytes() == jbits.pack_bits(mask).tobytes()
    packed = bits.pack_bits(mask)
    for off in (0, 1, 3):
        ln = max(n - off, 0)
        np.testing.assert_array_equal(bits.unpack_bits(packed, ln, off),
                                      jbits.unpack_bits(packed, ln, off))
        assert bits.count_set_bits(packed, ln, off) == \
            jbits.count_set_bits(packed, ln, off)
