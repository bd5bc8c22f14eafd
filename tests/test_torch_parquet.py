"""Parquet in the port (``arrow_tpu_torch/io/parquet/``, ``io/caching.py``,
``utils/snappy.py``, ``utils/brotli_ctypes.py``) against the JAX
package's (``arrow_tpu/io/parquet/``), with pyarrow as an oracle only.

* the writer's bytes equal the reference's over the option matrix of the
  reference's own tests (``tests/test_parquet*.py``): codecs, dictionary,
  page size, row groups, column encodings, bloom filters, nested,
  temporal and decimal types; each package reads the other's files to
  the same Table, buffer for buffer;
* pyarrow's files (both page versions, the codecs, dictionary and delta
  encodings, nulls) read to the reference's Table;
* the metadata views, statistics, the page index and bloom filters equal
  the reference's; row-group pruning and ``filters`` on the CPU;
* ``pre_buffer`` and ``io/caching.py`` against the reference's;
* the thrift, RLE, delta, bloom and snappy codecs against the
  reference's on inputs from a seed;
* no fallback: without its host library a read or write raises, as do
  brotli without libbrotli and zstd without ``zstandard``.

Exact throughout (bytes, buffers, Python values with NaN equal to NaN).
"""

import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import arrow_tpu as at
from arrow_tpu.array.array import pylist_equal
from arrow_tpu.io import caching as rcaching
from arrow_tpu.io import parquet as rpq
from arrow_tpu.io.parquet import bloom as rbloom
from arrow_tpu.io.parquet import delta as rdelta
from arrow_tpu.io.parquet import rle as rrle
from arrow_tpu.io.parquet import thrift as rthrift
from arrow_tpu_torch import io_streams
from arrow_tpu_torch.io import caching
from arrow_tpu_torch.io import parquet as pq
from arrow_tpu_torch.io.parquet import bloom, delta, host, rle, thrift
from arrow_tpu_torch.utils import brotli_ctypes, snappy

from test_torch_host_table import assert_same_data, carry_table, port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

N = 300


def _nulls(rng, vals, share=0.15):
    return [None if rng.random() < share else v for v in vals]


def _flat(seed: int = 7, n: int = N):
    """A reference Table of every flat type the writer takes, nulls in
    most columns, from a seed."""
    import datetime
    import decimal
    rng = np.random.default_rng(seed)
    ints = [int(v) for v in rng.integers(-2**40, 2**40, n)]
    floats = [float(v) for v in rng.normal(size=n) * 1e3]
    floats[3:6] = [float("nan"), float("inf"), -0.0]
    words = ["", "alpha", "beta", "γάμμα", "d" * 40]
    return at.table({
        "i64": at.array(_nulls(rng, ints), at.int64()),
        "i32": at.array([v % 2**20 - 2**19 for v in ints], at.int32()),
        "i16": at.array(_nulls(rng, [v % 30000 for v in ints]), at.int16()),
        "i8": at.array([v % 100 - 50 for v in ints], at.int8()),
        "u8": at.array(_nulls(rng, [v % 250 for v in ints]), at.uint8()),
        "u16": at.array([v % 60000 for v in ints], at.uint16()),
        "u32": at.array(_nulls(rng, [v % 2**32 for v in ints]), at.uint32()),
        "u64": at.array([v % 2**63 for v in ints], at.uint64()),
        "f64": at.array(_nulls(rng, floats), at.float64()),
        "f32": at.array([float(np.float32(v)) for v in floats],
                        at.float32()),
        "b": at.array(_nulls(rng, [bool(v % 3) for v in ints]), at.bool_()),
        "s": at.array(_nulls(rng, [words[v % 5] + str(v % 7)
                                   for v in ints]), at.string()),
        "bin": at.array(_nulls(rng, [bytes([v % 256]) * (v % 4)
                                     for v in ints]), at.binary()),
        "dict": at.array(_nulls(rng, [words[v % 4] for v in ints]),
                         at.dictionary(at.int32(), at.string())),
        "day": at.array(_nulls(rng, [datetime.date(1990, 1, 1)
                                     + datetime.timedelta(days=v % 9000)
                                     for v in ints]), at.date32()),
        "ts": at.array([v % 10**15 for v in ints], at.timestamp("us")),
        "ts_ms_utc": at.array(_nulls(rng, [v % 10**12 for v in ints]),
                              at.timestamp("ms", "UTC")),
        "dec": at.array(_nulls(rng, [decimal.Decimal(v % 10**7).scaleb(-2)
                                     for v in ints]),
                        at.decimal128(9, 2)),
        "fsb": at.array(_nulls(rng, [bytes([v % 256, 1, 2]) for v in ints]),
                        at.fixed_size_binary(3)),
    })


def _nested(seed: int = 11, n: int = 120):
    """Lists, structs and a list of structs, with nulls at each level."""
    rng = np.random.default_rng(seed)

    def some(k):
        return [None if rng.random() < 0.1 else int(v)
                for v in rng.integers(-99, 99, k)]
    lists = [None if rng.random() < 0.1 else some(int(rng.integers(0, 4)))
             for _ in range(n)]
    strs = [None if rng.random() < 0.1 else
            [None if rng.random() < 0.1 else f"w{int(v)}"
             for v in rng.integers(0, 9, int(rng.integers(0, 3)))]
            for _ in range(n)]
    structs = [None if rng.random() < 0.1 else
               {"a": None if rng.random() < 0.1 else int(rng.integers(9)),
                "b": f"s{int(rng.integers(5))}"} for _ in range(n)]
    los = [None if rng.random() < 0.1 else
           [{"x": int(v), "y": None if v % 3 == 0 else float(v)}
            for v in rng.integers(0, 50, int(rng.integers(0, 3)))]
           for _ in range(n)]
    return at.table({
        "id": at.array(list(range(n)), at.int64()),
        "ints": at.array(lists, at.list_(at.int64())),
        "strs": at.array(strs, at.list_(at.string())),
        "st": at.array(structs, at.struct([("a", at.int64()),
                                            ("b", at.string())])),
        "los": at.array(los, at.list_(at.struct([("x", at.int64()),
                                                 ("y", at.float64())]))),
    })


@pytest.fixture(scope="module")
def flat():
    rt = _flat()
    return rt, carry_table(rt)


@pytest.fixture(scope="module")
def nested():
    rt = _nested()
    return rt, carry_table(rt)


def _write(mod, tbl, row_group_size=None, **options):
    buf = io.BytesIO()
    with mod.ParquetWriter(buf, tbl.schema, **options) as w:
        w.write_table(tbl, row_group_size)
    return buf.getvalue()


def _same_table(got, want):
    """A port Table against a reference Table: the schema, and each
    column's chunks buffer for buffer (the reference's ``_assemble``
    makes one chunk a row group)."""
    assert got.schema.names == want.schema.names
    for g, w in zip(got.schema.fields, want.schema.fields):
        assert g.type == port_type(w.type), g.name
        assert g.nullable == w.nullable, g.name
    for name in want.schema.names:
        gc, wc = got.column(name), want.column(name)
        assert gc.num_chunks == wc.num_chunks, name
        for i, (a, b) in enumerate(zip(gc.chunks, wc.chunks)):
            assert_same_data(a.data, b.data, f"{name}[{i}]")


MATRIX = [
    {},
    {"compression": "snappy"},
    {"compression": "gzip"},
    {"compression": "brotli"},
    {"compression": "zstd"},
    {"use_dictionary": False},
    {"compression": "snappy", "use_dictionary": False},
    {"data_page_size": None},
    {"data_page_size": 512},
    {"data_page_size": 4096, "compression": "snappy"},
    {"row_group_size": 77},
    {"row_group_size": 77, "data_page_size": 256, "compression": "gzip"},
    {"write_bloom_filters": True},
    {"write_bloom_filters": True, "use_dictionary": False,
     "compression": "snappy"},
    {"column_encoding": {"i64": "DELTA_BINARY_PACKED",
                         "i32": "DELTA_BINARY_PACKED",
                         "f64": "BYTE_STREAM_SPLIT",
                         "f32": "BYTE_STREAM_SPLIT"}},
    {"column_encoding": {"u32": "BYTE_STREAM_SPLIT",
                         "u16": "DELTA_BINARY_PACKED"},
     "compression": "snappy", "data_page_size": 1024},
]


@pytest.mark.parametrize("case", range(len(MATRIX)))
def test_flat_bytes_equal_the_reference_and_each_reads_the_other(flat,
                                                                  case):
    rt, pt = flat
    options = dict(MATRIX[case])
    if options.get("compression") == "zstd":
        pytest.importorskip("zstandard")
    if options.get("compression") == "brotli" and \
            not brotli_ctypes.available():
        pytest.skip("no libbrotli here")
    rg = options.pop("row_group_size", None)
    if options.get("use_dictionary") is False:
        # a dictionary column needs the dictionary encoding in both
        # packages (test_a_dictionary_column_needs_its_encoding)
        names = [n for n in rt.column_names if n != "dict"]
        rt, pt = rt.select(names), pt.select(names)
    want = _write(rpq, rt, rg, **options)
    got = _write(pq, pt, rg, **options)
    assert got == want
    back = rpq.read_table(got)
    _same_table(pq.read_table(want), back)
    assert pylist_equal(back.to_pylist(), rt.to_pylist())


@pytest.mark.parametrize("compression", [None, "snappy", "gzip"])
@pytest.mark.parametrize("rows", [None, 50])
def test_nested_bytes_equal_the_reference(nested, compression, rows):
    rt, pt = nested
    want = _write(rpq, rt, rows, compression=compression)
    got = _write(pq, pt, rows, compression=compression)
    assert got == want
    _same_table(pq.read_table(got), rpq.read_table(want))
    assert pylist_equal(pq.read_table(got).to_pylist(), rt.to_pylist())


def test_write_table_and_files(tmp_path, flat):
    """``write_table`` to a path and to a file object, its options, and
    the reference's ``created_by``."""
    rt, pt = flat
    pq.write_table(pt, str(tmp_path / "p.parquet"), compression="snappy",
                   row_group_size=100)
    rpq.write_table(rt, str(tmp_path / "r.parquet"), compression="snappy",
                    row_group_size=100)
    assert (tmp_path / "p.parquet").read_bytes() == \
        (tmp_path / "r.parquet").read_bytes()
    pf = pq.ParquetFile(str(tmp_path / "p.parquet"))
    assert pf.created_by == "arrow_tpu parquet writer"
    assert pf.num_row_groups == 3 and pf.num_rows == N
    with open(tmp_path / "p.parquet", "rb") as f:
        _same_table(pq.read_table(f), rpq.read_table(
            str(tmp_path / "r.parquet")))


def test_a_dictionary_column_reads_back_as_its_values(flat):
    """Written as BYTE_ARRAY with a dictionary page (in order of first
    appearance, a null as the empty value); read back as plain strings,
    with no ARROW:schema, as the reference's."""
    rt, pt = flat
    data = _write(pq, pt.select(["dict"]))
    back = pq.read_table(data)
    assert str(back.schema.field("dict").type) == "string"
    assert back.column("dict").to_pylist() == rt.column("dict").to_pylist()
    assert pq.ParquetFile(data).key_value_metadata == {}


def test_a_dictionary_column_needs_its_encoding(flat):
    """Two shared limits, kept: without the dictionary encoding a
    dictionary column has no PLAIN encoder in either package, and
    BYTE_STREAM_SPLIT takes no fixed-size binary or decimal column."""
    rt, pt = flat
    for mod, t in ((rpq, rt), (pq, pt)):
        with pytest.raises(KeyError):
            _write(mod, t.select(["dict"]), use_dictionary=False)
        for name in ("fsb", "dec"):
            with pytest.raises(ValueError):
                _write(mod, t.select([name]),
                       column_encoding={name: "BYTE_STREAM_SPLIT"})


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("compression", ["none", "snappy", "gzip", "zstd",
                                         "brotli"])
@pytest.mark.parametrize("use_dictionary", [True, False])
def test_pyarrow_files_read_as_the_reference_reads_them(version,
                                                       compression,
                                                       use_dictionary):
    if compression == "zstd":
        pytest.importorskip("zstandard")
    rng = np.random.default_rng(5)
    n = 5000
    nulls = rng.random(n) < 0.3
    t = pa.table({
        "i64": pa.array(rng.integers(-10**12, 10**12, n)),
        "i32n": pa.array(np.ma.masked_array(
            rng.integers(-50, 50, n).astype(np.int32), mask=nulls)),
        "f64": pa.array(rng.normal(size=n)),
        "f32n": pa.array(np.ma.masked_array(
            rng.normal(size=n).astype(np.float32), mask=nulls)),
        "s": pa.array([None if m else f"v{int(v)}" for m, v in
                       zip(nulls, rng.integers(0, 40, n))]),
        "b": pa.array(rng.random(n) < 0.5),
    })
    buf = io.BytesIO()
    papq.write_table(t, buf, compression=compression,
                     data_page_version=version, data_page_size=8 * 1024,
                     use_dictionary=use_dictionary)
    data = buf.getvalue()
    if version == "2.0":
        # a shared limit, kept: pyarrow's v2 pages code booleans as RLE,
        # which neither package decodes
        for mod in (pq, rpq):
            with pytest.raises(NotImplementedError, match="encoding 3"):
                mod.read_table(data, columns=["b"])
        names = [n for n in t.column_names if n != "b"]
        _same_table(pq.read_table(data, columns=names),
                    rpq.read_table(data, columns=names))
        return
    _same_table(pq.read_table(data), rpq.read_table(data))


def test_pyarrow_delta_and_byte_stream_split_read(tmp_path):
    rng = np.random.default_rng(9)
    n = 3000
    t = pa.table({
        "i64": pa.array(rng.integers(-2**50, 2**50, n)),
        "i32": pa.array(rng.integers(-999, 999, n).astype(np.int32)),
        "f64": pa.array(rng.normal(size=n)),
        "s": pa.array([f"key{int(v):05d}" for v in
                       np.sort(rng.integers(0, 10**5, n))]),
    })
    for version in ("1.0", "2.0"):
        buf = io.BytesIO()
        papq.write_table(t, buf, use_dictionary=False,
                         data_page_version=version,
                         column_encoding={"i64": "DELTA_BINARY_PACKED",
                                          "i32": "DELTA_BINARY_PACKED",
                                          "f64": "BYTE_STREAM_SPLIT",
                                          "s": "DELTA_BYTE_ARRAY"})
        data = buf.getvalue()
        _same_table(pq.read_table(data), rpq.read_table(data))
        buf = io.BytesIO()
        papq.write_table(t.select(["s"]), buf, use_dictionary=False,
                         data_page_version=version,
                         column_encoding={"s": "DELTA_LENGTH_BYTE_ARRAY"})
        _same_table(pq.read_table(buf.getvalue()),
                    rpq.read_table(buf.getvalue()))


def test_pyarrow_nested_and_pyarrow_reads_ours(nested):
    rt, pt = nested
    data = _write(pq, pt)
    pa_back = papq.read_table(io.BytesIO(data))
    assert pylist_equal(pa_back.to_pylist(), rt.to_pylist())
    buf = io.BytesIO()
    papq.write_table(pa_back, buf)
    _same_table(pq.read_table(buf.getvalue()),
                rpq.read_table(buf.getvalue()))


def test_metadata_views_equal_the_reference(flat):
    rt, pt = flat
    data = _write(pq, pt, 100, write_bloom_filters=True)
    got, want = pq.read_metadata(data), rpq.read_metadata(data)
    assert got.to_dict() == want.to_dict()
    assert repr(got) == repr(want)
    assert str(pq.read_schema(data)) == str(pq.ParquetFile(
        data).schema_arrow)
    assert pq.read_schema(data).names == rpq.read_schema(data).names
    assert got.schema.names == want.schema.names
    for i in range(got.num_row_groups):
        g, w = got.row_group(i), want.row_group(i)
        assert g.to_dict() == w.to_dict()
        assert [repr(g.column(c)) for c in range(g.num_columns)] == \
            [repr(w.column(c)) for c in range(w.num_columns)]
    pf, rf = pq.ParquetFile(data), rpq.ParquetFile(data)
    for i in range(pf.num_row_groups):
        assert pylist_equal([pf.statistics(i)], [rf.statistics(i)])
        for c in range(len(pf.columns)):
            assert pylist_equal([pf.column_index(i, c)],
                                [rf.column_index(i, c)])
            assert pf.offset_index(i, c) == rf.offset_index(i, c)
            gb, wb = pf.bloom_filter(i, c), rf.bloom_filter(i, c)
            assert (gb is None) == (wb is None)
            if gb is not None:
                assert gb.bitset() == wb.bitset()
    assert pq.ParquetLogicalType("STRING").to_json() == \
        rpq.ParquetLogicalType("STRING").to_json()
    assert pq.ParquetReader is pq.ParquetFile


def test_write_metadata_equals_the_reference(tmp_path, flat):
    rt, pt = flat
    pq.write_metadata(pt.schema, str(tmp_path / "p"))
    rpq.write_metadata(rt.schema, str(tmp_path / "r"))
    assert (tmp_path / "p").read_bytes() == (tmp_path / "r").read_bytes()


@pytest.mark.parametrize("filters", [
    [("i64", ">", 0)],
    [("i32", "<=", -100), ("b", "==", True)],
    [[("s", "=", "alpha1")], [("u8", "in", [1, 2, 3, 200])]],
    [("day", ">=", 9000), ("f64", "<", 100.0)],
    [("i64", "=", 12345)],
])
def test_read_table_filters_on_the_cpu(flat, filters):
    """Row-group pruning by statistics and bloom filters, then the filter
    plan on the CPU: the reference's rows."""
    rt, pt = flat
    data = _write(pq, pt, 60, write_bloom_filters=True)
    got = pq.read_table(data, filters=filters, device="cpu")
    want = rpq.read_table(data, filters=filters)
    assert pylist_equal(got.to_pylist(), want.to_pylist())
    pf, rf = pq.ParquetFile(data), rpq.ParquetFile(data)
    assert [pf._row_group_may_match(i, filters)
            for i in range(pf.num_row_groups)] == \
        [rf._row_group_may_match(i, filters)
         for i in range(rf.num_row_groups)]


def test_the_card_is_the_default_for_filters(flat):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, pt = flat
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pq.read_table(_write(pq, pt), filters=[("i64", ">", 0)])


def test_row_groups_batches_and_columns(flat):
    rt, pt = flat
    data = _write(pq, pt, 64)
    pf, rf = pq.ParquetFile(data), rpq.ParquetFile(data)
    assert pf.num_row_groups == rf.num_row_groups == 5
    _same_table(pf.read_row_groups([1, 3], columns=["s", "f64"]),
                rf.read_row_groups([1, 3], columns=["s", "f64"]))
    assert [b.num_rows for b in pf.iter_batches(50, columns=["i64"])] == \
        [b.num_rows for b in rf.iter_batches(50, columns=["i64"])]
    assert pf.scan_contents(["i64"]) == rf.scan_contents(["i64"]) == N
    sel = pq.read_table(data, columns=["dec", "i8"])
    assert sel.column_names == ["i8", "dec"]  # the file's order
    _same_table(sel, rpq.read_table(data, columns=["dec", "i8"]))


def test_pre_buffer_and_the_range_cache(flat):
    """One coalesced read of the selected chunks; the same Table as a read
    without it; the cache and coalescing equal the reference's."""
    rt, pt = flat
    data = _write(pq, pt, 100)

    class Counting(io.BytesIO):
        reads = 0

        def read(self, *a):
            Counting.reads += 1
            return super().read(*a)

    pf = pq.ParquetFile(Counting(data))
    Counting.reads = 0
    got = pf.read(columns=["i64", "s"], pre_buffer=True)
    assert Counting.reads == 1
    _same_table(got, rpq.ParquetFile(data).read(columns=["i64", "s"]))
    pf = pq.ParquetFile(data)
    pf.pre_buffer(row_groups={0, 2}, cache_options=caching.CacheOptions(
        hole_size_limit=0))
    _same_table(pf.read_row_groups([0, 2]),
                rpq.ParquetFile(data).read_row_groups([0, 2]))
    rng = np.random.default_rng(2)
    for _ in range(20):
        ranges = [(int(o), int(n)) for o, n in zip(
            rng.integers(0, 10**6, 12), rng.integers(0, 5000, 12))]
        for kw in ({}, {"hole_size_limit": 100},
                   {"range_size_limit": 20000}):
            assert caching.coalesce_ranges(ranges, **kw) == \
                rcaching.coalesce_ranges(ranges, **kw)
    blob = bytes(range(256)) * 40
    c = caching.ReadRangeCache(io.BytesIO(blob), caching.CacheOptions())
    c.cache([(0, 16), (20, 16), (5000, 100)])
    assert c.read(4, 4) == blob[4:8] and c.read(5010, 20) == blob[5010:5030]
    assert c.read(9000, 4) == blob[9000:9004]
    assert vars(caching.CacheOptions.defaults()) == \
        vars(rcaching.CacheOptions.defaults())


# --- the codecs ------------------------------------------------------------------

def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return [b"", b"a", b"abcd" * 1000, rng.bytes(70000),
            rng.integers(0, 4, 300000).astype(np.uint8).tobytes(),
            np.round(rng.uniform(0, 1e5, 50000), 2).tobytes(),
            bytes(70000), (b"xy" * 40 + rng.bytes(7)) * 3000]


def test_snappy_equals_the_reference():
    import arrow_tpu.native as native
    for data in _inputs():
        packed = snappy.compress(data)
        assert packed == native.snappy_compress(data)
        assert snappy.decompress(packed) == data
        assert snappy.decompress(packed, len(data)) == data
        assert native.snappy_decompress(packed, len(data)) == data
        assert io_streams.decompress(io_streams.compress(
            data, "snappy"), len(data), "snappy", asbytes=True) == data
    with pytest.raises(ValueError, match="malformed"):
        snappy.decompress(b"\x10\x0f\xff\xff")


def test_brotli_equals_the_reference():
    from arrow_tpu.utils import brotli_ctypes as rbrotli
    if not brotli_ctypes.available():
        pytest.skip("no libbrotli here")
    for data in _inputs()[:5]:
        packed = brotli_ctypes.compress(data)
        assert packed == rbrotli.compress(data)
        assert brotli_ctypes.decompress(packed, len(data)) == data
        assert brotli_ctypes.decompress(packed) == data


def test_rle_equals_the_reference():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 8, 9, 100, 511, 512, 513, 5000):
        for bw in (1, 2, 3, 7, 8, 13, 20):
            hi = 1 << bw
            runs = np.repeat(rng.integers(0, hi, max(n // 7, 1)),
                             rng.integers(1, 30, max(n // 7, 1)))[:n]
            for vals in (rng.integers(0, hi, n), runs,
                         np.full(n, hi - 1)):
                enc = rle.encode_rle(vals, bw)
                assert enc == rrle.encode_rle(vals, bw), (n, bw)
                pad = b"\x05" + enc
                assert np.array_equal(rle.decode_rle(pad, 1, len(vals), bw),
                                      rrle.decode_rle(pad, 1, len(vals), bw))
    assert rle.bit_width_for(0) == rrle.bit_width_for(0) == 1
    with pytest.raises(ValueError, match="truncated"):
        rle.decode_rle(b"\x03", 0, 10, 4)


def test_delta_and_byte_stream_split_equal_the_reference():
    rng = np.random.default_rng(6)
    for n in (1, 2, 127, 128, 129, 1000):
        vals = rng.integers(-2**62, 2**62, n)
        enc = delta.encode_delta_binary_packed(vals)
        assert enc == rdelta.encode_delta_binary_packed(vals)
        got, end = delta.decode_delta_binary_packed(enc, 0)
        assert np.array_equal(got, vals) and end == len(enc)
        f = rng.normal(size=n)
        assert delta.encode_byte_stream_split(f) == \
            rdelta.encode_byte_stream_split(f)
        assert np.array_equal(delta.decode_byte_stream_split(
            delta.encode_byte_stream_split(f), n, 8).reshape(-1).view(
                np.float64), f)


def test_thrift_and_bloom_equal_the_reference():
    for mod in (thrift, rthrift):
        w = mod.CompactWriter()
        w.field_i32(1, -7)
        w.field_i64(20, 2**40)
        w.field_binary(21, "héllo")
        w.field_bool(22, True)
        w.field_list_begin(23, mod.CT_I32, 20)
        for v in range(20):
            w.elem_i32(v - 10)
        w.field_struct_begin(24)
        w.field_i16(1, 3)
        w.struct_end()
        w.struct_end()
        if mod is thrift:
            got = w.bytes()
        else:
            assert w.bytes() == got
    assert thrift.CompactReader(got).read_struct() == \
        rthrift.CompactReader(got).read_struct()
    rng = np.random.default_rng(8)
    u64 = rng.integers(0, 2**63, 1000).astype(np.uint64)
    assert np.array_equal(bloom.xxhash64_u64(u64), rbloom.xxhash64_u64(u64))
    u32 = u64.astype(np.uint32)
    assert np.array_equal(bloom.xxhash64_u32(u32), rbloom.xxhash64_u32(u32))
    for b in (b"", b"a", b"0123456789abcdef" * 5, "δδδ".encode()):
        assert bloom.xxhash64_bytes(b) == rbloom.xxhash64_bytes(b)
    bf, rbf = bloom.SplitBlockBloomFilter.for_ndv(500), \
        rbloom.SplitBlockBloomFilter.for_ndv(500)
    for v in range(500):
        bf.insert_hash(bloom.hash_value(v * 7, 2))
        rbf.insert_hash(rbloom.hash_value(v * 7, 2))
    assert bf.bitset() == rbf.bitset()
    assert all(bf.check_hash(bloom.hash_value(v * 7, 2)) for v in range(500))


def test_host_helpers_equal_the_reference():
    import arrow_tpu.native as native
    rng = np.random.default_rng(10)
    n = 2000
    lens = rng.integers(0, 9, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    pool = rng.integers(97, 100, int(offs[-1])).astype(np.uint8)
    valid = (rng.random(n) < 0.8).astype(np.uint8)
    for v in (None, valid):
        got, want = host.dict_encode_binary(pool, offs, v), \
            native.dict_encode_binary(pool, offs, v)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert host.minmax_binary(pool, offs, v) == \
            native.minmax_binary(pool, offs, v)
        assert host.plain_encode_byte_array(pool, offs, v) == \
            native.plain_encode_byte_array(pool, offs, v)
    ids = rng.integers(0, n, 500)
    assert all(np.array_equal(a, b) for a, b in zip(
        host.gather_var_bytes(pool, offs, ids),
        native.gather_var_bytes(pool, offs, ids)))
    enc = host.plain_encode_byte_array(pool, offs, None)
    got_offs, got_bytes = host.plain_decode_byte_array(enc, n)
    assert np.array_equal(got_offs, offs) and np.array_equal(got_bytes, pool)
    with pytest.raises(ValueError, match="truncated"):
        host.plain_decode_byte_array(enc[:-1], n)


# --- no fallback -----------------------------------------------------------------

def test_without_its_host_library_parquet_raises(monkeypatch, flat):
    """A read or write needs the host library: where it does not build,
    both raise, and nothing falls back to a slower path."""
    from arrow_tpu_torch.kernels import _build
    _, pt = flat
    data = _write(pq, pt)

    def fail(name):
        raise _build.BuildError(f"{name}.cpp: no compiler")
    monkeypatch.setattr(_build, "host_library", fail)
    host.library.cache_clear()
    snappy.library.cache_clear()
    try:
        with pytest.raises(NotImplementedError, match="host library"):
            pq.read_table(data)
        with pytest.raises(NotImplementedError, match="host library"):
            _write(pq, pt)
        with pytest.raises(NotImplementedError, match="host library"):
            io_streams.Codec("snappy").compress(b"abc")
        assert not io_streams.Codec.is_available("snappy")
    finally:
        monkeypatch.undo()
        host.library.cache_clear()
        snappy.library.cache_clear()
    assert pq.read_table(data).num_rows == N


def test_brotli_and_zstd_raise_where_they_are_missing(monkeypatch, flat):
    from arrow_tpu_torch.io.parquet import reader, writer
    _, pt = flat
    brotli_file = _write(rpq, at.table({"x": [1, 2]}), compression="brotli") \
        if brotli_ctypes.available() else None
    monkeypatch.setattr(brotli_ctypes, "_load", lambda: False)
    assert not io_streams.Codec.is_available("brotli")
    with pytest.raises(io_streams.ArrowInvalid, match="libbrotli"):
        io_streams.Codec("brotli")
    with pytest.raises(NotImplementedError, match="libbrotli"):
        _write(pq, pt, compression="brotli")
    if brotli_file is not None:
        with pytest.raises(NotImplementedError, match="libbrotli"):
            pq.read_table(brotli_file)
    monkeypatch.setattr(reader, "_zstd", None)
    monkeypatch.setattr(writer, "_zstd", None)
    with pytest.raises(NotImplementedError, match="zstandard"):
        _write(pq, pt, compression="zstd")
    pytest.importorskip("zstandard")
    zstd_file = _write(rpq, at.table({"x": [1, 2]}), compression="zstd")
    with pytest.raises(NotImplementedError, match="zstandard"):
        pq.read_table(zstd_file)


def test_no_module_needs_cryptography_or_a_compiler_to_import():
    import subprocess
    import sys
    code = ("import sys; sys.modules['cryptography'] = None; "
            "import arrow_tpu_torch.io.parquet as pq; "
            "import arrow_tpu_torch.io.parquet.encryption; "
            "import arrow_tpu_torch.dataset; "
            "from arrow_tpu_torch.kernels import _build; "
            "assert not any(k.startswith('host:') for k in _build._LIBS)")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
