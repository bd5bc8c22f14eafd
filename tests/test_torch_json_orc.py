"""JSON and ORC in the port (``arrow_tpu_torch/io/json.py``, ``io/orc.py``,
``csrc/orc_host.cpp``, the flat JSON tokenizer of ``csrc/csv_host.cpp``)
against the JAX package's (``arrow_tpu/io/json.py``, ``io/orc.py``), with
pyarrow as an oracle only, and ``chip_smoke.py``'s phase 3q on the CPU.

* JSON: the cases of ``tests/test_json_parallel.py``,
  ``test_interop_json_gandiva.py`` and ``test_io_interop.py``'s JSON
  class through both packages: the flat native route, the blocks on
  threads and their unification, the Python route for nested records and
  explicit schemas, ``open_json`` block by block, the options;
* ORC: ``tests/test_orc.py``'s cases: pyarrow's files over every encoding
  and compression the reference reads (none, zlib, snappy, zstd; RLEv1
  and RLEv2 with PATCHED_BASE; dictionary strings, dates, timestamps,
  decimals), the writer's bytes stripe for stripe (none and zlib), the
  RLEv2 coder against the reference's Python one, corrupt files, the
  incremental writer;
* no fallback: without its host library a read or write raises, and zstd
  without ``zstandard`` raises as the reference's does.

Exact throughout.
"""

import datetime as dt
import io
import json
import random
import sys
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pytest

import arrow_tpu as at
import arrow_tpu.native as rnat
from arrow_tpu.array.array import pylist_equal
from arrow_tpu.io import json as rjson
from arrow_tpu.io import orc as rorc
from arrow_tpu_torch.io import json as pjson
from arrow_tpu_torch.io import orc as porc

from test_torch_host_table import (assert_same_data, carry_table,
                                   port_schema, port_type)
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def same_table(got, want):
    assert got.column_names == want.column_names
    assert [f.type for f in got.schema] == \
        [port_type(f.type) for f in want.schema]
    assert pylist_equal(got.to_pydict(), want.to_pydict())


def same_or_same_error(port_call, ref_call):
    try:
        want = ref_call()
    except Exception as exc:  # noqa: BLE001 - its class is the oracle
        with pytest.raises(Exception) as got:
            port_call()
        assert type(got.value).__name__ == type(exc).__name__, got.value
        return None
    got = port_call()
    same_table(got, want)
    return got


# --- JSON: tests/test_json_parallel.py --------------------------------------------

def _ndjson(n, drift_at=None, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rec = {"a": None if i % 11 == 0 else int(i),
               "b": float(rng.normal()), "s": f"v{i % 53}"}
        if drift_at is not None and i >= drift_at:
            rec["extra"] = i * 2
        rows.append(json.dumps(rec))
    return ("\n".join(rows) + "\n").encode()


@pytest.fixture(scope="module")
def big_ndjson():
    return _ndjson(120_000)


def test_parallel_equals_single_block(big_ndjson):
    data = big_ndjson[:len(big_ndjson) // 4]
    data = data[:data.rfind(b"\n") + 1]
    whole = pjson._native_json_table(data, pjson.ReadOptions())
    spans = pjson._split_newline_blocks(data, 4)
    assert spans == rjson._split_newline_blocks(data, 4)
    uni = pjson._unify_chunk_tables([pjson._native_json_table(
        data[a:b], pjson.ReadOptions()) for a, b in spans])
    same_table(uni, rjson._native_json_table(data, rjson.ReadOptions()))
    assert uni.to_pydict() == whole.to_pydict()


def test_parallel_schema_drift_unifies():
    head, tail = _ndjson(5_000), _ndjson(3_000, drift_at=0, seed=1)

    def unified(mod):
        return mod._unify_chunk_tables([
            mod._native_json_table(head, mod.ReadOptions()),
            mod._native_json_table(tail, mod.ReadOptions())])
    got = unified(pjson)
    same_table(got, unified(rjson))
    assert got.column("extra").to_pylist()[4_999:5_001] == [None, 0]


@pytest.mark.parametrize("second", ["float", "missing", "null", "string"])
def test_block_types_unify_as_the_reference_does(second):
    first = [json.dumps({"x": 1, "y": "a"}) for _ in range(100)]
    other = {"float": {"x": 2.5, "y": "b"}, "missing": {"y": "b"},
             "null": {"x": None, "y": "b"}, "string": {"x": "s", "y": "b"}}
    rows = first + [json.dumps(other[second]) for _ in range(100)]
    data = ("\n".join(rows) + "\n").encode()

    def unified(mod):
        spans = mod._split_newline_blocks(data, 2)
        parts = [mod._native_json_table(data[a:b], mod.ReadOptions())
                 for a, b in spans]
        if any(p is None for p in parts):
            return "a block needs the Python route"
        return mod._unify_chunk_tables(parts)
    want = unified(rjson)
    got = unified(pjson)
    if want is None or isinstance(want, str):
        assert got == want   # the caller parses the whole input
    else:
        same_table(got, want)
    same_table(pjson.read_json(data), rjson.read_json(data))


def test_open_json_is_lazy_and_complete(big_ndjson):
    data = big_ndjson[:2_000_000]
    data = data[:data.rfind(b"\n") + 1]
    got = list(pjson.open_json(data, read_options=pjson.ReadOptions(
        block_size=1 << 16)))
    want = list(rjson.open_json(data, read_options=rjson.ReadOptions(
        block_size=1 << 16)))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert g.schema.names == w.schema.names == ["a", "b", "s"]
        assert g.to_pydict() == w.to_pydict()


def test_open_json_follows_the_first_blocks_schema():
    data = _ndjson(3_000) + _ndjson(3_000, drift_at=0, seed=2)
    for ro in ({"block_size": 1 << 15}, {"block_size": 1 << 30}):
        got = list(pjson.open_json(data, read_options=pjson.ReadOptions(
            **ro)))
        want = list(rjson.open_json(data, read_options=rjson.ReadOptions(
            **ro)))
        assert [g.to_pydict() for g in got] == [w.to_pydict() for w in want]


def test_read_json_large_parallel_matches_the_reference(big_ndjson):
    got = pjson.read_json(big_ndjson)
    same_table(got, rjson.read_json(big_ndjson))
    assert got.column("a").num_chunks == 1
    import pyarrow.json as pj
    want = pj.read_json(io.BytesIO(big_ndjson))
    assert got.column("b").to_pylist() == want.column("b").to_pylist()


# --- JSON: tests/test_interop_json_gandiva.py and test_io_interop.py ---------------

JSON_CASES = {
    "inference": b'{"a": 1, "b": "x"}\n{"a": null, "b": "y", "c": 2.5}\n',
    "nested": b'{"s": {"x": 1}, "l": [1, 2]}\n{"s": null, "l": []}\n',
    "escapes": (b'{"s": "a\\"b\\\\c\\nd\\u00e9\\ud83d\\ude00", "i": -5}\n'
                b'{"s": null, "i": 7}\n'),
    "numbers": (b'{"x": 1, "y": 1.5, "z": 2e3}\n'
                b'{"x": -9, "y": 0.25, "z": 1e-3}\n'),
    "nested_lists": (b'{"o": {"a": [1, 2], "b": "x"}, "l": [1, 2, null]}\n'
                     b'{"o": null, "l": []}\n'),
    "bool_null": (b'{"b": true, "n": null}\n{"b": false, "n": null}\n'
                  b'{"b": null, "n": null}\n'),
    "mixed": b'{"m": 1}\n{"m": "x"}\n{"m": true}\n{"m": 2.5}\n',
    "big_int": b'{"m": 123456789012345678901234567890}\n{"m": 1}\n',
    "crlf_blank": b'{"a": 1}\r\n\r\n{"a": 2}\r\n',
    "empty": b"",
}


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_read_json_matches_the_reference(case, monkeypatch):
    data = JSON_CASES[case]
    got = same_or_same_error(lambda: pjson.read_json(data),
                             lambda: rjson.read_json(data))
    if got is not None and case in ("inference", "escapes", "numbers",
                                    "bool_null", "nested"):
        import pyarrow.json as pj
        assert got.to_pydict() == pj.read_json(
            pa.BufferReader(data)).to_pydict()
    # the Python routes (the tokenizers declined) give the same Table
    monkeypatch.setattr(pjson, "_native_json_table", lambda *a, **k: None)
    monkeypatch.setattr(rjson, "_native_json_table", lambda *a, **k: None)
    same_or_same_error(lambda: pjson.read_json(data),
                       lambda: rjson.read_json(data))


@pytest.mark.parametrize("behavior", ["error", "infer", "ignore"])
def test_explicit_schema(behavior):
    for data in (b'{"a": 3}\n', b'{"a": 3, "zz": 1}\n{"a": 4.5}\n'):
        same_or_same_error(
            lambda: pjson.read_json(data, parse_options=pjson.ParseOptions(
                explicit_schema=port_schema(at.schema([("a", at.float64())])),
                unexpected_field_behavior=behavior)),
            lambda: rjson.read_json(data, parse_options=rjson.ParseOptions(
                explicit_schema=at.schema([("a", at.float64())]),
                unexpected_field_behavior=behavior)))


@pytest.mark.parametrize("name", ["ReadOptions", "ParseOptions"])
def test_the_json_option_classes(name):
    import pyarrow.json as pj
    inst = getattr(pjson, name)()
    assert [n for n in dir(getattr(pj, name)) if not n.startswith("_")
            and not hasattr(inst, n)] == []
    assert vars(inst) == vars(getattr(rjson, name)())
    assert inst.equals(getattr(pjson, name)()) and inst.validate() is None


def test_read_json_sources(tmp_path):
    data = JSON_CASES["inference"]
    (tmp_path / "a.json").write_bytes(data)
    for src in (str(tmp_path / "a.json"), io.BytesIO(data),
                bytearray(data)):
        same_table(pjson.read_json(src), rjson.read_json(data))


# --- ORC: tests/test_orc.py -----------------------------------------------------

def _pyarrow_orc(t, **kw):
    buf = io.BytesIO()
    paorc.write_table(t, buf, **kw)
    return buf.getvalue()


def _read_both(raw, columns=None):
    return same_or_same_error(lambda: porc.read_table(raw, columns),
                              lambda: rorc.read_table(raw, columns))


def _read_or_error(read, blob):
    """A read's Table, or the class name of what it raised."""
    try:
        return read(blob)
    except Exception as exc:  # noqa: BLE001 - compared by class
        return type(exc).__name__


def _same_read(blob):
    """Both packages raise the same class over ``blob``, or read the same
    buffers (a corrupt file may read to strings that are not UTF-8)."""
    got = _read_or_error(porc.read_table, blob)
    want = _read_or_error(rorc.read_table, blob)
    if isinstance(want, str):
        assert got == want
        return
    assert got.column_names == want.column_names
    for g, w in zip(got.columns, want.columns):
        assert g.num_chunks == w.num_chunks
        for a, b in zip(g.chunks, w.chunks):
            assert_same_data(a.data, b.data)


def test_basic_types_with_nulls():
    t = pa.table({"a": [1, 2, None], "s": ["x", None, "z"],
                  "f": [1.5, None, 3.5]})
    assert _read_both(_pyarrow_orc(t)).to_pydict() == t.to_pydict()


@pytest.fixture(scope="module")
def encodings_table():
    rng = np.random.default_rng(1)
    n = 20_000
    return pa.table({
        "i64": pa.array([int(v) if rng.random() > 0.05 else None
                         for v in rng.integers(-10**12, 10**12, n)]),
        "seq": pa.array(np.arange(n)),
        "const": pa.array(np.full(n, 7)),
        "f64": pa.array(rng.normal(size=n)),
        "dict_s": pa.array([random.Random(3).choice(
            ["aa", "bb", None, "dddd"]) for _ in range(n)]),
        "uniq": pa.array([f"u{i}" for i in range(n)]),
        "b": pa.array([bool(v) if rng.random() > 0.1 else None
                       for v in rng.integers(0, 2, n)]),
    })


@pytest.mark.parametrize("comp", ["uncompressed", "zlib", "zstd", "snappy"])
def test_all_encodings_compressions_stripes(encodings_table, comp):
    raw = _pyarrow_orc(encodings_table, compression=comp,
                       stripe_size=64 * 1024)
    f = porc.ORCFile(raw)
    assert len(f.stripes) > 1
    assert _read_both(raw).to_pydict() == encodings_table.to_pydict()


def test_temporal_decimal_small_types():
    t = pa.table({
        "d": pa.array([dt.date(2020, 1, 1), None], pa.date32()),
        "ts": pa.array([dt.datetime(2021, 5, 1, 12, 30, 15, 123456), None],
                       pa.timestamp("us")),
        "dec": pa.array([Decimal("12.34"), Decimal("-0.01")],
                        pa.decimal128(10, 2)),
        "i8": pa.array([1, -5], pa.int8()),
        "i16": pa.array([300, None], pa.int16()),
        "f32": pa.array([1.5, None], pa.float32()),
        "bin": pa.array([b"ab", None], pa.binary()),
    })
    assert _read_both(_pyarrow_orc(t)).to_pydict() == t.to_pydict()


def test_column_selection_and_schema():
    raw = _pyarrow_orc(pa.table({"a": [1], "b": ["x"], "c": [2.0]}))
    f = porc.ORCFile(raw)
    assert f.schema.names == ["a", "b", "c"]
    assert [t for t in f.schema.types] == [
        port_type(t) for t in rorc.ORCFile(raw).schema.types]
    out = _read_both(raw, ["c", "a"])
    assert out.to_pydict() == {"a": [1], "c": [2.0]}
    assert porc.ORCFile(raw).num_rows == 1


def test_not_orc_raises():
    for mod in (rorc, porc):
        with pytest.raises(ValueError):
            mod.read_table(b"PAR1not-an-orc-file")


def _rt_types():
    return {"i64": at.int64(), "i32": at.int32(), "i16": at.int16(),
            "i8": at.int8(), "f32": at.float32(), "f64": at.float64(),
            "s": at.string(), "bin": at.binary(), "b": at.bool_(),
            "d": at.date32(), "ts": at.timestamp("us"),
            "dec": at.decimal128(12, 2)}


def _writer_table(n, seed):
    rng = np.random.default_rng(seed)
    r = random.Random(seed)
    cols = {
        "i64": [int(v) if rng.random() > 0.05 else None
                for v in rng.integers(-2**62, 2**62, n)],
        "i32": [int(v) for v in rng.integers(-2**31, 2**31, n)],
        "i16": [int(v) if rng.random() > 0.5 else None
                for v in rng.integers(-2**15, 2**15, n)],
        "i8": [int(v) for v in rng.integers(-128, 128, n)],
        "f32": [float(np.float32(v)) if rng.random() > 0.1 else None
                for v in rng.normal(size=n)],
        "f64": [float(v) for v in rng.normal(size=n)],
        "s": [r.choice(["aa", "bbbb", None, "Ω" * 3, ""]) for _ in range(n)],
        "bin": [bytes([i % 256]) if i % 11 else None for i in range(n)],
        "b": [bool(v) if rng.random() > 0.2 else None
              for v in rng.integers(0, 2, n)],
        "d": [dt.date(2020, 1, 1) + dt.timedelta(days=int(v))
              if rng.random() > 0.1 else None
              for v in rng.integers(-30000, 30000, n)],
        "ts": [dt.datetime(2015, 1, 1) + dt.timedelta(microseconds=int(v))
               if rng.random() > 0.1 else None
               for v in rng.integers(-10**15, 10**15, n)],
        "dec": [Decimal(int(v)).scaleb(-2) if rng.random() > 0.1 else None
                for v in rng.integers(-10**10, 10**10, n)],
    }
    ts = _rt_types()
    return at.table({k: at.array(v, ts[k]) for k, v in cols.items()})


@pytest.fixture(scope="module")
def writer_table():
    rt = _writer_table(6_000, 7)
    return rt, carry_table(rt)


def _orc_bytes(mod, tbl, **kw):
    buf = io.BytesIO()
    mod.write_table(tbl, buf, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("comp", ["uncompressed", "zlib"])
@pytest.mark.parametrize("stripe_rows", [1_000, 8_192, 65_536])
def test_writer_bytes_equal_the_reference(writer_table, comp, stripe_rows):
    rt, pt = writer_table
    raw = _orc_bytes(porc, pt, stripe_rows=stripe_rows, compression=comp)
    assert raw == _orc_bytes(rorc, rt, stripe_rows=stripe_rows,
                             compression=comp)
    assert len(porc.ORCFile(raw).stripes) == -(-rt.num_rows // stripe_rows)
    orig = rt.to_pydict()
    assert porc.read_table(raw).to_pydict() == orig
    got = paorc.read_table(io.BytesIO(raw)).to_pydict()   # liborc
    assert got["i64"] == orig["i64"] and got["s"] == orig["s"]
    assert [None if v is None else v.replace(tzinfo=None)
            for v in got["ts"]] == orig["ts"]


def test_writer_empty_and_all_null():
    for rt in (at.table({"a": at.array([], at.int64()),
                         "s": at.array([], at.string())}),
               at.table({"x": at.array([None, None, None], at.int32())})):
        raw = _orc_bytes(porc, carry_table(rt))
        assert raw == _orc_bytes(rorc, rt)
        assert porc.read_table(raw).to_pydict() == rt.to_pydict()
        assert paorc.read_table(io.BytesIO(raw)).to_pydict() == \
            rt.to_pydict()


def test_writer_liborc_rewrites_our_file(writer_table):
    rt, pt = writer_table
    pyt = paorc.read_table(io.BytesIO(_orc_bytes(porc, pt)))
    raw = _pyarrow_orc(pyt.drop_columns(["ts"]))
    got = _read_both(raw).to_pydict()
    want = rt.to_pydict()
    assert all(got[k] == want[k] for k in want if k != "ts")


@pytest.mark.parametrize("bad", ["dictionary", "compression"])
def test_writer_refusals_match_the_reference(bad):
    rt = at.table({"d": at.array(["x", "y"]).dictionary_encode()}) \
        if bad == "dictionary" else at.table({"a": [1]})
    kw = {"compression": "snappy"} if bad == "compression" else {}
    for mod, tbl in ((rorc, rt), (porc, carry_table(rt))):
        with pytest.raises(NotImplementedError):
            _orc_bytes(mod, tbl, **kw)


def test_orc_writer_incremental():
    rt = at.table({"a": [1, 2, 3], "s": ["x", None, "z"]})
    pt = carry_table(rt)
    outs = []
    for mod, tbl in ((rorc, rt), (porc, pt)):
        buf = io.BytesIO()
        with mod.ORCWriter(buf) as w:
            w.write(tbl)
            w.write(tbl)
        outs.append(buf.getvalue())
        with pytest.raises(ValueError):
            mod.ORCWriter(io.BytesIO()).close()
    assert outs[0] == outs[1]
    assert porc.read_table(outs[1]).num_rows == 6


def _reference_python_rlev2(monkeypatch):
    """The reference's RLEv2 coder with its native library declined: its
    Python decoder and encoder."""
    monkeypatch.setattr(rnat, "orc_rlev2_decode", lambda *a: None)
    monkeypatch.setattr(rnat, "orc_rlev2_encode", lambda *a: None)


def test_rlev2_coder_matches_the_reference_python_one(monkeypatch):
    rng = np.random.default_rng(11)
    cases = []
    for signed in (False, True):
        for trial in range(60):
            kind = trial % 4
            k = int(rng.integers(1, 700))
            if kind == 0:
                vals = np.repeat(rng.integers(0, 50, 5), k // 5 + 1)[:k]
            elif kind == 1:
                vals = np.cumsum(rng.integers(0, 9, k))
            elif kind == 2:
                vals = rng.integers(0, 1 << 40, k)
            else:
                vals = rng.integers(0, 100, k)
                vals[::max(k // 8, 1)] += 1 << 30
            if signed:
                vals = vals - int(vals.mean())
            cases.append((vals.astype(np.int64), signed))
    cases += [(rng.integers(-3, 3, int(k)).astype(np.int64), True)
              for k in rng.integers(1, 64, 40)]
    _reference_python_rlev2(monkeypatch)
    for vals, signed in cases:
        enc = porc._rlev2_encode(vals, signed)
        assert enc == rorc._rlev2_encode(vals, signed)
        got = porc._rlev2_decode(enc, len(vals), signed)
        assert np.array_equal(got, rorc._rlev2_decode(enc, len(vals),
                                                      signed))
        assert np.array_equal(got, vals)


@pytest.mark.parametrize("pw_shift", [28, 29, 30, 31, 37, 45])
def test_patched_base_unaligned_patch_width_liborc(pw_shift, monkeypatch):
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 100, 512).astype(np.int64)
    vals[5:25] = (1 << pw_shift) + rng.integers(0, 1000, 20)
    raw = _pyarrow_orc(pa.table({"x": vals}))
    got = np.asarray(porc.read_table(raw).column("x").combine().to_pylist())
    assert np.array_equal(got, vals)
    _reference_python_rlev2(monkeypatch)
    assert rorc.read_table(raw).column("x").to_pylist() == vals.tolist()


def test_rlev1_and_byte_rle_files(monkeypatch):
    """A file of RLEv1 streams (an ORC 0.11 writer's) and byte RLE."""
    t = pa.table({"a": list(range(-50, 250)) * 3, "b": [1, 2, None] * 300,
                  "i8": pa.array([-1, 0, 1] * 300, pa.int8()),
                  "s": ["x", "yy", None] * 300})
    raw = _pyarrow_orc(t, file_version="0.11")
    assert _read_both(raw).to_pydict() == t.to_pydict()


@pytest.mark.parametrize("seed", [3, 4])
def test_orc_truncations_and_bitflips(seed):
    raw = _pyarrow_orc(pa.table({"a": list(range(200)),
                                 "s": [f"v{i % 7}" for i in range(200)]}))
    rng = np.random.default_rng(seed)
    blobs = [raw[:cut] for cut in sorted(set(
        int(v) for v in rng.integers(1, len(raw), 10)))]
    for _ in range(10):
        data = bytearray(raw)
        data[int(rng.integers(0, len(data)))] ^= 1 << int(rng.integers(0, 8))
        blobs.append(bytes(data))
    for blob in blobs:
        _same_read(blob)


def test_zstd_needs_zstandard(monkeypatch, encodings_table):
    raw = _pyarrow_orc(encodings_table.slice(0, 100), compression="zstd")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    for mod in (rorc, porc):
        with pytest.raises(ImportError):
            mod.read_table(raw)


def test_without_its_host_library_orc_and_json_raise(monkeypatch):
    from arrow_tpu_torch.io import csv_host
    from arrow_tpu_torch.kernels import _build
    raw = _pyarrow_orc(pa.table({"a": [1, 2]}))
    pt = carry_table(at.table({"a": [1, 2]}))

    def fail(name):
        raise _build.BuildError(f"{name}.cpp: no compiler")
    monkeypatch.setattr(_build, "host_library", fail)
    porc._library.cache_clear()
    csv_host.library.cache_clear()
    try:
        for call in (lambda: porc.read_table(raw),
                     lambda: _orc_bytes(porc, pt),
                     lambda: pjson.read_json(b'{"a": 1}\n'),
                     lambda: pjson.read_json(b'{"a": 1}\n', parse_options=(
                         pjson.ParseOptions(explicit_schema=pt.schema)))):
            with pytest.raises(NotImplementedError, match="host library"):
                call()
    finally:
        monkeypatch.undo()
        porc._library.cache_clear()
        csv_host.library.cache_clear()
    assert porc.read_table(raw).num_rows == 2


def test_orc_is_a_lazy_attribute():
    import arrow_tpu_torch
    assert arrow_tpu_torch.orc is porc


# --- chip_smoke.py's phase 3q on the CPU ------------------------------------------

def test_chip_smoke_phase_3q_on_cpu():
    """Phase 3q over phase 3l's Tables at SF 0.005 on the CPU: the CSV
    scan against numpy and the in-memory plan, open_csv against read_csv,
    the ORC dataset against the Table's plan and numpy, the zlib round
    trip, the JSON group-by against numpy and the Table's plan (no
    launches here)."""
    import chip_smoke
    _, host = chip_smoke.phase_host(sf=0.005, device="cpu")
    launches, facts = chip_smoke.phase_csv_json_orc(host, device="cpu")
    assert launches == {}
    assert set(chip_smoke.CSV_JSON_ORC_LAUNCHES) <= set(facts["walls"])
    assert facts["facts"]["lineitem csv GB"] > 0
    assert facts["facts"]["orders orc zlib GB"] > 0


def test_write_ndjson_reads_back_as_the_reference_reads_it(tmp_path):
    """chip_smoke's ndjson writer: every record of the Table, read back by
    both packages to its values, floats bit for bit."""
    import chip_smoke
    from arrow_tpu_torch.io import tpch
    cu = tpch.host_and_device("customer", 0.002, device="cpu")[0]
    path = str(tmp_path / "c.json")
    chip_smoke.write_ndjson(cu, path)
    got = pjson.read_json(path)
    same_table(got, rjson.read_json(path))
    want = {n: (chip_smoke._decoded(cu.column(n)) if cu.column(n).type.id
                == port_type(at.dictionary(at.int32(), at.string())).id
                else cu.column(n).combine()).to_pylist()
            for n in cu.column_names}
    assert got.to_pydict() == want
