"""Two repairs of the port's Parquet (``arrow_tpu_torch/io/parquet/``,
``csrc/parquet_host.cpp``), held to pyarrow (a test oracle only).

* Non-nullable columns. The writer declares a non-nullable field
  REQUIRED and now writes no definition levels for it, flat or nested; a
  nested field's levels follow the schema it writes. This departs from
  the reference (``arrow_tpu/io/parquet/writer.py``), which declares the
  column REQUIRED but writes levels anyway, so that every reader (its
  own, the port's before the repair, pyarrow) reads other values back or
  fails: the files here cannot be compared with the reference's. pyarrow
  reads the port's files, and the port reads pyarrow's, under each codec,
  with and without dictionary pages.
* Malformed page headers. A page whose sizes are negative, or whose
  levels overrun it, is refused before any buffer is sized or copied
  from it: ``read_table`` raises OSError (pyarrow's class for a
  malformed file) and ``io/parquet/host.py``'s calls give None or raise
  OSError. The reference trusts these sizes (``ADVICE.md``), so there is
  no reference result; each case runs in a subprocess, which must end
  normally, so that an abort of the host library fails the case.
"""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import arrow_tpu_torch as att
from arrow_tpu_torch import types as T
from arrow_tpu_torch.io import parquet as pq
from arrow_tpu_torch.io.parquet.thrift import CompactReader

from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ["none", "snappy", "gzip", "zstd", "brotli"]
N = 200


def _columns(seed=3, n=N):
    """(name, port type, pyarrow type, values) of non-nullable columns,
    flat and nested, from a seed; nested values may hold nulls below the
    root, the root never."""
    rng = np.random.default_rng(seed)
    ints = [int(v) for v in rng.integers(-2**40, 2**40, n)]
    floats = [float(v) for v in rng.normal(size=n)]
    words = [f"w{int(v)}" for v in rng.integers(0, 17, n)]
    lists = [[None if rng.random() < 0.1 else int(v)
              for v in rng.integers(0, 9, int(k))]
             for k in rng.integers(0, 4, n)]
    structs = [{"a": None if rng.random() < 0.2 else int(v), "b": w}
               for v, w in zip(rng.integers(0, 99, n), words)]
    return [
        ("i", T.int64(), pa.int64(), ints),
        ("f", T.float64(), pa.float64(), floats),
        ("s", T.string(), pa.string(), words),
        ("l", T.list_(T.int64()), pa.list_(pa.int64()), lists),
        ("st", T.struct([("a", T.int64()), ("b", T.string())]),
         pa.struct([("a", pa.int64()), ("b", pa.string())]), structs),
    ]


def _codec_ok(codec):
    from arrow_tpu_torch import io_streams
    return codec in ("none", "gzip") or io_streams.Codec.is_available(codec)


@pytest.mark.parametrize("use_dictionary", [True, False])
@pytest.mark.parametrize("codec", CODECS)
def test_the_ports_required_columns_read_back(codec, use_dictionary):
    """The port's file of non-nullable columns: pyarrow and the port read
    every value back, and the fields stay non-nullable."""
    if not _codec_ok(codec):
        pytest.skip(f"{codec} is not available here")
    cols = _columns()
    t = att.Table(att.schema([att.field(n, pt, False)
                              for n, pt, _, _ in cols]),
                  [att.chunked_array([att.array(v, pt)])
                   for _, pt, _, v in cols])
    buf = io.BytesIO()
    pq.write_table(t, buf, compression=codec, use_dictionary=use_dictionary)
    data = buf.getvalue()
    theirs = papq.read_table(pa.BufferReader(data))
    ours = pq.read_table(io.BytesIO(data), device="cpu")
    for name, _, pat, values in cols:
        assert theirs.schema.field(name).nullable is False
        assert theirs.schema.field(name).type == pat
        assert theirs.column(name).to_pylist() == values
        assert ours.schema.field(name).nullable is False
        assert ours.column(name).to_pylist() == values


@pytest.mark.parametrize("use_dictionary", [True, False])
@pytest.mark.parametrize("codec", CODECS)
def test_pyarrows_required_columns_read(codec, use_dictionary):
    cols = _columns(seed=5)
    schema = pa.schema([pa.field(n, pat, nullable=False)
                        for n, _, pat, _ in cols])
    pt = pa.table({n: pa.array(v, pat) for n, _, pat, v in cols},
                  schema=schema)
    sink = pa.BufferOutputStream()
    papq.write_table(pt, sink, compression=codec,
                     use_dictionary=use_dictionary)
    ours = pq.read_table(io.BytesIO(sink.getvalue().to_pybytes()),
                         device="cpu")
    for name, _, _, values in cols:
        assert ours.schema.field(name).nullable is False
        assert ours.column(name).to_pylist() == values


def test_a_required_column_with_a_null_is_refused():
    t = att.Table(att.schema([att.field("x", T.int64(), False)]),
                  [att.chunked_array([att.array([1, None], T.int64())])])
    with pytest.raises(ValueError, match="non-nullable"):
        pq.write_table(t, io.BytesIO())
    lists = att.Table(att.schema([att.field("l", T.list_(T.int64()),
                                            False)]),
                      [att.chunked_array([att.array([[1], None],
                                                    T.list_(T.int64()))])])
    with pytest.raises(ValueError, match="non-nullable"):
        pq.write_table(lists, io.BytesIO())


def test_a_nested_required_fields_levels_follow_the_schema():
    """The leaf specs of a REQUIRED root drop its definition level: the
    levels the writer shreds are those the reader derives from the file's
    schema."""
    from arrow_tpu_torch.io.parquet.nested import leaf_specs
    t = T.struct([("a", T.list_(T.int64())), ("b", T.string())])
    opt = leaf_specs("x", t)
    req = leaf_specs("x", t, nullable=False)
    assert [s.max_def for s in opt] == [4, 2]
    assert [s.max_def for s in req] == [3, 1]
    assert [s.max_rep for s in req] == [1, 0]
    buf = io.BytesIO()
    rows = [{"a": [1, None], "b": "p"}, {"a": None, "b": None},
            {"a": [], "b": "q"}]
    pq.write_table(att.Table(att.schema([att.field("x", t, False)]),
                             [att.chunked_array([att.array(rows, t)])]),
                   buf)
    got = pq.ParquetFile(io.BytesIO(buf.getvalue()))
    assert [c.max_def for c in got.fields[0].leaves] == [3, 1]
    assert papq.read_table(pa.BufferReader(buf.getvalue())) \
        .column("x").to_pylist() == rows


# --- malformed page headers --------------------------------------------------

def _file(values=(1, 2), codec="snappy", version="1.0", nulls=False):
    """pyarrow's Parquet file of one int64 column, and where its first
    page header starts."""
    arr = pa.array(list(values) + ([None] if nulls else []), pa.int64())
    sink = pa.BufferOutputStream()
    papq.write_table(pa.table({"x": arr}), sink, compression=codec,
                     data_page_version=version, use_dictionary=False)
    data = bytearray(sink.getvalue().to_pybytes())
    return data, 4


def _header(data, pos):
    r = CompactReader(bytes(data), pos)
    return r.read_struct(), r.pos


def _shape(h):
    """A header's fields and their kinds, nested."""
    return {k: _shape(v) if isinstance(v, dict) else type(v).__name__
            for k, v in h.items()}


def _patched(data, pos, want):
    """``data`` with one byte of the page header at ``pos`` set so that
    ``want(header)`` holds, the header keeping its length and its fields
    (one field's one-byte zigzag varint changed)."""
    h0, end = _header(data, pos)
    for i in range(pos, end):
        for b in (0x01, 0x7f, 0x7e, 0x03, 0x41):
            trial = bytearray(data)
            trial[i] = b
            try:
                h, e = _header(trial, pos)
            except Exception:  # noqa: BLE001 - not a header: try another
                continue
            if e == end and _shape(h) == _shape(h0) and want(h):
                return trial
    raise AssertionError("no one-byte edit of the header gives the case")


def _run(code, timeout=120):
    """``code`` in a fresh interpreter at the repository root: its exit
    status and output (an abort is a non-zero status, a hang past
    ``timeout`` seconds a failure)."""
    try:
        proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                              capture_output=True, text=True, cwd=ROOT,
                              env=dict(os.environ, PYTHONPATH=ROOT),
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the reader did not finish within {timeout} s")
    return proc.returncode, proc.stdout + proc.stderr


def _read_in_subprocess(tmp_path, data):
    path = tmp_path / "bad.parquet"
    path.write_bytes(bytes(data))
    rc, out = _run(f"""
        from arrow_tpu_torch.io import parquet as pq
        try:
            t = pq.read_table({str(path)!r}, device="cpu")
        except OSError as exc:
            print("OSError:", exc)
        else:
            print("READ", t.to_pydict())
            raise SystemExit(1)
        """)
    assert rc == 0, out
    assert out.startswith("OSError"), out
    return out


def _v2(h):
    return h.get(8) if isinstance(h.get(8), dict) else {}


CASES = {
    # v1 snappy page: a negative uncompressed size (the process aborted in
    # std::length_error before the repair)
    "v1 uncompressed size < 0": (dict(codec="snappy"),
                                 lambda h: h.get(2, 0) < 0),
    "v1 values < 0": (dict(codec="none"),
                      lambda h: isinstance(h.get(5), dict)
                      and h[5].get(1, 0) < 0),
    "v2 definition levels < 0": (
        dict(codec="none", version="2.0", nulls=True),
        lambda h: _v2(h).get(5, 0) < 0),
    "v2 levels past the page": (
        dict(codec="none", version="2.0", nulls=True),
        lambda h: h.get(3, 0) > 0 and _v2(h).get(5, 0) >= 0
        and _v2(h).get(5, 0) + _v2(h).get(6, 0) > h[3]),
    "v2 nulls < 0": (dict(codec="none", version="2.0", nulls=True),
                     lambda h: _v2(h).get(2, 0) < 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_malformed_page_header_raises_through_read_table(tmp_path, case):
    kw, want = CASES[case]
    data, pos = _file(**kw)
    # the file reads as it is
    assert papq.read_table(pa.BufferReader(bytes(data))).num_rows >= 2
    _read_in_subprocess(tmp_path, _patched(data, pos, want))


def test_a_malformed_page_header_through_the_host_calls(tmp_path):
    """``pq_scan_pages`` refuses headers with negative sizes, levels past
    the page, and skipped fields that run past the buffer (a binary or a
    list longer than what is left); ``pq_decode_flat`` checks each row of
    the table it is given again and raises OSError."""
    rc, out = _run("""
        import numpy as np
        from arrow_tpu_torch.io.parquet import host
        from arrow_tpu_torch.io.parquet.thrift import CompactWriter

        def header(v2=None, uncomp=16, comp=16, skip=b""):
            w = CompactWriter()
            w.field_i32(1, 3 if v2 else 0)
            w.field_i32(2, uncomp)
            w.field_i32(3, comp)
            body = w.bytes()
            if v2 is not None:
                w = CompactWriter()
                w.field_struct_begin(8)
                for fid, v in enumerate(v2, 1):
                    w.field_i32(fid, v)
                w.struct_end()
                body += w.bytes()
            return body + skip + b"\\x00"

        pad = bytes(64)
        cases = {
            "uncompressed < 0": header(uncomp=-64),
            "comp < 0": header(comp=-1),
            "values < 0": header(v2=[-2, 0, 2, 0, 1, 0]),
            "nulls < 0": header(v2=[2, -1, 2, 0, 1, 0]),
            "def levels < 0": header(v2=[2, 0, 2, 0, -1000, 0]),
            "rep levels < 0": header(v2=[2, 0, 2, 0, 1, -5]),
            "levels past the page": header(v2=[2, 0, 2, 0, 10, 10]),
            # field 9 a binary of 2**62 bytes; field 10 a list of 2**40
            # bools: a skip past the end of the buffer
            "binary past the end": header(skip=b"\\x68\\x80\\x80\\x80\\x80"
                                          b"\\x80\\x80\\x80\\x80\\x40"),
            "list past the end": header(skip=b"\\x79\\xf1\\x80\\x80\\x80"
                                        b"\\x80\\x80\\x20"),
        }
        for name, blob in cases.items():
            assert host.pq_scan_pages(blob + pad, 2) is None, name
        good = host.pq_scan_pages(header() + pad, 0)
        assert good is not None
        row = [0, 8, 16, 16, 2, 0, 0, 0, 0, 1]
        for i, v in ((3, -64), (2, -1), (1, -9), (4, -2), (7, -1000),
                     (8, -1), (7, 17)):
            tab = np.array([row], np.int64)
            tab[0, 0] = 3
            tab[0, i] = v
            for codec in (0, 1):
                try:
                    res = host.pq_decode_flat(bytes(64), tab, codec, 1, 1,
                                              8, 2)
                except OSError:
                    continue
                raise SystemExit(f"decoded {res} from row {tab.tolist()}")
        print("OK")
        """)
    assert rc == 0 and out.strip().endswith("OK"), out
