"""CSV in the port (``arrow_tpu_torch/io/csv.py``, ``io/csv_host.py``,
``csrc/csv_host.cpp``) against the JAX package's (``arrow_tpu/io/csv.py``
over ``arrow_tpu/native``), with pyarrow as an oracle only.

* the cases of the reference's CSV tests (``tests/test_io_interop.py``,
  ``test_csv_zc_tokenizer.py``, the CSV parts of
  ``test_api_conveniences.py`` and ``test_fuzz.py``) through both
  packages: the same Table (schema, inferred types, values, validity,
  order) or an error of the same class;
* every option class, the three read routes with the input that selects
  each (blocks on threads, one native pass, Python's ``csv``), ``open_csv``
  block by block, the invalid-row handlers;
* the writer's bytes over its types, delimiters and quoting styles, and
  ``CSVWriter``'s; the float cells against Python's ``repr``;
* no fallback: without its host library a read or write raises.

Exact throughout (parsed floats bit for bit: both run ``std::from_chars``).
"""

import csv as pycsv
import datetime as dt
import decimal
import io
import random

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pytest

import arrow_tpu as at
from arrow_tpu import native as rnat
from arrow_tpu.array.array import pylist_equal
from arrow_tpu.io import csv as rcsv
from arrow_tpu_torch.io import csv as pcsv
from arrow_tpu_torch.io import csv_host

from test_torch_host_table import carry_table, port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

CSV_DATA = b"""a,b,c,d,e
1,1.5,x,true,2021-01-01
2,,y,false,2021-06-15
,3.25,"z,w",true,
4,4.0,,TRUE,1999-12-31
"""


class _ZeroedNumpy:
    """numpy whose ``empty`` gives zeros. The reference's csv_format_f64
    reads a cell's exponent with atoi, on into its pool's next, unwritten
    bytes, so a digit left there by an earlier array keeps a cell like
    ``1e+06`` from its rewrite to ``1000000.0``; with its pools zeroed the
    reference writes the cells its comment promises (Python's repr), which
    the port writes always (ROADMAP.md, queue 3)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def empty(*args, **kwargs):
        return np.zeros(*args, **kwargs)


@pytest.fixture(autouse=True)
def reference_pools_zeroed(monkeypatch):
    monkeypatch.setattr(rnat, "np", _ZeroedNumpy())


def same_table(got, want):
    """The port's Table against the reference's: names, types (the port's
    of the reference's) and values with NaN equal to NaN."""
    assert got.column_names == want.column_names
    assert [f.type for f in got.schema] == \
        [port_type(f.type) for f in want.schema]
    assert pylist_equal(got.to_pydict(), want.to_pydict())


def both(call, *args, **kwargs):
    """``call`` of the port's module and of the reference's on the same
    input: the same Table, or errors of the same class."""
    data = [bytes(a) if isinstance(a, (bytes, bytearray)) else a
            for a in args]
    try:
        want = call(rcsv)(*data, **kwargs)
    except Exception as exc:  # noqa: BLE001 - its class is the oracle
        with pytest.raises(Exception) as got:
            call(pcsv)(*data, **kwargs)
        assert type(got.value).__name__ == type(exc).__name__, got.value
        return None
    got = call(pcsv)(*data, **kwargs)
    same_table(got, want)
    return got


def read_both(data, ro=None, po=None, co=None):
    """read_csv of ``data`` by both packages, each given its own options
    made from the same keyword dicts."""
    def opts(mod):
        return dict(
            read_options=None if ro is None else mod.ReadOptions(**ro),
            parse_options=None if po is None else mod.ParseOptions(**po),
            convert_options=None if co is None else mod.ConvertOptions(
                **co(mod) if callable(co) else co))
    try:
        want = rcsv.read_csv(data, **opts(rcsv))
    except Exception as exc:  # noqa: BLE001 - its class is the oracle
        with pytest.raises(Exception) as got:
            pcsv.read_csv(data, **opts(pcsv))
        assert type(got.value).__name__ == type(exc).__name__, got.value
        return None
    got = pcsv.read_csv(data, **opts(pcsv))
    same_table(got, want)
    return got


def types_of(mod):
    """The type constructors of a package (``at`` or the port's)."""
    if mod is rcsv:
        return at
    from arrow_tpu_torch import types as T
    return T


# --- tests/test_io_interop.py -------------------------------------------------

def test_csv_inference_matches_the_reference_and_pyarrow():
    got = read_both(CSV_DATA)
    theirs = pacsv.read_csv(pa.BufferReader(CSV_DATA))
    assert got.to_pydict() == theirs.to_pydict()


@pytest.mark.parametrize("case", range(4))
def test_csv_options(case):
    if case == 0:
        got = read_both(CSV_DATA, co=lambda m: {
            "column_types": {"a": types_of(m).float64()},
            "include_columns": ["a", "c"]})
        assert got.column("a").to_pylist() == [1.0, 2.0, None, 4.0]
    elif case == 1:
        got = read_both(b"1,x\n2,y\n", ro={"column_names": ["n", "s"]})
        assert got.to_pydict() == {"n": [1, 2], "s": ["x", "y"]}
    elif case == 2:
        got = read_both(b"9;q\n", ro={"autogenerate_column_names": True},
                        po={"delimiter": ";"})
        assert got.to_pydict() == {"f0": [9], "f1": ["q"]}
    else:
        got = read_both(b"skip me\nh1,h2\nignored,row\n1,2\n",
                        ro={"skip_rows": 1, "skip_rows_after_names": 1})
        assert got.to_pydict() == {"h1": [1], "h2": [2]}


def _written(mod, tbl, **wo):
    buf = io.StringIO()
    mod.write_csv(tbl, buf, None if not wo else mod.WriteOptions(**wo))
    return buf.getvalue()


def test_csv_write_read_roundtrip_and_pyarrow_reads_it():
    rt = at.table({"x": [1, None, 3], "s": ["a", "b,c", None],
                   "f": [1.5, 2.0, None]})
    text = _written(pcsv, carry_table(rt))
    assert text == _written(rcsv, rt)
    back = read_both(text.encode())
    assert back.column("s").to_pylist() == ["a", "b,c", ""]
    theirs = pacsv.read_csv(pa.BufferReader(text.encode()))
    assert theirs.column("x").to_pylist() == [1, None, 3]


def test_streaming_blocks_keep_one_schema():
    data = "a,b\n" + "\n".join(f"{i},x{i % 5}" for i in range(5000)) + "\n"
    got = list(pcsv.open_csv(io.StringIO(data), read_options=pcsv.ReadOptions(
        block_size=8192)))
    want = list(rcsv.open_csv(io.StringIO(data), read_options=rcsv.ReadOptions(
        block_size=8192)))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.to_pydict() == w.to_pydict()
        assert g.schema == got[0].schema


def test_read_all_and_next_batch():
    r = pcsv.open_csv(io.StringIO("a\n1\n2\n"))
    assert r.read_next_batch().to_pydict() == {"a": [1, 2]}
    with pytest.raises(StopIteration):
        r.read_next_batch()
    assert pcsv.open_csv(io.StringIO("a\n1\n2\n")).read_all().num_rows == 2
    for mod in (rcsv, pcsv):   # an empty input has no header row
        with pytest.raises(StopIteration):
            mod.open_csv(b"")


@pytest.mark.parametrize("sink", ["text", "binary", "path"])
def test_csv_writer_bytes(tmp_path, sink):
    rt = at.table({"a": [1, 2], "s": ["x", 'y"z']})
    pt = carry_table(rt)

    def write(mod, tbl, name):
        if sink == "path":
            target = str(tmp_path / name)
        else:
            target = io.StringIO() if sink == "text" else io.BytesIO()
        with mod.CSVWriter(target, tbl.schema) as w:
            w.write(tbl)
            w.write(tbl.to_batches()[0])
        if sink == "path":
            return open(target, "rb").read()
        out = target.getvalue()
        return out.encode() if isinstance(out, str) else out
    got, want = write(pcsv, pt, "p.csv"), write(rcsv, rt, "r.csv")
    assert got == want
    assert pacsv.read_csv(pa.BufferReader(got)).num_rows == 4


def test_sentinels():
    assert pcsv.ISO8601 == rcsv.ISO8601 == "ISO8601"
    row = pcsv.InvalidRow(2, 3, 7, "x,y,z")
    assert (row.expected_columns, row.actual_columns, row.number,
            row.text) == (2, 3, 7, "x,y,z")
    assert repr(row) == repr(rcsv.InvalidRow(2, 3, 7, "x,y,z"))


def _native_and_python(data, monkeypatch, kw=lambda m: {}):
    """The port's read by its native routes and by Python's csv (the
    tokenizer declined, as the reference's differential test forces it),
    each against the reference's native read."""
    want = rcsv.read_csv(data, **kw(rcsv))
    native = pcsv.read_csv(data, **kw(pcsv))
    same_table(native, want)
    monkeypatch.setattr(pcsv, "_tokenize_and_layout", lambda *a, **k: None)
    python = pcsv.read_csv(data, **kw(pcsv))
    monkeypatch.undo()
    same_table(python, want)
    return native


NATIVE_CASES = {
    "quotes": (b'a,b,c\n1,"x,y",2.5\n\n2,"he said ""hi""",-1e3\n3,,nan\n'
               b',"",4\n'),
    "crlf_missing": b'a,b\r\n1,x\r\n2\r\n3,z,extra\r\n',
    "temporal": (b"ts,d\n2020-01-01T12:30:45.123456,2020-01-01\n"
                 b"2020-06-15 23:59:59,1999-12-31\n"
                 b"2020-01-01T12:30:45Z,2020-02-29\n"
                 b"2020-01-01T12:30:45+05:30,2021-01-31\n"
                 b"2020-01-01,2000-02-29\n20200101T1230,0001-01-01\n"
                 b"2020-01-01T12:30:45.1234567,9999-12-31\n"),
    "lowercase_z": b"ts\n2020-01-01T12:30:45z\n2020-06-15T00:00:00z\n",
}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_and_python_routes_match_the_reference(case, monkeypatch):
    t = _native_and_python(NATIVE_CASES[case], monkeypatch)
    if case == "temporal":
        from arrow_tpu_torch import types as T
        assert t.schema.field("ts").type == T.timestamp("s")
        assert t.schema.field("d").type == T.date32()
    if case == "lowercase_z":
        from arrow_tpu_torch import types as T
        assert t.schema.field("ts").type == T.string()


def test_explicit_types_and_null_tokens(monkeypatch):
    data = b'i,f,s,bl\nNULL,NA,keep,true\n7,0.5,NULL,false\n'

    def kw(m):
        T = types_of(m)
        return {"convert_options": m.ConvertOptions(column_types={
            "i": T.int32(), "f": T.float32(), "s": T.string(),
            "bl": T.bool_()}, strings_can_be_null=True)}
    t = _native_and_python(data, monkeypatch, kw=kw)
    assert t.column("i").to_pylist() == [None, 7]
    assert t.column("s").to_pylist() == ["keep", None]


@pytest.mark.parametrize("seed", [7, 8])
def test_random_differential(seed, monkeypatch):
    rng = random.Random(seed)
    rows = []
    for _ in range(300):
        cells = []
        for _ in range(4):
            kind = rng.randrange(6)
            cells.append([str(rng.randrange(-999, 999)),
                          f"{rng.random():.4f}",
                          rng.choice(["NULL", "", "NA"]), '"qu,oted"',
                          '"do""uble"',
                          rng.choice(["plain", "words here"])][kind])
        rows.append(",".join(cells))
    data = ("h1,h2,h3,h4\n" + "\n".join(rows) + "\n").encode()
    _native_and_python(data, monkeypatch)


def test_ns_unit_overflow_raises_the_same_error():
    for mod in (rcsv, pcsv):
        T = types_of(mod)
        with pytest.raises((OverflowError, ValueError)) as exc:
            mod.read_csv(b"ts\n9999-01-01T00:00:00\n",
                         convert_options=mod.ConvertOptions(
                             column_types={"ts": T.timestamp("ns")}))
        if mod is rcsv:
            want = type(exc.value)
    assert type(exc.value) is want


def test_streaming_matches_read_csv():
    body = "".join(f"{i},{i * 0.5},s{i % 9}\n" for i in range(5000))
    data = ("x,y,z\n" + body).encode()
    whole = pcsv.read_csv(data)
    same_table(whole, rcsv.read_csv(data))
    batches = list(pcsv.open_csv(data, read_options=pcsv.ReadOptions(
        block_size=4096)))
    want = list(rcsv.open_csv(data, read_options=rcsv.ReadOptions(
        block_size=4096)))
    assert [b.num_rows for b in batches] == [b.num_rows for b in want]
    from arrow_tpu_torch.table import Table
    assert Table.from_batches(batches).to_pydict() == whole.to_pydict()


def test_write_csv_dictionary_numeric_decodes_values():
    rt = at.Table.from_arrays([at.array([100, 200, 100, 300])
                               .dictionary_encode()], names=["a"])
    buf = io.BytesIO()
    pcsv.write_csv(carry_table(rt), buf)
    want = io.BytesIO()
    rcsv.write_csv(rt, want)
    assert buf.getvalue() == want.getvalue()
    assert buf.getvalue().decode().split()[1:] == ["100", "200", "100",
                                                   "300"]


# --- tests/test_csv_zc_tokenizer.py ---------------------------------------------

def _fields(block):
    out, fid = [], 0
    for rc in block.row_counts.tolist():
        out.append([block.field_bytes(fid + k).decode() for k in range(rc)])
        fid += rc
    return out


ZC_CASES = [
    ('a,b,c\n1,"x",3\n', True), ('"q","r"\n"1","2"\n', True),
    ('"",""\n"a",""\n', True), ('"multi\nline",2\n"b",3\n', True),
    ('"a""b",2\n', False), ('plain,unquoted\n1,2\n', True),
    ('"a"x,2\n', False), ('"unterminated,2', True),
    ('a,b\r\n"1","2"\r\n', True), ('\n\n"a",1\n', True),
    ('"последний","ряд"\n', True),
]


@pytest.mark.parametrize("data,expect_zc", ZC_CASES)
def test_zc_tokenizer_matches_python_csv_and_the_reference(data, expect_zc):
    block = csv_host.csv_parse(data.encode(), ",", '"', True, None)
    ref = rnat.csv_parse(data.encode(), ",", '"', True, None)
    assert _fields(block) == _fields(ref) == list(
        pycsv.reader(io.StringIO(data)))
    assert (block.id_scale == 2) == expect_zc
    assert block.quoted.tolist() == ref.quoted.tolist()


def test_zc_read_csv_end_to_end():
    rows = ["i,s,f"] + [f'{i},"name-{i % 97}",{i / 7.0}' for i in range(5000)]
    rows.append('9999,"has ""quote"" inside",1.5')
    data = ("\n".join(rows) + "\n").encode()
    t = both(lambda m: m.read_csv, io.BytesIO(data).getvalue())
    assert t.column("s").to_pylist()[-1] == 'has "quote" inside'


def test_zc_quoted_flags_ride_through():
    data = b'a,b\n"",\nx,y\n'
    t = read_both(data)
    assert t.column("a").to_pylist() == ["", "x"]
    block = csv_host.csv_parse(data[4:], ",", '"', True, None)
    assert block.id_scale == 2 and block.quoted.tolist() == [1, 0, 0, 0]


def test_parallel_chunk_merge_matches_single(monkeypatch):
    monkeypatch.setenv("ARROW_TPU_CSV_PARALLEL_MIN", "1024")
    rows = ["h1,h2,h3"]
    for i in range(3000):
        rows.append(f'{i},"q{i}",' if i % 17 == 0 else
                    f'{i},"has ""dq"" here",{i * 2}' if i % 29 == 0 else
                    f"{i},plain{i},{i * 2}")
    data = ("\n".join(rows) + "\n").encode()
    par = csv_host.csv_parse_parallel(data, ",", '"', True, None)
    single = csv_host.csv_parse(data, ",", '"', True, None)
    assert par.row_counts.tolist() == single.row_counts.tolist()
    assert len(par.quoted) == len(single.quoted)
    assert all(par.field_bytes(f) == single.field_bytes(f)
               for f in range(len(single.quoted)))
    same_table(pcsv.read_csv(data), rcsv.read_csv(data))


# --- tests/test_api_conveniences.py: the options and the handlers ---------------

@pytest.mark.parametrize("name", ["ReadOptions", "ParseOptions",
                                  "ConvertOptions", "WriteOptions"])
def test_the_option_classes(name):
    pcls, rcls = getattr(pcsv, name), getattr(rcsv, name)
    inst = pcls()
    assert sorted(n for n in dir(getattr(pacsv, name))
                  if not n.startswith("_") and not hasattr(inst, n)) == []
    assert vars(inst).keys() == vars(rcls()).keys()
    assert {k: v for k, v in vars(inst).items() if k != "column_types"} \
        == {k: v for k, v in vars(rcls()).items() if k != "column_types"}
    assert inst.equals(pcls()) and inst.validate() is None
    assert not pcls().equals(rcls())
    if name == "ReadOptions":
        assert pcls(block_size=5).equals(pcls(block_size=5))
        assert not pcls(block_size=5).equals(pcls())


@pytest.mark.parametrize("case", ["decimal_point", "default_column_type",
                                  "auto_dict_encode", "cardinality_cap",
                                  "timestamp_parsers",
                                  "strings_can_be_null",
                                  "quoted_strings_can_be_null",
                                  "dictionary_type"])
def test_convert_option_semantics(case):
    def co(**kw):
        return lambda m: kw
    if case == "decimal_point":
        t = read_both(b"x\n1,5\n2,25\n", po={"delimiter": ";"},
                      co=co(decimal_point=","))
        assert t.column("x").to_pylist() == [1.5, 2.25]
    elif case == "default_column_type":
        t = read_both(b"a\n1\n2\n", co=lambda m: {
            "default_column_type": types_of(m).string()})
        assert t.column("a").to_pylist() == ["1", "2"]
    elif case == "auto_dict_encode":
        t = read_both(b"s\nx\ny\nx\n\n", co=co(auto_dict_encode=True))
        assert t.column("s").to_pylist() == ["x", "y", "x"]
    elif case == "cardinality_cap":
        t = read_both(b"s\nx\ny\nz\n", co=co(
            auto_dict_encode=True, auto_dict_max_cardinality=2))
        from arrow_tpu_torch import types as T
        assert t.schema.types[0] == T.string()
    elif case == "timestamp_parsers":
        t = read_both(b"t\n01/02/2020\n", co=lambda m: {
            "column_types": {"t": types_of(m).timestamp("s")},
            "timestamp_parsers": ["%d/%m/%Y"]})
        ref = pacsv.read_csv(io.BytesIO(b"t\n01/02/2020\n"),
                             convert_options=pacsv.ConvertOptions(
                                 column_types={"t": pa.timestamp("s")},
                                 timestamp_parsers=["%d/%m/%Y"]))
        assert t.column("t").to_pylist() == ref.column("t").to_pylist()
    elif case == "strings_can_be_null":
        t = read_both(b'a,b\nNULL,"NA"\nx,\n', co=co(
            strings_can_be_null=True))
        assert t.column("a").to_pylist() == [None, "x"]
    elif case == "quoted_strings_can_be_null":
        read_both(b'a,b\n"",NA\nx,1\n', co=co(
            strings_can_be_null=True, quoted_strings_can_be_null=False))
    else:
        read_both(b"s\nx\nNULL\ny\n", co=lambda m: {
            "column_types": {"s": types_of(m).dictionary(
                types_of(m).int32(), types_of(m).string())},
            "strings_can_be_null": True})


@pytest.mark.parametrize("decision", ["skip", "error", None])
@pytest.mark.parametrize("route", ["native", "python"])
def test_invalid_row_handler(decision, route):
    """The handler sees the short row (its number, counts and text) in
    both packages; "skip" drops it, "error" raises ArrowInvalid, anything
    else keeps it with its missing field null."""
    data = b"a,b\n1,2\n3\n4,5\n"
    seen, outs = {}, []
    for mod in (rcsv, pcsv):
        def handler(row, mod=mod):
            seen.setdefault(mod, []).append(
                (row.number, row.actual_columns, row.expected_columns,
                 row.text))
            return decision
        po = mod.ParseOptions(invalid_row_handler=handler,
                              **({"quote_char": "§"} if route == "python"
                                 else {}))
        try:
            t = mod.read_csv(io.BytesIO(data), parse_options=po)
            outs.append(("table", t.to_pydict()))
        except Exception as exc:  # noqa: BLE001 - compared below
            outs.append(("error", type(exc).__name__))
    assert outs[0] == outs[1]
    assert seen[rcsv] == seen[pcsv] == [(1, 1, 2, "3")]
    if decision == "error":
        assert outs[0] == ("error", "ArrowInvalid")


# --- the three read routes --------------------------------------------------------

@pytest.mark.parametrize("route", ["parallel", "native", "python"])
def test_each_route_is_taken_by_the_input_that_selects_it(route,
                                                          monkeypatch):
    taken = []
    for name in ("_read_csv_parallel", "_read_csv_native"):
        real = getattr(pcsv, name)

        def spy(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            if out is not None:
                taken.append(_name)
            return out
        monkeypatch.setattr(pcsv, name, spy)
    rng = np.random.default_rng(3)
    rows = [f"{int(a)},{b!r},s{int(a) % 13},2021-0{int(a) % 9 + 1}-1{c}"
            for a, b, c in zip(rng.integers(-50, 50, 4000),
                               rng.normal(size=4000).tolist(),
                               rng.integers(0, 9, 4000))]
    data = ("i,f,s,d\n" + "\n".join(rows) + "\n").encode()
    po = None
    if route == "parallel":
        monkeypatch.setenv("ARROW_TPU_CSV_BLOCK_BYTES", "8192")
    elif route == "python":
        po = {"quote_char": "§"}
    t = read_both(data, po=po)
    assert t.num_rows == 4000
    if route == "parallel":
        assert taken == ["_read_csv_parallel"]
        assert t.column("i").num_chunks > 1
    elif route == "native":
        assert taken == ["_read_csv_native"]
    else:
        assert taken == []


def test_the_parallel_route_unifies_block_types(monkeypatch):
    """int64 in one block and float64 in another give float64; a null
    column in one block takes the other's type; a conflict goes to the
    whole-input route, which infers once."""
    monkeypatch.setenv("ARROW_TPU_CSV_BLOCK_BYTES", "2048")
    ints = "\n".join(f"{i},,{i}" for i in range(600))
    floats = "\n".join(f"{i}.5,{i},x{i}" for i in range(600))
    data = ("a,b,c\n" + ints + "\n" + floats + "\n").encode()
    t = read_both(data)
    from arrow_tpu_torch import types as T
    assert [f.type for f in t.schema] == [T.float64(), T.int64(),
                                          T.string()]


def test_quoted_newlines_take_the_reference_route(monkeypatch):
    """A value holding a newline: with ``newlines_in_values`` the read is
    one native pass, never the blocks cut at newlines."""
    monkeypatch.setenv("ARROW_TPU_CSV_BLOCK_BYTES", "1024")
    data = b"a,b\n" + b'1,"two\nlines"\n2,x\n' * 400
    t = read_both(data, po={"newlines_in_values": True})
    assert t.column("b").to_pylist()[:2] == ["two\nlines", "x"]
    assert t.column("a").num_chunks == 1
    read_both(data, ro={"use_threads": False})


# --- tests/test_fuzz.py ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_csv_garbage(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        blob = bytes(rng.integers(32, 127, 200).astype(np.uint8))
        read_both(blob)


# --- the writer's bytes --------------------------------------------------------

def _rich(n=60, seed=5):
    rng = np.random.default_rng(seed)

    def nulls(vals, share=0.15):
        return [None if rng.random() < share else v for v in vals]
    specials = [0.1, 1e-5, 1e16, 123456789012345678.0, -0.0, 5e-324,
                float("inf"), float("-inf"), 2.5, 1e-4, 1e15, 0.0001234]
    floats = [float(v) for v in rng.normal(scale=1e6, size=n - 12)] + \
        specials
    return {
        "i64": nulls([int(v) for v in rng.integers(-10**12, 10**12, n)]),
        "i8": at.array(nulls([int(v) for v in rng.integers(-128, 128, n)]),
                       at.int8()),
        "u64": at.array([int(v) for v in rng.integers(0, 2**63, n)],
                        at.uint64()),
        "f64": nulls(floats),
        "f32": at.array(nulls([float(np.float32(v)) for v in floats]),
                        at.float32()),
        "b": nulls([bool(v) for v in rng.integers(0, 2, n)]),
        "s": nulls([rng.choice(["plain", "co,mma", 'qu"ote', "new\nline",
                                "", "tab\tx", "cr\rx", "Ω"])
                    for _ in range(n)]),
        "d": at.array(nulls([int(v) for v in rng.integers(-5000, 30000, n)]),
                      at.date32()),
        "ts": at.array(nulls([int(v) for v in rng.integers(0, 2**40, n)]),
                       at.timestamp("us")),
        "dec": at.array(nulls([decimal.Decimal(int(v)).scaleb(-2)
                               for v in rng.integers(-10**8, 10**8, n)]),
                        at.decimal128(12, 2)),
        "bin": at.array(nulls([bytes([65 + i % 26]) * (i % 4)
                               for i in range(n)]), at.binary()),
        "dict": at.array(nulls([["p", "q,r", "s"][int(v)]
                                for v in rng.integers(0, 3, n)]),
                         at.dictionary(at.int32(), at.string())),
    }


WRITE_SETS = {
    "native": ["i64", "i8", "f64", "s", "dict"],
    "fast": ["i64", "f32", "b", "s", "dict"],
    "rows": ["i64", "f64", "d", "ts", "dec", "bin", "s", "b", "f32"],
    "date_alone": ["d"], "string_alone": ["s"], "float_alone": ["f64"],
    "u64_big": ["u64", "i64"],
}


@pytest.mark.parametrize("delim", [",", ";", "\t", "-"])
@pytest.mark.parametrize("cols", sorted(WRITE_SETS))
def test_write_csv_bytes_equal_the_reference(cols, delim):
    rich = _rich()
    rt = at.table({k: rich[k] for k in WRITE_SETS[cols]})
    pt = carry_table(rt)
    for style in ("needed", "all_valid"):
        for header in (True, False):
            wo = {"delimiter": delim, "quoting_style": style,
                  "include_header": header}
            got = io.BytesIO()
            pcsv.write_csv(pt, got, pcsv.WriteOptions(**wo))
            want = io.BytesIO()
            rcsv.write_csv(rt, want, rcsv.WriteOptions(**wo))
            assert got.getvalue() == want.getvalue(), (style, header)


def test_write_csv_in_blocks_equals_the_reference(monkeypatch):
    """Past a block of rows a write formats its blocks on threads: the
    same bytes."""
    monkeypatch.setattr(pcsv, "_WRITE_BLOCK_ROWS", 7)
    rich = _rich(n=100, seed=9)
    for cols in (WRITE_SETS["native"], WRITE_SETS["rows"], ["d"]):
        rt = at.table({k: rich[k] for k in cols})
        got, want = io.StringIO(), io.StringIO()
        pcsv.write_csv(carry_table(rt), got)
        rcsv.write_csv(rt, want)
        assert got.getvalue() == want.getvalue()


def test_write_csv_of_an_empty_table_and_a_batch():
    rt = at.table({"a": at.array([], at.int64()),
                   "s": at.array([], at.string())})
    assert _written(pcsv, carry_table(rt)) == _written(rcsv, rt)
    rb = at.record_batch({"a": [1, None]})
    from arrow_tpu_torch.table import RecordBatch
    pb = carry_table(rb)
    pb = RecordBatch(pb.schema, [c.combine() for c in pb.columns])
    assert _written(pcsv, pb) == _written(rcsv, rb)


def test_float_cells_are_pythons_repr():
    rng = np.random.default_rng(21)
    bits = rng.integers(0, 2**63, 20000, dtype=np.int64)
    vals = bits.view(np.float64)
    vals = np.concatenate([vals[np.isfinite(vals)], rng.normal(size=2000),
                           10.0 ** rng.integers(-20, 25, 2000),
                           np.round(rng.normal(size=2000) * 1e4, 2)])
    cells = csv_host.csv_format_f64(vals, None)
    assert cells == [repr(float(v)) for v in vals]
    assert cells == rnat.csv_format_f64(vals, None)
    assert csv_host.csv_format_i64(np.array([0, -1, 2**63 - 1,
                                             -2**63]), None) == \
        ["0", "-1", str(2**63 - 1), str(-2**63)]


# --- dates and timestamps written as Python writes them -----------------------------

def test_date_cells_span_pythons_dates():
    days = np.array([-719162, -1, 0, 59, 10957, 2932896, 11016, -365],
                    dtype=np.int32)
    offs, pool = pcsv._date_cells(days, None)
    text = pool.tobytes().decode()
    assert [text[a:b] for a, b in zip(offs[:-1], offs[1:])] == [
        str(dt.date(1970, 1, 1) + dt.timedelta(days=int(d))) for d in days]
    assert pcsv._date_cells(np.array([2932897], np.int32), None) is None


# --- no fallback --------------------------------------------------------------------

def test_without_its_host_library_csv_raises(monkeypatch):
    from arrow_tpu_torch.kernels import _build
    pt = carry_table(at.table({"a": [1, 2]}))

    def fail(name):
        raise _build.BuildError(f"{name}.cpp: no compiler")
    monkeypatch.setattr(_build, "host_library", fail)
    csv_host.library.cache_clear()
    try:
        for call in (lambda: pcsv.read_csv(CSV_DATA),
                     lambda: pcsv.read_csv(CSV_DATA, parse_options=(
                         pcsv.ParseOptions(delimiter="§"))),
                     lambda: pcsv.open_csv(CSV_DATA),
                     lambda: pcsv.write_csv(pt, io.StringIO()),
                     lambda: pcsv.CSVWriter(io.StringIO(), pt.schema)):
            with pytest.raises(NotImplementedError, match="host library"):
                call()
    finally:
        monkeypatch.undo()
        csv_host.library.cache_clear()
    assert pcsv.read_csv(CSV_DATA).num_rows == 4
