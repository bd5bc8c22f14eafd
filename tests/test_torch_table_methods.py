"""The host containers' methods, joins, validation, builders, text and
comparison of the port (``arrow_tpu_torch/table.py``, ``array/array.py``,
``array/validate.py``, ``array/builder.py``, ``pretty.py``, ``compare.py``,
``dataset.py``'s joins) against the JAX package's on the same inputs.

* Inputs are made from a seed with numpy: seven columns (int64, float64
  with NaN, string, dictionary, bool, struct, list; each with nulls) in
  four chunks, one of them empty and each a slice of one Array.
* Every method of ``ChunkedArray``, ``RecordBatch``, ``Table``,
  ``RecordBatchReader`` and ``Array`` that the port has gives the
  reference's result, or an error of the same built-in class.
* ``Table.join`` for all eight join types, with and without
  ``coalesce_keys``, on nullable int64 keys and on dictionary string keys
  whose dictionaries differ between the sides, with suffixes, two-column
  keys and ``right_keys``: the same schema, values, validity, stored
  values under nulls and row order. ``join_asof`` at three tolerances;
  ``Dataset.join``/``join_asof``. A test pins the departure the two
  packages share: a full or right outer join that coalesces its keys
  drops the right key, so a row only the right side has keeps no key.
* ``validate`` on sound and broken ArrayData, the builders, ``pretty``'s
  text and ``compare``'s options.

Exact throughout; computed floats at rtol 1e-9 where they differ at all.
``to_string`` of an Array or ChunkedArray names the package and the type
as each package writes them (the port writes ``float64`` where the
reference writes ``double``); the rest of the text is the same.
"""

import contextlib
import io

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import compare as jcompare
from arrow_tpu import dataset as jds
from arrow_tpu import pretty as jpretty
from arrow_tpu.array import builder as jbuilder
from arrow_tpu.array import validate as jvalidate
from arrow_tpu.array.data import ArrayData as JArrayData
from arrow_tpu.buffer import Buffer as JBuffer
from arrow_tpu_torch import compare as tcompare
from arrow_tpu_torch import dataset as tds
from arrow_tpu_torch import pretty as tpretty
from arrow_tpu_torch.array import builder as tbuilder
from arrow_tpu_torch.array import validate as tvalidate
from arrow_tpu_torch.array.array import pylist_equal
from arrow_tpu_torch.array.data import ArrayData as TArrayData
from arrow_tpu_torch.buffer import Buffer as TBuffer

from test_torch_host_table import assert_same_data, port_schema, port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

CPU = {"device": "cpu"}
N = 40
CHUNKS = ((0, 7), (7, 0), (7, 18), (25, 15))
JOIN_TYPES = ["inner", "left outer", "right outer", "full outer",
              "left semi", "left anti", "right semi", "right anti"]


# --- inputs from a seed ---------------------------------------------------------

def _with_nulls(rng, vals, share=0.15):
    return [None if rng.random() < share else v for v in vals]


def column_values(seed=20, n=N):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 10, n).round(3)
    f[rng.random(n) < 0.1] = np.nan
    words = ["ab", "c", "", "déjà", "x y"]
    return {
        "i": _with_nulls(rng, rng.integers(-5, 20, n).tolist()),
        "f": _with_nulls(rng, f.tolist()),
        "s": _with_nulls(rng, [words[k] for k in rng.integers(0, 5, n)]),
        "d": _with_nulls(rng, [["red", "green", "blue"][k]
                               for k in rng.integers(0, 3, n)]),
        "b": _with_nulls(rng, (rng.random(n) < 0.5).tolist()),
        "st": _with_nulls(rng, [{"p": int(p), "q": q} for p, q in zip(
            rng.integers(0, 9, n), _with_nulls(rng, ["u", "v"] * (n // 2)))]),
        "l": _with_nulls(rng, [rng.integers(0, 5, int(k)).tolist()
                               for k in rng.integers(0, 4, n)]),
    }


def column_types(P):
    return {"i": P.int64(), "f": P.float64(), "s": P.string(),
            "d": P.dictionary(P.int32(), P.string()), "b": P.bool_(),
            "st": P.struct([("p", P.int64()), ("q", P.string())]),
            "l": P.list_(P.int64())}


def chunked(P, vals, t):
    whole = P.array(vals, t)
    return P.chunked_array([whole.slice(o, n) for o, n in CHUNKS], t)


def make_table(P, values):
    types = column_types(P)
    cols = [chunked(P, values[k], types[k]) for k in values]
    return P.Table(P.schema([(k, types[k]) for k in values]), cols)


@pytest.fixture(scope="module")
def pair():
    values = column_values()
    return make_table(at, values), make_table(att, values)


# --- comparing results --------------------------------------------------------------

def same(p, r, where=""):
    """The port's result ``p`` is the reference's ``r``."""
    if isinstance(r, (at.Table, at.RecordBatch)):
        assert type(p).__name__ == type(r).__name__, where
        assert p.schema.names == r.schema.names, where
        assert p.schema.types == port_schema(r.schema).types, where
        assert [f.nullable for f in p.schema] == \
            [f.nullable for f in r.schema], where
        assert p.schema.metadata == r.schema.metadata, where
        assert pylist_equal(p.to_pydict(), r.to_pydict()), where
    elif isinstance(r, at.ChunkedArray):
        assert isinstance(p, att.ChunkedArray), where
        assert p.type == port_type(r.type), where
        assert p.num_chunks == r.num_chunks, where
        assert pylist_equal(p.to_pylist(), r.to_pylist()), where
    elif isinstance(r, at.Array):
        assert isinstance(p, att.Array), where
        assert p.type == port_type(r.type), where
        assert pylist_equal(p.to_pylist(), r.to_pylist()), where
    elif isinstance(r, list):
        assert len(p) == len(r), where
        for a, b in zip(p, r):
            same(a, b, where)
    elif hasattr(r, "as_py"):
        assert pylist_equal(p.as_py(), r.as_py()), where
    else:
        assert pylist_equal(p, r), where


def builtin_class(exc):
    """The nearest built-in class of an exception: the packages' own
    classes are distinct objects, and the port's element-wise functions
    raise ValueError at once where the reference's ErrGuard raises its
    ArrowInvalid, a ValueError (``compute/elementwise.py``)."""
    return next(c for c in type(exc).__mro__ if c.__module__ == "builtins")


def run_both(call, ref_obj, port_obj):
    """``call(P, obj, device kwargs)`` on both packages: the same result,
    or an error of the same built-in class."""
    try:
        want = call(at, ref_obj, {})
    except Exception as exc:  # noqa: BLE001 - the class is compared
        with pytest.raises(builtin_class(exc)):
            call(att, port_obj, CPU)
        return None, None
    got = call(att, port_obj, CPU)
    same(got, want)
    return got, want


def same_bytes(p, r, where=""):
    """Column by column, byte for byte, values under nulls included."""
    for name, pc, rc in zip(r.schema.names, p.columns, r.columns):
        assert_same_data(pc.combine().data, rc.combine().data,
                         f"{where} {name}")


def _text(s, t_port, t_ref):
    return s.replace("arrow_tpu_torch.", "arrow_tpu.").replace(
        repr(t_port), repr(t_ref))


# --- ChunkedArray --------------------------------------------------------------------

def _mask(P, n=N):
    rng = np.random.default_rng(3)
    return P.array(_with_nulls(rng, (rng.random(n) < 0.6).tolist(), 0.1),
                   P.bool_())


def _indices(P):
    return P.array([3, 0, 39, 7, 7, 25, None, 12], P.int64())


CHUNKED_CASES = {
    "cast_float64": ("i", lambda P, c, d: c.cast(P.float64(), **d)),
    "cast_int32": ("i", lambda P, c, d: c.cast(P.int32(), **d)),
    "cast_dict_to_string": ("d", lambda P, c, d: c.cast(P.string(), **d)),
    "cast_bool_to_int8": ("b", lambda P, c, d: c.cast(P.int8(), **d)),
    "cast_float_to_int_fails": ("f", lambda P, c, d: c.cast(P.int64(), **d)),
    "dictionary_encode_s": ("s", lambda P, c, d: c.dictionary_encode(**d)),
    "dictionary_encode_i": ("i", lambda P, c, d: c.dictionary_encode(**d)),
    "dictionary_encode_d": ("d", lambda P, c, d: c.dictionary_encode(**d)),
    "filter_i": ("i", lambda P, c, d: c.filter(_mask(P), **d)),
    "filter_s_emit_null": ("s", lambda P, c, d: c.filter(
        _mask(P), "emit_null", **d)),
    "filter_chunked_mask": ("f", lambda P, c, d: c.filter(
        P.chunked_array([_mask(P).slice(0, 20), _mask(P).slice(20)]), **d)),
    "take_i": ("i", lambda P, c, d: c.take(_indices(P), **d)),
    "take_d": ("d", lambda P, c, d: c.take(_indices(P), **d)),
    "take_out_of_range": ("i", lambda P, c, d: c.take(
        P.array([0, 40], P.int64()), **d)),
    "drop_null_f": ("f", lambda P, c, d: c.drop_null(**d)),
    "drop_null_s": ("s", lambda P, c, d: c.drop_null(**d)),
    "fill_null_i": ("i", lambda P, c, d: c.fill_null(99, **d)),
    "fill_null_s": ("s", lambda P, c, d: c.fill_null("zz", **d)),
    "sort_i": ("i", lambda P, c, d: c.sort(**d)),
    "sort_f_descending": ("f", lambda P, c, d: c.sort("descending", **d)),
    "sort_s": ("s", lambda P, c, d: c.sort(**d)),
    "unique_i": ("i", lambda P, c, d: c.unique(**d)),
    "unique_s": ("s", lambda P, c, d: c.unique(**d)),
    "value_counts_i": ("i", lambda P, c, d: c.value_counts(**d)),
    "value_counts_d": ("d", lambda P, c, d: c.value_counts(**d)),
    "is_null_f": ("f", lambda P, c, d: c.is_null(**d)),
    "is_null_nan_is_null": ("f", lambda P, c, d: c.is_null(True, **d)),
    "is_valid_s": ("s", lambda P, c, d: c.is_valid(**d)),
    "is_nan_f": ("f", lambda P, c, d: c.is_nan(**d)),
    "index_i": ("i", lambda P, c, d: c.index(7, **d)),
    "index_i_from": ("i", lambda P, c, d: c.index(7, 20, **d)),
    "index_i_range": ("i", lambda P, c, d: c.index(7, 3, 30, **d)),
    "index_absent": ("s", lambda P, c, d: c.index("nope", **d)),
    "flatten_list": ("l", lambda P, c, d: c.flatten(**d)),
    "flatten_flat": ("i", lambda P, c, d: c.flatten(**d)),
    "unify_dictionaries": ("d", lambda P, c, d: c.unify_dictionaries()),
    "unify_dictionaries_flat": ("s", lambda P, c, d: c.unify_dictionaries()),
    "get_total_buffer_size": ("s", lambda P, c, d: c.get_total_buffer_size()),
    "nbytes": ("st", lambda P, c, d: c.nbytes),
    "data": ("i", lambda P, c, d: c.data.to_pylist()),
    "is_cpu": ("i", lambda P, c, d: c.is_cpu),
    "validate_full": ("l", lambda P, c, d: c.validate(full=True)),
}


@pytest.mark.parametrize("case", sorted(CHUNKED_CASES))
def test_chunked_array_methods(pair, case):
    col, call = CHUNKED_CASES[case]
    run_both(call, pair[0].column(col), pair[1].column(col))


@pytest.mark.parametrize("col", ["i", "f", "d", "st"])
def test_chunked_array_to_string(pair, col):
    r, p = pair[0].column(col), pair[1].column(col)
    assert _text(p.to_string(), p.type, r.type) == r.to_string()
    assert p.format() == p.to_string()


# --- RecordBatch and Table --------------------------------------------------------------

def _batch(P, t):
    return t.combine_chunks().to_batches()[0]


TABULAR_CASES = {
    "add_column_named": lambda P, t, d: t.add_column(
        1, "new", P.array(list(range(N)), P.int32())),
    "add_column_field": lambda P, t, d: t.add_column(
        0, P.field("new", P.int64(), False), list(range(N))),
    "append_column": lambda P, t, d: t.append_column(
        P.field("z", P.string()), P.array(["q"] * N, P.string())),
    "set_column": lambda P, t, d: t.set_column(
        2, P.field("s2", P.float64()), P.array([0.5] * N, P.float64())),
    "remove_column": lambda P, t, d: t.remove_column(3),
    "drop_columns": lambda P, t, d: t.drop_columns(["s", "st"]),
    "drop_columns_one": lambda P, t, d: t.drop_columns("l"),
    "drop_null": lambda P, t, d: t.select(["i", "s", "b"]).drop_null(**d),
    "cast": lambda P, t, d: t.select(["i", "b"]).cast(P.schema(
        [("i", P.float64()), ("b", P.int32())]), **d),
    "field_by_name": lambda P, t, d: port_or_ref_field(t.field("d")),
    "field_by_index": lambda P, t, d: port_or_ref_field(t.field(5)),
    "itercolumns": lambda P, t, d: [c.to_pylist() for c in t.itercolumns()],
    "shape": lambda P, t, d: t.shape,
    "nbytes": lambda P, t, d: t.nbytes,
    "get_total_buffer_size": lambda P, t, d: t.get_total_buffer_size(),
    "is_cpu": lambda P, t, d: t.is_cpu,
    "replace_schema_metadata": lambda P, t, d: t.replace_schema_metadata(
        {"k": "v"}),
    "metadata_kept_by_drop": lambda P, t, d: t.replace_schema_metadata(
        {b"k": b"v"}).drop_columns(["i"]),
    "to_struct_array": lambda P, t, d: t.select(["i", "s", "d"])
    .to_struct_array(),
    "struct_round_trip": lambda P, t, d: type(t).from_struct_array(
        t.select(["i", "f", "st"]).to_struct_array()),
    "to_string": lambda P, t, d: t.to_string(),
    "validate": lambda P, t, d: t.validate(),
    "validate_full": lambda P, t, d: t.validate(full=True),
    "filter": lambda P, t, d: t.filter(_mask(P), **d),
    "take": lambda P, t, d: t.select(["i", "s", "d"]).take(
        P.array([5, 0, 33], P.int64()), **d),
    "sort_by": lambda P, t, d: t.select(["i", "f", "s"]).sort_by(
        [("i", "descending"), ("s", "ascending")], **d),
    "rename_columns": lambda P, t, d: t.rename_columns(
        [f"c{k}" for k in range(t.num_columns)]),
}

TABLE_ONLY = {
    "drop": lambda P, t, d: t.drop(["f"]),
    "flatten": lambda P, t, d: t.flatten(),
    "unify_dictionaries": lambda P, t, d: t.unify_dictionaries(),
    "to_struct_array_chunks": lambda P, t, d: t.select(["i", "b"])
    .to_struct_array(16),
    "from_struct_array_chunked": lambda P, t, d: P.Table.from_struct_array(
        t.select(["i", "st"]).to_struct_array(16)),
    "combine_chunks": lambda P, t, d: t.combine_chunks(),
}


def port_or_ref_field(f):
    return (f.name, int(f.type.id), f.nullable, f.metadata)


@pytest.mark.parametrize("case", sorted(TABULAR_CASES) + sorted(TABLE_ONLY))
def test_table_methods(pair, case):
    call = TABULAR_CASES.get(case) or TABLE_ONLY[case]
    run_both(call, *pair)


@pytest.mark.parametrize("case", sorted(TABULAR_CASES))
def test_record_batch_methods(pair, case):
    run_both(TABULAR_CASES[case], _batch(at, pair[0]), _batch(att, pair[1]))


@pytest.mark.parametrize("rows", [
    [{"a": 1, "b": "u"}, {"a": 2, "b": None}, {"b": "w"}],
    [],
])
def test_from_pylist(rows):
    for cls in ("Table", "RecordBatch"):
        if not rows:
            schema = {P: P.schema([("a", P.int64())]) for P in (at, att)}
            same(getattr(att, cls).from_pylist(rows, schema[att]),
                 getattr(at, cls).from_pylist(rows, schema[at]))
        else:
            same(getattr(att, cls).from_pylist(rows),
                 getattr(at, cls).from_pylist(rows))


def test_record_batch_device_and_copy(pair):
    rb = _batch(att, pair[1])
    assert rb.device_type == att.DeviceAllocationType.CPU == \
        _batch(at, pair[0]).device_type
    assert rb.copy_to(None) is rb


# --- RecordBatchReader, ChunkResolver, Datum ---------------------------------------

def test_record_batch_reader_close_and_context(pair):
    got, want = [], []
    for P, t, out in ((at, pair[0], want), (att, pair[1], got)):
        with t.to_reader(16) as r:
            out.append(r.read_next_batch().num_rows)
        with pytest.raises(StopIteration):
            r.read_next_batch()
        r2 = t.to_reader(10)
        r2.close()
        out.append(r2.read_all().num_rows)
    assert got == want == [16, 0]


def test_record_batch_reader_from_stream(pair):
    r, p = pair
    same(att.RecordBatchReader.from_stream(p).read_all(),
         at.RecordBatchReader.from_stream(r).read_all())
    same(att.RecordBatchReader.from_stream(_batch(att, p)).read_all(),
         at.RecordBatchReader.from_stream(_batch(at, r)).read_all())
    batches = p.to_batches(9)
    same(att.RecordBatchReader.from_stream(iter(batches)).read_all(),
         r.combine_chunks())
    reader = p.to_reader(5)
    assert att.RecordBatchReader.from_stream(reader) is reader


@pytest.mark.parametrize("index", [0, 6, 7, 24, 25, 39])
def test_chunk_resolver(pair, index):
    ref = at.ChunkResolver(pair[0].column("i").chunks)
    got = att.ChunkResolver(pair[1].column("i").chunks)
    assert got.resolve(index) == ref.resolve(index)
    for a, b in zip(got.resolve_many([index, 3, 30]),
                    ref.resolve_many([index, 3, 30])):
        assert a.tolist() == b.tolist()


def test_datum_kinds(pair):
    r, p = pair
    pairs = [(r, p), (_batch(at, r), _batch(att, p)),
             (r.column("i"), p.column("i")),
             (r.column("i").chunk(0), p.column("i").chunk(0)), (5, 5),
             (at.scalar(2), att.scalar(2))]
    for a, b in pairs:
        ja, tb = at.Datum(a), att.Datum(b)
        assert (tb.kind, tb.is_scalar(), tb.is_array()) == \
            (ja.kind, ja.is_scalar(), ja.is_array())


# --- Array ------------------------------------------------------------------------

ARRAY_CASES = {
    "index": ("i", lambda P, a, d: a.index(7, **d)),
    "index_start_end": ("i", lambda P, a, d: a.index(7, 10, 40, **d)),
    "index_string": ("s", lambda P, a, d: a.index("c", **d)),
    "index_absent": ("f", lambda P, a, d: a.index(1e9, **d)),
    "diff_equal": ("i", lambda P, a, d: a.diff(a)),
    "diff": ("s", lambda P, a, d: a.diff(P.array(
        ["zz"] + a.to_pylist()[1:-1] + [None], P.string()))),
    "diff_lengths": ("i", lambda P, a, d: a.diff(a.slice(0, 30))),
    "statistics": ("i", lambda P, a, d: a.statistics),
    "view_uint64": ("i", lambda P, a, d: a.view(P.uint64())),
    "view_timestamp": ("i", lambda P, a, d: a.view(P.timestamp("ms"))),
    "view_not_a_type": ("i", lambda P, a, d: a.view("int64")),
    "get_total_buffer_size": ("s", lambda P, a, d: a.get_total_buffer_size()),
    "is_cpu": ("d", lambda P, a, d: a.is_cpu),
    "device_type": ("d", lambda P, a, d: a.device_type),
    "validate": ("st", lambda P, a, d: a.validate()),
    "validate_full": ("d", lambda P, a, d: a.validate(full=True)),
    "tolist": ("l", lambda P, a, d: a.tolist()),
}


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
def test_array_methods(pair, case):
    col, call = ARRAY_CASES[case]
    run_both(call, pair[0].column(col).chunk(2), pair[1].column(col).chunk(2))


def test_fill_null_of_strings_without_nulls():
    """The reference's ``fill_null`` (``coalesce``) of a string Array with
    no null gives its int32 codes; the port gives the strings, as pyarrow
    does."""
    pa = pytest.importorskip("pyarrow")
    vals = ["", "déjà", "x y", "c"]
    assert at.array(vals).fill_null("?").type == at.int32()
    got = att.array(vals).fill_null("?", device="cpu")
    assert got.type == att.string()
    assert got.to_pylist() == pa.array(vals).fill_null("?").to_pylist()


def test_array_copy_to_and_to_string(pair):
    r, p = pair[0].column("f").chunk(2), pair[1].column("f").chunk(2)
    assert p.copy_to(None) is p
    assert _text(p.to_string(), p.type, r.type) == r.to_string()


@pytest.mark.parametrize("offset", [0, 3])
def test_array_from_buffers(offset):
    vals = np.arange(10, dtype=np.int32)
    bits = np.packbits(np.arange(10) % 3 != 0, bitorder="little").tobytes()
    want = at.Array.from_buffers(at.int32(), 7, [bits, vals.tobytes()],
                                 offset=offset)
    got = att.Array.from_buffers(att.int32(), 7, [bits, vals.tobytes()],
                                 offset=offset)
    same(got, want)
    child = at.array([1, 2, 3, 4]), att.array([1, 2, 3, 4])
    offs = np.array([0, 1, 4], np.int32).tobytes()
    same(att.Array.from_buffers(att.list_(att.int64()), 2, [None, offs],
                                children=[child[1]]),
         at.Array.from_buffers(at.list_(at.int64()), 2, [None, offs],
                               children=[child[0]]))


# --- joins ------------------------------------------------------------------------

def join_sides(P, seed=5):
    """Two Tables with nullable int64 keys and dictionary string keys whose
    dictionaries differ between the sides, and a second key column."""
    rng = np.random.default_rng(seed)
    sides = []
    for n, words, tag in ((37, ["k3", "k1", "k0", "k2"], "l"),
                          (29, ["k2", "k4", "k3", "k1"], "r")):
        ints = _with_nulls(rng, rng.integers(0, 12, n).tolist(), 0.1)
        strs = _with_nulls(rng, [words[k] for k in rng.integers(0, 4, n)],
                           0.1)
        sides.append(P.table({
            "ik": P.array(ints, P.int64()),
            "sk": P.array(strs, P.dictionary(P.int32(), P.string())),
            "k2": P.array(rng.integers(0, 2, n).tolist(), P.int64()),
            f"{tag}v": P.array(rng.normal(0, 1, n).round(4).tolist(),
                               P.float64()),
            "shared": P.array([f"{tag}{i}" for i in range(n)], P.string()),
        }))
    return sides


@pytest.fixture(scope="module")
def join_pair():
    return join_sides(at), join_sides(att)


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("key", ["ik", "sk"])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_table_join(join_pair, jt, key, coalesce):
    (rl, rr), (pl, pr) = join_pair
    kw = dict(join_type=jt, coalesce_keys=coalesce, left_suffix="_l",
              right_suffix="_r")
    want = rl.join(rr, key, **kw)
    got = pl.join(pr, key, **kw, device="cpu")
    same(got, want, jt)
    same_bytes(got, want, jt)


@pytest.mark.parametrize("jt", ["inner", "left outer", "full outer",
                                "right anti"])
def test_table_join_two_keys_and_right_keys(join_pair, jt):
    (rl, rr), (pl, pr) = join_pair
    same(pl.join(pr, ["ik", "k2"], join_type=jt, right_suffix="_r",
                 device="cpu"),
         rl.join(rr, ["ik", "k2"], join_type=jt, right_suffix="_r"))
    rr2 = rr.rename_columns(["rik", "rsk", "rk2", "rv", "rshared"])
    pr2 = pr.rename_columns(["rik", "rsk", "rk2", "rv", "rshared"])
    want = rl.join(rr2, "sk", "rsk", join_type=jt)
    got = pl.join(pr2, "sk", "rsk", join_type=jt, device="cpu")
    same(got, want)
    same_bytes(got, want)


def test_full_outer_coalesce_departure():
    """Both packages drop the right key of a coalesced full outer join:
    the right-only row keeps no key (pyarrow gives k = [2, 3, 1, 4])."""
    for P, dev in ((at, {}), (att, CPU)):
        left = P.table({"k": [1, 2, 3], "a": [10, 20, 30]})
        right = P.table({"k": [2, 3, 4], "b": [200, 300, 400]})
        out = left.join(right, "k", join_type="full outer", **dev)
        assert out.to_pydict() == {"k": [1, 2, 3, None],
                                   "a": [10, 20, 30, None],
                                   "b": [None, 200, 300, 400]}
        out = left.join(right, "k", join_type="right outer", **dev)
        assert out.to_pydict()["k"] == [2, 3, None]


def asof_sides(P):
    rng = np.random.default_rng(11)
    lt = np.sort(rng.integers(0, 60, 25))
    rt = np.sort(rng.integers(0, 60, 18))
    return (P.table({"t": P.array(lt.tolist(), P.int64()),
                     "k": P.array(rng.integers(0, 2, 25).tolist(), P.int64()),
                     "v": P.array(list(range(25)), P.int64())}),
            P.table({"t": P.array(rt.tolist(), P.int64()),
                     "k": P.array(rng.integers(0, 2, 18).tolist(), P.int64()),
                     "w": P.array(rng.normal(0, 1, 18).round(3).tolist(),
                                  P.float64())}))


@pytest.mark.parametrize("tolerance", [-4, 0, 3])
def test_table_join_asof(tolerance):
    (rl, rr), (pl, pr) = asof_sides(at), asof_sides(att)
    want = rl.join_asof(rr, on="t", by="k", tolerance=tolerance)
    got = pl.join_asof(pr, on="t", by="k", tolerance=tolerance,
                       device="cpu")
    same(got, want)
    same_bytes(got, want)


def test_dataset_join_and_join_asof(join_pair):
    (rl, rr), (pl, pr) = join_pair
    jl, jr = jds.InMemoryDataset(rl), jds.InMemoryDataset(rr)
    tl, tr = tds.InMemoryDataset(pl), tds.InMemoryDataset(pr)
    for jt in ("inner", "left outer", "right semi"):
        want = jl.join(jr, "ik", join_type=jt, right_suffix="_r")
        same(tl.join(tr, "ik", join_type=jt, right_suffix="_r",
                     device="cpu"), want)
        same(tl.join(pr, "ik", join_type=jt, right_suffix="_r",
                     device="cpu"), want)
    (al, ar), (bl, br) = asof_sides(at), asof_sides(att)
    same(tds.InMemoryDataset(bl).join_asof(
        tds.InMemoryDataset(br), "t", "k", -4, device="cpu"),
        jds.InMemoryDataset(al).join_asof(jds.InMemoryDataset(ar), "t", "k",
                                          -4))


def test_join_of_a_table_reuses_its_uploads(join_pair):
    from arrow_tpu_torch.acero import source_cache
    _, (pl, pr) = join_pair
    pl.join(pr, "ik", device="cpu")
    before = dict(source_cache.UPLOAD_STATS)
    pl.join(pr, "ik", join_type="inner", device="cpu")
    assert source_cache.UPLOAD_STATS == before


# --- validate ---------------------------------------------------------------------

def _broken(P, kind):
    """An ArrayData with one fault of ``kind`` (None: sound)."""
    AD = JArrayData if P is at else TArrayData
    B = JBuffer if P is at else TBuffer
    offs = np.array([0, 2, 5, 5], np.int32)
    data = b"abcde"
    if kind == "offsets_decrease":
        offs = np.array([0, 4, 2, 5], np.int32)
    if kind == "offsets_past_data":
        offs = np.array([0, 2, 5, 9], np.int32)
    if kind == "bad_utf8":
        data = b"ab\xffde"
    if kind in (None, "offsets_decrease", "offsets_past_data", "bad_utf8"):
        return AD(P.string(), 3, [None, B(offs.tobytes()), B(data)])
    if kind == "short_bitmap":
        return AD(P.int32(), 20, [B(b"\xff"), B(bytes(80))])
    if kind == "null_count_no_bitmap":
        return AD(P.int32(), 4, [None, B(bytes(16))], null_count=2)
    if kind == "too_many_nulls":
        return AD(P.int32(), 4, [B(b"\x00"), B(bytes(16))], null_count=5)
    if kind == "buffer_count":
        return AD(P.int32(), 4, [None])
    if kind == "dict_index_out_of_range":
        d = AD(P.string(), 2, [None, B(np.array([0, 1, 2], np.int32)
                                      .tobytes()), B(b"xy")])
        return AD(P.dictionary(P.int32(), P.string()), 3,
                  [None, B(np.array([0, 1, 2], np.int32).tobytes())],
                  dictionary=d)
    raise AssertionError(kind)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("kind", [
    None, "offsets_decrease", "offsets_past_data", "bad_utf8",
    "short_bitmap", "null_count_no_bitmap", "too_many_nulls", "buffer_count",
    "dict_index_out_of_range"])
def test_validate(kind, full):
    fn = "validate_full" if full else "validate"
    try:
        getattr(jvalidate, fn)(_broken(at, kind))
    except jvalidate.ValidationError as exc:
        with pytest.raises(tvalidate.ValidationError) as got:
            getattr(tvalidate, fn)(_broken(att, kind))
        assert str(got.value) == str(exc)
        assert issubclass(tvalidate.ValidationError, ValueError)
        with pytest.raises(tvalidate.ValidationError):
            att.Array(_broken(att, kind)).validate(full=full)
        return
    getattr(tvalidate, fn)(_broken(att, kind))
    att.Array(_broken(att, kind)).validate(full=full)


# --- builders ---------------------------------------------------------------------

BUILDER_CASES = {
    "Int8Builder": [1, None, -3], "Int16Builder": [300, None],
    "Int32Builder": [7, 8, None], "Int64Builder": [2 ** 40, None],
    "UInt8Builder": [255, None], "UInt16Builder": [65535],
    "UInt32Builder": [1, None], "UInt64Builder": [2 ** 63, 0],
    "FloatBuilder": [1.5, None], "DoubleBuilder": [0.1, float("nan"), None],
    "BooleanBuilder": [True, 0, None, 1], "StringBuilder": ["a", b"b", 3],
    "BinaryBuilder": [b"x", bytearray(b"yz")],
}


@pytest.mark.parametrize("name", sorted(BUILDER_CASES))
def test_typed_builders(name):
    out = []
    for mod in (jbuilder, tbuilder):
        b = getattr(mod, name)()
        b.extend(BUILDER_CASES[name])
        b.append_null()
        b.append_nulls(2)
        out.append((len(b), b.null_count, b.finish(), len(b)))
    (ln, nc, arr, after), (tln, tnc, tarr, tafter) = out
    assert (tln, tnc, tafter) == (ln, nc, after)
    same(tarr, arr)


@pytest.mark.parametrize("values", [[1, -128, 127], [1, 300], [-40000],
                                    [2 ** 31], [None], []])
def test_adaptive_int_builder(values):
    got = tbuilder.AdaptiveIntBuilder().extend(values).finish()
    same(got, jbuilder.AdaptiveIntBuilder().extend(values).finish())


def test_nested_and_dictionary_builders():
    arrays = []
    for P, mod in ((at, jbuilder), (att, tbuilder)):
        d = mod.DictionaryBuilder()
        d.extend(["x", "y", None, "x"])
        child = mod.Int64Builder()
        lb = mod.ListBuilder(child)
        child.append(1).append(2)
        lb.append()
        lb.append([5])
        lb.append_null()
        lb2 = mod.ListBuilder(P.float64())
        lb2.append([1.5]).append()
        sb = mod.StructBuilder([("p", P.int64()), ("q", P.string())])
        sb.append({"p": 1, "q": "a"}).append_null()
        arrays.append([d.finish(), lb.finish(), lb2.finish(), sb.finish(),
                       lb.value_builder is child, d.type])
    want, got = arrays
    for g, w in zip(got[:4], want[:4]):
        same(g, w)
    assert got[4:] == want[4:]


@pytest.mark.parametrize("tname", ["bool_", "int8", "uint64", "float32",
                                   "float64", "string", "binary", "date32",
                                   "timestamp"])
def test_builder_for(tname):
    vals = {"date32": [0, 19000], "timestamp": [5, None],
            "string": ["a", None], "binary": [b"q"], "bool_": [True]}.get(
                tname, [1, None])
    got = tbuilder.builder_for(getattr(att, tname)())
    want = jbuilder.builder_for(getattr(at, tname)())
    assert type(got).__name__ == type(want).__name__
    if tname in ("date32", "timestamp"):
        vals = [None]
    same(got.extend(vals).finish(), want.extend(vals).finish())


def test_builder_for_nested():
    for t in ("list", "struct"):
        pt = att.list_(att.int32()) if t == "list" else \
            att.struct([("a", att.int8())])
        jt = at.list_(at.int32()) if t == "list" else \
            at.struct([("a", at.int8())])
        got, want = tbuilder.builder_for(pt), jbuilder.builder_for(jt)
        assert type(got).__name__ == type(want).__name__
        v = [[1, 2]] if t == "list" else [{"a": 3}]
        same(got.extend(v).finish(), want.extend(v).finish())


# --- pretty and compare ------------------------------------------------------------

@pytest.mark.parametrize("window", [2, 10, 30])
@pytest.mark.parametrize("col", ["i", "f", "s", "b", "st"])
def test_array_to_string(pair, col, window):
    r = pair[0].column(col).combine()
    p = pair[1].column(col).combine()
    assert tpretty.array_to_string(p, window) == \
        jpretty.array_to_string(r, window)


@pytest.mark.parametrize("max_rows", [0, 5, 100])
def test_table_to_string(pair, max_rows):
    r, p = (t.select(["i", "f", "s", "d", "b"]) for t in pair)
    assert tpretty.table_to_string(p, max_rows) == \
        jpretty.table_to_string(r, max_rows)
    assert tpretty.table_to_string(_batch(att, p), max_rows) == \
        jpretty.table_to_string(_batch(at, r), max_rows)


def test_pretty_print(pair):
    outs = []
    for mod, t in ((jpretty, pair[0]), (tpretty, pair[1])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.pretty_print(t.select(["i", "s"]), max_rows=4)
            mod.pretty_print(t.column("f"), window=3)
            mod.pretty_print(t.column("d").chunk(0))
        with pytest.raises(TypeError):
            mod.pretty_print(3)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]


_EQ = [(dict(), False), (dict(nans_equal=True), False),
       (dict(signed_zeros_equal=False), False), (dict(atol=0.01), True),
       (dict(atol=1e-9), True), (dict(nans_equal=True, atol=0.5), True)]


@pytest.mark.parametrize("opts,approx", _EQ)
def test_compare(opts, approx):
    a = [1.0, float("nan"), -0.0, None, 2.0]
    b = [1.0, float("nan"), 0.0, None, 2.001]
    res = []
    for P, mod in ((at, jcompare), (att, tcompare)):
        o = mod.EqualOptions(**opts)
        o2 = o.with_atol(o.atol).with_nans_equal(o.nans_equal) \
            .with_signed_zeros_equal(o.signed_zeros_equal)
        x, y = P.array(a, P.float64()), P.array(b, P.float64())
        tx, ty = P.table({"c": x}), P.table({"c": y})
        res.append((mod.array_equals(x, y, o, approx),
                    mod.array_equals(x, x, o2, approx),
                    mod.array_equals(x, P.array([1], P.int64()), o),
                    mod.table_equals(tx, ty, o, approx),
                    mod.table_equals(tx, tx, None, approx),
                    mod.array_equals(P.array([[1.0, None]]),
                                     P.array([[1.0, None]]), o, approx)))
    assert res[1] == res[0]
