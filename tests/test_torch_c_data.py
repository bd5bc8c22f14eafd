"""The C data interface of the port (``arrow_tpu_torch/c_data.py``) against
the JAX package's (``arrow_tpu/c_data.py``), with pyarrow as a consumer and
producer, as ``tests/test_io_interop.py`` uses it.

* the formats of every type, both ways, the reference's; an extension
  type raises as the reference's ``format_for_type`` does; the view types
  have the spec's formats here (a departure: the reference raises);
* export to pyarrow and import from it, by address and by capsule, the
  reference's cases and the port's layouts (views, unions, maps, slices);
* the C stream of a Table, a RecordBatch and a reader, consumed by the
  port and by pyarrow, and a pyarrow stream consumed by the port;
* ownership, the reference's leak not copied: with the cyclic collector
  off, after an export, an import and ``del``, the export state is empty
  and an exported buffer dies with its Table; a dropped capsule releases
  its struct; a closed or dropped reader releases its stream; an error in
  a producer's callback comes back as an error code, not an exception.
"""

import ctypes
import gc
import weakref

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import c_data as rc
from arrow_tpu_torch import c_data as pc

from test_torch_host_table import port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def _types(P):
    fs = [P.field("a", P.int8()), P.field("b", P.string())]
    return [
        P.null(), P.bool_(), P.int8(), P.uint16(), P.int32(), P.uint64(),
        P.float16(), P.float32(), P.float64(), P.string(), P.binary(),
        P.large_string(), P.large_binary(), P.date32(), P.date64(),
        P.timestamp("ms"), P.timestamp("ns", "UTC"), P.time32("s"),
        P.time64("us"), P.duration("ms"), P.month_interval(),
        P.day_time_interval(), P.month_day_nano_interval(),
        P.fixed_size_binary(5), P.decimal128(20, 4), P.decimal256(40, 5),
        P.decimal32(7, 2), P.decimal64(12, 3), P.list_(P.int8()),
        P.large_list(P.string()), P.fixed_size_list(P.int8(), 3),
        P.struct(fs), P.map_(P.string(), P.int32()),
        P.dictionary(P.int16(), P.string()),
        P.run_end_encoded(P.int32(), P.float64()), P.sparse_union(fs),
        P.dense_union(fs, [5, 7])]


@pytest.mark.parametrize("i", range(len(_types(at))))
def test_formats_are_the_references(i):
    r, p = _types(at)[i], _types(att)[i]
    fmt = rc.format_for_type(r)
    assert pc.format_for_type(p) == fmt
    if r.id == at.TypeId.DICTIONARY:
        return
    children = list(r.fields)
    kids = [att.field(f.name, port_type(f.type), f.nullable)
            for f in children]
    got, want = pc.type_for_format(fmt, kids), rc.type_for_format(fmt,
                                                                  children)
    if "union" in repr(want):  # port_type has no unions: by their parts
        assert (repr(got), got.mode, got.type_codes) == \
            (repr(want), want.mode, want.type_codes)
    else:
        assert got == port_type(want)


@pytest.mark.parametrize("case", ["uuid", "fixed_shape_tensor"])
def test_an_extension_type_has_no_format_as_in_the_reference(case):
    from arrow_tpu import extension as rx
    from arrow_tpu_torch import extension as px
    r = rx.uuid() if case == "uuid" else rx.fixed_shape_tensor(
        at.float32(), [2])
    p = px.uuid() if case == "uuid" else px.fixed_shape_tensor(
        att.float32(), [2])
    with pytest.raises(NotImplementedError, match="C ABI format"):
        rc.format_for_type(r)
    with pytest.raises(NotImplementedError, match="C ABI format"):
        pc.format_for_type(p)
    storage = att.array([b"0123456789abcdef"], att.fixed_size_binary(16)) \
        if case == "uuid" else att.array([[1.0, 2.0]],
                                         att.fixed_size_list(att.float32(), 2))
    arr = att.Array(att.ArrayData(p, 1, storage.data.buffers,
                                  storage.data.children))
    with pytest.raises(NotImplementedError):
        arr.__arrow_c_array__()
    assert not any(pc.export_state().values())


@pytest.mark.parametrize("fmt,tname", [("vu", "string_view"),
                                       ("vz", "binary_view"),
                                       ("+vl", "list_view")])
def test_the_view_formats_are_a_departure(fmt, tname):
    """The reference has no view format; the port has the spec's."""
    r = getattr(at, tname)(at.int8()) if tname == "list_view" else \
        getattr(at, tname)()
    with pytest.raises(NotImplementedError):
        rc.format_for_type(r)
    p = getattr(att, tname)(att.int8()) if tname == "list_view" else \
        getattr(att, tname)()
    assert pc.format_for_type(p) == fmt
    kids = [att.field("item", att.int8())] if tname == "list_view" else []
    assert pc.type_for_format(fmt, kids) == p


CDATA_CASES = [
    ([1, 2, None], None),
    (["a", None, "bb"], None),
    ([1.5, None], None),
    ([True, None], None),
    ([b"xy", None], "binary"),
    ([[1, 2], None], "list<int64>"),
    ([{"a": 1, "b": "z"}, None], "struct"),
    (["u", "v", "u", None], "dictionary"),
]


def _type(P, name):
    return {None: None, "binary": P.binary(),
            "list<int64>": P.list_(P.int64()),
            "struct": P.struct([("a", P.int64()), ("b", P.string())]),
            "dictionary": P.dictionary(P.int32(), P.string())}[name]


def _export(P, C, arr):
    sch, a = C.ArrowSchemaStruct(), C.ArrowArrayStruct()
    C.export_array(arr, ctypes.addressof(a), ctypes.addressof(sch))
    return pa.Array._import_from_c(ctypes.addressof(a), ctypes.addressof(sch))


@pytest.mark.parametrize("case", range(len(CDATA_CASES)))
def test_export_to_pyarrow_as_the_reference(case):
    vals, tname = CDATA_CASES[case]
    want = _export(at, rc, at.array(vals, _type(at, tname)))
    got = _export(att, pc, att.array(vals, _type(att, tname)))
    assert got.type == want.type
    assert got.to_pylist() == want.to_pylist() == vals
    del got, want
    assert not any(pc.export_state().values())


@pytest.mark.parametrize("case", range(len(CDATA_CASES)))
def test_import_from_pyarrow_as_the_reference(case):
    vals, tname = CDATA_CASES[case]
    src = pa.array(vals).dictionary_encode() if tname == "dictionary" \
        else pa.array(vals, type=pa.binary() if tname == "binary" else None)
    out = []
    for C in (rc, pc):
        sch, a = C.ArrowSchemaStruct(), C.ArrowArrayStruct()
        src._export_to_c(ctypes.addressof(a), ctypes.addressof(sch))
        out.append(C.import_array(ctypes.addressof(a),
                                  ctypes.addressof(sch)))
    want, got = out
    assert got.type == port_type(want.type)
    assert got.to_pylist() == want.to_pylist() == src.to_pylist()


def _layouts():
    fs = [att.field("a", att.int64()), att.field("b", att.string())]
    sparse = att.Array.from_buffers(
        att.sparse_union(fs), 4, [np.array([0, 1, 1, 0], np.int8)],
        children=[att.array([1, 2, 3, 4]), att.array(["w", None, "y", "z"])])
    dense = att.Array.from_buffers(
        att.dense_union(fs, [3, 9]), 4,
        [np.array([3, 9, 9, 3], np.int8), np.array([0, 0, 1, 1], np.int32)],
        children=[att.array([10, 20]), att.array(["p", None])])
    return {
        "string_view": att.array(["a", None, "a value of 24 bytes long",
                                  ""], att.string_view()),
        "binary_view": att.array([b"x" * 13, None, b"y"], att.binary_view()),
        "list_view": att.array([[1, 2], None, [], [3]],
                               att.list_view(att.int32())),
        "large_list_view": att.array([[1.5], [None, 2.5]],
                                     att.large_list_view(att.float64())),
        "sparse_union": sparse, "dense_union": dense,
        "map": att.array([{"k": 1, "j": 2}, None, {}],
                         att.map_(att.string(), att.int64())),
        "sliced strings": att.array(["a", None, "bcd", "ef", None, "g"])
        .slice(1, 4),
        "sliced ints": att.array(list(range(20)) + [None]).slice(3, 15),
        "fixed_size_list": att.array([[1, 2], None, [3, 4]],
                                     att.fixed_size_list(att.int16(), 2)),
        "decimal": att.array([1, None, -7], att.decimal128(10, 2)),
        "timestamp": att.array([1, None, 3], att.timestamp("us", "UTC")),
    }


@pytest.mark.parametrize("name", sorted(_layouts()))
def test_layouts_round_trip_through_pyarrow(name):
    arr = _layouts()[name]
    theirs = pa.array(arr)  # __arrow_c_array__
    assert theirs.to_pylist() == arr.to_pylist()
    back = pc.import_array(*reversed(theirs.__arrow_c_array__()))
    assert back.type == arr.type
    assert back.to_pylist() == arr.to_pylist()
    sch, a = arr.__arrow_c_array__()
    again = pc.import_array(a, sch)
    assert again.to_pylist() == arr.to_pylist() and again.offset == \
        arr.offset
    del theirs, sch, a
    assert not any(pc.export_state().values())


def _table(P):
    return P.table({"i": P.array([1, None, 3, 4], P.int64()),
                    "s": P.array(["x", None, "zz", "w"], P.string()),
                    "d": P.array(["u", "v", "u", None],
                                 P.dictionary(P.int32(), P.string()))})


@pytest.mark.parametrize("what", ["table", "batch", "reader", "two chunks"])
def test_the_c_stream_as_the_reference(what):
    def source(P):
        t = _table(P)
        if what == "batch":
            return t.to_batches()[0]
        if what == "reader":
            return P.RecordBatchReader.from_batches(t.schema, t.to_batches())
        if what == "two chunks":
            return P.concat_tables([t, t.slice(1, 2)])
        return t
    want = at.RecordBatchReader.from_stream(source(at)).read_all()
    got = att.RecordBatchReader.from_stream(
        source(att).__arrow_c_stream__()).read_all()
    assert got.to_pydict() == want.to_pydict()
    assert [f.type for f in got.schema] == \
        [port_type(f.type) for f in want.schema]
    theirs = pa.RecordBatchReader.from_stream(source(att)).read_all()
    assert theirs.to_pydict() == want.to_pydict()
    del theirs
    assert not any(pc.export_state().values())


def test_a_pyarrow_stream_into_the_port():
    src = pa.table({"k": [10, None, 30], "s": ["a", "bb", None],
                    "v": pa.array(["p", "q", "p"]).dictionary_encode()})
    want = at.RecordBatchReader.from_stream(src).read_all()
    got = att.RecordBatchReader.from_stream(src).read_all()
    assert got.to_pydict() == want.to_pydict() == src.to_pydict()
    assert got.schema == att.RecordBatchReader.from_stream(
        src.__arrow_c_stream__()).schema


def test_the_export_state_empties_without_the_collector():
    """The reference's leak, not copied: three stream exports imported,
    read and deleted, three array capsules dropped unconsumed, leave
    nothing; a weakref to an exported buffer dies with its Table."""
    assert not gc.isenabled()
    t = _table(att)
    buf = t.column("i").chunks[0].data.buffers[1].to_numpy()
    ref = weakref.ref(buf)  # the memory an export points at
    for _ in range(3):
        out = att.RecordBatchReader.from_stream(
            t.__arrow_c_stream__()).read_all()
        assert out.to_pydict() == t.to_pydict()
        del out
    for _ in range(3):
        caps = t.column("s").chunks[0].__arrow_c_array__()
        del caps
    assert pc.export_state() == {"structs": 0, "capsules": 0, "streams": 0}
    assert pc._EXPORTS == {} and pc._STREAMS == {} and pc._CAPSULES == {}
    del t, buf
    assert ref() is None


def test_a_consumer_keeps_the_buffers_until_it_releases():
    t = _table(att)
    buf = t.column("i").chunks[0].data.buffers[1].to_numpy()
    ref = weakref.ref(buf)
    theirs = pa.table(t)  # zero-copy: pyarrow holds our structs
    del t, buf
    assert ref() is not None and pc.export_state()["structs"] > 0
    assert theirs.column("i").to_pylist() == [1, None, 3, 4]
    del theirs
    assert ref() is None and not any(pc.export_state().values())


@pytest.mark.parametrize("how", ["close", "drop", "half read"])
def test_an_imported_stream_is_released(how):
    t = _table(att)
    stream = att.concat_tables([t, t])
    reader = att.RecordBatchReader.from_stream(stream.__arrow_c_stream__())
    assert pc.export_state()["streams"] == 1
    if how == "half read":
        next(reader)
        reader.close()
    elif how == "close":
        reader.close()
    else:
        del reader
    assert not any(pc.export_state().values())


def test_a_dropped_unread_capsule_releases_its_stream():
    caps = _table(att).__arrow_c_stream__()
    assert pc.export_state()["streams"] == 1
    del caps
    assert not any(pc.export_state().values())


def test_an_error_in_a_callback_comes_back_as_a_code():
    """A batch that cannot be exported makes get_next answer EIO with a
    message; nothing crosses the callback."""
    field = att.field("", att.struct([att.field("x", att.int64())]))
    bad = att.ArrayData(field.type, 1, [None], [None], null_count=0)
    caps = pc.stream_capsule([bad], field)
    with pytest.raises(OSError, match="get_next failed"):
        att.RecordBatchReader.from_stream(caps).read_all()
    del caps
    assert not any(pc.export_state().values())


def test_a_capsule_is_consumed_once():
    caps = _table(att).__arrow_c_stream__()
    att.RecordBatchReader.from_stream(caps).read_all()
    with pytest.raises(ValueError, match="released or moved"):
        att.RecordBatchReader.from_stream(caps)
    del caps
    assert not any(pc.export_state().values())
