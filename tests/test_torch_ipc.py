"""Arrow IPC in the port (``arrow_tpu_torch/ipc/``) against the JAX
package's (``arrow_tpu/ipc/``), with pyarrow as an oracle only.

* the 23 tables of ``tests/test_ipc.py``'s SIMPLE_CASES, uncompressed, LZ4
  and zstd: the port's stream and file bytes equal the reference's for the
  same Table, each package reads the other's bytes to equal values, and
  pyarrow reads the port's;
* pyarrow's files and streams (dictionaries, zstd, LZ4) read by the port;
* sliced arrays rebased, schema and field metadata, several batches over
  one dictionary (written once), intervals, the compat classes, and the
  random differential of ``test_ipc.py:164``;
* the port's departures, with the same results: a file reader loads only
  the columns asked for, and an extension field reads as its storage.

Exact throughout: bytes, or values compared as Python values.
"""

import io

import numpy as np
import pyarrow as pa
import pyarrow.ipc as paipc
import pytest

import arrow_tpu as at
from arrow_tpu import ipc as rip
from arrow_tpu.array.array import pylist_equal
from arrow_tpu_torch import ipc
from arrow_tpu_torch import types as T
from arrow_tpu_torch.array.array import array
from arrow_tpu_torch.table import RecordBatch, Table

from test_ipc import SIMPLE_CASES
from test_torch_host_table import carry_table, port_schema
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

CODECS = [None, "lz4", "zstd"]


def _file_bytes(mod, tbl, codec=None, chunk=None):
    buf = io.BytesIO()
    with mod.new_file(buf, tbl.schema, codec=codec) as w:
        w.write_table(tbl, chunk)
    return buf.getvalue()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", range(len(SIMPLE_CASES)))
def test_bytes_equal_the_reference_and_each_reads_the_other(case, codec):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    rt = at.table(SIMPLE_CASES[case])
    pt = carry_table(rt)
    want = rip.serialize_table(rt, codec=codec)
    got = ipc.serialize_table(pt, codec=codec)
    assert got == want
    assert _file_bytes(ipc, pt, codec, 2) == _file_bytes(rip, rt, codec, 2)
    assert pylist_equal(ipc.deserialize_table(want).to_pylist(),
                        rt.to_pylist())
    assert pylist_equal(rip.deserialize_table(got).to_pylist(),
                        rt.to_pylist())
    back = ipc.open_file(_file_bytes(rip, rt, codec, 2))
    assert back.num_record_batches == (2 if rt.num_rows > 2 else 1)
    assert pylist_equal(back.read_all().to_pylist(), rt.to_pylist())
    assert pylist_equal(paipc.open_stream(got).read_all().to_pylist(),
                        rt.to_pylist())


def test_file_format_read_by_pyarrow_and_back():
    rt = at.table({"x": [1, None, 3], "y": ["a", "b", None]})
    data = _file_bytes(ipc, carry_table(rt), chunk=2)
    fr = ipc.open_file(data)
    assert fr.num_record_batches == 2
    assert fr.get_batch(1).to_pydict() == {"x": [3], "y": [None]}
    assert fr.read_all().to_pydict() == rt.to_pydict()
    pf = paipc.open_file(pa.BufferReader(data))
    assert pf.read_all().to_pylist() == rt.to_pylist()


def test_pyarrow_files_and_streams():
    pa_tbl = pa.table({"x": [1, 2, None], "d": pa.array(
        ["u", "v", "u"]).dictionary_encode(), "s": ["a", None, "ccc"]})
    sink = pa.BufferOutputStream()
    with paipc.new_file(sink, pa_tbl.schema) as w:
        w.write_table(pa_tbl)
    assert ipc.open_file(sink.getvalue().to_pybytes()).read_all() \
        .to_pylist() == pa_tbl.to_pylist()
    for codec in ("lz4", "zstd"):
        sink = pa.BufferOutputStream()
        with paipc.new_stream(sink, pa_tbl.schema, options=paipc
                              .IpcWriteOptions(compression=codec)) as w:
            w.write_table(pa_tbl)
        assert ipc.deserialize_table(sink.getvalue().to_pybytes()) \
            .to_pylist() == pa_tbl.to_pylist()


def test_compressed_streams_both_ways():
    pytest.importorskip("zstandard")
    rt = at.table({"x": list(range(10000))})
    pt = carry_table(rt)
    for codec in ("zstd", "lz4"):
        data = ipc.serialize_table(pt, codec=codec)
        assert len(data) < len(ipc.serialize_table(pt))
        assert data == rip.serialize_table(rt, codec=codec)
        assert paipc.open_stream(data).read_all().to_pylist() == \
            rt.to_pylist()


def test_sliced_arrays_serialize_rebased():
    ra = at.array([1, 2, None, 4, 5]).slice(1, 3)
    rt = at.Table.from_batches([at.RecordBatch.from_arrays([ra], ["x"])])
    pt = carry_table(rt)
    assert pt.column("x").chunks[0].offset == 1
    data = ipc.serialize_table(pt)
    assert data == rip.serialize_table(rt)
    assert ipc.deserialize_table(data).column("x").to_pylist() == \
        [2, None, 4]
    s = array(["a", "bb", None, "dddd"]).slice(1, 2)
    tbl = Table.from_batches([RecordBatch.from_arrays([s], ["s"])])
    assert paipc.open_stream(ipc.serialize_table(tbl)).read_all() \
        .column("s").to_pylist() == ["bb", None]


def test_schema_and_field_metadata():
    rs = at.schema([at.field("x", at.int64(), metadata={"k": "v"})],
                   metadata={"tbl": "meta"})
    rt = at.Table.from_batches([at.RecordBatch(rs, [at.array([1, 2])])],
                               schema=rs)
    ps = T.Schema([T.Field("x", T.int64(), metadata={"k": "v"})],
                  metadata={"tbl": "meta"})
    pt = Table.from_batches([RecordBatch(ps, [array([1, 2])])], ps)
    data = ipc.serialize_table(pt)
    assert data == rip.serialize_table(rt)
    back = ipc.open_stream(data)
    assert back.schema.metadata == {b"tbl": b"meta"}
    assert back.schema.fields[0].metadata == {b"k": b"v"}
    assert paipc.open_stream(data).read_all().schema.metadata == \
        {b"tbl": b"meta"}


def test_several_batches_over_one_dictionary():
    rt = at.dictionary(at.int32(), at.string())
    rbs = [at.RecordBatch.from_arrays([at.array(["x", "y"], rt)], ["d"])
           for _ in range(2)]
    pbs = [RecordBatch(port_schema(b.schema), carry_table(b).columns[0]
                       .chunks) for b in rbs]
    bufs = []
    for mod, batches in ((ipc, pbs), (rip, rbs)):
        buf = io.BytesIO()
        with mod.new_stream(buf, batches[0].schema) as w:
            for b in batches:
                w.write_batch(b)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    msgs = [m.header_type for m in ipc.MessageReader(bufs[0])]
    assert msgs == [1, 2, 3, 3]  # the dictionary written once
    batches = list(ipc.open_stream(bufs[0]))
    assert len(batches) == 2
    assert batches[1].column("d").to_pylist() == ["x", "y"]


def test_intervals():
    rt = at.table(
        {"mi": at.array([(1, 2, 3), None], at.month_day_nano_interval()),
         "dt": at.array([(5, 250), None], at.day_time_interval()),
         "m": at.array([7, None], at.month_interval())})
    pt = carry_table(rt)
    data = ipc.serialize_table(pt)
    assert data == rip.serialize_table(rt)
    assert rip.deserialize_table(data).to_pydict() == rt.to_pydict()
    back = ipc.deserialize_table(data)
    for name in ("mi", "dt", "m"):
        assert back.column(name).combine().data.buffers[1].to_pybytes() \
            == pt.column(name).combine().data.buffers[1].to_pybytes()
    src = pa.table({"mi": pa.array([(9, 8, 7)],
                                   pa.month_day_nano_interval())})
    b2 = io.BytesIO()
    with pa.ipc.new_stream(b2, src.schema) as w:
        w.write_table(src)
    got = ipc.open_stream(b2.getvalue()).read_all()
    assert got.column("mi").type == T.month_day_nano_interval()
    assert rip.deserialize_table(ipc.serialize_table(got)).to_pydict() == \
        {"mi": [(9, 8, 7)]}


def test_compat_classes():
    rt = at.table({"a": [1, 2, None], "s": ["x", None, "z"]})
    pt = carry_table(rt)
    raw = ipc.serialize_table(pt)
    msgs = list(ipc.MessageReader(raw))
    assert [m.header_type for m in msgs] == \
        [m.header_type for m in rip.MessageReader(raw)] == [1, 3]
    sch = ipc.read_schema(raw)
    assert sch.names == ["a", "s"]
    assert ipc.read_record_batch(msgs[1], sch).to_pydict() == rt.to_pydict()
    assert ipc.read_message(raw).header_type == 1
    t = carry_table(at.table({"a": list(range(100))}))
    rbt = at.table({"a": list(range(100))})
    assert ipc.get_record_batch_size(t.to_batches()[0]) == \
        rip.get_record_batch_size(rbt.to_batches()[0])
    assert ipc.IpcWriteOptions(compression="zstd").compression == "zstd"
    assert ipc.IpcReadOptions().use_threads
    assert ipc.MetadataVersion.V5 == 5
    assert ipc.ReadStats().num_messages == ipc.WriteStats().num_messages == 0
    for name in ("read_tensor", "write_tensor", "serialize_pandas",
                 "deserialize_pandas"):
        with pytest.raises(NotImplementedError, match="item 13.2"):
            getattr(ipc, name)(None)


def test_random_differential():
    rng = np.random.default_rng(42)
    n = 1000
    mask = rng.random(n) < 0.2
    ints = rng.integers(-1000, 1000, n)
    floats = rng.normal(size=n)
    rt = at.table({
        "i": [None if m else int(v) for m, v in zip(mask, ints)],
        "f": [None if m else float(v) for m, v in zip(mask, floats)],
        "s": [None if m else f"s{v}" for m, v in zip(mask, ints)],
    })
    pt = carry_table(rt)
    for codec in (None, "lz4"):
        data = ipc.serialize_table(pt, codec=codec)
        assert data == rip.serialize_table(rt, codec=codec)
        assert paipc.open_stream(data).read_all().to_pylist() == \
            rt.to_pylist()
    sink = pa.BufferOutputStream()
    pa_tbl = paipc.open_stream(data).read_all()
    with paipc.new_stream(sink, pa_tbl.schema) as w:
        w.write_table(pa_tbl)
    assert ipc.deserialize_table(sink.getvalue().to_pybytes()).to_pylist() \
        == rt.to_pylist()


def test_a_file_reader_loads_only_the_columns_asked_for():
    rt = at.table({"a": [1, 2, None, 4], "s": ["x", None, "z", "w"],
                   "d": at.array(["p", "q", "p", None],
                                 at.dictionary(at.int32(), at.string())),
                   "l": at.array([[1], None, [], [2, 3]],
                                 at.list_(at.int64()))})
    for codec in (None, "lz4"):
        data = _file_bytes(rip, rt, codec, 3)
        fr = ipc.open_file(data)
        for cols in (["d"], ["l", "a"], ["s", "d", "a"]):
            got = fr.read_all(cols)
            assert got.schema.names == cols
            assert got.to_pydict() == rt.select(cols).to_pydict()
        with pytest.raises(KeyError):
            fr.read_all(["nope"])


def test_an_extension_field_reads_as_its_storage():
    """The port has no extension types: a field of one reads as its
    storage type, the extension keys dropped, as the reference reads a
    name it has not registered."""
    storage = pa.array([b"0123456789abcdef", None], pa.binary(16))
    ext = pa.ExtensionArray.from_storage(pa.uuid(), storage)
    sink = pa.BufferOutputStream()
    tbl = pa.table({"u": ext})
    with paipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    got = ipc.deserialize_table(sink.getvalue().to_pybytes())
    f = got.schema.field("u")
    assert f.type == T.fixed_size_binary(16) and not f.metadata
    assert got.column("u").to_pylist() == storage.to_pylist()


def test_a_union_field_raises():
    tbl = pa.table({"u": pa.UnionArray.from_sparse(
        pa.array([0, 1], pa.int8()), [pa.array([1, 2]),
                                      pa.array(["a", "b"])])})
    sink = pa.BufferOutputStream()
    with paipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    with pytest.raises(NotImplementedError, match="union"):
        ipc.deserialize_table(sink.getvalue().to_pybytes())


def test_the_flatbuffer_builder_is_the_runtimes():
    """The port's Builder against the ``flatbuffers`` runtime on the same
    objects: strings, a vector of offsets, shared vtables, scalars at and
    off their defaults, growth from a small buffer."""
    import flatbuffers
    from arrow_tpu_torch.ipc import fb as pfb
    words = ["", "a", "hello", "12345678", "x" * 33]
    rb, pb = flatbuffers.Builder(16), pfb.Builder(16)
    r_offs, p_offs = [], []
    for i, w in enumerate(words):
        rs, ps = rb.CreateString(w), pb.create_string(w)
        rb.StartObject(3)
        rb.PrependInt64Slot(2, i * 7, 0)
        rb.PrependUOffsetTRelativeSlot(1, rs, 0)
        rb.PrependInt16Slot(0, i % 2, 1)
        r_offs.append(rb.EndObject())
        p_offs.append(pfb._table(pb, 3, [(2, "i64", i * 7, 0),
                                         (1, "off", ps, 0),
                                         (0, "i16", i % 2, 1)]))
    rb.StartVector(4, len(r_offs), 4)
    for o in reversed(r_offs):
        rb.PrependUOffsetTRelative(o)
    rb.Finish(rb.EndVector())
    assert pb.finish(pfb._offset_vector(pb, p_offs)) == bytes(rb.Output())
