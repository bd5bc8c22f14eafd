"""Extension types of the port (``arrow_tpu_torch/extension.py``) and
pyarrow's per-type names (``compat_names.py``) against the JAX package's
(``arrow_tpu/extension.py``, ``compat_names.py``), the cases of
``tests/test_interchange_extensions.py`` and more.

* the six built-ins: names, storage types, metadata bytes, equality,
  ``deserialize`` and the registry (``reconstruct`` of a registered and
  an unregistered name);
* ``ExtensionArray.from_storage`` and ``FixedShapeTensorArray``'s numpy
  conversions;
* IPC: a schema and a batch with extension columns byte for byte the
  reference's, read back rebuilt by both packages where the name is
  registered and as the storage type where it is not; pyarrow reads the
  bytes as its own extension types;
* the casts through the storage type (``compute/cast_host.py``);
* ``compat_names``: every name the reference exports, its ``isinstance``
  answers over every type, and the misc functions.
"""

import io

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import compat_names as rcn
from arrow_tpu import extension as rx
from arrow_tpu import ipc as rip
from arrow_tpu_torch import compat_names as pcn
from arrow_tpu_torch import extension as px
from arrow_tpu_torch import ipc as pip

from test_torch_host_table import port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def _exts(X, P):
    return {
        "uuid": X.uuid(), "bool8": X.bool8(), "json": X.json_(),
        "json large": X.json_(P.large_string()),
        "opaque": X.opaque(P.binary(), "geometry", "postgis"),
        "fst": X.fixed_shape_tensor(P.float32(), [2, 3]),
        "fst named": X.fixed_shape_tensor(P.int64(), [2, 2], ["r", "c"],
                                          [1, 0]),
        "vst": X.variable_shape_tensor(P.float32(), 2, uniform_shape=[None, 3]),
    }


@pytest.mark.parametrize("name", sorted(_exts(rx, at)))
def test_the_built_ins_are_the_references(name):
    r, p = _exts(rx, at)[name], _exts(px, att)[name]
    assert p.extension_name == r.extension_name
    assert p.extension_metadata() == r.extension_metadata()
    assert p.storage_type == port_type(r.storage_type)
    assert p == _exts(px, att)[name] and hash(p) == hash(
        _exts(px, att)[name])
    assert p != p.storage_type
    assert int(p.id) == int(r.id) == 31
    back = px.reconstruct(p.storage_type, p.extension_name,
                          p.extension_metadata())
    assert back == p and type(back) is type(p)
    for attr in ("shape", "dim_names", "permutation", "ndim",
                 "uniform_shape", "type_name", "vendor_name"):
        assert getattr(p, attr, None) == getattr(r, attr, None), attr


def test_the_registry():
    class Rational(px.ExtensionType):
        EXTENSION_NAME = "example.rational"

        def __init__(self):
            super().__init__(att.struct([("n", att.int64()),
                                         ("d", att.int64())]),
                             self.EXTENSION_NAME)

        @classmethod
        def deserialize(cls, storage_type, metadata):
            return cls()
    storage = Rational().storage_type
    assert px.reconstruct(storage, "example.rational", b"") == storage
    px.register_extension_type(Rational)
    try:
        assert px.lookup_extension_type("example.rational") is Rational
        assert isinstance(px.reconstruct(storage, "example.rational", b""),
                          Rational)
    finally:
        px.unregister_extension_type("example.rational")
    assert px.lookup_extension_type("example.rational") is None
    with pytest.raises(ValueError):
        px.register_extension_type(type("NoName", (px.ExtensionType,), {}))
    for X in (rx, px):
        assert X.lookup_extension_type("arrow.uuid") is X.UuidType


def test_extension_array_from_storage():
    fst = px.fixed_shape_tensor(att.float32(), [2])
    storage = att.array([[1.0, 2.0], [3.0, 4.0]],
                        att.fixed_size_list(att.float32(), 2))
    ea = px.ExtensionArray.from_storage(fst, storage)
    assert isinstance(ea, px.FixedShapeTensorArray)
    assert len(ea) == 2 and ea.null_count == 0
    assert ea.to_pylist() == [[1.0, 2.0], [3.0, 4.0]]
    with pytest.raises(TypeError):
        px.ExtensionArray.from_storage(fst, att.array([1.0], att.float64()))
    plain = px.ExtensionArray.from_storage(
        px.uuid(), att.array([b"0123456789abcdef"], att.fixed_size_binary(16)))
    assert type(plain) is px.ExtensionArray
    assert "arrow.uuid" in repr(plain)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int8", "uint64"])
def test_fixed_shape_tensor_array_numpy(dtype):
    arr = np.arange(24).astype(dtype).reshape(2, 3, 4)
    got = px.FixedShapeTensorArray.from_numpy_ndarray(arr)
    want = rx.FixedShapeTensorArray.from_numpy_ndarray(arr)
    assert got.type.shape == want.type.shape == [3, 4]
    assert got.to_pylist() == want.to_pylist()
    assert np.array_equal(got.to_numpy_ndarray(), arr)
    assert got.to_numpy_ndarray().dtype == want.to_numpy_ndarray().dtype
    with pytest.raises(ValueError):
        px.FixedShapeTensorArray.from_numpy_ndarray(np.arange(3))


def _ext_batch(P, X):
    fst = X.fixed_shape_tensor(P.float64(), [2])
    uuid = P.array([b"0123456789abcdef", None, b"fedcba9876543210"],
                   P.fixed_size_binary(16))
    tens = P.array([[1.0, 2.0], [3.0, 4.0], None],
                   P.fixed_size_list(P.float64(), 2))
    b8 = P.array([1, 0, None], P.int8())
    js = P.array(['{"a": 1}', None, "[]"], P.string())
    cols = [P.Array(P.ArrayData(t, 3, a.data.buffers, a.data.children))
            for t, a in ((X.uuid(), uuid), (fst, tens), (X.bool8(), b8),
                         (X.json_(), js))]
    schema = P.schema([P.field(n, c.type) for n, c in
                       zip(["u", "t", "b", "j"], cols)])
    return P.RecordBatch(schema, cols)


def test_extension_columns_in_ipc_are_the_references():
    bufs = []
    for P, X, I in ((at, rx, rip), (att, px, pip)):
        rb = _ext_batch(P, X)
        sink = io.BytesIO()
        with I.new_stream(sink, rb.schema) as w:
            w.write_batch(rb)
        bufs.append(sink.getvalue())
    assert bufs[0] == bufs[1]
    got = pip.deserialize_table(bufs[0])
    want = rip.deserialize_table(bufs[0])
    for f, rf in zip(got.schema, want.schema):
        assert isinstance(f.type, px.ExtensionType)
        assert f.type.extension_name == rf.type.extension_name
        assert not f.metadata
    assert got.to_pydict() == want.to_pydict()
    theirs = pa.ipc.open_stream(bufs[1]).read_all()
    assert "fixed_shape_tensor" in str(theirs.schema.field("t").type)
    assert theirs.column("u").type == pa.uuid()
    assert theirs.column("t").combine_chunks().storage.to_pylist() == \
        [[1.0, 2.0], [3.0, 4.0], None]


def test_an_unregistered_name_reads_as_its_storage():
    sink = io.BytesIO()
    rb = _ext_batch(att, px)
    with pip.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    for name in ("arrow.uuid", "arrow.bool8"):
        px.unregister_extension_type(name)
    try:
        got = pip.deserialize_table(sink.getvalue())
    finally:
        px.register_extension_type(px.UuidType)
        px.register_extension_type(px.Bool8Type)
    assert got.schema.field("u").type == att.fixed_size_binary(16)
    assert got.schema.field("b").type == att.int8()
    assert isinstance(got.schema.field("t").type, px.FixedShapeTensorType)
    assert not got.schema.field("u").metadata
    assert got.column("b").to_pylist() == [1, 0, None]


def test_extension_columns_in_an_ipc_file_with_a_column_subset(tmp_path):
    rb = _ext_batch(att, px)
    path = str(tmp_path / "e.arrow")
    with open(path, "wb") as f, pip.new_file(f, rb.schema) as w:
        w.write_batch(rb)
        w.write_batch(rb)
    got = pip.open_file(att.memory_map(path)).read_all(["t", "j"])
    assert got.column_names == ["t", "j"]
    assert got.column("j").to_pylist() == ['{"a": 1}', None, "[]"] * 2


@pytest.mark.parametrize("case", ["to storage", "from storage", "bool8 up",
                                  "storage widened"])
def test_casts_through_the_storage_are_the_references(case):
    def run(P, X, pc, **dev):
        b8 = P.Array(P.ArrayData(X.bool8(), 3, P.array(
            [1, 0, None], P.int8()).data.buffers))
        ints = P.array([1, 0, None], P.int8())
        if case == "to storage":
            return pc.cast(b8, P.int8(), **dev)
        if case == "from storage":
            return pc.cast(ints, X.bool8(), **dev)
        if case == "bool8 up":
            return pc.cast(b8, P.int64(), **dev)
        return pc.cast(P.array([1, 2], P.int64()), X.bool8(), **dev)
    import arrow_tpu.compute as rpc
    import arrow_tpu_torch.compute as ppc
    want = run(at, rx, rpc)
    got = run(att, px, ppc, device="cpu")
    assert repr(got.type) == repr(want.type).replace("arrow_tpu", "")
    assert got.to_pylist() == want.to_pylist()


# --- compat_names -----------------------------------------------------------------

def test_every_compat_name_is_the_ports():
    assert set(rcn.__all__) == set(pcn.__all__)
    for name in rcn.__all__:
        assert hasattr(att, name), name


def _values(P):
    fs = [P.field("a", P.int8())]
    vals = [P.array([1], P.int8()), P.array([1.5]), P.array(["x"]),
            P.array([b"y"]), P.array([True]), P.array([1], P.uint64()),
            P.array([[1]]), P.array([{"a": 1}]), P.array([None]),
            P.array([1], P.date32()), P.array([1], P.timestamp("ms")),
            P.array(["u"], P.dictionary(P.int32(), P.string())),
            P.array([1], P.decimal128(5, 2)),
            P.array(["x"], P.string_view())]
    types = [P.int8(), P.float64(), P.decimal32(4, 1), P.decimal64(9, 2),
             P.decimal128(20, 2), P.decimal256(40, 2), P.sparse_union(fs),
             P.dense_union(fs), P.list_view(P.int8()), P.large_list(P.int8()),
             P.large_list_view(P.int8()), P.time32("s"), P.time64("us")]
    return vals, types


@pytest.mark.parametrize("name", sorted(n for n in rcn.__all__
                                        if n.endswith(("Array", "Type"))
                                        and n not in ("BaseExtensionType",
                                                      "UnknownExtensionType")))
def test_compat_isinstance_is_the_references(name):
    rv, rt = _values(at)
    pv, ptypes = _values(att)
    rcls, pcls = getattr(rcn, name), getattr(pcn, name)
    for r, p in zip(rv + rt, pv + ptypes):
        assert isinstance(p, pcls) is isinstance(r, rcls), (name, r)


def test_compat_scalars_and_misc():
    assert isinstance(att.scalar(5), pcn.Int64Scalar)
    assert not isinstance(att.scalar("x"), pcn.Int64Scalar)
    assert isinstance(att.scalar(1.5), pcn.FloatingPointScalar)
    assert att.union([att.field("a", att.int8())], "dense").mode == "dense"
    assert att.union([att.field("a", att.int8())]).mode == "sparse"
    for P in (at, att):
        assert P.arange(5).to_pylist() == [0, 1, 2, 3, 4]
        assert P.arange(2, 8, 3, type=P.int32()).to_pylist() == [2, 5]
    m = att.MonthDayNano((1, 2, 3))
    assert m == (1, 2, 3) and list(m) == [1, 2, 3]
    assert repr(m) == repr(at.MonthDayNano((1, 2, 3)))
    kv = att.KeyValueMetadata({"a": "b"}, c=b"d")
    assert kv == at.KeyValueMetadata({"a": "b"}, c=b"d")
    assert (kv.key(0), kv.value(1)) == (b"a", b"d")
    assert att.DictionaryMemo()._dicts == {}
    u = att.UnknownExtensionType(att.int8(), b"xyz")
    assert u.extension_metadata() == b"xyz" and \
        u.extension_name == "arrow.unknown"
    assert att.BaseExtensionType is px.ExtensionType
    assert att.have_libhdfs() is at.have_libhdfs() is False
    assert att.is_opentelemetry_enabled() is False
    assert att.get_libraries() == att.get_library_dirs() == []
    assert att.get_include().endswith("csrc")
    with pytest.raises(NotImplementedError):
        att.jemalloc_set_decay_ms(0)
