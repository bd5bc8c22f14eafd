"""The port's top level (``arrow_tpu_torch/__init__.py``, ``api.py``,
``types.py``'s factories, ``memory.py``'s pools) against the JAX
package's.

* ``api.py``'s functions: ``scalar``, ``nulls``, ``repeat``,
  ``infer_type``, ``concat_arrays``, ``concat_batches``, ``concat_tables``
  (with ``promote_options``), ``unify_schemas``, ``type_for_alias``,
  ``show_versions``; the pandas pair's bytes and frames equal to the
  reference's.
* The type factories the port added (``field``, ``schema``, ``utf8``,
  the views, the unions, ``DictionaryType``) as type objects equal to the
  reference's; an Array of a view built as the reference builds it, one
  of a union refused as the reference refuses it.
* The memory pools, the thread counts and the other top-level names.
* The README's first example (``README.md:10-30``, the lines that need no
  pyarrow) on the port with ``device="cpu"``, equal to the reference's.
* The reference's top-level names that the port still lacks, pinned by
  the later part of ROADMAP item 13.2 that each waits for (part 4's
  ``flight`` alone).
"""

import contextlib
import io
import types

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu_torch.array.array import pylist_equal

from test_torch_host_table import port_schema, port_type
from test_torch_table_methods import builtin_class, same
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


# --- api.py ------------------------------------------------------------------------

@pytest.mark.parametrize("value,tname", [
    (5, None), (2.5, None), ("x", None), (None, None), (True, None),
    (3, "int8"), (7, "float32"), ("déjà", "large_string"), (None, "int64"),
])
def test_scalar(value, tname):
    want = at.scalar(value, None if tname is None else getattr(at, tname)())
    got = att.scalar(value, None if tname is None else getattr(att, tname)())
    assert pylist_equal(got.as_py(), want.as_py())
    assert got.type == port_type(want.type)
    assert got.is_valid == want.is_valid


def test_scalar_refuses_a_wrong_value():
    with pytest.raises(Exception) as want:
        at.scalar("x", at.int64())
    with pytest.raises(builtin_class(want.value)):
        att.scalar("x", att.int64())


@pytest.mark.parametrize("size,tname", [(0, None), (3, None), (4, "int32"),
                                        (2, "string"), (5, "float64")])
def test_nulls(size, tname):
    same(att.nulls(size, None if tname is None else getattr(att, tname)()),
         at.nulls(size, None if tname is None else getattr(at, tname)()))


@pytest.mark.parametrize("value", [1, 2.5, "ab", None, [1, 2]])
def test_repeat(value):
    same(att.repeat(value, 4), at.repeat(value, 4))
    same(att.repeat(att.scalar(value), 3), at.repeat(at.scalar(value), 3))


@pytest.mark.parametrize("values", [[1, 2], [1.0, None], ["a"], [None],
                                    [True, False], [[1], None], [b"x"],
                                    [{"a": 1}]])
def test_infer_type(values):
    assert att.infer_type(values) == port_type(at.infer_type(values))


def _arrays(P):
    rng = np.random.default_rng(2)
    a = P.array(rng.integers(0, 9, 12).tolist(), P.int64())
    d = P.array(["x", "y", None, "x"], P.dictionary(P.int32(), P.string()))
    d2 = P.array(["z", "x"], P.dictionary(P.int32(), P.string()))
    return a, d, d2


# the reference's dictionary of the chunks of one dictionary: the values
# the rows use, in order of first use
REFERENCE_DICTIONARY = {"one_dictionary_slices": ["y", "x"],
                        "one_dictionary_twice": ["x", "y"],
                        "one_dictionary_chunked": ["x", "y"]}


@pytest.mark.parametrize("case", ["ints", "sliced", "one", "dictionaries",
                                  "empty", "types_differ"]
                         + sorted(REFERENCE_DICTIONARY))
def test_concat_arrays(case):
    """The port's concatenation is the reference's, value for value. Chunks
    of one dictionary keep that dictionary in the port (a departure, as
    Arrow's Concatenate), where the reference rebuilds it."""
    def call(P):
        a, d, d2 = _arrays(P)
        return {"ints": lambda: P.concat_arrays([a, a]),
                "sliced": lambda: P.concat_arrays([a.slice(3, 4),
                                                   a.slice(9)]),
                "one": lambda: P.concat_arrays([a]),
                "dictionaries": lambda: P.concat_arrays([d, d2]),
                "empty": lambda: P.concat_arrays([]),
                "types_differ": lambda: P.concat_arrays(
                    [a, P.array([1], P.int32())]),
                "one_dictionary_slices": lambda: P.concat_arrays(
                    [d.slice(1, 2), d.slice(3)]),
                "one_dictionary_twice": lambda: P.concat_arrays([d, d]),
                "one_dictionary_chunked": lambda: P.chunked_array(
                    [d.slice(2), d, d.slice(1, 1)]).combine()}[case]()
    try:
        want = call(at)
    except Exception as exc:  # noqa: BLE001 - the class is compared
        with pytest.raises(Exception) as got:
            call(att)
        assert type(got.value).__name__ == type(exc).__name__
        return
    got = call(att)
    same(got, want)
    if case in REFERENCE_DICTIONARY:
        assert att.Array(got.data.dictionary).to_pylist() == ["x", "y"]
        assert at.Array(want.data.dictionary).to_pylist() == \
            REFERENCE_DICTIONARY[case]


def _tables(P):
    t1 = P.table({"a": P.array([1, 2], P.int64()),
                  "s": P.array(["x", None], P.string())})
    t2 = P.table({"a": P.array([3], P.int64()),
                  "s": P.array(["y"], P.string())})
    t3 = P.table({"a": P.array([4, 5], P.int64()),
                  "n": P.array([0.5, None], P.float64())})
    t4 = P.table({"s": P.nulls(2), "a": P.array([6, 7], P.int64())})
    t5 = P.table({"a": P.array(["no"], P.string())})
    return t1, t2, t3, t4, t5


@pytest.mark.parametrize("picks,promote", [
    ((0, 1), "none"), ((0, 1, 0), "none"), ((0, 2), "none"),
    ((0, 2), "default"), ((0, 2, 3), "permissive"), ((0, 3), "default"),
    ((0, 4), "default"), ((), "none")])
def test_concat_tables(picks, promote):
    def call(P):
        ts = _tables(P)
        return P.concat_tables([ts[i] for i in picks],
                               promote_options=promote)
    try:
        want = call(at)
    except Exception as exc:  # noqa: BLE001 - the class is compared
        with pytest.raises(Exception) as got:
            call(att)
        assert type(got.value).__name__ == type(exc).__name__
        return
    got = call(att)
    same(got, want)
    assert [c.num_chunks for c in got.columns] == \
        [c.num_chunks for c in want.columns]


def test_concat_batches():
    bs = {P: [t.to_batches()[0] for t in _tables(P)[:2]] for P in (at, att)}
    same(att.concat_batches(bs[att]), at.concat_batches(bs[at]))
    for P in (at, att):
        with pytest.raises(Exception, match="at least one"):
            P.concat_batches([])


@pytest.mark.parametrize("case", ["disjoint", "null_promotes",
                                  "nullable_widens", "conflict", "same"])
def test_unify_schemas(case):
    def call(P):
        a = P.schema([P.field("a", P.int64(), False),
                      P.field("b", P.null())])
        b = {"disjoint": P.schema([("c", P.string())]),
             "null_promotes": P.schema([("b", P.float32())]),
             "nullable_widens": P.schema([P.field("a", P.int64())]),
             "conflict": P.schema([("a", P.string())]),
             "same": a}[case]
        return P.unify_schemas([a, b])
    try:
        want = call(at)
    except Exception as exc:  # noqa: BLE001 - the class is compared
        with pytest.raises(Exception) as got:
            call(att)
        assert type(got.value).__name__ == type(exc).__name__
        return
    got = call(att)
    assert got == port_schema(want)
    assert [f.nullable for f in got] == [f.nullable for f in want]


@pytest.mark.parametrize("alias", ["i4", "double", "utf8", "large_str",
                                   "timestamp[ms]", "date32[day]", "null"])
def test_type_for_alias(alias):
    assert att.type_for_alias(alias) == port_type(at.type_for_alias(alias))


def test_show_versions():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        att.show_versions()
    lines = out.getvalue().splitlines()
    assert lines[0] == "arrow_tpu_torch build info:"
    assert "  version: 0.1.0" in lines and "runtime info:" in lines
    assert att.show_info is att.show_versions


@pytest.mark.parametrize("name", ["serialize_pandas", "deserialize_pandas"])
def test_the_pandas_pair_waits_for_part_2(name):
    """Part 2 ported the pair: the reference's bytes and frames."""
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"i": [1, 2, 3], "f": [0.5, None, 2.0],
                       "s": ["x", "y", "zz"]})
    if name == "serialize_pandas":
        assert att.serialize_pandas(df) == at.serialize_pandas(df)
    else:
        blob = at.serialize_pandas(df)
        pd.testing.assert_frame_equal(att.deserialize_pandas(blob),
                                      at.deserialize_pandas(blob))


# --- types ------------------------------------------------------------------------

def _type_cases(P):
    f = P.field("x", P.int32(), False, {"k": "v"})
    return {
        "field": f, "field_with_name": f.with_name("y"),
        "field_with_type": f.with_type(P.string()),
        "field_with_nullable": f.with_nullable(True),
        "field_without_metadata": f.remove_metadata(),
        "schema_pairs": P.schema([("a", P.int8()), ("b", P.utf8())]),
        "schema_dict": P.schema({"a": P.large_utf8()}, {"m": "1"}),
        "schema_of_schema": P.schema(P.schema([f])),
        "utf8": P.utf8(), "large_utf8": P.large_utf8(),
        "dictionary_ordered": P.dictionary(P.int16(), P.string(), True),
        "struct_dict": P.struct({"p": P.int8(), "q": P.bool_()}),
    }


@pytest.mark.parametrize("case", sorted(_type_cases(at)))
def test_type_factories(case):
    want, got = _type_cases(at)[case], _type_cases(att)[case]
    if isinstance(want, at.Schema):
        assert got.metadata == want.metadata
        got, want = got.fields, want.fields
    else:
        got, want = [got], [want]
    for g, w in zip(got, want, strict=True):
        if isinstance(w, at.Field):
            assert (g.name, g.nullable, g.metadata) == \
                (w.name, w.nullable, w.metadata)
            g, w = g.type, w.type
        if w.id == at.TypeId.DICTIONARY:
            assert (g.index_type, g.value_type) == \
                (port_type(w.index_type), port_type(w.value_type))
        else:
            assert g == port_type(w)
        assert getattr(g, "ordered", False) == getattr(w, "ordered", False)


def _views_and_unions(P):
    fs = [P.field("a", P.int8()), P.field("b", P.string())]
    return {"string_view": P.string_view(), "binary_view": P.binary_view(),
            "list_view": P.list_view(P.int64()),
            "large_list_view": P.large_list_view(P.field("v", P.int8())),
            "sparse_union": P.sparse_union(fs),
            "dense_union": P.dense_union(fs, [5, 7])}


@pytest.mark.parametrize("case", sorted(_views_and_unions(at)))
def test_view_and_union_types(case):
    want, got = _views_and_unions(at)[case], _views_and_unions(att)[case]
    assert int(got.id) == int(want.id) and repr(got) == repr(want)
    assert got == _views_and_unions(att)[case]
    assert [(f.name, f.nullable) for f in got.fields] == \
        [(f.name, f.nullable) for f in want.fields]
    if "union" in case:
        assert (got.mode, got.type_codes) == (want.mode, want.type_codes)
        assert isinstance(got, att.UnionType)
    # part 3 gave the views a host layout; a union is built from buffers,
    # and from a sequence refused, as in the reference
    try:
        ref = at.array([None], want)
    except NotImplementedError:
        with pytest.raises(NotImplementedError, match="construction for"):
            att.array([None], got)
    else:
        assert att.array([None], got).to_pylist() == ref.to_pylist()


def test_schema_edits():
    want = at.schema([("a", at.int8()), ("b", at.int16()), ("a", at.int32())])
    got = att.schema([("a", att.int8()), ("b", att.int16()),
                      ("a", att.int32())])
    assert got.get_all_field_indices("a") == want.get_all_field_indices("a")
    assert got.field_by_name("b").type == att.int16()
    assert got.field_by_name("zz") is None is want.field_by_name("zz")
    assert got.insert(1, att.field("z", att.bool_())) == port_schema(
        want.insert(1, at.field("z", at.bool_())))
    assert got.remove(0) == port_schema(want.remove(0))
    assert got.set(1, att.field("q", att.utf8())) == port_schema(
        want.set(1, at.field("q", at.utf8())))
    assert got.with_metadata({"x": "y"}).metadata == \
        want.with_metadata({"x": "y"}).metadata
    assert got.with_metadata({"x": "y"}).remove_metadata().metadata is None
    empty = got.empty_table()
    assert (empty.num_rows, empty.column_names) == (0, ["a", "b", "a"])
    assert att.field("s", att.struct([("p", att.int8())])).flatten()[0] == \
        att.field("s.p", att.int8())


# --- memory, threads and the other names -----------------------------------------

def test_memory_pools():
    for P in (at, att):
        assert P.supported_memory_backends() == ["system"]
        assert P.system_memory_pool() is P.default_memory_pool()
        assert P.total_allocated_bytes() >= 0
        for make in (P.ProxyMemoryPool, P.proxy_memory_pool,
                     P.logging_memory_pool):
            pool = make(P.default_memory_pool())
            assert isinstance(pool, P.MemoryPool)
        for name in ("jemalloc_memory_pool", "mimalloc_memory_pool"):
            with pytest.raises(NotImplementedError):
                getattr(P, name)()
    parent = att.MemoryPool()
    proxy = att.ProxyMemoryPool(parent)
    buf = proxy.allocate(100)
    assert proxy.bytes_allocated() == parent.bytes_allocated() == 100
    assert proxy.backend_name == "proxy[system]"
    del buf
    import gc
    gc.collect()
    assert proxy.bytes_allocated() == parent.bytes_allocated() == 0
    capped = att.CappedMemoryPool(64, parent)
    keep = capped.allocate(60)
    with pytest.raises(MemoryError):
        capped.allocate(8)
    del keep
    sink = io.StringIO()
    logging = att.LoggingMemoryPool(parent, sink)
    b = logging.allocate(7)
    del b
    gc.collect()
    assert sink.getvalue() == "Allocate: size = 7\nFree: size = 7\n"
    was = att.default_memory_pool()
    att.log_memory_allocations(True)
    assert isinstance(att.default_memory_pool(), att.LoggingMemoryPool)
    att.log_memory_allocations(False)
    assert att.default_memory_pool() is was
    att.set_memory_pool(proxy)
    try:
        assert att.default_memory_pool() is proxy
    finally:
        att.set_memory_pool(was)


def test_thread_counts_and_versions():
    for P in (at, att):
        assert P.cpu_count() >= 1 and P.io_thread_count() >= 1
        with pytest.raises(ValueError):
            P.set_cpu_count(0)
        with pytest.raises(ValueError):
            P.set_io_thread_count(0)
    before = att.io_thread_count()
    att.set_io_thread_count(3)
    assert att.io_thread_count() == 3
    att.set_io_thread_count(before)
    assert att.cpp_version() == at.cpp_version() == "0.1.0"
    assert att.cpp_version_info() == at.cpp_version_info()
    assert att.cpp_build_info().version == att.build_info().version
    assert att.VersionInfo is tuple and att.CppBuildInfo is att.BuildInfo
    assert att.runtime_info().backend == "cpu"
    assert att.__version__ == at.__version__


def test_other_top_level_names():
    assert att.NA is att.NULL and att.NA.as_py() is None
    assert att.NA.type == att.null()
    assert att.lib is att and att.util.__name__ == "arrow_tpu_torch.utils"
    assert att.DeviceAllocationType.CPU == at.DeviceAllocationType.CPU == 1
    opts = att.CacheOptions.from_network_metrics(5, 100)
    want = at.CacheOptions.from_network_metrics(5, 100)
    assert vars(opts) == vars(want)
    assert att.Buffer(b"ab").to_pybytes() == b"ab"
    assert att.allocate_buffer(3).size == 3
    assert att.as_buffer(b"xyz").size == 3
    data = att.array([1, None]).data
    assert isinstance(data, att.ArrayData)
    assert att.builder_for(att.int8()).type == att.int8()
    tg = att.table({"k": [1, 1, 2]}).group_by("k")
    assert isinstance(tg, att.TableGroupBy)
    for name in ("pretty", "compare", "io", "memory", "config", "device",
                 "parallel"):
        assert isinstance(getattr(att, name), types.ModuleType), name


# --- the README's first example -------------------------------------------------------

def _readme(P, dev):
    import importlib
    pc = importlib.import_module(P.__name__ + ".compute")
    acero = importlib.import_module(P.__name__ + ".acero")
    ipc = importlib.import_module(P.__name__ + ".ipc")
    field, Declaration = acero.field, acero.Declaration
    t = P.table({"k": ["a", "b", "a"], "v": [1.0, 2.0, None]})
    other = P.table({"k": ["a", "c"], "w": [10, 20]})
    return [
        pc.sum(t.column("v"), **dev),
        t.filter(field("v") > 1.0, **dev),
        t.group_by("k").aggregate([("v", "sum")], **dev),
        t.join(other, keys="k", **dev),
        t.sort_by([("v", "descending")], **dev),
        Declaration.from_sequence([
            Declaration("table_source", acero.TableSourceNodeOptions(t)),
            Declaration("filter", acero.FilterNodeOptions(field("v") > 0)),
            Declaration("aggregate", acero.AggregateNodeOptions(
                [("v", "mean", None, "avg")], keys=["k"])),
        ]).to_table(**dev),
        ipc.serialize_table(t),
    ]


def test_readme_first_example():
    want = _readme(at, {})
    got = _readme(att, {"device": "cpu"})
    assert got[0].as_py() == want[0].as_py() == 3.0
    for g, w in zip(got[1:-1], want[1:-1]):
        same(g, w)
    assert bytes(got[-1]) == bytes(want[-1])


# --- what is left --------------------------------------------------------------------

# The reference's top-level names that the port lacks, by the later part of
# ROADMAP.md item 13.2 that each waits for: none, since part 4 (flight)
# ported the last.
LATER = {}
# the reference's lazily imported modules, its __getattr__'s names
REFERENCE_LAZY = ("acero", "dataset", "fs", "flight", "parallel", "tensor",
                  "c_data", "gandiva", "device", "pretty", "substrait",
                  "config", "orc", "compare", "interchange")


def test_only_the_later_parts_of_item_13_2_are_left():
    from arrow_tpu import compat_names
    names = {n for n in dir(at) if not n.startswith("_")
             and not isinstance(getattr(at, n), types.ModuleType)}
    names |= set(REFERENCE_LAZY) | {"compute", "ipc", "util", "lib",
                                    "memory", "config", "io"}
    names |= set(compat_names.__all__)
    missing = {n for n in names if not hasattr(att, n)}
    pinned = set().union(*LATER.values())
    assert missing == pinned & names == set()


@pytest.mark.parametrize("cls,methods", [
    ("Table", {"to_pandas", "from_pandas", "to_tensor",
               "__arrow_c_stream__", "__dataframe__"}),
    ("RecordBatch", {"to_pandas", "from_pandas", "serialize",
                     "__arrow_c_stream__", "__dataframe__"}),
    ("ChunkedArray", {"to_pandas"}),
    ("RecordBatchReader", {"read_pandas", "__arrow_c_stream__"}),
    ("Array", {"to_pandas", "from_pandas", "__arrow_c_array__",
               "__dlpack__", "__dlpack_device__"}),
])
def test_only_the_interop_methods_are_left(cls, methods):
    """Part 2 ported the containers' interop methods: none is left."""
    ref = {n for n in dir(getattr(at, cls))
           if not n.startswith("_") or n in methods}
    port = set(dir(getattr(att, cls)))
    assert methods <= port
    assert ref - port == set()


# --- ROADMAP item 13.3: the submodules' and classes' names -------------------------

# The names of these modules and classes, reference against port. A module's
# public names are its ``__all__``, or else the names it defines, and the
# re-exports that pyarrow's counterpart has too (``REEXPORTS``); the names a
# module imports for its own use do not count. Left out by the port's
# contract: ``put_sharded`` (it places arrays on a TPU mesh); nothing else
# may be missing.
SUBMODULES = ("compute", "types", "config", "acero", "dataset", "api",
              "parallel", "parallel.distributed", "utils.tdigest", "buffer")
REEXPORTS = {"compute": {"Expression", "field", "scalar"},
             "dataset": {"FileSelector", "FileSystem", "LocalFileSystem",
                         "FilterNodeOptions", "TableSourceNodeOptions"},
             "api": {"array_data_from_sequence"}}
LEFT_OUT = {"parallel.distributed": {"put_sharded"}}
CLASSES = {
    "Schema": ("types", set()),
    "DataType": ("types", set()),
    "Field": ("types", set()),
    "Buffer": ("buffer", set()),
    "Scalar": ("compute.registry", set()),
}


def _module(pkg, name):
    import importlib
    return importlib.import_module(f"{pkg}.{name}")


@pytest.mark.parametrize("name", SUBMODULES)
def test_every_public_name_of_the_submodule_resolves(name):
    """Every public name of the reference's module is the port's too, but
    the contract's."""
    ref, port = _module("arrow_tpu", name), _module("arrow_tpu_torch", name)

    def defined_here(n):
        where = getattr(getattr(ref, n), "__module__", None) or ref.__name__
        return where == ref.__name__ or where.startswith(ref.__name__ + ".")

    public = set(ref.__all__) if hasattr(ref, "__all__") else {
        n for n in dir(ref) if not n.startswith("_")
        and not isinstance(getattr(ref, n), types.ModuleType)
        and defined_here(n)}
    public |= REEXPORTS.get(name, set())
    missing = {n for n in public if not hasattr(port, n)}
    assert missing == LEFT_OUT.get(name, set())


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_every_public_attribute_of_the_class_resolves(cls):
    mod, waiting = CLASSES[cls]
    ref = getattr(_module("arrow_tpu", mod), cls)
    port = getattr(_module("arrow_tpu_torch", mod), cls)
    missing = {n for n in dir(ref) if not n.startswith("_")
               and not hasattr(port, n)}
    assert missing == waiting


def _all_types(P):
    fs = [P.field("a", P.int8()), P.field("b", P.string())]
    return [
        P.null(), P.bool_(), P.int8(), P.int16(), P.int32(), P.int64(),
        P.uint8(), P.uint16(), P.uint32(), P.uint64(), P.float16(),
        P.float32(), P.float64(), P.date32(), P.date64(),
        P.timestamp("ms"), P.timestamp("ns", "UTC"), P.time32("s"),
        P.time64("us"), P.duration("ms"), P.month_interval(),
        P.day_time_interval(), P.month_day_nano_interval(),
        P.decimal32(7, 2), P.decimal64(12, 3), P.decimal128(20, 4),
        P.decimal256(40, 5), P.string(), P.binary(), P.large_string(),
        P.large_binary(), P.fixed_size_binary(4), P.string_view(),
        P.binary_view(), P.list_(P.int8()), P.large_list(P.string()),
        P.fixed_size_list(P.int8(), 3), P.list_view(P.int16()),
        P.large_list_view(P.int16()), P.struct(fs),
        P.map_(P.string(), P.int32()), P.dictionary(P.int32(), P.string()),
        P.run_end_encoded(P.int32(), P.float64()), P.sparse_union(fs),
        P.dense_union(fs)]


PREDICATES = sorted(n for n in dir(at.types) if n.startswith("is_")
                    and not n.endswith("_value"))
VALUE_PREDICATES = sorted(n for n in dir(at.types) if n.startswith("is_")
                          and n.endswith("_value"))


@pytest.mark.parametrize("name", PREDICATES)
def test_type_predicate(name):
    """Each of pyarrow.types' predicates over every type the port has,
    the reference's answer; and False for what is not a type."""
    pred, want = getattr(att.types, name), getattr(at.types, name)
    for p, r in zip(_all_types(att), _all_types(at), strict=True):
        assert pred(p) is want(r), (name, r)
    assert pred(None) is want(None) is False


@pytest.mark.parametrize("name", VALUE_PREDICATES)
def test_value_predicate(name):
    values = [True, np.bool_(False), 1, np.int8(3), np.uint64(9), 1.5,
              np.float32(2.0), "x", None, b"y"]
    assert [getattr(att.types, name)(v) for v in values] == \
        [getattr(at.types, name)(v) for v in values]


@pytest.mark.parametrize("attr", [
    "num_fields", "num_buffers", "has_variadic_buffers", "name",
    "is_primitive", "is_binary_like", "is_binary_view_like",
    "is_large_binary_like"])
def test_data_type_attribute(attr):
    for p, r in zip(_all_types(att), _all_types(at), strict=True):
        assert getattr(p, attr) == getattr(r, attr), (attr, r)


def test_data_type_field():
    for p, r in zip(_all_types(att), _all_types(at), strict=True):
        for i in range(r.num_fields):
            assert p.field(i).name == r.field(i).name
            assert p.field(i).type == port_type(r.field(i).type)


def _schemas(P):
    return [P.schema([("a", P.int64()), ("b", P.string()),
                      P.field("c", P.bool_(), False)]),
            P.schema([("x", P.int8())], {"k": "v"}), P.schema([])]


def test_schema_text_and_metadata():
    for p, r in zip(_schemas(att), _schemas(at)):
        assert repr(p) == repr(r) == p.to_string() == r.to_string()
        assert p.add_metadata({"m": "1"}).metadata == \
            r.add_metadata({"m": "1"}).metadata
    assert repr(att.schema([("a", att.int64())])) == "Schema:\na: int64"


def test_schema_serialize():
    for p, r in zip(_schemas(att), _schemas(at)):
        got = p.serialize()
        assert isinstance(got, att.Buffer)
        assert got.to_pybytes() == r.serialize().to_pybytes()


def test_buffer_attributes():
    for data in (b"abc\x00\xff", bytearray(b"xyz"),
                 np.arange(5, dtype=np.int32)):
        p, r = att.py_buffer(data), at.py_buffer(data)
        assert p.hex() == r.hex()
        assert (p.is_cpu, p.is_mutable, p.parent) == \
            (r.is_cpu, r.is_mutable, r.parent)
        assert p.address == p.to_numpy().ctypes.data
        assert p.slice(1, 2).address == p.address + 1


@pytest.mark.parametrize("value,src,dst", [
    (5, "int64", "float64"), (None, "int32", "int8"), ("7", "string", "int64"),
    (2.5, "float64", "int32"), (True, "bool_", "int16")])
def test_scalar_cast_equals_validate(value, src, dst):
    from arrow_tpu.compute.registry import Scalar as RS
    from arrow_tpu_torch.compute.registry import Scalar as PS
    r = RS(value, getattr(at, src)())
    p = PS(value, getattr(att, src)())
    try:
        want = r.cast(getattr(at, dst)())
    except Exception as exc:  # noqa: BLE001 - the port raises alike
        with pytest.raises(builtin_class(exc)):
            p.cast(getattr(att, dst)(), device="cpu")
    else:
        got = p.cast(getattr(att, dst)(), device="cpu")
        assert (got.value, got.type) == (want.value, port_type(want.type))
    assert p.equals(PS(value, getattr(att, src)())) is \
        r.equals(RS(value, getattr(at, src)())) is True
    assert p.equals(PS(value, att.uint8())) is \
        r.equals(RS(value, at.uint8())) is False
    assert p.validate() is r.validate() is None
    assert p.validate(full=True) is None


def test_tdigest_quantiles_after_a_merge():
    from arrow_tpu.utils.tdigest import TDigest as RD
    from arrow_tpu_torch.utils.tdigest import TDigest as PD
    rng = np.random.default_rng(11)
    parts = [rng.lognormal(0, 1.5, 5_000), rng.normal(3, 1, 7_000),
             np.concatenate([rng.uniform(size=300), [np.nan]])]
    q = [0.0, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0]
    for delta in (20, 100):
        r = [RD.from_array(p, delta) for p in parts]
        p = [PD.from_array(x, delta) for x in parts]
        rm, pm = r[0].merge(r[1:]), p[0].merge(p[1:])
        np.testing.assert_array_equal(pm.quantile(q), rm.quantile(q))
        np.testing.assert_array_equal(pm.means, rm.means)
        np.testing.assert_array_equal(pm.weights, rm.weights)
        assert (pm.min, pm.max, len(pm), pm.total_weight, repr(pm)) == \
            (rm.min, rm.max, len(rm), rm.total_weight, repr(rm))
        assert pm.median() == rm.median() and pm.mean() == rm.mean()
        assert pm.merge(PD(delta)).quantile(0.3) == \
            rm.merge(RD(delta)).quantile(0.3)
    assert np.isnan(PD().quantile(0.5)) and np.isnan(RD().quantile(0.5))


@pytest.mark.parametrize("width,padding", [(5, "0"), (2, "0"), (6, "*")])
def test_utf8_zfill(width, padding):
    import arrow_tpu.compute as jpc
    import arrow_tpu_torch.compute as pc
    vals = ["1", "-23", "+4", "", None, "déjà", "12345678"]
    want = jpc.utf8_zfill(at.array(vals), width, padding).to_pylist()
    got = pc.utf8_zfill(att.array(vals), width, padding, device="cpu")
    assert got.to_pylist() == want


def test_function_registry_is_the_references():
    """F10: ``compute.function_registry()`` is a FunctionRegistry, as the
    reference's; ``compute.registry.function_registry()`` stays the dict
    of name -> Function, as the reference's module's is."""
    import arrow_tpu.compute as jpc
    import arrow_tpu_torch.compute as pc
    from arrow_tpu.compute import registry as jreg
    from arrow_tpu_torch.compute import registry as preg
    got, want = pc.function_registry(), jpc.function_registry()
    assert type(got).__name__ == type(want).__name__ == "FunctionRegistry"
    assert isinstance(got, pc.FunctionRegistry)
    assert got.list_functions() == want.list_functions()
    for name in want.list_functions():
        assert got.get_function(name).kind == want.get_function(name).kind
        assert got.get_function(name) is preg.get_function(name)
    assert isinstance(preg.function_registry(), dict)
    assert isinstance(jreg.function_registry(), dict)
    assert sorted(preg.function_registry()) == got.list_functions()


def test_kernel_and_function_classes():
    import arrow_tpu.compute as jpc
    import arrow_tpu_torch.compute as pc
    for base in ("Kernel", "Function"):
        kids = [n for n in dir(jpc) if n.endswith(base) and n != base]
        assert kids and [n for n in dir(pc) if n.endswith(base)
                         and n != base] == kids
        for n in kids:
            assert issubclass(getattr(pc, n), getattr(pc, base))


def test_compute_expressions_filter_a_table():
    """The pyarrow idiom ``t.filter(pc.field("a") > 1)`` and
    ``pc.scalar``."""
    import arrow_tpu.compute as jpc
    import arrow_tpu_torch.compute as pc
    data = {"a": [3, 1, None, 2, 5], "b": ["x", "y", "z", "w", None]}
    rt, pt = at.table(data), att.table(data)
    want = rt.filter(jpc.field("a") > jpc.scalar(1))
    got = pt.filter(pc.field("a") > pc.scalar(1), device="cpu")
    same(got, want)
    assert isinstance(pc.field("a"), pc.Expression)
    assert pc.Expression is att.acero.Expression


def test_config_global_options(monkeypatch):
    """The reference's fields and defaults; ``initialize`` keeps a
    ``bloom_mode`` and refuses, changing nothing, the options the port
    cannot honour. Unlike the reference's, it writes no environment
    variable."""
    from arrow_tpu import config as jcfg
    from arrow_tpu_torch import config as pcfg
    import dataclasses
    import os
    assert [(f.name, f.default) for f in
            dataclasses.fields(pcfg.GlobalOptions)] == \
        [(f.name, f.default) for f in dataclasses.fields(jcfg.GlobalOptions)]
    assert pcfg.global_options() == pcfg.GlobalOptions()
    monkeypatch.setattr(pcfg, "_GLOBAL", pcfg.global_options())
    env = dict(os.environ)
    pcfg.initialize(None)
    assert pcfg.global_options() == pcfg.GlobalOptions()
    opts = pcfg.GlobalOptions(bloom_mode="never")
    pcfg.initialize(opts)
    assert pcfg.global_options() is opts
    for field, refused in (
            ("io_threads", {"io_threads": 3}),
            ("fragment_readahead", {"fragment_readahead": 2}),
            ("movement_mode", {"movement_mode": "sort"}),
            ("movement_mode", {"bloom_mode": "always",
                               "movement_mode": "direct"})):
        with pytest.raises(NotImplementedError, match=field):
            pcfg.initialize(pcfg.GlobalOptions(**refused))
        assert pcfg.global_options() is opts
    with pytest.raises(ValueError, match="bloom_mode"):
        pcfg.initialize(pcfg.GlobalOptions(bloom_mode="sometimes"))
    assert pcfg.global_options() is opts
    assert dict(os.environ) == env


@pytest.mark.parametrize("mode,probe_rows", [
    ("auto", 5000), ("auto", 12), ("always", 12), ("never", 5000)])
def test_bloom_mode_reaches_the_joins(monkeypatch, mode, probe_rows):
    """``GlobalOptions.bloom_mode`` decides the port's bloom as
    ``ARROW_TPU_BLOOM`` does the reference's (auto: the probe side's
    capacity is at least 4x the build side's, 1,024 rows), and the join
    equals the reference's under each mode."""
    from arrow_tpu_torch import config as pcfg
    from arrow_tpu_torch.compute import bloom
    rng = np.random.default_rng(11)
    left = {"k": rng.integers(0, 20, probe_rows).tolist(),
            "x": rng.integers(0, 99, probe_rows).tolist()}
    right = {"k": list(range(0, 20, 2)), "y": list(range(10))}
    monkeypatch.setattr(pcfg, "_GLOBAL", pcfg.global_options())
    monkeypatch.setenv("ARROW_TPU_BLOOM", mode)
    pcfg.initialize(pcfg.GlobalOptions(bloom_mode=mode))
    built = []
    real = bloom.build_bloom
    monkeypatch.setattr(bloom, "build_bloom",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    keys = [("k", "ascending"), ("x", "ascending")]
    got = att.table(left).join(att.table(right), "k", join_type="inner",
                               device="cpu")
    want = at.table(left).join(at.table(right), "k", join_type="inner")
    same(got.sort_by(keys, device="cpu"), want.sort_by(keys))
    assert len(built) == (mode == "always" or
                          (mode == "auto" and probe_rows >= 4096))


def test_acero_and_dataset_exports():
    import arrow_tpu.acero as jac
    import arrow_tpu.dataset as jds
    from arrow_tpu.device.column import download_table as jdownload
    import arrow_tpu_torch.acero as ac
    import arrow_tpu_torch.dataset as ds
    from arrow_tpu_torch.device.column import download, upload_table
    for n in dir(jac):
        if n.endswith("NodeOptions") and n != "ExecNodeOptions":
            assert issubclass(getattr(ac, n), ac.ExecNodeOptions) is \
                issubclass(getattr(jac, n), jac.ExecNodeOptions), n
    data = {"a": [3, 1, None, 2], "s": ["p", "q", "p", None]}

    def plan(A, src):
        return A.Declaration.from_sequence([
            A.Declaration("table_source", A.TableSourceNodeOptions(src)),
            A.Declaration("filter", A.FilterNodeOptions(A.field("a") > 1))])
    want = jdownload(jac.execute_declaration(plan(
        jac, at.table(data)))).to_pydict()
    got = download(ac.execute_declaration(plan(ac, upload_table(
        att.table(data), device="cpu"))))
    assert got == want
    for n in ("FileSelector", "FileSystem", "LocalFileSystem"):
        assert getattr(ds, n) is getattr(att.fs, n)
        assert getattr(jds, n) is getattr(at.fs, n)
    for n in ("FilterNodeOptions", "TableSourceNodeOptions"):
        assert getattr(ds, n) is getattr(ac, n)


@pytest.mark.parametrize("values,tname", [
    ([1, None, 3], None), (["a", None, "ccc"], None), ([[1, 2], None, []], None),
    ([1.5, None], "float32"), ([None, None], "null")])
def test_array_data_from_sequence(values, tname):
    from arrow_tpu.array.construct import array_data_from_sequence as ref
    from test_torch_host_table import assert_same_data
    got = att.api.array_data_from_sequence(
        values, None if tname is None else getattr(att, tname)())
    want = ref(values, None if tname is None else getattr(at, tname)())
    assert_same_data(got, want)
