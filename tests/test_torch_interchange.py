"""The dataframe interchange protocol of the port
(``arrow_tpu_torch/interchange.py``, ``Table.__dataframe__``) against the
JAX package's (``arrow_tpu/interchange.py``), the cases of
``tests/test_interchange_extensions.py`` and more, with pandas and pyarrow
as producers and consumers.

* the protocol objects' answers (dtypes, nulls, buffers, chunks,
  categoricals, metadata) equal the reference's;
* ``from_dataframe`` of the port's, the reference's, pandas' and
  pyarrow's frames gives the reference's Table: types and values, the
  dictionaries in first-appearance order, strings with nulls, sliced and
  chunked columns, and the reference's quirks (a pandas sentinel reads
  as a category);
* pyarrow and pandas consume the port's frames.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.interchange as pai
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import interchange as ri
from arrow_tpu_torch import interchange as pi

from test_torch_host_table import port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def _table(P):
    return P.table({
        "i": P.array([1, None, 3, 4, 5], P.int64()),
        "u": P.array([7, 8, None, 1, 2], P.uint16()),
        "f": P.array([1.5, 2.5, None, -0.0, 9.0], P.float64()),
        "h": P.array([1.5, None, 2.0, 3.0, 4.0], P.float32()),
        "s": P.array(["x", None, "zzz", "", "déjà"], P.string()),
        "ls": P.array(["a", "bb", None, "c", "d"], P.large_string()),
        "b": P.array([True, False, None, True, True], P.bool_()),
        "ts": P.array([1000, 2000, 3000, None, 5], P.timestamp("us")),
        "tz": P.array([1, 2, 3, 4, None], P.timestamp("ms", "UTC")),
        "d32": P.array([1, None, 3, 4, 5], P.date32()),
        "t64": P.array([1, 2, None, 4, 5], P.time64("ns")),
        "dur": P.array([1, 2, 3, None, 5], P.duration("s")),
        "d": P.array(["b", "a", "b", None, "c"],
                     P.dictionary(P.int32(), P.string())),
        "di": P.array([5, 3, 5, 3, None], P.dictionary(P.int8(), P.int64())),
    })


def test_protocol_answers_are_the_references():
    r, p = _table(at).__dataframe__(), _table(att).__dataframe__()
    assert p.num_columns() == r.num_columns()
    assert p.num_rows() == r.num_rows() and p.num_chunks() == 1
    assert p.column_names() == r.column_names()
    assert p.metadata == r.metadata
    for name in r.column_names():
        rc, pc = r.get_column_by_name(name), p.get_column_by_name(name)
        assert (pc.size(), pc.offset, pc.null_count) == \
            (rc.size(), rc.offset, rc.null_count)
        assert [int(x) if not isinstance(x, str) else x for x in pc.dtype] \
            == [int(x) if not isinstance(x, str) else x for x in rc.dtype]
        assert tuple(map(int, (pc.describe_null[0],))) == \
            tuple(map(int, (rc.describe_null[0],)))
        rb, pb = rc.get_buffers(), pc.get_buffers()
        for key in ("data", "validity", "offsets"):
            assert (rb[key] is None) == (pb[key] is None), (name, key)
            if rb[key] is not None:
                assert pb[key][0].bufsize == rb[key][0].bufsize
                assert [str(int(x)) if not isinstance(x, str) else x
                        for x in pb[key][1]] == \
                    [str(int(x)) if not isinstance(x, str) else x
                     for x in rb[key][1]]
                assert pb[key][0].__dlpack_device__()[0] == 1
        if rc.dtype[0] == ri.DtypeKind.CATEGORICAL:
            assert pc.describe_categorical["is_dictionary"]
            assert pc.describe_categorical["categories"].size() == \
                rc.describe_categorical["categories"].size()
        else:
            with pytest.raises(TypeError):
                pc.describe_categorical


@pytest.mark.parametrize("n_chunks", [None, 2, 3])
def test_chunks_are_the_references(n_chunks):
    r, p = _table(at).__dataframe__(), _table(att).__dataframe__()
    rs = [c.num_rows() for c in r.get_chunks(n_chunks)]
    ps = [c.num_rows() for c in p.get_chunks(n_chunks)]
    assert ps == rs
    col = p.get_column_by_name("s")
    assert [c.size() for c in col.get_chunks(n_chunks)] == \
        [c.size() for c in r.get_column_by_name("s").get_chunks(n_chunks)]
    assert p.select_columns([0, 4]).column_names() == ["i", "s"]
    assert p.select_columns_by_name(["d"]).num_columns() == 1


def _same(got, want):
    assert got.schema.names == want.schema.names
    assert [f.type for f in got.schema] == \
        [port_type(f.type) for f in want.schema]
    assert got.to_pydict() == want.to_pydict()
    for g, w in zip(got.columns, want.columns):
        g, w = g.combine(), w.combine()
        assert g.null_count == w.null_count
        if w.type.id == at.TypeId.DICTIONARY:
            assert g.dictionary.to_pylist() == w.dictionary.to_pylist()
            assert g.indices.to_pylist() == w.indices.to_pylist()


@pytest.mark.parametrize("how", ["protocol", "sliced", "batch", "chunked"])
def test_from_dataframe_of_the_ports_frame(how):
    def frame(P):
        t = _table(P)
        if how == "sliced":
            t = t.slice(1, 3)
        elif how == "batch":
            return t.to_batches()[0].__dataframe__()
        elif how == "chunked":
            t = P.concat_tables([t, t.slice(2)])
        return t.__dataframe__()
    _same(pi.from_dataframe(frame(att)), ri.from_dataframe(frame(at)))


def test_from_dataframe_of_a_table_is_the_table():
    t = _table(att)
    assert pi.from_dataframe(t) is t
    rb = t.to_batches()[0]
    assert pi.from_dataframe(rb).to_pydict() == t.to_pydict()
    with pytest.raises(TypeError):
        pi.from_dataframe(object())


def _pandas_frames():
    return {
        "numbers": pd.DataFrame({"x": [1, 2, 3], "z": [0.5, None, 2.0],
                                 "u": np.array([1, 2, 3], np.uint8)}),
        "strings": pd.DataFrame({"y": pd.array(["a", "bb", None],
                                               dtype="string")}),
        "bools": pd.DataFrame({"b": [True, False, True]}),
        "categories": pd.DataFrame({"c": pd.Categorical(
            ["q", "p", None, "q"])}),
        "dates": pd.DataFrame({"t": pd.to_datetime(
            ["2020-01-01", "2021-06-01", "1999-12-31"])}),
        "sliced": pd.DataFrame({"x": list(range(10)),
                                "s": [str(i) for i in range(10)]}).iloc[3:7],
    }


@pytest.mark.parametrize("name", sorted(_pandas_frames()))
def test_from_dataframe_of_pandas(name):
    df = _pandas_frames()[name]
    _same(pi.from_dataframe(df), ri.from_dataframe(df))


@pytest.mark.parametrize("case", ["plain", "nulls", "dictionary", "chunks",
                                  "sliced"])
def test_from_dataframe_of_pyarrow(case):
    src = {
        "plain": pa.table({"k": [10, 20], "s": ["u", "vv"],
                           "f": [0.5, 1.5]}),
        "nulls": pa.table({"k": [10, None, 3], "s": [None, "x", "yy"],
                           "b": [None, True, False]}),
        "dictionary": pa.table({"c": pa.array(["p", "q", None, "p"])
                                .dictionary_encode()}),
        "chunks": pa.concat_tables([pa.table({"k": [1, 2]}),
                                    pa.table({"k": [3, None]})]),
        "sliced": pa.table({"k": list(range(12)),
                            "s": [chr(65 + i) for i in range(12)]})
        .slice(5, 4),
    }[case]
    _same(pi.from_dataframe(src), ri.from_dataframe(src))


def test_first_appearance_order_of_a_large_categorical():
    rng = np.random.default_rng(3)
    cats = [f"v{i}" for i in range(50)]
    codes = rng.integers(0, 50, 5000)
    df = pd.DataFrame({"c": pd.Categorical.from_codes(codes, cats)})
    _same(pi.from_dataframe(df), ri.from_dataframe(df))


def test_consumers_take_the_ports_frame():
    t = att.table({"i": att.array([1, None, 3]),
                   "s": att.array(["x", None, "zzz"]),
                   "b": att.array([True, False, None]),
                   "d": att.array(["a", "b", "a"],
                                  att.dictionary(att.int32(), att.string()))})
    got = pai.from_dataframe(t)
    assert got.to_pydict() == t.to_pydict()
    df = pd.api.interchange.from_dataframe(t)
    assert df["s"].tolist()[0] == "x" and df.shape == (3, 4)
    assert df["d"].tolist() == ["a", "b", "a"]
