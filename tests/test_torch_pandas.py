"""The pandas methods of the port against the JAX package's: ``Array``,
``ChunkedArray``, ``RecordBatch``, ``Table`` and ``RecordBatchReader``'s
``to_pandas``/``from_pandas``/``read_pandas``, ``Schema.from_pandas`` and
``pandas_metadata``, ``DataType.to_pandas_dtype``, the IPC pair
``serialize_pandas``/``deserialize_pandas``, and ``read_pandas`` of
Parquet, Feather and a Parquet dataset. pandas is imported when a method
is called: where there is none (the card's machine may lack it) the
method raises ImportError, with no fallback."""

import builtins

import numpy as np
import pandas as pd
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu_torch.array.array import pylist_equal

from test_torch_host_table import port_schema
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


def _arrays(P):
    return {
        "ints": P.array([1, 2, 3], P.int64()),
        "int nulls": P.array([1, None, 3], P.int32()),
        "floats": P.array([1.5, None, -0.0], P.float64()),
        "f32": P.array([1.5, 2.5], P.float32()),
        "strings": P.array(["a", None, "ccc"], P.string()),
        "bools": P.array([True, None, False], P.bool_()),
        "timestamps": P.array([1000, None, 3000], P.timestamp("ms")),
        "tz": P.array([1000, 2000], P.timestamp("us", "Europe/Paris")),
        "durations": P.array([5, None], P.duration("s")),
        "dictionary": P.array(["x", "y", None, "x"],
                              P.dictionary(P.int32(), P.string())),
        "dates": P.array([1, 2], P.date32()),
        "lists": P.array([[1, 2], None], P.list_(P.int64())),
    }


@pytest.mark.parametrize("name", sorted(_arrays(at)))
def test_array_to_pandas_is_the_references(name):
    want = _arrays(at)[name].to_pandas()
    got = _arrays(att)[name].to_pandas()
    pd.testing.assert_series_equal(got, want)
    cols = at.chunked_array([_arrays(at)[name]]).to_pandas()
    pd.testing.assert_series_equal(
        att.chunked_array([_arrays(att)[name]]).to_pandas(), cols)


@pytest.mark.parametrize("values,tname", [
    ([1, 2, None], None), ([1.5, float("nan"), 2.0], None),
    (["a", None], None), ([1, 2], "int8"), ([True, None], None)])
def test_array_from_pandas_is_the_references(values, tname):
    s = pd.Series(values, dtype=object)
    want = at.Array.from_pandas(s, None if tname is None else
                                getattr(at, tname)())
    got = att.Array.from_pandas(s, None if tname is None else
                                getattr(att, tname)())
    assert pylist_equal(got.to_pylist(), want.to_pylist())
    assert repr(got.type) == repr(want.type).replace("double", "float64")
    assert pylist_equal(att.Array.from_pandas(values).to_pylist(),
                        at.Array.from_pandas(values).to_pylist())


def _frame():
    return pd.DataFrame({"i": np.array([1, 2, 3], np.int64),
                         "f": [0.5, None, 2.0],
                         "o": pd.Series(["x", None, "z"], dtype=object),
                         "t": pd.to_datetime(["2020-01-01", "2021-01-01",
                                              "2022-06-30"]),
                         "b": [True, False, True]})


def test_table_and_batch_round_trips_are_the_references():
    df = _frame()
    want, got = at.Table.from_pandas(df), att.Table.from_pandas(df)
    assert got.schema == port_schema(want.schema)
    assert pylist_equal(got.to_pylist(), want.to_pylist())
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas())
    rb = att.RecordBatch.from_pandas(df)
    assert pylist_equal(rb.to_pylist(),
                        at.RecordBatch.from_pandas(df).to_pylist())
    pd.testing.assert_frame_equal(rb.to_pandas(), got.to_pandas())
    schema = att.schema([("i", att.float64()), ("f", att.float64()),
                         ("o", att.string()), ("t", att.timestamp("ns")),
                         ("b", att.bool_())])
    cast = att.RecordBatch.from_pandas(df, schema, device="cpu")
    assert cast.schema == schema
    assert att.Schema.from_pandas(df) == got.schema
    reader = att.RecordBatchReader.from_batches(got.schema,
                                                got.to_batches())
    pd.testing.assert_frame_equal(reader.read_pandas(), got.to_pandas())


def test_pandas_metadata_and_dtypes_are_the_references():
    meta = {"index_columns": [], "columns": [{"name": "a"}]}
    import json
    md = {"pandas": json.dumps(meta)}
    assert att.schema([("a", att.int8())], md).pandas_metadata == \
        at.schema([("a", at.int8())], md).pandas_metadata == meta
    assert att.schema([("a", att.int8())]).pandas_metadata is None
    for name in ("int8", "uint32", "float16", "float64", "bool_", "string",
                 "date32", "binary", "null"):
        assert getattr(att, name)().to_pandas_dtype() is \
            getattr(at, name)().to_pandas_dtype(), name
    for unit in ("s", "ms", "us", "ns"):
        assert att.timestamp(unit).to_pandas_dtype() is \
            at.timestamp(unit).to_pandas_dtype()
        assert att.duration(unit).to_pandas_dtype() is \
            at.duration(unit).to_pandas_dtype()


def test_the_ipc_pair_is_the_references():
    df = pd.DataFrame({"i": [1, 2, 3], "f": [0.5, None, 2.0]})
    blob = att.serialize_pandas(df)
    assert blob == at.serialize_pandas(df)
    pd.testing.assert_frame_equal(att.deserialize_pandas(blob),
                                  at.deserialize_pandas(blob))


def test_read_pandas_of_files(tmp_path):
    from arrow_tpu import feather as rfeather
    from arrow_tpu.io import parquet as rpq
    from arrow_tpu_torch import feather
    from arrow_tpu_torch.io import parquet as pq
    t = att.table({"a": [1, 2, 3], "s": ["x", None, "z"]})
    rt = at.table({"a": [1, 2, 3], "s": ["x", None, "z"]})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p)
    pd.testing.assert_frame_equal(pq.read_pandas(p), rpq.read_pandas(p))
    pd.testing.assert_frame_equal(pq.read_pandas(p, columns=["s"]),
                                  rpq.read_pandas(p, columns=["s"]))
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"f{i}.feather"))
        feather.write_feather(t, paths[-1])
    pd.testing.assert_frame_equal(
        feather.FeatherDataset(paths).read_pandas(),
        rfeather.FeatherDataset(paths).read_pandas())
    assert rt.to_pydict() == t.to_pydict()


def test_without_pandas_every_method_raises(monkeypatch):
    real = builtins.__import__

    def no_pandas(name, *args, **kwargs):
        if name.split(".")[0] == "pandas":
            raise ImportError("No module named 'pandas'")
        return real(name, *args, **kwargs)
    t = att.table({"a": [1, 2]})
    monkeypatch.setattr(builtins, "__import__", no_pandas)
    for call in (lambda: t.to_pandas(), lambda: t.column("a").to_pandas(),
                 lambda: t.column("a").combine().to_pandas(),
                 lambda: t.to_batches()[0].to_pandas(),
                 lambda: att.Array.from_pandas([1]),
                 lambda: att.RecordBatchReader.from_batches(
                     t.schema, t.to_batches()).read_pandas(),
                 lambda: att.deserialize_pandas(att.ipc.serialize_table(t))):
        with pytest.raises(ImportError):
            call()
