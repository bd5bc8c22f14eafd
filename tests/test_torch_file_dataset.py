"""Datasets of files in the port (``arrow_tpu_torch/dataset.py``'s file
part: ``IpcFileFormat``, ``FeatherFileFormat``, the Parquet, CSV, JSON
and ORC formats, ``FileFragment``,
``FileSystemDataset``, ``dataset(path)``, ``write_dataset``) against the
JAX package's, with pyarrow as an oracle only.

* ``tests/test_dataset_fs.py:63-134``'s IPC and Feather cases: round trips,
  hive and directory partitioning with pruning, each package reading the
  other's dataset, pyarrow's datasets, the mock file system;
* ``write_dataset``'s files byte for byte the reference's, partitioned or
  not, over nulls, strings, dictionaries and two keys;
* scans of file fragments (TPC-H lineitem as eight IPC files) equal to the
  in-memory scan and to the reference's plan over the same rows; the
  eight files' equal dictionaries keep their codes, with no recode;
* Parquet, the default format, CSV, JSON and ORC against the reference
  (dataset, write, from_paths, the format classes, parquet_dataset;
  JSON's write raises in both);
* ``chip_smoke.py``'s phase 3o on the CPU at SF 0.005.

Exact throughout, but Q1's float sums (rtol 1e-9 against the reference,
whose sums add in another order).
"""

import os

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu import acero as jacero
from arrow_tpu import dataset as rds
from arrow_tpu.acero import field as rfield
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch import dataset as ds
from arrow_tpu_torch import types as T
from arrow_tpu_torch.acero import Declaration, ScanNodeOptions, field
from arrow_tpu_torch.fs import MockFileSystem

from test_torch_host_table import carry_table
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


@pytest.fixture(scope="module")
def sample():
    rt = at.table({"year": [2020, 2020, 2021, 2021, 2022],
                   "v": [1.0, 2.0, 3.0, 4.0, 5.0],
                   "s": ["a", "b", "c", "d", "e"]})
    return rt, carry_table(rt)


@pytest.fixture(scope="module")
def rich():
    """Nulls in every column, strings, a dictionary, dates, bools and two
    partition keys, from a seed."""
    rng = np.random.default_rng(17)
    n = 400

    def nulls(vals, share=0.1):
        return [None if rng.random() < share else v for v in vals]
    rt = at.table({
        "k": nulls([int(v) for v in rng.integers(0, 3, n)], 0.05),
        "tag": [["x", "y"][int(v)] for v in rng.integers(0, 2, n)],
        "i": nulls([int(v) for v in rng.integers(-1000, 1000, n)]),
        "f": nulls([float(v) for v in rng.normal(size=n)]),
        "b": nulls([bool(v) for v in rng.integers(0, 2, n)]),
        "s": nulls([f"s{int(v)}" for v in rng.integers(0, 50, n)]),
        "d": at.array(nulls([["p", "q", "r", "p"][int(v)]
                             for v in rng.integers(0, 4, n)]),
                      at.dictionary(at.int32(), at.string())),
        "day": at.array(nulls([int(v) for v in rng.integers(0, 9000, n)]),
                        at.date32())})
    return rt, carry_table(rt)


def _equal(got, want):
    """The same columns, rows, order and nulls."""
    assert got.to_pydict() == want.to_pydict()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs_ in os.walk(root) for f in fs_)


def _same_files(a, b):
    assert _files(a) == _files(b)
    for rel in _files(a):
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


# --- tests/test_dataset_fs.py:63-134 ----------------------------------------------

@pytest.mark.parametrize("fmt", ["ipc", "arrow", "feather"])
def test_dataset_roundtrip_formats(tmp_path, sample, fmt):
    rt, pt = sample
    p, r = str(tmp_path / "p"), str(tmp_path / "r")
    ds.write_dataset(pt, p, format=fmt)
    rds.write_dataset(rt, r, format=fmt)
    _same_files(p, r)
    back = ds.dataset(p, format=fmt).to_table(device="cpu")
    assert back.num_rows == 5
    assert sorted(back.column_names) == ["s", "v", "year"]
    assert back.to_pydict() == rt.to_pydict()
    assert ds.dataset(r, format=fmt).schema == pt.schema
    assert rds.dataset(p, format=fmt).to_table().to_pydict() == \
        rt.to_pydict()


def test_hive_partitioned_roundtrip_and_pruning(tmp_path, sample):
    rt, pt = sample
    p, r = str(tmp_path / "p"), str(tmp_path / "r")
    ds.write_dataset(pt, p, format="ipc", partitioning=["year"],
                     partitioning_flavor="hive")
    rds.write_dataset(rt, r, format="ipc", partitioning=["year"],
                      partitioning_flavor="hive")
    _same_files(p, r)
    data = ds.dataset(p, format="ipc",
                      partitioning=ds.partitioning(flavor="hive"))
    ref = rds.dataset(p, format="ipc",
                      partitioning=rds.partitioning(flavor="hive"))
    assert [(f.name, str(f.type)) for f in data.schema] == \
        [("v", "float64"), ("s", "string"), ("year", "int64")]
    assert data.to_table(device="cpu").to_pydict() == \
        ref.to_table().to_pydict()
    pruned = data.to_table(filter=field("year") == 2021, device="cpu")
    assert pruned.to_pydict() == \
        ref.to_table(filter=rfield("year") == 2021).to_pydict()
    assert sorted(pruned.to_pydict()["v"]) == [3.0, 4.0]
    assert len(list(data.get_fragments(field("year") == 2021))) == 1
    mixed = data.to_table(filter=(field("year") == 2021)
                          & (field("v") > 3.0), device="cpu")
    assert mixed.to_pydict()["v"] == [4.0]
    sel = data.to_table(columns=["v", "year"], device="cpu")
    assert sel.column_names == ["v", "year"]
    assert sel.to_pydict() == ref.to_table(
        columns=["v", "year"]).to_pydict()
    assert data.fragments[1].to_table(["year"]).to_pydict() == \
        {"year": [2021, 2021]}


def test_directory_partitioning(tmp_path, sample):
    rt, pt = sample
    p, r = str(tmp_path / "p"), str(tmp_path / "r")
    ds.write_dataset(pt, p, format="ipc", partitioning=["year"])
    rds.write_dataset(rt, r, format="ipc", partitioning=["year"])
    _same_files(p, r)
    part = ds.partitioning(T.Schema([T.Field("year", T.int64())]))
    data = ds.dataset(p, format="ipc", partitioning=part)
    t = data.to_table(filter=field("year") == 2022, device="cpu")
    assert t.to_pydict()["v"] == [5.0]
    assert t.to_pydict() == rds.dataset(
        r, format="ipc", partitioning=rds.partitioning(at.schema(
            [("year", at.int64())]))).to_table(
                filter=rfield("year") == 2022).to_pydict()


def test_pyarrow_reads_our_dataset_and_we_read_its(tmp_path, sample):
    pads = pytest.importorskip("pyarrow.dataset")
    rt, pt = sample
    d = str(tmp_path / "ours")
    ds.write_dataset(pt, d, format="ipc", partitioning=["year"],
                     partitioning_flavor="hive")
    pa_ds = pads.dataset(d, format="ipc", partitioning="hive")
    assert sorted(pa_ds.to_table().to_pydict()["v"]) == rt.to_pydict()["v"]
    theirs = str(tmp_path / "theirs")
    pads.write_dataset(pa.table(rt.to_pydict()), theirs, format="ipc",
                       partitioning=["year"], partitioning_flavor="hive")
    data = ds.dataset(theirs, format="ipc",
                      partitioning=ds.partitioning(flavor="hive"))
    t = data.to_table(device="cpu")
    assert t.num_rows == 5
    assert sorted(t.to_pydict()["year"]) == [2020, 2020, 2021, 2021, 2022]


def test_mock_fs_dataset(sample):
    rt, pt = sample
    m = MockFileSystem()
    ds.write_dataset(pt, "root", format="ipc", filesystem=m)
    from arrow_tpu.fs import MockFileSystem as RMock
    rm = RMock()
    rds.write_dataset(rt, "root", format="ipc", filesystem=rm)
    assert m.files == rm.files
    data = ds.dataset("root", format="ipc", filesystem=m)
    assert data.to_table(device="cpu").to_pydict() == rt.to_pydict()


def test_fragment_readahead_is_accepted(tmp_path, sample):
    _, pt = sample
    d = str(tmp_path / "ra")
    ds.write_dataset(pt, d, format="ipc", partitioning=["year"])
    data = ds.dataset(d, format="ipc",
                      partitioning=ds.partitioning(flavor="hive"))
    serial = data.to_table(use_threads=False, device="cpu")
    assert data.to_table(fragment_readahead=4, device="cpu").to_pydict() \
        == serial.to_pydict()


# --- write_dataset byte for byte ---------------------------------------------------

@pytest.mark.parametrize("fmt", ["ipc", "feather"])
@pytest.mark.parametrize("keys,flavor", [
    ([], None), (["k"], "hive"), (["tag"], None), (["tag", "k"], "hive"),
    (["d"], "hive")])
def test_write_dataset_files_equal_the_reference(tmp_path, rich, keys,
                                                 flavor, fmt):
    rt, pt = rich
    p, r = str(tmp_path / "p"), str(tmp_path / "r")
    ds.write_dataset(pt, p, format=fmt, partitioning=keys or None,
                     partitioning_flavor=flavor)
    rds.write_dataset(rt, r, format=fmt, partitioning=keys or None,
                      partitioning_flavor=flavor)
    _same_files(p, r)
    paths = [os.path.join(p, f) for f in _files(p)]
    back = ds.FileSystemDataset.from_paths(paths, format=fmt)
    assert back.to_table(device="cpu").num_rows == rt.num_rows


def test_write_dataset_of_a_record_batch_and_an_empty_table(tmp_path, rich):
    rt, pt = rich
    ds.write_dataset(pt.to_batches()[0], str(tmp_path / "p"), format="ipc")
    rds.write_dataset(rt.to_batches()[0], str(tmp_path / "r"), format="ipc")
    _same_files(str(tmp_path / "p"), str(tmp_path / "r"))
    ds.write_dataset(pt.slice(0, 0), str(tmp_path / "e"), format="ipc",
                     partitioning=["k"])
    assert os.listdir(tmp_path / "e") == []


# --- scans of file fragments ---------------------------------------------------

@pytest.fixture(scope="module")
def lineitem_files(tmp_path_factory):
    """TPC-H lineitem at SF 0.01 as eight IPC files written by the
    reference; (the reference Table, the port's Table, the directory)."""
    from arrow_tpu import ipc as rip
    from arrow_tpu.io import tpch as jtpch
    root = tmp_path_factory.mktemp("lineitem")
    ref = jtpch.lineitem_table(0.01)
    rt = at.Table.from_batches([ref]) if not hasattr(ref, "column_names") \
        else ref
    n = rt.num_rows
    step = -(-n // 8)
    for i, s in enumerate(range(0, n, step)):
        part = rt.slice(s, step)
        with open(root / f"part-{i}.arrow", "wb") as f:
            with rip.new_file(f, part.schema) as w:
                w.write_table(part)
    return rt, carry_table(rt), str(root)


def test_a_scan_of_file_fragments(lineitem_files):
    """Q1 and Q6 over the eight files: equal to the same scans of the
    in-memory slices bit for bit, and to the reference's plans over its
    Table."""
    import chip_smoke
    from arrow_tpu.io import tpch_queries as jq
    from arrow_tpu_torch.io import tpch_queries as tq
    rt, pt, root = lineitem_files
    files = ds.dataset(root, format="ipc")
    assert len(files.fragments) == 8 and files.schema == pt.schema
    step = -(-pt.num_rows // 8)
    memory = ds.InMemoryDataset([pt.slice(i, step)
                                 for i in range(0, pt.num_rows, step)])
    for cols, make_t, make_j in ((chip_smoke.Q1_COLUMNS, tq.q1_plan,
                                  jq.q1_plan),
                                 (chip_smoke.Q6_COLUMNS, tq.q6_plan,
                                  jq.q6_plan)):
        got = {}
        for name, data in (("files", files), ("memory", memory)):
            got[name] = chip_smoke._with_leaf(make_t(pt), Declaration(
                "scan", ScanNodeOptions(data, cols))).to_table(device="cpu")
        assert chip_smoke.table_digest(got["files"]) == \
            chip_smoke.table_digest(got["memory"])
        assert_tables_match(got["files"], make_j(rt).to_table().to_pydict())
    q6 = chip_smoke.q6_condition()
    scanned = ds.Scanner(files, chip_smoke.Q6_COLUMNS, q6,
                         device="cpu").to_table()
    assert scanned.to_pydict() == ds.Scanner(
        memory, chip_smoke.Q6_COLUMNS, q6, device="cpu").to_table() \
        .to_pydict()
    assert files.count_rows(q6, device="cpu") == scanned.num_rows


def test_eight_files_keep_their_codes(lineitem_files, monkeypatch):
    """The files' dictionaries are equal objects' values, not one object:
    the scan keeps the codes, with no recode into a union."""
    from arrow_tpu_torch.acero import exec as texec
    _, pt, root = lineitem_files
    data = ds.dataset(root, format="ipc")

    def no_recode(cols):
        raise AssertionError("recoded")
    monkeypatch.setattr(texec, "_unify_dictionaries", no_recode)
    got = data.to_table(columns=["l_returnflag", "l_shipmode"],
                        device="cpu")
    assert got.to_pydict() == pt.select(["l_returnflag",
                                         "l_shipmode"]).to_pydict()


def test_file_dataset_methods(lineitem_files):
    rt, pt, root = lineitem_files
    ref = rds.dataset(root, format="ipc")
    data = ds.FileSystemDataset.from_paths(
        [os.path.join(root, f) for f in sorted(os.listdir(root))],
        format="ipc")
    assert data.files == [f.path for f in data.fragments]
    cols = ["l_orderkey", "l_quantity"]
    assert data.head(7, columns=cols, device="cpu").to_pydict() == \
        ref.head(7, columns=cols).to_pydict()
    assert data.take([0, 5, 9000], columns=cols, device="cpu") \
        .to_pydict() == ref.take(at.array([0, 5, 9000]),
                                 columns=cols).to_pydict()
    assert sum(b.num_rows for b in data.to_batches(
        columns=cols, device="cpu")) == rt.num_rows
    tagged = list(data.scanner(cols, device="cpu").scan_batches())
    assert [t.fragment.path for t in tagged] == data.files
    frag = data.fragments[2]
    assert frag.to_table(cols).to_pydict() == \
        ref.fragments[2].to_table(cols).to_pydict()


def test_the_card_is_the_default_for_files(lineitem_files):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.dataset(lineitem_files[2], format="ipc").to_table()


# --- the other formats -----------------------------------------------------------

def _write_ndjson_dirs(root, rt):
    """``rt`` as newline-delimited JSON files, one a year directory (hive),
    a record a row (the reference writes no JSON)."""
    import json
    rows = rt.to_pylist()
    for year in sorted({r["year"] for r in rows}):
        d = os.path.join(root, f"year={year}")
        os.makedirs(d)
        with open(os.path.join(d, "part-0.json"), "w") as f:
            for r in rows:
                if r["year"] == year:
                    f.write(json.dumps({k: v for k, v in r.items()
                                        if k != "year"}) + "\n")


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json", "orc"])
def test_the_other_formats_raise(tmp_path, sample, fmt):
    """The formats of files, ported, held to the reference: Parquet (the
    default), CSV and ORC by ``write_dataset``'s files and bytes, hive
    partitioned and not, the dataset of them, ``from_paths`` and the
    format's class; JSON, which the reference cannot write
    (``FileFormat.write`` raises NotImplementedError in both), by a
    dataset of hand-written ndjson files. ``parquet_dataset`` over a
    directory of no file raises as the reference's does (the reference
    lists a ``_metadata`` file as a fragment, the port skips it: the
    reference's rows either way)."""
    rt, pt = sample
    hive = ds.HivePartitioning(), rds.HivePartitioning()
    fmt_kw = {} if fmt == "parquet" else {"format": fmt}
    if fmt == "json":
        for mod, t in ((ds, pt), (rds, rt)):
            with pytest.raises(NotImplementedError):
                mod.write_dataset(t, str(tmp_path / "w"), format="json")
        _write_ndjson_dirs(str(tmp_path / "p"), rt)
        (tmp_path / "r").symlink_to(tmp_path / "p")
    else:
        ds.write_dataset(pt, str(tmp_path / "p"), partitioning=["year"],
                         partitioning_flavor="hive", **fmt_kw)
        rds.write_dataset(rt, str(tmp_path / "r"), partitioning=["year"],
                          partitioning_flavor="hive", **fmt_kw)
        _same_files(tmp_path / "p", tmp_path / "r")
        ds.write_dataset(pt, str(tmp_path / "p1"), **fmt_kw)
        rds.write_dataset(rt, str(tmp_path / "r1"), **fmt_kw)
        _same_files(tmp_path / "p1", tmp_path / "r1")
    got = ds.dataset(str(tmp_path / "p"), partitioning=hive[0], **fmt_kw)
    want = rds.dataset(str(tmp_path / "r"), partitioning=hive[1], **fmt_kw)
    _equal(got.to_table(device="cpu"), want.to_table())
    assert got.schema.names == want.schema.names
    paths = [str(tmp_path / "p" / f) for f in _files(tmp_path / "p")]
    _equal(ds.FileSystemDataset.from_paths(paths, **fmt_kw).to_table(
        device="cpu"), rds.FileSystemDataset.from_paths(
            paths, **fmt_kw).to_table())
    cls = {"parquet": ds.ParquetFileFormat, "csv": ds.CsvFileFormat,
           "json": ds.JsonFileFormat, "orc": ds.OrcFileFormat}[fmt]
    assert isinstance(cls(), ds.FileFormat) and cls().name == fmt
    assert isinstance(got.fragments[0].format, cls)
    if fmt == "csv":
        opts = ds.CsvFragmentScanOptions(convert_options="c")
        assert (opts.type_name, opts.convert_options) == ("csv", "c")
    if fmt == "json":
        opts = ds.JsonFragmentScanOptions(read_options="r")
        assert (opts.type_name, opts.read_options) == ("json", "r")
    if fmt == "parquet":
        (tmp_path / "p" / "_metadata").write_bytes(b"not a fragment")
        _equal(ds.parquet_dataset(str(tmp_path / "p" / "_metadata"),
                                  partitioning=hive[0]).to_table(
                                      device="cpu"), want.to_table())
    # parquet_dataset over a directory of no file raises as the
    # reference's does
    (tmp_path / "none").mkdir()
    for mod in (ds, rds):
        with pytest.raises(ValueError, match="no files"):
            mod.parquet_dataset(str(tmp_path / "none" / "_metadata"))


# --- phase 3o on the CPU ---------------------------------------------------------

def test_chip_smoke_phase_3o_on_cpu():
    """``chip_smoke.py``'s phase 3o over phase 3l's Tables at SF 0.005 on
    the CPU: every path against its in-memory twin, its Table or numpy (no
    launches here)."""
    import chip_smoke
    _, host = chip_smoke.phase_host(sf=0.005, device="cpu")
    launches, facts = chip_smoke.phase_files(host, device="cpu")
    assert launches == {}
    assert set(chip_smoke.FILE_LAUNCHES) <= set(facts["walls"])
    assert facts["facts"]["lineitem ipc GB"] > 0
    assert facts["facts"]["feather lz4 GB"] < facts["facts"]["feather raw GB"]


def test_phase_3o_hive_plan_matches_the_reference():
    """Phase 3o's hive aggregate over orders at SF 0.01 under a filter
    node, against the reference's Declaration over the same rows."""
    import chip_smoke
    from arrow_tpu.io import tpch as jtpch
    ref = jtpch.orders_table(0.01)
    rt = at.Table.from_batches([ref]) if not hasattr(ref, "column_names") \
        else ref
    pt = carry_table(rt)
    cols = ["o_orderstatus"] + chip_smoke.HIVE_COLUMNS

    def source(m, t):
        return m.Declaration.from_sequence([
            m.Declaration("table_source", m.TableSourceNodeOptions(
                t.select(cols))),
            m.Declaration("filter", m.FilterNodeOptions(
                m.field("o_orderstatus") == chip_smoke.HIVE_STATUS))])
    got = chip_smoke.hive_orders_plan(source(tacero, pt)).to_table(
        device="cpu")
    want = chip_smoke.hive_orders_plan(source(jacero, rt),
                                       ac=jacero).to_table()
    assert_tables_match(got, want.to_pydict())
