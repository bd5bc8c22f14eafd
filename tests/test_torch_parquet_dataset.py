"""Parquet datasets in the port (``arrow_tpu_torch/dataset.py``'s Parquet
part: ``ParquetFileFormat``, ``parquet_dataset``, the default format of
``dataset``/``write_dataset``/``from_paths``; ``io/parquet/metadata.py``'s
``write_to_dataset``, ``ParquetDataset``; ``read_table(filters=)``)
against the JAX package's, with pyarrow as an oracle only.

* ``write_dataset`` and ``write_to_dataset``: the reference's directories,
  file names and bytes, partitioned or not; the port's
  ``metadata_collector`` and ``file_visitor`` (the reference has neither);
* datasets of Parquet files: the reference's rows, hive and directory
  partitioning with pruning, ``from_paths``, a scan reading only the
  columns it needs, discovery skipping ``_``/``.`` names (a ``_metadata``
  file), ``parquet_dataset`` and ``ParquetDataset`` with filters, the
  options classes; pyarrow's datasets;
* Q1 and Q6 over TPC-H lineitem as eight Parquet files (SF 0.01) against
  the in-memory slices and the reference's plans; ``read_table`` under
  DNF filters on the CPU, against the reference's;
* ``chip_smoke.py``'s phase 3p on the CPU at SF 0.005.

Exact throughout, but Q1's float sums (rtol 1e-9 against the reference,
whose sums add in another order).
"""

import os

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu import dataset as rds
from arrow_tpu.acero import field as rfield
from arrow_tpu.io import parquet as rpq
from arrow_tpu_torch import dataset as ds
from arrow_tpu_torch.acero import Declaration, ScanNodeOptions, field
from arrow_tpu_torch.io import parquet as pq

from test_torch_host_table import carry_table
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


@pytest.fixture(scope="module")
def rich():
    """Nulls in most columns, strings, a dictionary, dates and two
    partition keys, from a seed."""
    rng = np.random.default_rng(23)
    n = 300

    def nulls(vals, share=0.1):
        return [None if rng.random() < share else v for v in vals]
    rt = at.table({
        "k": [int(v) for v in rng.integers(0, 3, n)],
        "tag": [["x", "y"][int(v)] for v in rng.integers(0, 2, n)],
        "i": nulls([int(v) for v in rng.integers(-1000, 1000, n)]),
        "f": nulls([float(v) for v in rng.normal(size=n)]),
        "s": nulls([f"s{int(v)}" for v in rng.integers(0, 50, n)]),
        "d": at.array(nulls([["p", "q", "r"][int(v)]
                             for v in rng.integers(0, 3, n)]),
                      at.dictionary(at.int32(), at.string())),
        "day": at.array(nulls([int(v) for v in rng.integers(0, 9000, n)]),
                        at.date32())})
    return rt, carry_table(rt)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs_ in os.walk(root) for f in fs_)


def _same_bytes(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("keys,flavor", [
    (None, None), (["k"], "hive"), (["k"], None), (["k", "tag"], "hive")])
def test_write_dataset_equals_the_reference(tmp_path, rich, keys, flavor):
    rt, pt = rich
    ds.write_dataset(pt, str(tmp_path / "p"), partitioning=keys,
                     partitioning_flavor=flavor)
    rds.write_dataset(rt, str(tmp_path / "r"), partitioning=keys,
                      partitioning_flavor=flavor)
    _same_bytes(tmp_path / "p", tmp_path / "r")
    if keys is None:
        got = ds.dataset(str(tmp_path / "p")).to_table(device="cpu")
        want = rds.dataset(str(tmp_path / "r")).to_table()
    else:
        part = (ds.HivePartitioning(), rds.HivePartitioning()) \
            if flavor == "hive" else (
                ds.DirectoryPartitioning(ds.Schema([ds.Field(
                    k, _ptype(rt, k)) for k in keys])),
                rds.DirectoryPartitioning(at.schema([(k, rt.schema.field(
                    k).type) for k in keys])))
        got = ds.dataset(str(tmp_path / "r"), partitioning=part[0]) \
            .to_table(device="cpu")
        want = rds.dataset(str(tmp_path / "p"), partitioning=part[1]) \
            .to_table()
    assert got.to_pydict() == want.to_pydict()


def _ptype(rt, name):
    from test_torch_host_table import port_type
    return port_type(rt.schema.field(name).type)


def test_write_to_dataset_and_its_metadata(tmp_path, rich):
    """The reference's files; the port's collector holds each file's
    metadata with its relative path; write_metadata's ``_metadata`` is the
    reference's (its collector is ignored there too); parquet_dataset
    over it skips it, as ParquetDataset does, with the reference's rows."""
    rt, pt = rich
    collector = []
    pq.write_to_dataset(pt, str(tmp_path / "p"), partition_cols=["k"],
                        metadata_collector=collector)
    rpq.write_to_dataset(rt, str(tmp_path / "r"), partition_cols=["k"])
    _same_bytes(tmp_path / "p", tmp_path / "r")
    assert [m.file_path for m in collector] == _files(tmp_path / "p")
    assert [m.num_rows for m in collector] == [
        rpq.read_metadata(str(tmp_path / "r" / f)).num_rows
        for f in _files(tmp_path / "r")]
    assert collector[0].to_dict() == rpq.read_metadata(
        str(tmp_path / "r" / _files(tmp_path / "r")[0])).to_dict()
    rest = pt.select([n for n in pt.column_names if n != "k"])
    rrest = rt.select([n for n in rt.column_names if n != "k"])
    pq.write_metadata(rest.schema, str(tmp_path / "p" / "_metadata"),
                      metadata_collector=collector)
    rpq.write_metadata(rrest.schema, str(tmp_path / "m"))
    assert (tmp_path / "p" / "_metadata").read_bytes() == \
        (tmp_path / "m").read_bytes()
    got = ds.parquet_dataset(str(tmp_path / "p" / "_metadata"),
                             partitioning=ds.HivePartitioning())
    assert len(got.fragments) == 3
    want = rds.dataset(str(tmp_path / "r"),
                       partitioning=rds.HivePartitioning())
    assert got.to_table(device="cpu").to_pydict() == \
        want.to_table().to_pydict()
    pds = pq.ParquetDataset(str(tmp_path / "p"), filters=[("k", "=", 1)])
    rpds = rpq.ParquetDataset(str(tmp_path / "r"), filters=[("k", "=", 1)])
    assert pds.read(device="cpu").to_pydict() == rpds.read().to_pydict()
    assert pds.schema.names == rpds.schema.names
    # the port's dataset of a directory is a FileSystemDataset, whose
    # files the view lists (the reference's plain Dataset has none)
    assert rpds.files is None
    assert pds.files == [str(tmp_path / "p" / f)
                         for f in _files(tmp_path / "p") if "=" in f]
    pd = pytest.importorskip("pandas")
    pd.testing.assert_frame_equal(pds.read_pandas(device="cpu"),
                                  rpds.read_pandas())


def test_the_file_visitor(tmp_path, rich):
    _, pt = rich
    seen = []
    ds.write_dataset(pt, str(tmp_path / "p"), partitioning=["tag"],
                     partitioning_flavor="hive", file_visitor=seen.append)
    assert [w.path for w in seen] == [str(tmp_path / "p" / f)
                                      for f in _files(tmp_path / "p")]
    assert [w.size for w in seen] == [os.path.getsize(w.path) for w in seen]
    assert sum(w.metadata.num_rows for w in seen) == pt.num_rows
    seen.clear()
    ds.write_dataset(pt, str(tmp_path / "i"), format="ipc",
                     file_visitor=seen.append)
    assert len(seen) == 1 and seen[0].metadata is None


def test_discovery_skips_underscore_and_dot_names(tmp_path, rich):
    """The reference lists every file and fails on a ``_metadata`` with
    another column order; the port skips such names (pyarrow's default),
    giving the reference's rows where it gives any."""
    rt, pt = rich
    ds.write_dataset(pt, str(tmp_path / "p"), partitioning=["k"],
                     partitioning_flavor="hive")
    want = ds.dataset(str(tmp_path / "p"),
                      partitioning=ds.HivePartitioning()).to_table(
                          device="cpu")
    pq.write_metadata(pt.schema, str(tmp_path / "p" / "_metadata"))
    with pytest.raises(TypeError):
        rds.dataset(str(tmp_path / "p"),
                    partitioning=rds.HivePartitioning()).to_table()
    (tmp_path / "p" / ".hidden").write_bytes(b"junk")
    os.makedirs(tmp_path / "p" / "_tmp")
    (tmp_path / "p" / "_tmp" / "part-9.parquet").write_bytes(b"junk")
    got = ds.dataset(str(tmp_path / "p"), partitioning=ds.HivePartitioning())
    assert len(got.fragments) == 3
    assert got.to_table(device="cpu").to_pydict() == want.to_pydict()


def test_datasets_of_parquet_files(tmp_path, rich):
    """from_paths and dataset(paths) by default; pruning by partition;
    a fragment's columns; the format class, its options and inspect."""
    rt, pt = rich
    rds.write_dataset(rt, str(tmp_path / "r"), partitioning=["k"],
                      partitioning_flavor="hive")
    paths = [str(tmp_path / "r" / f) for f in _files(tmp_path / "r")]
    for make in (ds.FileSystemDataset.from_paths, ds.dataset):
        got = make(paths)
        want = (rds.FileSystemDataset.from_paths if make is not ds.dataset
                else rds.dataset)(paths)
        assert got.to_table(device="cpu").to_pydict() == \
            want.to_table().to_pydict()
        assert got.files == paths if hasattr(got, "files") else True
    data = ds.dataset(str(tmp_path / "r"), partitioning=ds.HivePartitioning())
    ref = rds.dataset(str(tmp_path / "r"), partitioning=rds.HivePartitioning())
    cond = (field("k") == 2) & (field("f") > 0.0)
    assert len(list(data.get_fragments(cond))) == 1
    assert data.to_table(["s", "k", "f"], cond, device="cpu").to_pydict() == \
        ref.to_table(["s", "k", "f"], (rfield("k") == 2)
                     & (rfield("f") > 0.0)).to_pydict()
    frag = data.fragments[1]
    assert frag.to_table(["day", "k"]).to_pydict() == \
        ref.fragments[1].to_table(["day", "k"]).to_pydict()
    assert ds.ParquetFragmentScanOptions(pre_buffer=False).pre_buffer is False
    fmt = ds.ParquetFileFormat()
    assert fmt.inspect(data.fragments[0].fs, paths[0]).names == \
        [n for n in rt.column_names if n != "k"]
    for cls in (ds.ParquetReadOptions, ds.ParquetFileWriteOptions,
                ds.ParquetFactoryOptions, ds.FragmentScanOptions):
        cls()
    assert ds.ParquetFileFragment is ds.FileFragment
    assert ds.RowGroupInfo(3).id == 3
    assert ds.ParquetDatasetFactory(str(tmp_path / "r")).finish() \
        .to_table(device="cpu").num_rows == rt.num_rows


def test_a_scan_reads_only_the_columns_it_needs(tmp_path, rich, monkeypatch):
    from arrow_tpu_torch.io.parquet import reader
    _, pt = rich
    ds.write_dataset(pt, str(tmp_path / "p"))
    data = ds.dataset(str(tmp_path / "p"))
    read = []
    original = reader.ParquetFile._read_chunk

    def spy(self, cs, chunk, num_rows):
        read.append(cs.name)
        return original(self, cs, chunk, num_rows)
    monkeypatch.setattr(reader.ParquetFile, "_read_chunk", spy)
    got = data.to_table(["f", "s"], field("i") > 0, device="cpu")
    assert sorted(set(read)) == ["f", "i", "s"]
    assert got.column_names == ["f", "s"]


def test_pyarrow_reads_our_dataset_and_we_read_its(tmp_path, rich):
    rt, pt = rich
    ds.write_dataset(pt, str(tmp_path / "p"), partitioning=["k"],
                     partitioning_flavor="hive")
    import pyarrow.dataset as pads
    theirs = pads.dataset(str(tmp_path / "p"), partitioning="hive").to_table()
    assert theirs.num_rows == pt.num_rows
    assert sorted(theirs.column("i").to_pylist(),
                  key=lambda v: (v is None, v)) == sorted(
        pt.column("i").to_pylist(), key=lambda v: (v is None, v))
    pads.write_dataset(pa.table({"x": [1, 2, 3], "s": ["a", None, "c"]}),
                       str(tmp_path / "pa"), format="parquet")
    assert ds.dataset(str(tmp_path / "pa")).to_table(
        device="cpu").to_pydict() == {"x": [1, 2, 3], "s": ["a", None, "c"]}


# --- lineitem as eight Parquet files ---------------------------------------------

@pytest.fixture(scope="module")
def lineitem_parquet(tmp_path_factory):
    """TPC-H lineitem at SF 0.01 as eight snappy Parquet files written by
    the reference; (the reference Table, the port's Table, the
    directory)."""
    from arrow_tpu.io import tpch as jtpch
    root = tmp_path_factory.mktemp("lineitem_parquet")
    ref = jtpch.lineitem_table(0.01)
    rt = at.Table.from_batches([ref]) if not hasattr(ref, "column_names") \
        else ref
    step = -(-rt.num_rows // 8)
    for i, s in enumerate(range(0, rt.num_rows, step)):
        rpq.write_table(rt.slice(s, step), str(root / f"part-{i}.parquet"),
                        compression="snappy")
    return rt, carry_table(rt), str(root)


def test_q1_and_q6_over_parquet_files(lineitem_parquet):
    """Q1 and Q6 over the eight files against the same scans of the
    in-memory slices (the flags by value, the rest bit for bit) and the
    reference's plans over its Table; the Scanner and count_rows."""
    import chip_smoke
    from arrow_tpu.io import tpch_queries as jq
    from arrow_tpu_torch.io import tpch_queries as tq
    rt, pt, root = lineitem_parquet
    files = ds.dataset(root)
    assert len(files.fragments) == 8
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
        chip_smoke._same_scan("scan", got["files"], got["memory"])
        assert_tables_match(got["files"], make_j(rt).to_table().to_pydict())
    q6 = chip_smoke.q6_condition()
    scanned = ds.Scanner(files, chip_smoke.Q6_COLUMNS, q6,
                         device="cpu").to_table()
    chip_smoke._selected_rows("scanner", scanned, pt, chip_smoke.q6_mask(pt),
                              chip_smoke.Q6_COLUMNS)
    assert files.count_rows(q6, device="cpu") == scanned.num_rows


def test_read_table_filters_against_the_reference(lineitem_parquet):
    import chip_smoke
    rt, pt, root = lineitem_parquet
    path = os.path.join(root, "part-3.parquet")
    filters = chip_smoke.q6_filters()
    got = pq.read_table(path, columns=chip_smoke.Q6_COLUMNS,
                        filters=filters, device="cpu")
    want = rpq.read_table(path, columns=chip_smoke.Q6_COLUMNS,
                          filters=filters)
    assert got.to_pydict() == want.to_pydict()
    assert 0 < got.num_rows < pq.ParquetFile(path).num_rows
    dnf = [[("l_quantity", "<", 2.0)], [("l_discount", "in", [0.0, 0.1])]]
    assert pq.read_table(path, filters=dnf, device="cpu").to_pydict() == \
        rpq.read_table(path, filters=dnf).to_pydict()
    expr = pq.filters_to_expression(dnf)
    rexpr = rpq.filters_to_expression(dnf)
    assert str(expr) == str(rexpr)


def test_chip_smoke_phase_3p_on_cpu():
    """``chip_smoke.py``'s phase 3p over phase 3l's Tables at SF 0.005 on
    the CPU: every path against numpy, its in-memory twin or its Table
    (no launches here)."""
    import chip_smoke
    _, host = chip_smoke.phase_host(sf=0.005, device="cpu")
    launches, facts = chip_smoke.phase_parquet(host, device="cpu")
    assert launches == {}
    assert set(chip_smoke.PARQUET_LAUNCHES) <= set(facts["walls"])
    f = facts["facts"]
    assert 0 < f["lineitem parquet GB"] < f["lineitem Q1 columns GB"]
    assert f["orders encrypted GB"] > 0


@pytest.mark.parametrize("seed", range(4))
def test_short_values_code_as_the_hash_coder_does(seed):
    """The upload's exact 64-bit keys of values of 7 bytes or less (a
    Parquet scan's plain string flags take them) give the codes and first
    rows of the checked hash coder: empties, nulls, non-ASCII bytes,
    every length 0-7."""
    from arrow_tpu_torch.device import column
    rng = np.random.default_rng(seed)
    n = 5000
    lens = rng.integers(0, 8, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    raw = rng.integers(0, 3, int(offs[-1])).astype(np.uint8) * 120
    valid = rng.random(n) < 0.9
    lens = np.where(valid, lens, 0)
    keys = column._short_keys(raw, offs[:-1], lens)
    codes, first = column._first_appearance(keys)
    want_codes, want_first = column._codes_by_hash(raw, offs[:-1], lens)
    assert np.array_equal(codes, want_codes)
    assert np.array_equal(first, want_first)


def test_dictionary_pages_hand_the_upload_its_codes(tmp_path):
    """A string column read from dictionary pages comes with the codes the
    upload would find from its bytes (nulls, empty values, repeated
    dictionary values, several pages); a column with a plain page among
    its dictionary pages (pyarrow's fallback) is coded from its bytes."""
    from arrow_tpu_torch.device import column
    rng = np.random.default_rng(31)
    n = 3000
    words = ["", "a", "bb", "ccc", "dddddddddd", "é"]
    rt = at.table({
        "s": at.array([None if v == 6 else words[v % 6] + ("x" if v > 7 else "")
                       for v in rng.integers(0, 9, n)], at.string()),
        "b": at.array([bytes([v]) * (v % 3) for v in rng.integers(0, 5, n)],
                      at.binary()),
        "d": at.array([["p", "q", "p", None][v] for v in
                       rng.integers(0, 4, n)],
                      at.dictionary(at.int32(), at.string())),
    })
    pt = carry_table(rt)
    path = str(tmp_path / "d.parquet")
    with pq.ParquetWriter(path, pt.schema, data_page_size=256) as w:
        w.write_table(pt, 1000)
    pa_path = str(tmp_path / "pa.parquet")
    import pyarrow.parquet as papq
    papq.write_table(pa.table({"s": [f"v{i}" for i in range(n)]}), pa_path,
                     dictionary_pagesize_limit=256, data_page_size=256)
    checked = 0
    for src, known in ((path, True), (pa_path, False)):
        for col in pq.read_table(src).columns:
            for chunk in col.chunks:
                assert (chunk.data in column._KNOWN_CODES) == known
                got = column._encode_binary(chunk)
                column._KNOWN_CODES.pop(chunk.data, None)
                want = column._encode_binary(chunk)
                assert np.array_equal(got[0], want[0]) and got[2] == want[2]
                checked += 1
    assert checked == 10
