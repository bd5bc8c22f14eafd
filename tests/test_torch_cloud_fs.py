"""The port's fsspec adapters and cloud file systems (``arrow_tpu_torch/fs.py``,
``fs_s3.py``, ``fs_gcs.py``, ``fs_azure.py``, ``fs_hdfs.py``) against the
JAX package's, over the repository's in-process emulators
(``tests/s3_emulator.py``, ``tests/cloud_emulators.py``: loopback HTTP,
the standard library only).

* ``tests/test_dataset_fs.py:149-413``'s cases through both packages:
  file round trips, partitioned datasets, scans with pruning, a dataset
  equal to its local twin, the dataset classes, and fsspec's ``memory``
  protocol (where ``fsspec`` is installed; the card's machine has none).
* For the same writes, each client stores the reference's objects, byte
  for byte, and lists the reference's ``FileInfo``s. A signature holds a
  time, so the objects are compared, not the requests.
* ``PyFileSystem`` over a handler, the S3 helpers, the lazy names.

Every emulator is stopped in its fixture's teardown. Exact throughout.
"""

import base64

import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import dataset as jds
from arrow_tpu import fs as jfs
from arrow_tpu.acero import field as jfield
from arrow_tpu_torch import dataset as tds
from arrow_tpu_torch import fs as tfs
from arrow_tpu_torch.acero import field as tfield
from cloud_emulators import AzureEmulator, GcsEmulator, WebHdfsEmulator
from s3_emulator import S3Emulator

from test_torch_table_methods import builtin_class, same
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

CPU = {"device": "cpu"}
KINDS = ("s3", "gcs", "azure", "hdfs")
BASE = {"s3": "bkt", "gcs": "bkt", "azure": "ctr", "hdfs": "/data"}
LAKE = {"s3": "lake", "gcs": "lake", "azure": "lake", "hdfs": "/lake"}


def _client(mod, kind, em):
    if kind == "s3":
        return mod.S3FileSystem(access_key="test", secret_key="secret",
                                endpoint_override=em.endpoint,
                                allow_bucket_creation=True)
    if kind == "gcs":
        return mod.GcsFileSystem(access_token="tok",
                                 endpoint_override=em.endpoint,
                                 project_id="p", scheme="http")
    if kind == "azure":
        key = base64.b64encode(b"secretsecretsecret").decode()
        return mod.AzureFileSystem("acct", account_key=key,
                                   blob_storage_authority=em.endpoint,
                                   scheme="http")
    host, port = em.host_port
    return mod.HadoopFileSystem(host, port, user="u")


_EMULATORS = {"s3": S3Emulator, "gcs": GcsEmulator, "azure": AzureEmulator,
              "hdfs": WebHdfsEmulator}


@pytest.fixture(params=KINDS)
def clouds(request):
    """(kind, reference's file system, its emulator, port's, its
    emulator), each on an emulator of its own, stopped at the end."""
    kind = request.param
    with _EMULATORS[kind]() as jem, _EMULATORS[kind]() as tem:
        yield (kind, _client(jfs, kind, jem), jem, _client(tfs, kind, tem),
               tem)


def stored(kind, em):
    """The emulator's objects: path -> bytes."""
    state = em.state
    if kind == "hdfs":
        return dict(state.files)
    tops = state.containers if kind == "azure" else state.buckets
    return {f"{top}/{key}": data for top, objs in tops.items()
            for key, data in objs.items()}


def infos(fs, selector_or_path):
    got = fs.get_file_info(selector_or_path)
    got = got if isinstance(got, list) else [got]
    return [(i.path, i.type, i.size) for i in got]


def sample(P):
    return P.table({"year": [2020, 2020, 2021, 2021, 2022],
                    "v": [1.0, 2.0, 3.0, 4.0, 5.0],
                    "s": ["a", "b", "c", "d", "e"]})


# --- the file battery and the dataset battery, both packages -------------------------

def file_battery(mod, fs, base):
    """``tests/test_dataset_fs.py``'s ``_file_battery``; returns what it
    listed and read."""
    seen = []
    fs.create_dir(base)
    with fs.open_output_stream(f"{base}/dir/a.bin") as f:
        f.write(b"hello cloud")
    info = fs.get_file_info(f"{base}/dir/a.bin")
    assert info.is_file and info.size == 11
    with fs.open_input_stream(f"{base}/dir/a.bin") as f:
        assert f.read() == b"hello cloud"
    with fs.open_input_file(f"{base}/dir/a.bin") as f:
        assert f.read() == b"hello cloud"
    seen.append(infos(fs, mod.FileSelector(base, recursive=True)))
    assert any(p.endswith("dir/a.bin") and t == "File" for p, t, _ in seen[0])
    assert any(p.endswith("dir") and t == "Directory" for p, t, _ in seen[0])
    seen.append(infos(fs, base))
    fs.move(f"{base}/dir/a.bin", f"{base}/dir/b.bin")
    assert fs.get_file_info(f"{base}/dir/a.bin").type == "NotFound"
    assert fs.get_file_info(f"{base}/dir/b.bin").size == 11
    seen.append(infos(fs, f"{base}/dir"))
    fs.delete_file(f"{base}/dir/b.bin")
    assert fs.get_file_info(f"{base}/dir/b.bin").type == "NotFound"
    return seen


def test_file_round_trip(clouds):
    kind, jf, jem, tf, tem = clouds
    assert file_battery(tfs, tf, BASE[kind]) == \
        file_battery(jfs, jf, BASE[kind])
    assert stored(kind, tem) == stored(kind, jem)


@pytest.mark.parametrize("fmt", ["parquet", "ipc", "csv"])
def test_partitioned_dataset(clouds, fmt):
    """A hive-partitioned dataset written through the client (the
    reference's objects, byte for byte), scanned whole and pruned."""
    kind, jf, jem, tf, tem = clouds
    lake = LAKE[kind]
    jf.create_dir(lake)
    tf.create_dir(lake)
    jds.write_dataset(sample(at), f"{lake}/t", format=fmt,
                      partitioning=["year"], partitioning_flavor="hive",
                      filesystem=jf)
    tds.write_dataset(sample(att), f"{lake}/t", format=fmt,
                      partitioning=["year"], partitioning_flavor="hive",
                      filesystem=tf)
    assert stored(kind, tem) == stored(kind, jem)
    assert infos(tf, tfs.FileSelector(f"{lake}/t", recursive=True)) == \
        infos(jf, jfs.FileSelector(f"{lake}/t", recursive=True))
    want = jds.dataset(f"{lake}/t", format=fmt,
                       partitioning=jds.partitioning(flavor="hive"),
                       filesystem=jf)
    got = tds.dataset(f"{lake}/t", format=fmt,
                      partitioning=tds.partitioning(flavor="hive"),
                      filesystem=tf)
    same(got.to_table(**CPU), want.to_table())
    same(got.to_table(filter=tfield("year") == 2021, **CPU),
         want.to_table(filter=jfield("year") == 2021))
    assert got.to_table(filter=tfield("year") == 2021, **CPU).num_rows == 2
    assert len(list(got.get_fragments(tfield("year") == 2021))) == 1


def test_dataset_equals_its_local_twin(clouds, tmp_path):
    kind, jf, jem, tf, tem = clouds
    lake = LAKE[kind]
    tf.create_dir(lake)
    tds.write_dataset(sample(att), f"{lake}/t2", format="ipc", filesystem=tf)
    tds.write_dataset(sample(att), str(tmp_path / "local"), format="ipc")
    via_cloud = tds.dataset(f"{lake}/t2", format="ipc",
                            filesystem=tf).to_table(**CPU)
    via_local = tds.dataset(str(tmp_path / "local"),
                            format="ipc").to_table(**CPU)
    assert via_cloud.equals(via_local)
    jf.create_dir(lake)
    jds.write_dataset(sample(at), f"{lake}/t2", format="ipc", filesystem=jf)
    assert stored(kind, tem) == stored(kind, jem)


def test_copy_files_to_and_from_a_cloud(clouds, tmp_path):
    kind, jf, jem, tf, tem = clouds
    base = BASE[kind]
    (tmp_path / "src" / "e").mkdir(parents=True)
    (tmp_path / "src" / "a.bin").write_bytes(b"A")
    (tmp_path / "src" / "e" / "b.bin").write_bytes(b"BB")
    for mod, fs in ((jfs, jf), (tfs, tf)):
        fs.create_dir(base)
        mod.copy_files(str(tmp_path / "src"), f"{base}/copy",
                       destination_filesystem=fs)
    assert stored(kind, tem) == stored(kind, jem)
    tfs.copy_files(f"{base}/copy", str(tmp_path / "back"),
                   source_filesystem=tf)
    assert (tmp_path / "back" / "e" / "b.bin").read_bytes() == b"BB"


def test_parquet_and_ipc_readers_over_a_cloud(clouds):
    """The Parquet and IPC readers read a cloud file whole through
    open_input_file (no local path, no map)."""
    from arrow_tpu_torch import ipc
    from arrow_tpu_torch.io import parquet as pq
    kind, _, _, tf, _ = clouds
    base = BASE[kind]
    tf.create_dir(base)
    t = sample(att)
    with tf.open_output_stream(f"{base}/f.parquet") as f:
        pq.write_table(t, f)
    with tf.open_output_stream(f"{base}/f.arrow") as f:
        with ipc.new_file(f, t.schema) as w:
            w.write_table(t)
    assert tf.local_path(f"{base}/f.parquet") is None
    with tf.open_input_file(f"{base}/f.parquet") as f:
        assert pq.read_table(f, **CPU).equals(t)
    with tf.open_input_file(f"{base}/f.arrow") as f:
        assert ipc.open_file(f).read_all().equals(t)


# --- the dataset classes (tests/test_dataset_fs.py TestDatasetCompat) ---------------

def test_in_memory_and_union_datasets():
    for P, D, dev in ((at, jds, {}), (att, tds, CPU)):
        t = P.table({"a": [1, 2, 3]})
        imd = D.InMemoryDataset(t)
        assert imd.to_table(**dev).num_rows == 3
        u = D.UnionDataset(None, [imd, D.InMemoryDataset(t)])
        assert u.to_table(**dev).num_rows == 6


def test_orc_json_and_file_system_datasets(tmp_path):
    for P, D, dev, tag in ((at, jds, {}, "r"), (att, tds, CPU, "p")):
        t = P.table({"a": [1, 2, 3], "s": ["x", "y", None]})
        root = str(tmp_path / f"orc_{tag}")
        D.write_dataset(t, root, format="orc")
        back = D.dataset(root, format="orc").to_table(**dev)
        assert sorted(back.column("a").to_pylist()) == [1, 2, 3]
        jdir = tmp_path / f"json_{tag}"
        jdir.mkdir()
        (jdir / "j.json").write_text('{"a": 1}\n{"a": 2}\n')
        jt = D.dataset(str(jdir), format="json").to_table(**dev)
        assert sorted(jt.column("a").to_pylist()) == [1, 2]
        root = tmp_path / f"fsd_{tag}"
        D.write_dataset(P.table({"a": [1, 2]}), str(root), format="parquet")
        files = [str(p) for p in root.iterdir()]
        fsd = D.FileSystemDataset.from_paths(files, format="parquet")
        assert fsd.files == files and fsd.to_table(**dev).num_rows == 2
    for field, D in ((jfield, jds), (tfield, tds)):
        e = (field("p") == 1) & (field("q") == "x")
        assert D.get_partition_keys(e) == {"p": 1, "q": "x"}


# --- fsspec, PyFileSystem and the names ----------------------------------------------

def test_fsspec_memory_protocol_full_surface():
    pytest.importorskip("fsspec")
    seen = []
    for mod in (jfs, tfs):
        m = mod.FsspecFileSystem.from_uri("memory")
        root = f"/bkt_{mod.__name__.replace('.', '_')}"
        with m.open_output_stream(f"{root}/dir/a.bin") as f:
            f.write(b"hello")
        info = m.get_file_info(f"{root}/dir/a.bin")
        assert info.is_file and info.size == 5
        paths = [i.path.replace(root, "") for i in m.get_file_info(
            mod.FileSelector(root, recursive=True))]
        with m.open_input_stream(f"{root}/dir/a.bin") as f:
            assert f.read() == b"hello"
        m.move(f"{root}/dir/a.bin", f"{root}/dir/b.bin")
        gone = m.get_file_info(f"{root}/dir/a.bin").type
        m.delete_file(f"{root}/dir/b.bin")
        m.create_dir(f"{root}/e")
        m.delete_dir(root)
        seen.append((paths, gone, m.equals(m),
                     m.equals(mod.FsspecFileSystem(m.fs))))
    assert seen[1] == seen[0]
    assert seen[1][1] == "NotFound"


def test_parquet_round_trip_through_fsspec():
    pytest.importorskip("fsspec")
    from arrow_tpu_torch.io.parquet import read_table, write_table
    m = tfs.FsspecFileSystem.from_uri("memory")
    t = att.table({"a": [1, 2, 3], "s": ["x", None, "z"]})
    with m.open_output_stream("/data_port/p.parquet") as f:
        write_table(t, f)
    with m.open_input_stream("/data_port/p.parquet") as f:
        assert read_table(f, **CPU).to_pydict() == t.to_pydict()
    m.delete_dir("/data_port")


@pytest.mark.parametrize("name", ["FsspecS3FileSystem",
                                  "FsspecAzureFileSystem",
                                  "FsspecHadoopFileSystem"])
def test_fsspec_cloud_classes_need_their_drivers(name):
    """Without its driver (or the driver's native library) each raises
    when made, as the reference's does: ImportError for s3fs and adlfs,
    absent here and on the card's machine."""
    pytest.importorskip("fsspec")
    for mod in (jfs, tfs):
        cls = getattr(mod, name)
        assert issubclass(cls, mod.FsspecFileSystem) and cls.__name__ == name
    with pytest.raises(Exception) as want:
        getattr(jfs, name)()
    with pytest.raises(builtin_class(want.value)):
        getattr(tfs, name)()


def test_fsspec_gcs_class():
    pytest.importorskip("gcsfs")
    assert tfs.FsspecGcsFileSystem(token="anon") is not None


class _DictHandler(tfs.FileSystemHandler):
    """A handler over a dict, without fsspec."""

    def __init__(self):
        self.files = {}

    def get_type_name(self):
        return "dict"

    def get_file_info(self, paths):
        return [tfs.FileInfo(p, tfs.FileType.File, len(self.files[p]))
                if p in self.files else tfs.FileInfo(p, tfs.FileType.NotFound)
                for p in paths]

    def open_input_stream(self, path):
        import io
        return io.BytesIO(self.files[path])

    def open_output_stream(self, path, metadata=None):
        import io
        files = self.files

        class _Sink(io.BytesIO):
            def close(self):
                files[path] = self.getvalue()
                super().close()
        return _Sink()

    def create_dir(self, path, recursive=True):
        pass

    def delete_file(self, path):
        del self.files[path]


def test_py_file_system_over_a_handler():
    fs = tfs.PyFileSystem(_DictHandler())
    assert fs.type_name == "dict"
    with fs.open_output_stream("t/f.bin") as f:
        f.write(b"abc")
    assert fs.open_input_stream("t/f.bin").read() == b"abc"
    assert fs.open_input_file("t/f.bin").read() == b"abc"
    assert fs.get_file_info("t/f.bin").size == 3
    assert [i.type for i in fs.get_file_info(["t/f.bin", "no"])] == \
        ["File", "NotFound"]
    assert fs.files == {"t/f.bin": b"abc"}  # the handler's, through getattr
    fs.delete_file("t/f.bin")
    assert fs.get_file_info("t/f.bin").type == "NotFound"
    base = tfs.FileSystemHandler()
    for name in ("get_type_name", "get_file_info", "open_input_stream",
                 "open_output_stream"):
        with pytest.raises(NotImplementedError):
            getattr(base, name)(*(["x"] if name != "get_type_name" else []))


def test_py_file_system_over_fsspec():
    fsspec = pytest.importorskip("fsspec")
    got = []
    for mod in (jfs, tfs):
        pyfs = mod.PyFileSystem(mod.FSSpecHandler(
            fsspec.filesystem("memory")))
        path = f"/t_{mod.__name__.replace('.', '_')}/f.bin"
        with pyfs.open_output_stream(path) as f:
            f.write(b"abc")
        info = pyfs.get_file_info(path)
        got.append((pyfs.open_input_stream(path).read(), info.type,
                    info.size, pyfs.type_name,
                    pyfs.get_file_info(path + "x").type))
        pyfs.delete_file(path)
    assert got[1] == got[0]


def test_s3_helpers_and_names():
    for mod in (jfs, tfs):
        mod.initialize_s3(mod.S3LogLevel.Warn)
        mod.ensure_s3_initialized()
        mod.finalize_s3()
        mod.ensure_s3_finalized()
        with pytest.raises(OSError):
            mod.resolve_s3_region("bucket")
        assert mod.FileStats is mod.FileInfo
    assert [getattr(tfs.S3LogLevel, n) for n in
            ("Off", "Fatal", "Error", "Warn", "Info", "Debug", "Trace")] == \
        list(range(7))
    for cls in ("S3RetryStrategy", "AwsStandardS3RetryStrategy",
                "AwsDefaultS3RetryStrategy"):
        s = getattr(tfs, cls)(5)
        assert s.max_attempts == 5 == getattr(jfs, cls)(5).max_attempts
        assert getattr(tfs, cls)().max_attempts == 3
    assert tfs.S3FileSystem.__module__ == "arrow_tpu_torch.fs_s3"
    assert tfs.GcsFileSystem.__module__ == "arrow_tpu_torch.fs_gcs"
    assert tfs.AzureFileSystem.__module__ == "arrow_tpu_torch.fs_azure"
    assert tfs.HadoopFileSystem.__module__ == "arrow_tpu_torch.fs_hdfs"
    assert {"S3FileSystem", "HadoopFileSystem"} <= set(dir(tfs))
    with pytest.raises(AttributeError):
        tfs.NoSuchFileSystem


@pytest.mark.parametrize("kind", KINDS)
def test_clients_equal_and_from_uri(kind):
    with _EMULATORS[kind]() as em:
        a, b = _client(tfs, kind, em), _client(tfs, kind, em)
        assert a.equals(b) and not a.equals(tfs.LocalFileSystem())
    if kind == "hdfs":
        fs = tfs.HadoopFileSystem.from_uri("hdfs://me@nn:9871/x")
        want = jfs.HadoopFileSystem.from_uri("hdfs://me@nn:9871/x")
        assert (fs.endpoint, fs.user) == (want.endpoint, want.user)
    if kind == "s3":
        assert tfs.S3FileSystem(region="eu-west-1").endpoint == \
            jfs.S3FileSystem(region="eu-west-1").endpoint


# --- chip_smoke.py's phase 3r on the CPU ----------------------------------------

def test_chip_smoke_phase_3r_on_cpu():
    """Phase 3r at SF 0.005 on the CPU: every path runs and holds its
    checks (the launch counts are the card's alone)."""
    import chip_smoke
    _, host = chip_smoke.phase_host(sf=0.005, device="cpu")
    launches, facts = chip_smoke.phase_host_surface(host, device="cpu")
    assert launches == {}
    assert set(chip_smoke.HOST_SURFACE_LAUNCHES) <= set(facts["walls"])
    assert facts["facts"]["s3 GB"] > 0 and facts["facts"]["hdfs GB"] > 0
