"""File systems, streams, codecs and Feather in the port (``fs.py``,
``io_streams.py``, ``utils/lz4frame.py`` with its built library,
``feather.py``, ``io/feather_v1.py``) against the JAX package's, with
pyarrow as an oracle only.

* ``tests/test_dataset_fs.py``'s local, mock and subtree cases, and
  ``copy_files`` between them; the fsspec and cloud names made or called
  as the reference's are (``tests/test_torch_cloud_fs.py`` drives them
  against the emulators);
* the streams and ``Codec``: the codecs' bytes equal the reference's
  (gzip's header holds a time, so its round trips are compared);
* ``tests/test_io_interop.py``'s LZ4 frame vectors (:172), its LZ4 IPC
  interop (:148) and Feather V1 both ways (:122), byte for byte beside
  the reference's writers, and pyarrow's LZ4 frames read by the port;
* a mapped read copies no body byte: every Buffer lies in the map.

Exact throughout.
"""

import io
import mmap
import os
import warnings

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu import feather as rfeather
from arrow_tpu import fs as rfs
from arrow_tpu import io_streams as rio
from arrow_tpu import ipc as rip
from arrow_tpu.utils import lz4frame as rlz4
from arrow_tpu_torch import feather, fs, io_streams, ipc
from arrow_tpu_torch.buffer import Buffer
from arrow_tpu_torch.fs import (FileSelector, FileType, LocalFileSystem,
                                MockFileSystem, SubTreeFileSystem)
from arrow_tpu_torch.utils import lz4frame

from test_torch_host_table import carry_table
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401


# --- file systems (tests/test_dataset_fs.py:16-61) -----------------------------

def test_local_fs(tmp_path):
    local = LocalFileSystem()
    p = str(tmp_path / "a" / "f.bin")
    with local.open_output_stream(p) as f:
        f.write(b"hello")
    info = local.get_file_info(p)
    assert info.is_file and info.size == 5 and info.base_name == "f.bin"
    with local.open_input_stream(p) as f:
        assert f.read() == b"hello"
    for recursive in (True, False):
        sel = FileSelector(str(tmp_path), recursive=recursive)
        got = [(i.path, i.type, i.size) for i in local.get_file_info(sel)]
        want = [(i.path, i.type, i.size) for i in
                rfs.LocalFileSystem().get_file_info(rfs.FileSelector(
                    str(tmp_path), recursive=recursive))]
        assert got == want
    assert any(i.path.endswith("f.bin") for i in local.get_file_info(
        FileSelector(str(tmp_path), recursive=True)))
    assert local.get_file_info(str(tmp_path)).type == FileType.Directory
    assert local.local_path(p) == p
    local.move(p, str(tmp_path / "g.bin"))
    local.delete_file(str(tmp_path / "g.bin"))
    assert local.get_file_info(p).type == FileType.NotFound
    assert local.get_file_info(FileSelector(str(tmp_path / "no"),
                                            allow_not_found=True)) == []
    with pytest.raises(FileNotFoundError):
        local.get_file_info(FileSelector(str(tmp_path / "no")))
    local.create_dir(str(tmp_path / "d" / "e"))
    local.delete_dir(str(tmp_path / "d"))
    assert not (tmp_path / "d").exists()


def test_mock_fs():
    m = MockFileSystem()
    with m.open_output_stream("dir/x.txt") as f:
        f.write(b"abc")
    assert m.get_file_info("dir/x.txt").size == 3
    assert m.get_file_info("dir").type == FileType.Directory
    with m.open_input_stream("dir/x.txt") as f:
        assert f.read() == b"abc"
    infos = m.get_file_info(FileSelector("dir"))
    assert [i.path for i in infos if i.is_file] == ["dir/x.txt"]
    m.move("dir/x.txt", "y.txt")
    assert m.get_file_info("dir/x.txt").type == FileType.NotFound
    assert m.get_file_info("y.txt").is_file
    assert m.local_path("y.txt") is None
    with pytest.raises(FileNotFoundError):
        m.open_input_stream("nope")


def test_subtree_fs(tmp_path):
    sub = SubTreeFileSystem(str(tmp_path), LocalFileSystem())
    with sub.open_output_stream("inner/f.txt") as f:
        f.write(b"z")
    assert (tmp_path / "inner" / "f.txt").exists()
    assert sub.get_file_info("inner/f.txt").is_file
    assert sub.local_path("inner/f.txt") == str(tmp_path / "inner" /
                                                "f.txt")
    sel = sub.get_file_info(FileSelector("inner"))
    assert [i.base_name for i in sel] == ["f.txt"]
    mock_sub = SubTreeFileSystem("root", MockFileSystem())
    with mock_sub.open_output_stream("a/b.bin") as f:
        f.write(b"xy")
    assert mock_sub.base_fs.get_file_info("root/a/b.bin").size == 2


def test_copy_files_between_file_systems(tmp_path):
    m = MockFileSystem()
    for name in ("d/a.bin", "d/e/b.bin"):
        with m.open_output_stream(name) as f:
            f.write(name.encode())
    fs.copy_files("d", str(tmp_path / "out"), source_filesystem=m)
    assert (tmp_path / "out" / "e" / "b.bin").read_bytes() == b"d/e/b.bin"
    back = MockFileSystem()
    fs.copy_files(str(tmp_path / "out" / "a.bin"), "c.bin",
                  destination_filesystem=back)
    assert back.files == {"c.bin": b"d/a.bin"}


@pytest.mark.parametrize("name", [
    "FsspecFileSystem", "FsspecS3FileSystem", "FsspecGcsFileSystem",
    "FsspecAzureFileSystem", "FsspecHadoopFileSystem", "S3FileSystem",
    "GcsFileSystem", "AzureFileSystem", "HadoopFileSystem", "PyFileSystem",
    "FSSpecHandler", "initialize_s3", "resolve_s3_region"])
def test_the_fsspec_and_cloud_file_systems_raise(name):
    """Each name made or called with no arguments, as the reference's: the
    same error class where it raises (a missing argument, a missing fsspec
    driver), else an object of the same class name with the same
    endpoint."""
    try:
        want = getattr(rfs, name)()
    except Exception as exc:  # noqa: BLE001 - the class is compared
        base = next(c for c in type(exc).__mro__
                    if c.__module__ == "builtins")
        with pytest.raises(base):
            getattr(fs, name)()
        return
    got = getattr(fs, name)()
    assert type(got).__name__ == type(want).__name__
    assert getattr(got, "endpoint", None) == getattr(want, "endpoint", None)


# --- streams and codecs ----------------------------------------------------------

def test_buffer_streams():
    r = io_streams.BufferReader(Buffer(b"abcdef"))
    assert r.size() == 6 and r.read(2) == b"ab"
    assert r.read_buffer(3).to_pybytes() == b"cde"
    out = io_streams.BufferOutputStream()
    out.write(b"xyz")
    assert out.finish().to_pybytes() == b"xyz"
    mock = io_streams.MockOutputStream()
    mock.write(b"1234")
    mock.write(np.zeros(3, np.int64))
    assert mock.size() == mock.tell() == 28
    assert io_streams.py_buffer(b"qq").to_pybytes() == b"qq"
    raw = np.arange(8, dtype=np.uint8)
    fb_ = io_streams.foreign_buffer(raw.ctypes.data, 8, base=raw)
    assert fb_.to_pybytes() == raw.tobytes()
    target = io_streams.ResizableBuffer(b"\x00" * 4)
    w = io_streams.FixedSizeBufferWriter(target)
    w.write(b"ab")
    assert target.to_pybytes() == b"ab\x00\x00"
    with pytest.raises(io_streams.ArrowInvalid):
        w.write(b"xyz")
    target.resize(6)
    assert target.to_pybytes() == b"ab\x00\x00\x00\x00"
    t = io_streams.TransformInputStream(io.BytesIO(b"ab"), bytes.upper)
    assert t.read() == b"AB"
    s = io_streams.transcoding_input_stream(
        io.BytesIO("é".encode("latin-1")), "latin-1", "utf-8")
    assert s.read() == "é".encode()
    b = io_streams.BufferedInputStream(io.BytesIO(b"buffered"))
    assert b.read() == b"buffered"
    o = io_streams.BufferedOutputStream(io.BytesIO())
    o.write(b"x")
    assert isinstance(o, io_streams.NativeFile)


def test_os_file_and_memory_map(tmp_path):
    p = str(tmp_path / "m.bin")
    with io_streams.OSFile(p, "w") as f:
        f.write(b"0123456789")
    m = io_streams.memory_map(p)
    assert m.size() == 10 and m.read(3) == b"012"
    buf = m.read_buffer(4)
    assert buf.to_pybytes() == b"3456" and m.tell() == 7
    assert not buf.to_numpy().flags.writeable
    owner = buf.to_numpy()
    while isinstance(owner, (np.ndarray, memoryview)):
        owner = owner.base if isinstance(owner, np.ndarray) else owner.obj
    assert isinstance(owner, mmap.mmap)
    assert m.read_buffer().to_pybytes() == b"789"
    m.close()
    assert m.closed and buf.to_pybytes() == b"3456"  # the map outlives it
    c = io_streams.create_memory_map(str(tmp_path / "c.bin"), 4)
    c.write(b"wxyz")
    c.close()
    assert (tmp_path / "c.bin").read_bytes() == b"wxyz"


@pytest.mark.parametrize("codec", ["lz4", "lz4_frame", "zstd", "bz2"])
def test_codec_bytes_equal_the_reference(codec):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    rng = np.random.default_rng(3)
    data = rng.integers(0, 8, 300_000, dtype=np.uint8).tobytes()
    c = io_streams.Codec(codec)
    comp = c.compress(data)
    assert comp == rio.Codec(codec).compress(data)
    assert c.decompress(comp, len(data)) == data
    assert io_streams.compress(Buffer(data), codec).to_pybytes() == comp
    assert io_streams.decompress(comp, len(data), codec,
                                 asbytes=True) == data


def test_gzip_and_compressed_streams(tmp_path):
    data = b"compress me " * 1000
    c = io_streams.Codec("gzip")
    assert c.decompress(c.compress(data)) == data
    assert rio.Codec("gzip").decompress(c.compress(data)) == data
    p = str(tmp_path / "x.gz")
    with io_streams.output_stream(p, compression="gzip") as f:
        f.write(data)
    assert io_streams.input_stream(p).read() == data  # .gz found by name
    for codec in ("lz4", "bz2"):
        p = str(tmp_path / f"x.{codec}")
        with io_streams.CompressedOutputStream(p, codec) as f:
            f.write(data)
        with open(p, "rb") as f:
            assert f.read() == rio.Codec(codec).compress(data)
        assert io_streams.CompressedInputStream(p, codec).read() == data
    assert io_streams.input_stream(b"raw").read() == b"raw"


def test_codec_availability():
    """lz4, snappy (the port's host libraries) and brotli (the system
    libbrotli, here as in the reference) are available, and snappy and
    brotli give the reference's bytes and read them back."""
    assert io_streams.Codec.is_available("lz4")
    assert not io_streams.Codec.is_available("nope")
    data = np.random.default_rng(3).integers(0, 8, 5000).astype(
        np.uint8).tobytes() * 3
    for name in ("snappy", "brotli"):
        assert io_streams.Codec.is_available(name) == \
            rio.Codec.is_available(name)
        assert io_streams.Codec.is_available(name)
        packed = io_streams.Codec(name).compress(data)
        assert packed == rio.Codec(name).compress(data)
        assert io_streams.Codec(name).decompress(packed, len(data)) == data
        assert rio.Codec(name).decompress(packed, len(data)) == data
    with pytest.raises(io_streams.ArrowInvalid):
        io_streams.Codec("nope")


# --- LZ4 (tests/test_io_interop.py:148,172) ---------------------------------------

def test_lz4_frame_codec_vectors():
    assert lz4frame.xxhash32(b"") == 0x02CC5D05
    assert lz4frame.xxhash32(b"abc") == 0x32D153FF
    blob = bytes(range(256)) * 3
    assert lz4frame.xxhash32(blob, 7) == rlz4.xxhash32(blob, 7)
    rng = np.random.default_rng(1)
    for c in (b"", b"q", b"ab" * 9000,
              bytes(rng.integers(0, 256, 70000, dtype=np.uint8)),
              rng.integers(0, 3, 9_000_001, dtype=np.uint8).tobytes()):
        comp = lz4frame.compress(c)
        assert comp == rlz4.compress(c)
        assert lz4frame.decompress(comp, len(c)) == c
        assert lz4frame.decompress(comp) == c
        assert rlz4.decompress(comp) == c
    with pytest.raises(ValueError):
        lz4frame.decompress(b"\x00" * 16)


def test_pyarrow_lz4_frames():
    data = (b"pyarrow frames " * 400_000)[:5_000_000]
    theirs = pa.compress(data, codec="lz4", asbytes=True)
    assert lz4frame.decompress(theirs) == data
    assert pa.decompress(lz4frame.compress(data), len(data), codec="lz4",
                         asbytes=True) == data


def test_lz4_ipc_interop():
    rt = at.table({"a": list(range(5000)),
                   "s": ["val" + str(i % 50) for i in range(5000)]})
    pt = carry_table(rt)
    buf = io.BytesIO()
    with ipc.new_file(buf, pt.schema, codec="lz4") as w:
        w.write_table(pt)
    rbuf = io.BytesIO()
    with rip.new_file(rbuf, rt.schema, codec="lz4") as w:
        w.write_table(rt)
    assert buf.getvalue() == rbuf.getvalue()
    assert ipc.open_file(buf.getvalue()).read_all().to_pydict() == \
        rt.to_pydict()
    buf.seek(0)
    assert pa.ipc.open_file(buf).read_all().to_pydict() == rt.to_pydict()
    pb = io.BytesIO()
    with pa.ipc.new_file(pb, pa.schema([("a", pa.int64()),
                                        ("s", pa.string())]),
                         options=pa.ipc.IpcWriteOptions(
                             compression="lz4")) as w:
        w.write_table(pa.table(rt.to_pydict()))
    assert ipc.open_file(pb.getvalue()).read_all().to_pydict() == \
        rt.to_pydict()


# --- Feather (tests/test_io_interop.py:122) --------------------------------------

V1_DATA = {"a": [1, 2, None], "s": ["x", None, "zz"], "f": [1.5, 2.5, 3.5],
           "b": [True, False, None]}


def _v1_table():
    return at.table(V1_DATA, schema=at.schema([
        at.field("a", at.int64()), at.field("s", at.string()),
        at.field("f", at.float64()), at.field("b", at.bool_())]))


def test_feather_v1_both_directions(tmp_path):
    import pyarrow.feather as pf
    warnings.filterwarnings("ignore", category=FutureWarning)
    rt = _v1_table()
    p, r = str(tmp_path / "p.feather"), str(tmp_path / "r.feather")
    feather.write_feather(carry_table(rt), p, version=1)
    rfeather.write_feather(rt, r, version=1)
    assert open(p, "rb").read() == open(r, "rb").read()
    assert pf.read_table(p).to_pydict() == V1_DATA
    assert feather.read_feather(p).to_pydict() == V1_DATA
    assert feather.read_table(p, columns=["s", "a"]).to_pydict() == \
        {"s": V1_DATA["s"], "a": V1_DATA["a"]}
    pf.write_feather(pa.table(V1_DATA, schema=pa.schema(
        [("a", pa.int64()), ("s", pa.string()), ("f", pa.float64()),
         ("b", pa.bool_())])), p, version=1)
    assert feather.read_feather(p).to_pydict() == V1_DATA
    with pytest.raises(ValueError):
        feather.write_feather(carry_table(rt), p, version=1,
                              compression="lz4")
    with pytest.raises(NotImplementedError):
        feather.write_feather(carry_table(at.table({"d": at.array(
            [1], at.date32())})), p, version=1)


@pytest.mark.parametrize("compression", [None, "lz4", "zstd"])
def test_feather_v2_equals_the_reference(tmp_path, compression):
    if compression == "zstd":
        pytest.importorskip("zstandard")
    import pyarrow.feather as pf
    rt = at.table({"x": list(range(1000)), "s": [f"v{i % 7}" for i in
                                                 range(1000)],
                   "d": at.array([["a", "b"][i % 2] for i in range(1000)],
                                 at.dictionary(at.int32(), at.string()))})
    p, r = str(tmp_path / "p.feather"), str(tmp_path / "r.feather")
    feather.write_feather(carry_table(rt), p, compression=compression)
    rfeather.write_feather(rt, r, compression=compression)
    assert open(p, "rb").read() == open(r, "rb").read()
    assert feather.read_feather(r).to_pydict() == rt.to_pydict()
    assert feather.read_table(p, columns=["d"]).to_pydict() == \
        {"d": rt.to_pydict()["d"]}
    assert pa.ipc.open_file(p).read_all().to_pydict() == rt.to_pydict()
    feather.write_feather(carry_table(rt), p, chunksize=300)
    assert pa.ipc.open_file(p).num_record_batches == 4
    ds = feather.FeatherDataset([p, r]).read_table()
    assert ds.num_rows == 2000 and ds.columns[0].num_chunks == 5
    warnings.filterwarnings("ignore", category=FutureWarning)
    assert pf.read_table(r).num_rows == 1000


# --- a mapped read copies no body byte -------------------------------------------

def test_a_mapped_read_copies_no_body_byte(tmp_path):
    rt = at.table({"i": list(range(1000)), "f": [i / 3 for i in range(1000)],
                   "s": [None if i % 9 == 0 else f"s{i}" for i in
                         range(1000)]})
    p = str(tmp_path / "t.arrow")
    with open(p, "wb") as f:
        with ipc.new_file(f, carry_table(rt).schema) as w:
            w.write_table(carry_table(rt), 300)
    m = io_streams.memory_map(p)
    got = ipc.open_file(m).read_all()
    lo = m.mapped().ctypes.data
    hi = lo + m.size()
    assert got.to_pydict() == rt.to_pydict()
    for col in got.columns:
        for chunk in col.chunks:
            for buf in chunk.data.buffers:
                if buf is not None:
                    assert lo <= buf.to_numpy().ctypes.data < hi
    m.close()
    # Feather by path maps the file the same way
    tbl = feather.read_table(p)
    owner = tbl.column("f").chunks[0].data.buffers[1].to_numpy()
    while isinstance(owner, (np.ndarray, memoryview)):
        owner = owner.base if isinstance(owner, np.ndarray) else owner.obj
    assert isinstance(owner, mmap.mmap)
    os.remove(p)  # the map outlives the name
    assert tbl.to_pydict() == rt.to_pydict()
