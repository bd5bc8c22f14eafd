"""File systems (counterpart of ``arrow_tpu/fs.py``; reference:
cpp/src/arrow/filesystem/filesystem.h): ``FileInfo`` and ``FileSelector``,
the ``FileSystem`` interface, ``LocalFileSystem``, ``SubTreeFileSystem``,
the in-memory ``MockFileSystem`` (filesystem/mockfs.h) and ``copy_files``;
``FsspecFileSystem`` and ``PyFileSystem`` over a ``FileSystemHandler``
(``FSSpecHandler``), which need the ``fsspec`` package when they are made;
and the cloud file systems, REST clients on the standard library alone:
``S3FileSystem`` (SigV4), ``GcsFileSystem`` (a bearer token),
``AzureFileSystem`` (SharedKey) and ``HadoopFileSystem`` (WebHDFS), in
``fs_s3.py``, ``fs_gcs.py``, ``fs_azure.py`` and ``fs_hdfs.py``. A cloud
file system keeps no local path: the readers read its files whole
through ``open_input_stream``/``open_input_file``.
"""

from __future__ import annotations

import io
import os
import posixpath
import shutil
from typing import Dict, List, Optional

class FileType:
    NotFound = "NotFound"
    File = "File"
    Directory = "Directory"


class FileInfo:
    __slots__ = ("path", "type", "size", "mtime")

    def __init__(self, path: str, type: str, size: int = -1, mtime=None):
        self.path = path
        self.type = type
        self.size = size
        self.mtime = mtime

    @property
    def base_name(self) -> str:
        return posixpath.basename(self.path)

    @property
    def is_file(self) -> bool:
        return self.type == FileType.File

    def __repr__(self):
        return f"FileInfo({self.path!r}, {self.type}, size={self.size})"


FileStats = FileInfo  # the deprecated pyarrow name


class FileSelector:
    def __init__(self, base_dir: str, recursive: bool = False,
                 allow_not_found: bool = False):
        self.base_dir = base_dir
        self.recursive = recursive
        self.allow_not_found = allow_not_found


class FileSystem:
    def get_file_info(self, path_or_selector):
        raise NotImplementedError

    def open_input_stream(self, path: str):
        raise NotImplementedError

    def open_input_file(self, path: str):
        return self.open_input_stream(path)

    def open_output_stream(self, path: str):
        raise NotImplementedError

    def create_dir(self, path: str, recursive: bool = True):
        raise NotImplementedError

    def delete_dir(self, path: str):
        raise NotImplementedError

    def delete_file(self, path: str):
        raise NotImplementedError

    def move(self, src: str, dest: str):
        raise NotImplementedError

    def equals(self, other) -> bool:
        return self is other

    def local_path(self, path: str) -> Optional[str]:
        """The operating system's path of ``path`` where this file system
        keeps it on a local disk (a file the readers can map), else
        None."""
        return None


def _local_info(p: str) -> FileInfo:
    if os.path.isdir(p):
        return FileInfo(p, FileType.Directory)
    return FileInfo(p, FileType.File, os.path.getsize(p),
                    os.path.getmtime(p))


class LocalFileSystem(FileSystem):
    def get_file_info(self, path_or_selector):
        if isinstance(path_or_selector, FileSelector):
            sel = path_or_selector
            out: List[FileInfo] = []
            if not os.path.isdir(sel.base_dir):
                if sel.allow_not_found:
                    return out
                raise FileNotFoundError(sel.base_dir)
            if sel.recursive:
                for root, dirs, files in os.walk(sel.base_dir):
                    out.extend(FileInfo(os.path.join(root, d),
                                        FileType.Directory) for d in dirs)
                    out.extend(_local_info(os.path.join(root, f))
                               for f in files)
            else:
                out = [_local_info(os.path.join(sel.base_dir, name))
                       for name in os.listdir(sel.base_dir)]
            return sorted(out, key=lambda i: i.path)
        p = path_or_selector
        if os.path.isdir(p) or os.path.isfile(p):
            return _local_info(p)
        return FileInfo(p, FileType.NotFound)

    def open_input_stream(self, path: str):
        return open(path, "rb")

    def open_output_stream(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return open(path, "wb")

    def create_dir(self, path: str, recursive: bool = True):
        os.makedirs(path, exist_ok=True)

    def delete_dir(self, path: str):
        shutil.rmtree(path)

    def delete_file(self, path: str):
        os.remove(path)

    def move(self, src: str, dest: str):
        shutil.move(src, dest)

    def local_path(self, path: str) -> Optional[str]:
        return path


class MockFileSystem(FileSystem):
    """An in-memory file system (filesystem/mockfs.h)."""

    def __init__(self):
        self.files: Dict[str, bytes] = {}
        self.dirs = {""}

    def _norm(self, p: str) -> str:
        return p.strip("/")

    def get_file_info(self, path_or_selector):
        if isinstance(path_or_selector, FileSelector):
            sel = path_or_selector
            base = self._norm(sel.base_dir)
            out = []
            seen_dirs = set()
            for p, data in sorted(self.files.items()):
                if base and not p.startswith(base + "/"):
                    continue
                rel = p[len(base) + 1:] if base else p
                if "/" in rel:
                    d = rel.split("/")[0]
                    full_d = posixpath.join(base, d) if base else d
                    if full_d not in seen_dirs:
                        seen_dirs.add(full_d)
                        out.append(FileInfo(full_d, FileType.Directory))
                    if not sel.recursive:
                        continue
                out.append(FileInfo(p, FileType.File, len(data)))
            return sorted(out, key=lambda i: i.path)
        p = self._norm(path_or_selector)
        if p in self.files:
            return FileInfo(p, FileType.File, len(self.files[p]))
        if p in self.dirs or any(f.startswith(p + "/") for f in self.files):
            return FileInfo(p, FileType.Directory)
        return FileInfo(p, FileType.NotFound)

    def open_input_stream(self, path: str):
        p = self._norm(path)
        if p not in self.files:
            raise FileNotFoundError(path)
        return io.BytesIO(self.files[p])

    def open_output_stream(self, path: str):
        fs = self
        p = self._norm(path)

        class _Sink(io.BytesIO):
            def close(self):
                fs.files[p] = self.getvalue()
                super().close()

            def __exit__(self, *exc):
                self.close()
        return _Sink()

    def create_dir(self, path: str, recursive: bool = True):
        self.dirs.add(self._norm(path))

    def delete_dir(self, path: str):
        p = self._norm(path)
        self.dirs.discard(p)
        for f in [f for f in self.files if f.startswith(p + "/")]:
            del self.files[f]

    def delete_file(self, path: str):
        del self.files[self._norm(path)]

    def move(self, src: str, dest: str):
        self.files[self._norm(dest)] = self.files.pop(self._norm(src))


class SubTreeFileSystem(FileSystem):
    """Another file system re-rooted at a prefix (filesystem.h
    SubTreeFileSystem)."""

    def __init__(self, base_path: str, base_fs: FileSystem):
        self.base_path = base_path.rstrip("/")
        self.base_fs = base_fs

    def _full(self, p: str) -> str:
        return posixpath.join(self.base_path, p.lstrip("/"))

    def get_file_info(self, path_or_selector):
        if isinstance(path_or_selector, FileSelector):
            sel = FileSelector(self._full(path_or_selector.base_dir),
                               path_or_selector.recursive,
                               path_or_selector.allow_not_found)
            return self.base_fs.get_file_info(sel)
        return self.base_fs.get_file_info(self._full(path_or_selector))

    def open_input_stream(self, path):
        return self.base_fs.open_input_stream(self._full(path))

    def open_output_stream(self, path):
        return self.base_fs.open_output_stream(self._full(path))

    def create_dir(self, path, recursive=True):
        return self.base_fs.create_dir(self._full(path), recursive)

    def delete_dir(self, path):
        return self.base_fs.delete_dir(self._full(path))

    def delete_file(self, path):
        return self.base_fs.delete_file(self._full(path))

    def local_path(self, path: str) -> Optional[str]:
        return self.base_fs.local_path(self._full(path))


def copy_files(source, destination, source_filesystem=None,
               destination_filesystem=None, chunk_size=1024 * 1024,
               use_threads=True):
    """Copy a file or a directory's files between file systems
    (pyarrow.fs.copy_files)."""
    src_fs = source_filesystem or LocalFileSystem()
    dst_fs = destination_filesystem or LocalFileSystem()
    info = src_fs.get_file_info(source)
    if isinstance(info, list):
        info = info[0]
    if info.type == FileType.Directory:
        pairs = []
        for fi in src_fs.get_file_info(FileSelector(source, recursive=True)):
            if fi.type != FileType.File:
                continue
            rel = fi.path[len(source):].lstrip("/")
            dst = f"{destination}/{rel}"
            try:
                dst_fs.create_dir(dst.rsplit("/", 1)[0], recursive=True)
            except Exception:
                pass
            pairs.append((fi.path, dst))
    else:
        pairs = [(source, destination)]
    for src, dst in pairs:
        with src_fs.open_input_stream(src) as r, \
                dst_fs.open_output_stream(dst) as w:
            w.write(r.read())


class FsspecFileSystem(FileSystem):
    """Any fsspec file system through this interface (pyarrow's
    PyFileSystem over FSSpecHandler): fsspec's memory, local, http and
    other protocols, and s3, gcs, abfs and hdfs where their drivers are
    installed."""

    def __init__(self, fs):
        self.fs = fs

    @classmethod
    def from_uri(cls, protocol: str, **storage_options):
        import fsspec
        return cls(fsspec.filesystem(protocol, **storage_options))

    def _info(self, raw) -> FileInfo:
        t = FileType.Directory if raw.get("type") == "directory" \
            else FileType.File
        return FileInfo(raw["name"], t, raw.get("size") or -1)

    def get_file_info(self, path_or_selector):
        if isinstance(path_or_selector, FileSelector):
            sel = path_or_selector
            try:
                raws = self.fs.ls(sel.base_dir, detail=True)
            except FileNotFoundError:
                if sel.allow_not_found:
                    return []
                raise
            out = [self._info(r) for r in raws]
            if sel.recursive:
                for r in list(raws):
                    if r.get("type") == "directory":
                        out.extend(self.get_file_info(
                            FileSelector(r["name"], True, True)))
            return out
        path = path_or_selector
        if not self.fs.exists(path):
            return FileInfo(path, FileType.NotFound)
        return self._info(self.fs.info(path))

    def open_input_stream(self, path: str):
        return self.fs.open(path, "rb")

    open_input_file = open_input_stream

    def open_output_stream(self, path: str):
        return self.fs.open(path, "wb")

    def create_dir(self, path: str, recursive: bool = True):
        self.fs.makedirs(path, exist_ok=True)

    def delete_dir(self, path: str):
        self.fs.rm(path, recursive=True)

    def delete_file(self, path: str):
        self.fs.rm_file(path) if hasattr(self.fs, "rm_file") \
            else self.fs.rm(path)

    def move(self, src: str, dest: str):
        self.fs.mv(src, dest)

    def equals(self, other) -> bool:
        return isinstance(other, FsspecFileSystem) and \
            self.fs == other.fs


def _fsspec_backed(protocol: str, doc_name: str):
    class _Cloud(FsspecFileSystem):
        __doc__ = (f"{doc_name} via fsspec (reference: "
                   f"filesystem/{protocol}fs.h). Requires the fsspec "
                   f"{protocol} driver package at construction time.")

        def __init__(self, **storage_options):
            import fsspec
            super().__init__(fsspec.filesystem(protocol,
                                               **storage_options))
    _Cloud.__name__ = doc_name
    return _Cloud


FsspecS3FileSystem = _fsspec_backed("s3", "FsspecS3FileSystem")
FsspecGcsFileSystem = _fsspec_backed("gcs", "FsspecGcsFileSystem")
FsspecAzureFileSystem = _fsspec_backed("abfs", "FsspecAzureFileSystem")
FsspecHadoopFileSystem = _fsspec_backed("hdfs", "FsspecHadoopFileSystem")

# the REST clients are the cloud file systems (reference:
# filesystem/s3fs.h, gcsfs.h, azurefs.h, hdfs.h), resolved when first
# named, since their modules import this one
_NATIVE_FS = {"S3FileSystem": "fs_s3", "GcsFileSystem": "fs_gcs",
              "AzureFileSystem": "fs_azure",
              "HadoopFileSystem": "fs_hdfs"}


def __getattr__(name):
    mod = _NATIVE_FS.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f".{mod}", __package__),
                   name)


def __dir__():
    return sorted(list(globals()) + list(_NATIVE_FS))


class FileSystemHandler:
    """Abstract handler backing PyFileSystem (python/pyarrow/fs.py).
    Subclasses implement the filesystem primitives."""

    def get_type_name(self):
        raise NotImplementedError

    def get_file_info(self, paths):
        raise NotImplementedError

    def open_input_stream(self, path):
        raise NotImplementedError

    def open_output_stream(self, path, metadata=None):
        raise NotImplementedError


class PyFileSystem(FileSystem):
    """FileSystem over a python FileSystemHandler (pyarrow
    PyFileSystem)."""

    def __init__(self, handler):
        self.handler = handler

    @property
    def type_name(self):
        return self.handler.get_type_name()

    def get_file_info(self, paths):
        single = isinstance(paths, str)
        infos = self.handler.get_file_info(
            [paths] if single else list(paths))
        return infos[0] if single else infos

    def open_input_stream(self, path):
        return self.handler.open_input_stream(path)

    def open_input_file(self, path):
        return self.handler.open_input_stream(path)

    def open_output_stream(self, path, metadata=None):
        return self.handler.open_output_stream(path, metadata)

    def create_dir(self, path, recursive=True):
        return self.handler.create_dir(path, recursive)

    def delete_file(self, path):
        return self.handler.delete_file(path)

    def __getattr__(self, name):
        return getattr(self.handler, name)


class FSSpecHandler(FileSystemHandler):
    """Handler adapting an fsspec filesystem (pyarrow FSSpecHandler)."""

    def __init__(self, fs):
        self.fs = fs

    def get_type_name(self):
        return f"fsspec+{getattr(self.fs, 'protocol', '?')}"

    def get_file_info(self, paths):
        out = []
        for p in paths:
            try:
                info = self.fs.info(p)
                ftype = FileType.Directory if info.get("type") == \
                    "directory" else FileType.File
                out.append(FileInfo(p, ftype,
                                    size=info.get("size") or 0))
            except FileNotFoundError:
                out.append(FileInfo(p, FileType.NotFound))
        return out

    def open_input_stream(self, path):
        return self.fs.open(path, "rb")

    def open_output_stream(self, path, metadata=None):
        return self.fs.open(path, "wb")

    def create_dir(self, path, recursive=True):
        self.fs.makedirs(path, exist_ok=True)

    def delete_file(self, path):
        self.fs.rm(path)


class S3LogLevel:
    Off = 0
    Fatal = 1
    Error = 2
    Warn = 3
    Info = 4
    Debug = 5
    Trace = 6


class S3RetryStrategy:
    def __init__(self, max_attempts: int = 3):
        self.max_attempts = max_attempts


class AwsStandardS3RetryStrategy(S3RetryStrategy):
    pass


class AwsDefaultS3RetryStrategy(S3RetryStrategy):
    pass


_S3_INITIALIZED = [False]


def initialize_s3(log_level=None, num_event_loop_threads: int = 1):
    """Nothing to start: the S3 client is plain HTTP."""
    _S3_INITIALIZED[0] = True


def ensure_s3_initialized():
    _S3_INITIALIZED[0] = True


def finalize_s3():
    _S3_INITIALIZED[0] = False


def ensure_s3_finalized():
    _S3_INITIALIZED[0] = False


def resolve_s3_region(bucket: str) -> str:
    raise OSError("S3 region resolution needs network access to AWS, "
                  "which the port does not make")
