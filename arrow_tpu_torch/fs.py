"""File systems (counterpart of ``arrow_tpu/fs.py``; reference:
cpp/src/arrow/filesystem/filesystem.h): ``FileInfo`` and ``FileSelector``,
the ``FileSystem`` interface, ``LocalFileSystem``, ``SubTreeFileSystem``,
the in-memory ``MockFileSystem`` (filesystem/mockfs.h) and ``copy_files``.

Not ported yet (ROADMAP.md, queue 1, item 13): the fsspec adapters
(``FsspecFileSystem``, ``PyFileSystem``, ``FSSpecHandler`` and the
``Fsspec*FileSystem`` classes) and the cloud file systems with their S3
helpers; the card's machine has no ``fsspec``. Each raises
NotImplementedError naming that item.
"""

from __future__ import annotations

import io
import os
import posixpath
import shutil
from typing import Dict, List, Optional

_LATER = "ROADMAP.md, queue 1, item 13: the fsspec and cloud file systems"


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


# --- not ported yet: the fsspec adapters and the cloud file systems ----------

def _not_ported(name: str):
    raise NotImplementedError(f"{name} is not ported yet ({_LATER})")


def _later_class(name: str, base=FileSystem):
    def __init__(self, *args, **kwargs):
        _not_ported(name)

    def from_uri(cls, *args, **kwargs):
        _not_ported(name)
    return type(name, (base,), {
        "__init__": __init__, "from_uri": classmethod(from_uri),
        "__doc__": f"Not ported yet ({_LATER})."})


def _later_function(name: str):
    def call(*args, **kwargs):
        _not_ported(name)
    call.__name__ = call.__qualname__ = name
    call.__doc__ = f"Not ported yet ({_LATER})."
    return call


FsspecFileSystem = _later_class("FsspecFileSystem")
FsspecS3FileSystem = _later_class("FsspecS3FileSystem")
FsspecGcsFileSystem = _later_class("FsspecGcsFileSystem")
FsspecAzureFileSystem = _later_class("FsspecAzureFileSystem")
FsspecHadoopFileSystem = _later_class("FsspecHadoopFileSystem")
S3FileSystem = _later_class("S3FileSystem")
GcsFileSystem = _later_class("GcsFileSystem")
AzureFileSystem = _later_class("AzureFileSystem")
HadoopFileSystem = _later_class("HadoopFileSystem")
PyFileSystem = _later_class("PyFileSystem")
FileSystemHandler = _later_class("FileSystemHandler", object)
FSSpecHandler = _later_class("FSSpecHandler", object)
S3RetryStrategy = _later_class("S3RetryStrategy", object)
AwsStandardS3RetryStrategy = _later_class("AwsStandardS3RetryStrategy",
                                          object)
AwsDefaultS3RetryStrategy = _later_class("AwsDefaultS3RetryStrategy",
                                         object)
initialize_s3 = _later_function("initialize_s3")
ensure_s3_initialized = _later_function("ensure_s3_initialized")
finalize_s3 = _later_function("finalize_s3")
ensure_s3_finalized = _later_function("ensure_s3_finalized")
resolve_s3_region = _later_function("resolve_s3_region")


class S3LogLevel:
    """The S3 client's log levels (pyarrow.fs.S3LogLevel)."""
    Off, Fatal, Error, Warn, Info, Debug, Trace = range(7)
