"""A Google Cloud Storage file system (counterpart of
``arrow_tpu/fs_gcs.py``; reference: cpp/src/arrow/filesystem/gcsfs.h), a
client of the GCS JSON API over HTTP with the standard library alone.

Paths are "bucket/object...". Auth is a bearer access token
(``access_token=``) or none; ``endpoint_override`` names a GCS-compatible
store (the tests' emulator, ``tests/cloud_emulators.py``).

JSON API surface used (storage/v1):
  list    GET  /storage/v1/b/{bucket}/o?prefix=&delimiter=&pageToken=
  stat    GET  /storage/v1/b/{bucket}/o/{object}
  read    GET  /download/storage/v1/b/{bucket}/o/{object}?alt=media
  write   POST /upload/storage/v1/b/{bucket}/o?uploadType=media&name=
  delete  DELETE /storage/v1/b/{bucket}/o/{object}
  copy    POST /storage/v1/b/{b}/o/{o}/copyTo/b/{b2}/o/{o2}
  bucket  POST /storage/v1/b?project=
"""

from __future__ import annotations

import io
import json
import posixpath
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from .fs import FileInfo, FileSelector, FileSystem, FileType


class GcsFileSystem(FileSystem):
    def __init__(self, access_token: str = "",
                 endpoint_override: Optional[str] = None,
                 project_id: str = "", anonymous: bool = False,
                 scheme: str = "https"):
        self.access_token = "" if anonymous else access_token
        self.project_id = project_id
        if endpoint_override:
            if "://" in endpoint_override:
                self.endpoint = endpoint_override
            else:
                self.endpoint = f"{scheme}://{endpoint_override}"
        else:
            self.endpoint = "https://storage.googleapis.com"

    # --- HTTP ----------------------------------------------------------
    def _request(self, method: str, path: str, query: str = "",
                 payload: bytes = b"",
                 content_type: str = "application/octet-stream"):
        url = self.endpoint + path
        if query:
            url += "?" + query
        hdrs = {}
        if self.access_token:
            hdrs["Authorization"] = f"Bearer {self.access_token}"
        if payload:
            hdrs["Content-Type"] = content_type
        req = urllib.request.Request(url, data=payload or None,
                                     headers=hdrs, method=method)
        return urllib.request.urlopen(req, timeout=60)

    def _obj_path(self, bucket: str, key: str) -> str:
        return (f"/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
                f"/o/{urllib.parse.quote(key, safe='')}")

    @staticmethod
    def _split(path: str):
        path = path.strip("/")
        if "/" in path:
            b, k = path.split("/", 1)
        else:
            b, k = path, ""
        return b, k

    def _list(self, bucket: str, prefix: str, delimiter: str = ""):
        items, prefixes, token = [], [], None
        while True:
            q = {"prefix": prefix}
            if delimiter:
                q["delimiter"] = delimiter
            if token:
                q["pageToken"] = token
            qs = urllib.parse.urlencode(sorted(q.items()))
            with self._request(
                    "GET",
                    f"/storage/v1/b/{urllib.parse.quote(bucket)}/o",
                    qs) as r:
                doc = json.loads(r.read())
            for it in doc.get("items", ()):
                items.append((it["name"], int(it.get("size", 0))))
            prefixes.extend(doc.get("prefixes", ()))
            token = doc.get("nextPageToken")
            if not token:
                break
        return items, prefixes

    # --- FileSystem API ------------------------------------------------
    def get_file_info(self, path_or_selector):
        if isinstance(path_or_selector, FileSelector):
            sel = path_or_selector
            bucket, key = self._split(sel.base_dir)
            prefix = key + "/" if key else ""
            try:
                if sel.recursive:
                    keys, _ = self._list(bucket, prefix)
                    out = [FileInfo(f"{bucket}/{k}", FileType.File, sz)
                           for k, sz in keys if k != prefix]
                    dirs = set()
                    for k, _sz in keys:
                        d = posixpath.dirname(k)
                        while d and d + "/" != prefix and \
                                d != key and d not in dirs:
                            dirs.add(d)
                            d = posixpath.dirname(d)
                    out += [FileInfo(f"{bucket}/{d}",
                                     FileType.Directory)
                            for d in dirs]
                else:
                    keys, prefixes = self._list(bucket, prefix, "/")
                    out = [FileInfo(f"{bucket}/{k}", FileType.File, sz)
                           for k, sz in keys if k != prefix]
                    out += [FileInfo(f"{bucket}/{p.rstrip('/')}",
                                     FileType.Directory)
                            for p in prefixes]
            except urllib.error.HTTPError as e:
                if e.code == 404 and sel.allow_not_found:
                    return []
                raise
            return sorted(out, key=lambda i: i.path)
        path = path_or_selector
        bucket, key = self._split(path)
        if key:
            try:
                with self._request("GET",
                                   self._obj_path(bucket, key)) as r:
                    meta = json.loads(r.read())
                return FileInfo(path, FileType.File,
                                int(meta.get("size", -1)))
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    raise
            keys, prefixes = self._list(bucket, key + "/", "/")
            if keys or prefixes:
                return FileInfo(path, FileType.Directory)
            return FileInfo(path, FileType.NotFound)
        try:
            self._list(bucket, "", "/")
            return FileInfo(path, FileType.Directory)
        except urllib.error.HTTPError:
            return FileInfo(path, FileType.NotFound)

    def open_input_stream(self, path: str):
        bucket, key = self._split(path)
        with self._request(
                "GET", f"/download{self._obj_path(bucket, key)}",
                "alt=media") as r:
            return io.BytesIO(r.read())

    def open_output_stream(self, path: str):
        fs = self
        bucket, key = self._split(path)

        class _Writer(io.BytesIO):
            def close(self2):
                data = self2.getvalue()
                q = urllib.parse.urlencode(
                    {"uploadType": "media", "name": key})
                fs._request(
                    "POST",
                    f"/upload/storage/v1/b/"
                    f"{urllib.parse.quote(bucket)}/o", q,
                    payload=data).close()
                super().close()

            def __exit__(self2, *a):
                self2.close()
        return _Writer()

    def create_dir(self, path: str, recursive: bool = True):
        bucket, key = self._split(path)
        if not key:
            try:
                body = json.dumps({"name": bucket}).encode()
                q = urllib.parse.urlencode(
                    {"project": self.project_id or "default"})
                self._request("POST", "/storage/v1/b", q, body,
                              "application/json").close()
            except urllib.error.HTTPError as e:
                if e.code != 409:  # already exists
                    raise
        # object prefixes need no markers (gcsfs.cc behaves the same)

    def delete_file(self, path: str):
        bucket, key = self._split(path)
        self._request("DELETE", self._obj_path(bucket, key)).close()

    def delete_dir(self, path: str):
        bucket, key = self._split(path)
        keys, _ = self._list(bucket, key + "/" if key else "")
        for k, _sz in keys:
            self._request("DELETE", self._obj_path(bucket, k)).close()

    def move(self, src: str, dest: str):
        sb, sk = self._split(src)
        db, dk = self._split(dest)
        self._request(
            "POST",
            f"{self._obj_path(sb, sk)}/copyTo"
            f"/b/{urllib.parse.quote(db, safe='')}"
            f"/o/{urllib.parse.quote(dk, safe='')}").close()
        self.delete_file(src)

    def equals(self, other) -> bool:
        return isinstance(other, GcsFileSystem) and \
            other.endpoint == self.endpoint
