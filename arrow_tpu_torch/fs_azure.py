"""An Azure Blob Storage file system (counterpart of
``arrow_tpu/fs_azure.py``; reference: cpp/src/arrow/filesystem/azurefs.h),
a client of the Blob service REST API (x-ms-version 2020-10-02) with
SharedKey signing and the standard library alone.

Paths are "container/blob...". ``blob_storage_authority`` names an
Azurite-style endpoint, addressed by path (the tests' emulator,
``tests/cloud_emulators.py``).

REST surface used:
  list      GET    /{container}?restype=container&comp=list&prefix=...
  read      GET    /{container}/{blob}
  stat      HEAD   /{container}/{blob}
  write     PUT    /{container}/{blob}  (x-ms-blob-type: BlockBlob)
  delete    DELETE /{container}/{blob}
  copy      PUT    /{container}/{blob}  (x-ms-copy-source: ...)
  container PUT    /{container}?restype=container
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import hmac
import io
import posixpath
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional
from xml.etree import ElementTree

from .fs import FileInfo, FileSelector, FileSystem, FileType

_MS_VERSION = "2020-10-02"


class AzureFileSystem(FileSystem):
    def __init__(self, account_name: str, account_key: str = "",
                 blob_storage_authority: Optional[str] = None,
                 scheme: str = "https"):
        self.account_name = account_name
        self.account_key = account_key
        if blob_storage_authority:
            auth = blob_storage_authority
            if "://" not in auth:
                auth = f"{scheme}://{auth}"
            # Azurite-style path addressing: http://host:port/account
            self.endpoint = auth.rstrip("/") + "/" + account_name
        else:
            self.endpoint = \
                f"https://{account_name}.blob.core.windows.net"

    # --- SharedKey signing (Authorization of Azure Storage docs) -------
    def _sign(self, method: str, path: str, query: dict,
              headers: dict, payload: bytes) -> dict:
        now = email.utils.formatdate(usegmt=True)
        hdrs = {"x-ms-date": now, "x-ms-version": _MS_VERSION}
        hdrs.update(headers)
        if not self.account_key:
            return hdrs
        canon_headers = "".join(
            f"{k}:{v}\n" for k, v in sorted(hdrs.items())
            if k.startswith("x-ms-"))
        # canonicalized resource: /account/path + sorted query
        res = f"/{self.account_name}{path}"
        for k in sorted(query):
            res += f"\n{k}:{query[k]}"
        sts = "\n".join([
            method,
            "",                              # Content-Encoding
            "",                              # Content-Language
            str(len(payload)) if payload else "",
            "",                              # Content-MD5
            headers.get("Content-Type", ""),
            "",                              # Date (x-ms-date used)
            "", "", "", "", "",              # If-*/Range
        ]) + "\n" + canon_headers + res
        key = base64.b64decode(self.account_key)
        sig = base64.b64encode(
            hmac.new(key, sts.encode(), hashlib.sha256).digest()
        ).decode()
        hdrs["Authorization"] = \
            f"SharedKey {self.account_name}:{sig}"
        return hdrs

    def _request(self, method: str, path: str, query: dict = None,
                 payload: bytes = b"", headers: dict = None):
        query = dict(query or {})
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(sorted(query.items()))
        hdrs = self._sign(method, path, query, dict(headers or {}),
                          payload)
        req = urllib.request.Request(url, data=payload or None,
                                     headers=hdrs, method=method)
        return urllib.request.urlopen(req, timeout=60)

    @staticmethod
    def _split(path: str):
        path = path.strip("/")
        if "/" in path:
            c, b = path.split("/", 1)
        else:
            c, b = path, ""
        return c, b

    def _list(self, container: str, prefix: str, delimiter: str = ""):
        blobs, prefixes, marker = [], [], None
        while True:
            q = {"restype": "container", "comp": "list",
                 "prefix": prefix}
            if delimiter:
                q["delimiter"] = delimiter
            if marker:
                q["marker"] = marker
            with self._request("GET", f"/{container}", q) as r:
                doc = r.read()
            root = ElementTree.fromstring(doc)
            blobs_el = root.find("Blobs")
            if blobs_el is not None:
                for b in blobs_el.findall("Blob"):
                    nm = b.find("Name").text
                    props = b.find("Properties")
                    sz = int(props.find("Content-Length").text) \
                        if props is not None and \
                        props.find("Content-Length") is not None else 0
                    blobs.append((nm, sz))
                for p in blobs_el.findall("BlobPrefix"):
                    prefixes.append(p.find("Name").text)
            nm_el = root.find("NextMarker")
            marker = nm_el.text if nm_el is not None else None
            if not marker:
                break
        return blobs, prefixes

    # --- FileSystem API ------------------------------------------------
    def get_file_info(self, path_or_selector):
        if isinstance(path_or_selector, FileSelector):
            sel = path_or_selector
            container, key = self._split(sel.base_dir)
            prefix = key + "/" if key else ""
            try:
                if sel.recursive:
                    keys, _ = self._list(container, prefix)
                    out = [FileInfo(f"{container}/{k}", FileType.File,
                                    sz)
                           for k, sz in keys if k != prefix]
                    dirs = set()
                    for k, _sz in keys:
                        d = posixpath.dirname(k)
                        while d and d + "/" != prefix and \
                                d != key and d not in dirs:
                            dirs.add(d)
                            d = posixpath.dirname(d)
                    out += [FileInfo(f"{container}/{d}",
                                     FileType.Directory)
                            for d in dirs]
                else:
                    keys, prefixes = self._list(container, prefix, "/")
                    out = [FileInfo(f"{container}/{k}", FileType.File,
                                    sz)
                           for k, sz in keys if k != prefix]
                    out += [FileInfo(f"{container}/{p.rstrip('/')}",
                                     FileType.Directory)
                            for p in prefixes]
            except urllib.error.HTTPError as e:
                if e.code == 404 and sel.allow_not_found:
                    return []
                raise
            return sorted(out, key=lambda i: i.path)
        path = path_or_selector
        container, key = self._split(path)
        if key:
            try:
                with self._request("HEAD",
                                   f"/{container}/{key}") as r:
                    size = int(r.headers.get("Content-Length", -1))
                return FileInfo(path, FileType.File, size)
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    raise
            keys, prefixes = self._list(container, key + "/", "/")
            if keys or prefixes:
                return FileInfo(path, FileType.Directory)
            return FileInfo(path, FileType.NotFound)
        try:
            self._list(container, "", "/")
            return FileInfo(path, FileType.Directory)
        except urllib.error.HTTPError:
            return FileInfo(path, FileType.NotFound)

    def open_input_stream(self, path: str):
        container, key = self._split(path)
        with self._request("GET", f"/{container}/{key}") as r:
            return io.BytesIO(r.read())

    def open_output_stream(self, path: str):
        fs = self
        container, key = self._split(path)

        class _Writer(io.BytesIO):
            def close(self2):
                data = self2.getvalue()
                fs._request("PUT", f"/{container}/{key}",
                            payload=data,
                            headers={"x-ms-blob-type": "BlockBlob"}
                            ).close()
                super().close()

            def __exit__(self2, *a):
                self2.close()
        return _Writer()

    def create_dir(self, path: str, recursive: bool = True):
        container, key = self._split(path)
        if not key:
            try:
                self._request("PUT", f"/{container}",
                              {"restype": "container"}).close()
            except urllib.error.HTTPError as e:
                if e.code != 409:
                    raise

    def delete_file(self, path: str):
        container, key = self._split(path)
        self._request("DELETE", f"/{container}/{key}").close()

    def delete_dir(self, path: str):
        container, key = self._split(path)
        keys, _ = self._list(container, key + "/" if key else "")
        for k, _sz in keys:
            self._request("DELETE", f"/{container}/{k}").close()

    def move(self, src: str, dest: str):
        sc, sk = self._split(src)
        dc, dk = self._split(dest)
        self._request(
            "PUT", f"/{dc}/{dk}",
            headers={"x-ms-copy-source":
                     f"{self.endpoint}/{sc}/{sk}"}).close()
        self.delete_file(src)

    def equals(self, other) -> bool:
        return isinstance(other, AzureFileSystem) and \
            other.endpoint == self.endpoint
