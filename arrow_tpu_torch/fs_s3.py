"""An S3 file system (counterpart of ``arrow_tpu/fs_s3.py``; reference:
cpp/src/arrow/filesystem/s3fs.h), a client of the S3 REST API over HTTP
with AWS Signature Version 4 and the standard library alone.

Paths are "bucket/key...". GET, PUT (a whole object; a copy by
``x-amz-copy-source``), DELETE, HEAD, ListObjectsV2 with a prefix and a
delimiter, and CreateBucket. ``endpoint_override`` names any
S3-compatible store (the tests' emulator, ``tests/s3_emulator.py``);
without it the client signs for AWS's regional endpoint.

S3 has no directories: ``create_dir`` makes a bucket (with
``allow_bucket_creation``) and nothing else, and a directory's FileInfo
comes from the keys' prefixes, as filesystem/s3fs.cc's walker makes it.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import io
import posixpath
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional
from xml.etree import ElementTree

from .fs import FileInfo, FileSelector, FileSystem, FileType


def _sha256_hex(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


class S3FileSystem(FileSystem):
    def __init__(self, access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1",
                 endpoint_override: Optional[str] = None,
                 scheme: str = "http",
                 session_token: Optional[str] = None,
                 allow_bucket_creation: bool = False):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.session_token = session_token
        self.allow_bucket_creation = allow_bucket_creation
        if endpoint_override:
            if "://" in endpoint_override:
                self.endpoint = endpoint_override
            else:
                self.endpoint = f"{scheme}://{endpoint_override}"
        else:
            self.endpoint = f"https://s3.{region}.amazonaws.com"

    # --- SigV4 ---------------------------------------------------------
    def _sign(self, method: str, path: str, query: str,
              headers: dict, payload: bytes) -> dict:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host = urllib.parse.urlparse(self.endpoint).netloc
        headers = dict(headers)
        headers["host"] = host
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = _sha256_hex(payload)
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        signed = sorted(headers)
        canonical_headers = "".join(
            f"{k}:{headers[k].strip()}\n" for k in signed)
        # canonical query: sorted, url-encoded
        q_items = urllib.parse.parse_qsl(query, keep_blank_values=True)
        cq = "&".join(f"{urllib.parse.quote(k, safe='')}="
                      f"{urllib.parse.quote(v, safe='')}"
                      for k, v in sorted(q_items))
        creq = "\n".join([
            method, urllib.parse.quote(path), cq, canonical_headers,
            ";".join(signed), headers["x-amz-content-sha256"]])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                             _sha256_hex(creq.encode())])

        def hm(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = hm(("AWS4" + self.secret_key).encode(), datestamp)
        k = hm(k, self.region)
        k = hm(k, "s3")
        k = hm(k, "aws4_request")
        sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        headers.pop("host")
        return headers

    def _request(self, method: str, path: str, query: str = "",
                 payload: bytes = b"", headers: Optional[dict] = None):
        if not path.startswith("/"):
            path = "/" + path
        url = self.endpoint + urllib.parse.quote(path)
        if query:
            url += "?" + query
        hdrs = self._sign(method, path, query, headers or {}, payload)
        req = urllib.request.Request(url, data=payload or None,
                                     headers=hdrs, method=method)
        return urllib.request.urlopen(req, timeout=60)

    # --- FileSystem API ------------------------------------------------
    def _split(self, path: str):
        path = path.strip("/")
        if "/" in path:
            b, k = path.split("/", 1)
        else:
            b, k = path, ""
        return b, k

    def _list(self, bucket: str, prefix: str, delimiter: str = ""):
        """ListObjectsV2: yields (keys: [(key, size)], prefixes)."""
        token = None
        keys, prefixes = [], []
        while True:
            q = {"list-type": "2", "prefix": prefix}
            if delimiter:
                q["delimiter"] = delimiter
            if token:
                q["continuation-token"] = token
            qs = urllib.parse.urlencode(sorted(q.items()))
            with self._request("GET", f"/{bucket}", qs) as r:
                doc = r.read()
            root = ElementTree.fromstring(doc)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[:root.tag.index("}") + 1]
            for c in root.findall(f"{ns}Contents"):
                keys.append((c.find(f"{ns}Key").text,
                             int(c.find(f"{ns}Size").text)))
            for p in root.findall(f"{ns}CommonPrefixes"):
                prefixes.append(p.find(f"{ns}Prefix").text)
            trunc = root.find(f"{ns}IsTruncated")
            if trunc is not None and trunc.text == "true":
                nt = root.find(f"{ns}NextContinuationToken")
                token = nt.text if nt is not None else None
                if not token:
                    break
            else:
                break
        return keys, prefixes

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
                with self._request("HEAD", f"/{bucket}/{key}") as r:
                    size = int(r.headers.get("Content-Length", -1))
                return FileInfo(path, FileType.File, size)
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    raise
            # directory? any key under the prefix
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
        with self._request("GET", f"/{bucket}/{key}") as r:
            return io.BytesIO(r.read())

    def open_output_stream(self, path: str):
        fs = self
        bucket, key = self._split(path)

        class _Writer(io.BytesIO):
            def close(self2):
                data = self2.getvalue()
                fs._request("PUT", f"/{bucket}/{key}", payload=data)
                super().close()

            def __exit__(self2, *a):
                self2.close()
        return _Writer()

    def create_dir(self, path: str, recursive: bool = True):
        bucket, key = self._split(path)
        if not key and self.allow_bucket_creation:
            try:
                self._request("PUT", f"/{bucket}").close()
            except urllib.error.HTTPError as e:
                if e.code not in (200, 409):  # exists
                    raise
        # key prefixes need no objects (the reference skips directory
        # markers by default too)

    def delete_file(self, path: str):
        bucket, key = self._split(path)
        self._request("DELETE", f"/{bucket}/{key}").close()

    def delete_dir(self, path: str):
        bucket, key = self._split(path)
        keys, _ = self._list(bucket, key + "/" if key else "")
        for k, _sz in keys:
            self._request("DELETE", f"/{bucket}/{k}").close()

    def move(self, src: str, dest: str):
        sb, sk = self._split(src)
        db, dk = self._split(dest)
        hdrs = {"x-amz-copy-source": f"/{sb}/{sk}"}
        self._request("PUT", f"/{db}/{dk}", headers=hdrs).close()
        self.delete_file(src)

    def equals(self, other) -> bool:
        return isinstance(other, S3FileSystem) and \
            other.endpoint == self.endpoint
