"""Coalesced reads of byte ranges (counterpart of
``arrow_tpu/io/caching.py``; reference: cpp/src/arrow/io/caching.h
ReadRangeCache and CacheOptions).

Nearby ranges are read as one: a seek and a read a coalesced range rather
than one a column chunk, which is what a high-latency file system needs.
``ParquetFile.pre_buffer`` uses it.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple


class CacheOptions:
    """Coalescing knobs (io/caching.h CacheOptions::Defaults: hole
    limit 8 KiB, range limit 32 MiB)."""

    def __init__(self, *, hole_size_limit: int = 8192,
                 range_size_limit: int = 32 * 1024 * 1024,
                 lazy: bool = False, prefetch_limit: int = 0):
        self.hole_size_limit = hole_size_limit
        self.range_size_limit = range_size_limit
        self.lazy = lazy
        self.prefetch_limit = prefetch_limit

    @staticmethod
    def defaults() -> "CacheOptions":
        return CacheOptions()

    @staticmethod
    def from_network_metrics(time_to_first_byte_millis,
                             transfer_bandwidth_mib_per_sec,
                             ideal_bandwidth_utilization_frac=0.9,
                             max_ideal_request_size_mib=64) -> "CacheOptions":
        """The defaults, whatever the metrics, as the reference gives."""
        return CacheOptions()


def coalesce_ranges(ranges: Sequence[Tuple[int, int]],
                    hole_size_limit: int = 8192,
                    range_size_limit: int = 32 * 1024 * 1024
                    ) -> List[Tuple[int, int]]:
    """[(offset, length)] -> sorted coalesced [(offset, length)]
    (io/caching.cc CoalesceReadRanges)."""
    if not ranges:
        return []
    rs = sorted((int(o), int(ln)) for o, ln in ranges if ln > 0)
    out: List[Tuple[int, int]] = []
    cur_off, cur_len = rs[0]
    for off, ln in rs[1:]:
        end = cur_off + cur_len
        if off <= end + hole_size_limit and \
                (max(off + ln, end) - cur_off) <= range_size_limit:
            cur_len = max(off + ln, end) - cur_off
        else:
            out.append((cur_off, cur_len))
            cur_off, cur_len = off, ln
    out.append((cur_off, cur_len))
    return out


class ReadRangeCache:
    """Caches coalesced reads of a random-access source
    (io/caching.h ReadRangeCache)."""

    def __init__(self, source, options: CacheOptions = None):
        self.source = source
        self.options = options or CacheOptions()
        self._starts: List[int] = []
        self._blocks: List[Tuple[int, bytes]] = []

    def cache(self, ranges: Sequence[Tuple[int, int]]) -> None:
        """Fetch (coalesced) ranges now; later reads are served from
        memory."""
        for off, ln in coalesce_ranges(
                ranges, self.options.hole_size_limit,
                self.options.range_size_limit):
            self.source.seek(off)
            data = self.source.read(ln)
            idx = bisect.bisect_left(self._starts, off)
            self._starts.insert(idx, off)
            self._blocks.insert(idx, (off, data))

    def read(self, offset: int, length: int) -> bytes:
        """Serve from cache; falls back to the source on a miss."""
        idx = bisect.bisect_right(self._starts, offset) - 1
        if idx >= 0:
            boff, data = self._blocks[idx]
            if boff <= offset and offset + length <= boff + len(data):
                return data[offset - boff:offset - boff + length]
        self.source.seek(offset)
        return self.source.read(length)


class _CachedSource:
    """File-object facade over a ReadRangeCache (seek/read protocol,
    drop-in for the parquet reader's src)."""

    def __init__(self, cache: ReadRangeCache, size: int):
        self._cache = cache
        self._pos = 0
        self._size = size

    def seek(self, offset: int, whence: int = 0):
        if whence == 2:
            self._pos = self._size + offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = self._size - self._pos
        n = min(n, max(self._size - self._pos, 0))
        out = self._cache.read(self._pos, n)
        self._pos += len(out)
        return out
