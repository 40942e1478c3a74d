"""Host-side scan prefetch & cache — the replacement for the
reference's scanserver (SURVEY §2.3: a shared-memory daemon + LRU
CacheManager feeding out-of-core scans to clients,
src/scanserver/serverInterface.cc, cache/cacheManager.cc:79-113).

On an accelerator host the data plane is simpler and faster: a bounded
thread-pool pipeline reads and parses scans *ahead* of the registration
loop (text parse is the bottleneck, it overlaps with device compute),
and a byte-budgeted LRU keeps recently used scans resident, evicting
old ones exactly like CacheManager::allocateCacheObject flushes LRU
pages on miss.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator

from .scandir import PointFilter, RawScan, get_format, list_identifiers, read_scan

__all__ = ["ScanCache", "prefetch_scans"]


class ScanCache:
    """Byte-budgeted LRU of loaded scans (CacheManager role)."""

    def __init__(self, max_bytes: int = 4 << 30):
        self.max_bytes = max_bytes
        self._lru: "collections.OrderedDict[str, RawScan]" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _nbytes(scan: RawScan) -> int:
        return sum(v.nbytes for v in scan.channels.values())

    def get(self, key: str) -> RawScan | None:
        with self._lock:
            scan = self._lru.get(key)
            if scan is not None:
                self._lru.move_to_end(key)
            return scan

    def put(self, key: str, scan: RawScan) -> None:
        with self._lock:
            if key in self._lru:
                return
            self._lru[key] = scan
            self._bytes += self._nbytes(scan)
            while self._bytes > self.max_bytes and len(self._lru) > 1:
                _, old = self._lru.popitem(last=False)
                self._bytes -= self._nbytes(old)

    def __len__(self) -> int:
        return len(self._lru)


def prefetch_scans(
    directory: str,
    format: str = "uos",
    start: int = 0,
    end: int = -1,
    point_filter: PointFilter | None = None,
    *,
    lookahead: int = 2,
    workers: int = 2,
    cache: ScanCache | None = None,
    transform: Callable[[RawScan], RawScan] | None = None,
) -> Iterator[RawScan]:
    """Yield scans in order while reading up to ``lookahead`` scans
    ahead in background threads.

    ``transform`` (e.g. a reduction) runs inside the worker so parsing
    AND reduction overlap the consumer's device work — the pipelining
    SURVEY §7 Phase 3 calls for (scanserver's cache role is played by
    host RAM + this pipeline).
    """
    spec = get_format(format)
    idents = list_identifiers(directory, spec, start, end)
    cache = cache if cache is not None else ScanCache()  # empty cache is falsy!

    def load(ident: str) -> RawScan:
        key = f"{directory}/{ident}"
        hit = cache.get(key)
        if hit is not None:
            return hit
        scan = read_scan(directory, ident, spec, point_filter)
        if transform is not None:
            scan = transform(scan)
        cache.put(key, scan)
        return scan

    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: collections.deque[Future] = collections.deque()
        it = iter(idents)
        for _ in range(lookahead + 1):
            ident = next(it, None)
            if ident is None:
                break
            pending.append(pool.submit(load, ident))
        while pending:
            fut = pending.popleft()
            ident = next(it, None)
            if ident is not None:
                pending.append(pool.submit(load, ident))
            yield fut.result()
