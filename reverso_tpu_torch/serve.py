"""Serving-side query batching: coalesce concurrent searches into one
kernel launch.

The exact scan's cost is dominated by streaming the database from the
card's memory — a launch with 64 stacked queries costs about as much as
one query — so concurrent callers enqueue, a collector thread drains the
queue into a single `DeviceIndex.search` launch, and each caller gets
its slice back. Per-request state stays immutable; only the device
launch is shared. The batcher is the JAX package's (`_bucket` and
`_round_up_8` set the launch shapes); a search returns device tensors
from an asynchronous launch, and the completion pool copies them to the
host.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from .store.index import to_host


class SearchError(RuntimeError):
    pass


class OverloadedError(SearchError):
    """Queue full: the request was shed immediately (HTTP 429 analog).

    Shedding beats queueing here: the batcher drains max_batch requests
    per launch, so a queue deeper than a few launches means every new
    caller would wait multiple device launches anyway — failing fast
    keeps tail latency bounded and lets the client back off/retry."""


def _round_up_8(x: int) -> int:
    return ((x + 7) // 8) * 8


class _Pending:
    __slots__ = ("query", "k", "space", "event", "scores", "ids",
                 "error")

    def __init__(self, query: np.ndarray, k: int, space: str = ""):
        self.query = query
        self.k = k
        self.space = space
        self.event = threading.Event()
        self.scores = None
        self.ids = None
        self.error: Optional[BaseException] = None


class BatchingSearcher:
    """Blocking `search()` front-end that batches concurrent callers.

    index_fn: zero-arg callable returning the current index object
        (anything with `.search(queries[B, d], k) -> (scores, ids)`);
        called once per launch so store rebuilds are picked up.
    max_delay_s: how long the first request in a batch may wait for
        co-travellers. Zero still batches whatever is already queued.
    max_batch: cap on queries per launch (memory of the score staging
        scales with the batch).
    max_queue: bound on requests waiting for a launch; arrivals beyond
        it are shed with `OverloadedError` instead of queueing (the
        collector is single-worker, so an unbounded queue would turn
        overload into unbounded latency rather than fast errors).
    """

    def __init__(self, index_fn: Callable[[], object], *,
                 max_delay_s: float = 0.003, max_batch: int = 256,
                 k_cap: int = 128, max_queue: int = 1024,
                 latency_window: int = 512, max_inflight: int = 2):
        self._index_fn = index_fn
        self._max_delay_s = max_delay_s
        self._max_batch = max_batch
        self._k_cap = k_cap
        self._max_queue = max_queue
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        self.launches = 0          # telemetry: device launches issued
        self.served = 0            # telemetry: requests served
        self.shed = 0              # telemetry: requests rejected (queue full)
        # end-to-end request latencies (seconds), newest-last ring
        self._latencies: deque[float] = deque(maxlen=latency_window)
        self._stats_lock = threading.Lock()
        # A launch is asynchronous: the collector launches and hands
        # the blocking device->host copy to this completion pool, so the
        # next batch's launch overlaps the previous batch's copy.
        # max_inflight bounds launched-but-unfetched batches so overload
        # can't stack unbounded device work behind the queue bound.
        import concurrent.futures as _cf
        self._inflight = threading.Semaphore(max(1, max_inflight))
        self._completer = _cf.ThreadPoolExecutor(
            max_workers=max(1, max_inflight),
            thread_name_prefix="reverso-search-complete")
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="reverso-search-batcher")
        self._worker.start()

    # -- client side -------------------------------------------------------

    def search(self, query: np.ndarray, k: int,
               timeout: Optional[float] = 60.0, *, space: str = ""):
        """Search for one query vector [d]; returns (scores[k], ids[k]).

        Thread-safe; blocks until the coalesced launch completes.
        `space` selects a named vector space ('' = default); requests
        only coalesce with co-travellers of the same space. k > k_cap
        raises (silent truncation would return fewer results than asked
        with no error); route large-k requests directly to the index
        instead.
        """
        k = int(k)
        if k > self._k_cap:
            raise SearchError(
                f"k={k} exceeds the batcher's k_cap={self._k_cap}; "
                "use a direct index search for large k")
        if k < 1:
            # a negative k would silently mis-slice the padded launch
            # (scores[row, :-5]) and return the wrong result count
            raise SearchError(f"k must be >= 1, got {k}")
        q = np.asarray(query, np.float32).reshape(-1)
        p = _Pending(q, k, str(space or ""))
        t0 = time.monotonic()
        with self._cv:
            # _closed is checked UNDER the lock: an unsynchronized
            # pre-check raced close() — a request could enqueue just
            # after the collector's final drain and strand its caller
            # for the full timeout instead of failing fast
            if self._closed:
                raise SearchError("searcher is closed")
            if len(self._queue) >= self._max_queue:
                with self._stats_lock:
                    self.shed += 1
                raise OverloadedError(
                    f"overloaded: {len(self._queue)} requests queued "
                    f"(max_queue={self._max_queue}); retry later")
            self._queue.append(p)
            self._cv.notify()
        if not p.event.wait(timeout):
            # withdraw the request if it is still queued, so an
            # abandoned caller doesn't consume a launch slot
            with self._cv:
                try:
                    self._queue.remove(p)
                except ValueError:
                    pass   # already draining; its result will be dropped
            raise SearchError("search timed out")
        if p.error is not None:
            raise SearchError(str(p.error)) from p.error
        with self._stats_lock:
            self._latencies.append(time.monotonic() - t0)
        return p.scores, p.ids

    def stats(self) -> dict:
        """Telemetry snapshot: launches/served/shed counters, current
        queue depth, and p50/p95 end-to-end latency (ms) over the last
        `latency_window` served requests."""
        with self._cv:
            depth = len(self._queue)
        with self._stats_lock:
            lat = sorted(self._latencies)
            shed, launches, served = self.shed, self.launches, self.served
        out = {"launches": launches, "served": served,
               "shed": shed, "queue_depth": depth,
               "latency_count": len(lat)}
        if lat:
            out["latency_p50_ms"] = 1e3 * lat[len(lat) // 2]
            out["latency_p95_ms"] = 1e3 * lat[min(len(lat) - 1,
                                                  int(len(lat) * 0.95))]
        return out

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5)

    # -- collector ----------------------------------------------------------

    def _drain(self) -> list[_Pending]:
        """Wait for the first request, then linger max_delay_s for
        co-travellers (or until max_batch)."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if self._closed and not self._queue:
                return []
            deadline = time.monotonic() + self._max_delay_s
            while (len(self._queue) < self._max_batch
                   and not self._closed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            batch = self._queue[:self._max_batch]
            del self._queue[:len(batch)]
            return batch

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Next power-of-two batch size (capped): launches snap to a
        small set of shapes (the JAX package's, where each shape was a
        compile)."""
        b = 1
        while b < n:
            b *= 2
        return min(b, cap)

    def _launch(self, group: list[_Pending]) -> None:
        """Launch one device search for same-dimension requests (at the
        padded shapes), then hand the blocking fetch to the completion
        pool."""
        k_max = max(p.k for p in group)
        k_pad = min(self._k_cap, _round_up_8(k_max))
        bucket = self._bucket(len(group), self._max_batch)
        d = group[0].query.shape[0]
        queries = np.zeros((bucket, d), np.float32)
        for row, p in enumerate(group):
            queries[row] = p.query
        index = (self._index_fn(group[0].space) if group[0].space
                 else self._index_fn())
        self._inflight.acquire()           # bound dispatched-unfetched work
        try:
            result = index.search(queries, k_pad)   # asynchronous launch
        except BaseException:
            self._inflight.release()
            raise
        self._completer.submit(self._complete, group, result)

    def _complete(self, group: list[_Pending], result) -> None:
        """Fetch a dispatched launch and distribute slices (pool thread)."""
        try:
            scores, ids = (to_host(a) for a in result)
            for row, p in enumerate(group):
                p.scores = scores[row, :p.k]
                p.ids = ids[row, :p.k]
            with self._stats_lock:
                self.launches += 1
                self.served += len(group)
        except BaseException as e:
            for p in group:
                p.error = e
        finally:
            self._inflight.release()
            for p in group:
                p.event.set()

    def _run(self) -> None:
        while True:
            batch = self._drain()
            if not batch:
                if self._closed:
                    self._completer.shutdown(wait=True)
                    return
                continue
            # group by (space, query dimension): one malformed request
            # must not poison its co-travellers' batch, and named-space
            # requests must hit their own index
            by_dim: dict[tuple, list[_Pending]] = {}
            for p in batch:
                by_dim.setdefault((p.space, p.query.shape[0]),
                                  []).append(p)
            for group in by_dim.values():
                try:
                    self._launch(group)
                except BaseException as e:   # propagate to this group only
                    for p in group:
                        p.error = e
                        p.event.set()
