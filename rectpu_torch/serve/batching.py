"""Request micro-batching for the prediction server.

A copy of ``rectpu/serve/batching.py`` (same class, same counters). The
reference delegates online serving to ML Engine, which batches concurrent
prediction requests server-side (reference scripts/mle_deploy.sh); here a
``MicroBatcher`` coalesces concurrent ``/predict`` requests into one device
call. On the card each dispatch pays kernel-launch and host<->device copy
latency, and one [sum(n_i)]-row forward keeps the card busier than k tiny
ones.

Mechanics: request threads encode their features (pure-CPU, parallel), then
enqueue `(encoded_batch, event)` and block. A single dispatcher thread takes
the first waiting request, keeps draining the queue until `max_batch` rows
are gathered or `max_delay_ms` has elapsed since that first request, then
concatenates and dispatches ONE device apply. Errors in the device call
propagate to all requests in the batch; encode errors stay per-request
(raised before enqueue).

The dispatcher does NOT block on the device->host transfer: CUDA launches
are asynchronous, so the dispatcher hands the in-flight output to a
completion thread (bounded in-flight queue) and immediately starts
collecting the next batch.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from rectpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class _Pending:
    batch: dict
    n: int
    done: threading.Event = field(default_factory=threading.Event)
    result: dict | None = None
    error: BaseException | None = None


class MicroBatcher:
    """Coalesces concurrent predict() calls into single device dispatches.

    Drop-in for ``ServingModel.predict``: ``MicroBatcher(served).predict(...)``
    returns exactly what ``served.predict(...)`` would. Stats counters
    (``requests_served``, ``batches_dispatched``, ``rows_dispatched``) let
    callers observe coalescing.
    """

    def __init__(self, served, max_batch: int | None = None,
                 max_delay_ms: float = 2.0, start: bool = True,
                 max_in_flight: int = 2, num_dispatchers: int = 1):
        """``num_dispatchers=1``: one dispatcher + a completion thread
        pipelines transfer behind compute. ``num_dispatchers>1``: a pool of
        dispatchers each runs its own coalesced batch end-to-end, overlapping
        round trips."""
        self.served = served
        self.max_batch = max_batch if max_batch is not None else served.max_batch
        self.max_delay_s = max_delay_ms / 1e3
        self._lock = threading.Condition()
        self._queue: list[_Pending] = []
        self._closed = False
        self._stats_lock = threading.Lock()
        self.requests_served = 0
        self.batches_dispatched = 0
        self.rows_dispatched = 0
        self._threads: list[threading.Thread] = []
        self._completer: threading.Thread | None = None
        # (items, device_out, n) awaiting device->host transfer; bounded so a
        # slow transfer backpressures dispatch instead of piling device work
        self._in_flight: queue.Queue = queue.Queue(maxsize=max_in_flight)
        if start:
            if num_dispatchers <= 1:
                self._completer = threading.Thread(
                    target=self._complete_loop, name="microbatcher-complete",
                    daemon=True,
                )
                self._completer.start()
                self._threads = [threading.Thread(
                    target=self._run, name="microbatcher", daemon=True
                )]
            else:
                self._threads = [
                    threading.Thread(target=self._run_sync,
                                     name=f"microbatcher-{i}", daemon=True)
                    for i in range(num_dispatchers)
                ]
            for t in self._threads:
                t.start()

    # -- request side ------------------------------------------------------

    def predict(self, features: dict) -> dict:
        batch = self.served.encode_request(features)  # raises per-request
        item = _Pending(batch, batch["cat_ids"].shape[0])
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(item)
            self._lock.notify()
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        if self._completer is not None:
            self._in_flight.put(None)  # sentinel after the dispatcher stopped
            self._completer.join(timeout=5)

    # -- dispatcher side ---------------------------------------------------

    def _take_batch(self) -> list[_Pending]:
        """Block until work exists, then drain until max_batch rows or the
        delay window (measured from the first request taken) closes."""
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if self._closed and not self._queue:
                return []
            items = [self._queue.pop(0)]
        rows = items[0].n
        deadline = time.monotonic() + self.max_delay_s
        while rows < self.max_batch:
            with self._lock:
                # never overshoot max_batch
                while (self._queue and rows < self.max_batch
                       and rows + self._queue[0].n <= self.max_batch):
                    items.append(self._queue.pop(0))
                    rows += items[-1].n
                if self._queue and rows + self._queue[0].n > self.max_batch:
                    break
            remaining = deadline - time.monotonic()
            if remaining <= 0 or rows >= self.max_batch:
                break
            with self._lock:
                if not self._queue and not self._closed:
                    self._lock.wait(timeout=remaining)
                if self._closed and not self._queue:
                    break
        return items

    def _merge(self, items: list[_Pending]):
        if len(items) == 1:
            return items[0].batch, items[0].n
        keys = items[0].batch.keys()
        b = {k: np.concatenate([it.batch[k] for it in items]) for k in keys}
        return b, sum(it.n for it in items)

    def _finish(self, items: list[_Pending], out: dict | None,
                error: BaseException | None) -> None:
        """Split a completed batch's host outputs (or an error) to its
        waiters and bump the stats counters."""
        off = 0
        for it in items:
            if error is not None:
                it.error = error
            else:
                it.result = {k: v[off:off + it.n] for k, v in out.items()}
                off += it.n
        with self._stats_lock:
            self.batches_dispatched += 1
            self.rows_dispatched += sum(it.n for it in items)
            self.requests_served += len(items)
        for it in items:
            it.done.set()

    def _dispatch(self, items: list[_Pending]) -> None:
        """Synchronous dispatch+complete (used by tests / drain paths)."""
        try:
            b, n = self._merge(items)
            out = self.served.apply_encoded(b, n)
        except BaseException as e:  # propagate to every waiter in the batch
            self._finish(items, None, e)
        else:
            self._finish(items, out, None)

    def _complete_loop(self) -> None:
        while True:
            entry = self._in_flight.get()
            if entry is None:
                return
            items, dev_out, n = entry
            try:
                out = self.served.finalize(dev_out, n)
            except BaseException as e:
                self._finish(items, None, e)
            else:
                self._finish(items, out, None)

    def _run_sync(self) -> None:
        """Dispatcher-pool worker: take a coalesced batch, run it end-to-end
        (dispatch + transfer) on this thread. K workers overlap K round
        trips — the winning shape when dispatch latency, not device
        occupancy, bounds throughput."""
        while True:
            items = self._take_batch()
            if not items:
                return
            self._dispatch(items)

    def _run(self) -> None:
        while True:
            items = self._take_batch()
            if not items:
                return
            try:
                b, n = self._merge(items)
                dev_out, n = self.served.apply_encoded_async(b, n)
            except BaseException as e:
                # dispatch-side failure (bad shapes, launch error): fail the
                # batch without involving the completer
                self._finish(items, None, e)
                continue
            self._in_flight.put((items, dev_out, n))  # blocks at max_in_flight
