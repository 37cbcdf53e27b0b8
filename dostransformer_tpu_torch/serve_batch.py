"""Cross-request micro-batching for the serving path.

Counterpart of dostransformer_tpu/serve_batch.py, ported as it stands.
Concurrent ``predict`` calls coalesce into ONE call of the wrapped
predictor: a single worker thread drains the request queue, waits up to
``max_delay_ms`` for stragglers, concatenates the sample lists, runs the
wrapped predictor once, and splits the [N, bins] result back per request.

Why: the card serves one request at a time anyway (serve_http serializes on
a lock), and each request pays fixed costs (a short final batch padded with
dummy graphs, the one copy to the host) — so K concurrent 8-sample requests
cost K of them serially, while one coalesced 8K-sample request streams its
batches through the predictor's graphs (serve_dispatch.py) and pays them
once. Only the worker thread touches the card, so a graph's capture runs
there too.

Failure isolation: the predictor raises ValueError on client-side input
errors (empty request, shape-envelope overflow in collate). A coalesced
dispatch that fails is retried per-request so one client's bad input cannot
fail its neighbors — the slow path only runs on errors.

    batcher = CoalescingBatcher(predictor, max_delay_ms=2.0)
    dos = batcher.predict(samples)   # thread-safe, blocks for the result
    batcher.close()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np

from dostransformer_tpu_torch.data.graph import RequestError


class CoalescingBatcher:
    """Thread-safe predict() that coalesces concurrent requests.

    Wraps any object with ``predict(samples) -> [N, bins]`` in input order
    (serve.Predictor, serve_dispatch.ExportedPredictor). ``max_delay_ms``
    bounds the extra latency a lone request pays waiting for company;
    ``max_samples`` caps one coalesced dispatch (a full window dispatches
    immediately).
    """

    def __init__(self, predictor, max_delay_ms: float = 2.0,
                 max_samples: int = 4096):
        self.predictor = predictor
        self.max_delay_s = max_delay_ms / 1e3
        self.max_samples = max_samples
        self.batch_size = getattr(predictor, "batch_size", None)
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # orders enqueues against close(): the shutdown sentinel must be the
        # LAST item the queue ever sees, or a request racing close() would
        # land behind a dead worker and block its Future forever
        self._gate = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dostpu-batcher")
        self._worker.start()

    def predict(self, samples: Sequence) -> np.ndarray:
        """Enqueue one request and block for its rows of the coalesced
        result. Raises whatever the predictor raised for THIS request."""
        samples = list(samples)
        if not samples:
            # same message/path as Predictor.predict — never coalesce an
            # empty list into a neighbor's batch
            raise RequestError("empty request: no samples to predict")
        fut: Future = Future()
        with self._gate:
            if self._closed:
                # a request enqueued after the sentinel would wait forever
                # on a worker that already exited
                raise RuntimeError("CoalescingBatcher is closed")
            self._q.put((samples, fut))
        return fut.result()

    def close(self) -> None:
        """Drain pending requests and stop the worker (idempotent).
        Requests enqueued before close() still resolve; predict() after
        close() raises RuntimeError."""
        with self._gate:
            if not self._closed:
                self._closed = True
                self._q.put(None)
        self._worker.join()

    # -- worker ------------------------------------------------------------

    def _collect(self, first):
        """First request + everything arriving within the delay window."""
        batch = [first]
        total = len(first[0])
        end = time.monotonic() + self.max_delay_s
        while total < self.max_samples:
            remaining = end - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:          # close() mid-window: stop collecting,
                self._q.put(None)     # re-post the sentinel for _run
                break
            batch.append(item)
            total += len(item[0])
        return batch

    def _dispatch(self, batch) -> None:
        try:
            all_samples = [s for samples, _ in batch for s in samples]
            out = self.predictor.predict(all_samples)
        except Exception as e:
            if len(batch) == 1:
                batch[0][1].set_exception(e)
                return
            # isolate the offender: retry each request on its own
            for samples, fut in batch:
                try:
                    fut.set_result(self.predictor.predict(samples))
                except Exception as ee:
                    fut.set_exception(ee)
            return
        row = 0
        for samples, fut in batch:
            # copy, not a view: per-request results must not share the
            # coalesced buffer (a client mutating its rows in place would
            # corrupt its neighbors', and one held slice would pin the
            # whole window's memory)
            fut.set_result(out[row: row + len(samples)].copy())
            row += len(samples)

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            try:
                batch = self._collect(item)
                self._dispatch(batch)
            except BaseException as e:  # noqa: B036 — the worker must
                # survive ANYTHING (MemoryError on a huge window, a buggy
                # wrapped predictor, ...): a dead worker would silently
                # hang every queued and future request forever, since
                # predict() keeps enqueueing while _closed is False
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
