"""Host-side request batching for production serving.

Port of ``audio2face_tpu/serving_queue.py`` (host code, as it stands; the
dispatcher calls the predictor under ``torch.inference_mode()``, which is
per thread). The reference serves one clip at a time from inside its Lightning predict
loop; this module provides the fleet-style front end: concurrent callers
submit single clips, a dispatcher thread coalesces them (up to the
predictor's ``max_batch``, waiting at most ``max_wait_ms`` for stragglers)
and issues one padded, bucketed ``FaceFormerPredictor`` call per group —
so GPU utilization tracks offered load instead of per-caller batch size.

Production hardening (round 3):

- **bounded queue + backpressure**: ``max_queue`` caps in-flight depth;
  at the cap ``submit`` either blocks the caller (default) or raises
  ``queue.Full`` (``block=False``) — offered load can no longer grow the
  queue without bound.
- **cancellation**: callers may ``future.cancel()`` any time before
  dispatch; cancelled requests are skipped (and never run) — the standard
  ``concurrent.futures`` contract via ``set_running_or_notify_cancel``.
- **per-request timeout**: ``submit(..., timeout=s)`` bounds time in
  queue; requests still undispatched at their deadline resolve with
  ``TimeoutError`` instead of waiting forever behind a slow batch.
- **failure isolation**: a predictor exception resolves (only) that
  group's futures with the exception; the dispatcher thread survives and
  keeps serving subsequent requests.
- **queue wait**: each request's wait from ``submit`` to dispatch is kept
  for the last ``WAIT_WINDOW`` requests (``queue_waits()``, the daemon's
  ``/stats``).

Pure host-side threading: the GPU sees only the predictor's calls.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

WAIT_WINDOW = 512  # the last queue waits kept for queue_waits()


@dataclass(eq=False)  # identity semantics; field-wise eq over arrays is a trap
class _Request:
    audio: np.ndarray
    one_hot: np.ndarray
    template: np.ndarray
    sample_rate: int
    future: Future
    deadline: Optional[float] = None  # monotonic seconds; None = no timeout
    submitted: float = 0.0  # monotonic seconds when submit() was called
    # whether this request currently owns a depth-semaphore slot. submit()
    # always acquires one; _requeue() may fail its non-blocking re-acquire,
    # in which case the request rides slotless and _take must NOT release
    # for it (a release would exceed the BoundedSemaphore's bound and kill
    # the dispatcher thread with ValueError).
    holds_slot: bool = True


class BatchingServer:
    """Coalesce concurrent single-clip requests into batched predictor calls.

    Usage::

        server = BatchingServer(predictor, max_queue=64)
        fut = server.submit(audio, one_hot, template, timeout=30.0)
        vertices = fut.result()
        server.close()
    """

    def __init__(
        self,
        predictor,
        *,
        max_wait_ms: float = 10.0,
        max_queue: Optional[int] = None,
    ):
        self.predictor = predictor
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        # queue-depth accounting lives in a semaphore rather than the
        # Queue's maxsize so close()'s sentinel can never block on a full
        # queue; one release per request the dispatcher takes off the queue
        self._slots = (
            threading.BoundedSemaphore(max_queue) if max_queue else None
        )
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._closed = False
        # predictor calls made (the dispatcher thread alone writes it):
        # coalescing shows as fewer batches than requests
        self.batches = 0
        # seconds from submit to dispatch of the last WAIT_WINDOW requests
        self._waits: collections.deque = collections.deque(maxlen=WAIT_WINDOW)
        self._waits_lock = threading.Lock()
        # serializes the closed-check against close()'s sentinel enqueue:
        # without it a submit could land BEHIND the shutdown sentinel and
        # its future would never resolve
        self._lock = threading.Lock()
        self._thread.start()

    def submit(
        self,
        audio: np.ndarray,
        one_hot: np.ndarray,
        template: np.ndarray,
        sample_rate: int = 16000,
        *,
        timeout: Optional[float] = None,
        block: bool = True,
    ) -> Future:
        """Enqueue one clip; returns a Future resolving to (T, V, 3).

        timeout: max seconds the request may wait before dispatch — the
            clock starts NOW, so time spent blocked at the backpressure
            gate counts against it: if no slot frees within the deadline
            ``submit`` raises ``TimeoutError`` synchronously, and a request
            still undispatched at its deadline resolves its future with
            ``TimeoutError``. (It does not preempt a dispatch in flight.)
        block: behavior at ``max_queue`` depth — True applies backpressure
            (the caller blocks for a free slot), False raises ``queue.Full``.
        """
        t0 = time.monotonic()
        if self._slots is not None and not self._slots.acquire(
            block, timeout if block else None
        ):
            if block and timeout is not None:
                raise TimeoutError(
                    "timed out waiting for a serving-queue slot"
                )
            raise queue.Full("serving queue is at max_queue depth")
        try:
            fut: Future = Future()
            req = _Request(
                np.asarray(audio, np.float32),
                np.asarray(one_hot, np.float32),
                np.asarray(template, np.float32),
                int(sample_rate),
                fut,
                t0 + timeout if timeout is not None else None,
                t0,
            )
            with self._lock:
                if self._closed:
                    raise RuntimeError("server is closed")
                self._q.put(req)
            return fut
        except BaseException:
            if self._slots is not None:
                self._slots.release()
            raise

    def queue_waits(self) -> list[float]:
        """Seconds from ``submit`` to dispatch of the last requests
        dispatched (at most ``WAIT_WINDOW``)."""
        with self._waits_lock:
            return list(self._waits)

    def close(self) -> None:
        """Drain outstanding requests and stop the dispatcher."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join()

    # ------------------------------------------------------------------

    def _take(self, timeout: Optional[float] = None) -> Optional[_Request]:
        """Pop one item, releasing its depth slot if it owns one (the
        sentinel and slotless requeued stragglers don't)."""
        item = self._q.get() if timeout is None else self._q.get(timeout=timeout)
        if item is not None and self._slots is not None and item.holds_slot:
            self._slots.release()
        return item

    def _run(self) -> None:
        stop = False
        while not stop:
            first = self._take()
            if first is None:
                break
            group = [first]
            deadline = time.monotonic() + self.max_wait
            # same-rate requests batch together; a rate change flushes
            while len(group) < self.predictor.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._take(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                if nxt.sample_rate != first.sample_rate:
                    self._requeue(nxt)  # next group picks it up
                    break
                group.append(nxt)
            self._dispatch(group)
        # drain requests that slipped behind the shutdown sentinel (e.g. a
        # rate-change requeue) — close() promises every future resolves
        leftovers: list[_Request] = []
        while True:
            try:
                r = self._take(timeout=0.001)
            except queue.Empty:
                break
            if r is not None:
                leftovers.append(r)
        while leftovers:
            rate = leftovers[0].sample_rate
            group: list[_Request] = []
            rest: list[_Request] = []
            for r in leftovers:
                if r.sample_rate == rate and len(group) < self.predictor.max_batch:
                    group.append(r)
                else:
                    rest.append(r)
            leftovers = rest
            self._dispatch(group)

    def _requeue(self, r: _Request) -> None:
        """Put a popped request back (rate-change flush); re-takes a slot
        if one is free, else rides slotless — depth accounting may briefly
        undercount by the one straggler, never overcount. Slot ownership is
        recorded on the request so _take releases exactly what was
        acquired (a blind release here could exceed the semaphore bound
        once concurrent submits grab the freed slots first)."""
        r.holds_slot = (
            self._slots.acquire(blocking=False) if self._slots is not None else True
        )
        self._q.put(r)

    def _dispatch(self, group: list[_Request]) -> None:
        # filter cancelled / queue-expired requests: cancellation uses the
        # standard Future contract (set_running_or_notify_cancel marks the
        # survivors running, so they can no longer be cancelled mid-batch)
        now = time.monotonic()
        live: list[_Request] = []
        for r in group:
            if r.deadline is not None and now > r.deadline:
                if not r.future.cancelled() and not r.future.done():
                    r.future.set_exception(
                        TimeoutError(
                            "request timed out in serving queue before dispatch"
                        )
                    )
                continue
            if not r.future.set_running_or_notify_cancel():
                continue  # cancelled by the caller; never runs
            live.append(r)
        if not live:
            return
        now = time.monotonic()
        with self._waits_lock:
            self._waits.extend(now - r.submitted for r in live)
        try:
            self.batches += 1
            # grad mode is per thread: this thread's calls build no graph
            with torch.inference_mode():
                results = self.predictor(
                    [r.audio for r in live],
                    np.stack([r.one_hot for r in live]),
                    np.stack([r.template for r in live]),
                    sample_rate=live[0].sample_rate,
                )
            for r, v in zip(live, results):
                r.future.set_result(v)
        except Exception as e:
            # the whole group shares one padded predictor call, so one bad
            # request fails its groupmates' futures too — but never the
            # dispatcher: the loop continues serving later submissions
            for r in live:
                if not r.future.done():
                    r.future.set_exception(e)
