"""The traced run's reduction: device time by operation, busy and idle
time, each kernel's launching span, and the idle gaps by what the host was
doing.

Reads the profiler's raw events (``kineto_results.events()``): device
events (kernels, copies, sets) with their correlation ids and the host's
runtime calls that launched them (``cuda*``/``cu*``, the same ids); and
the harness's own spans, recorded on the same clock. Nothing here reads
the program.
"""

from __future__ import annotations

import contextlib
import heapq
import threading
import time
from typing import Callable, Optional

WINDOW = "window"


class Spans:
    """The harness's spans, recorded on the host clock the profiler uses
    (``time.time_ns``) from any thread, the program's own included."""

    def __init__(self):
        self.spans: list = []  # (start_ns, end_ns, name)
        self._lock = threading.Lock()

    def wrap(self, name: str, fn: Callable) -> Callable:
        """``fn`` called inside the span ``name``."""

        def wrapper(*args, **kwargs):
            start = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                end = time.time_ns()
                with self._lock:
                    self.spans.append((start, end, name))

        return wrapper

    @contextlib.contextmanager
    def window(self):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((start, time.time_ns(), WINDOW))


def no_span(name: str, fn: Callable) -> Callable:
    return fn


@contextlib.contextmanager
def profiled(enabled: bool):
    """The profiler around the window (CPU and CUDA activities), or nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def _device_type_name(ev) -> str:
    return str(ev.device_type()).split(".")[-1].upper()


class Trace:
    """Device events of one traced window, reduced."""

    def __init__(self, prof, spans: list):
        launches, device = {}, []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = ev.start_ns()
            if _device_type_name(ev) == "CUDA":
                device.append((start, start + ev.duration_ns(), name, ev.correlation_id()))
            elif name.startswith("cu"):
                launches[ev.correlation_id()] = start
        windows = [sp for sp in spans if sp[2] == WINDOW]
        if windows:
            self.t0, self.t1 = windows[0][0], windows[0][1]
        elif device:
            self.t0, self.t1 = min(d[0] for d in device), max(d[1] for d in device)
        else:
            self.t0 = self.t1 = 0
        self.spans = sorted(sp for sp in spans if sp[2] != WINDOW)
        self.device = sorted(d for d in device if d[1] > self.t0 and d[0] < self.t1)
        self.launched = [launches.get(d[3]) for d in self.device]
        self.matched = sum(t is not None for t in self.launched)
        self.span_of = self._spans_at(self.launched)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _busy_intervals(self) -> list:
        merged = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds in which some kernel, copy or set ran."""
        return sum(e - s for s, e in self._busy_intervals()) / 1e9

    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def _spans_at(self, times: list) -> list:
        """The innermost harness span (latest start) open at each time."""
        order = sorted((t, i) for i, t in enumerate(times) if t is not None)
        out: list = [None] * len(times)
        open_: list = []  # heap of (-start, end, name)
        k = 0
        for t, i in order:
            while k < len(self.spans) and self.spans[k][0] <= t:
                s, e, name = self.spans[k]
                heapq.heappush(open_, (-s, e, name))
                k += 1
            # times only grow, so a span closed now stays closed
            while open_ and open_[0][1] < t:
                heapq.heappop(open_)
            out[i] = open_[0][2] if open_ else None
        return out

    def device_seconds(self, match: Callable[[str], bool], span_name: Optional[str] = None) -> float:
        """Device seconds of the events whose name ``match`` accepts and,
        with ``span_name``, that were launched inside that harness span."""
        total = 0
        for (s, e, name, _), sp in zip(self.device, self.span_of):
            if match(name) and (span_name is None or sp == span_name):
                total += e - s
        return total / 1e9

    def breakdown(self, n: int = 10) -> dict:
        """The device operations with the most time, and the longest idle
        gaps named by the harness span the host was in when each began."""
        by_name: dict = {}
        for s, e, name, _ in self.device:
            key = name[:120]
            by_name[key] = by_name.get(key, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        edges = [self.t0]
        gaps = []
        for s, e in self._busy_intervals():
            if s > edges[-1]:
                gaps.append((s - edges[-1], edges[-1]))
            edges.append(e)
        if self.t1 > edges[-1]:
            gaps.append((self.t1 - edges[-1], edges[-1]))
        gaps = sorted(gaps, reverse=True)[:n]
        names = self._spans_at([g[1] for g in gaps])
        return {
            "device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[nm or "window", g[0] / 1e9] for g, nm in zip(gaps, names)],
        }
