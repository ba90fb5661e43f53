"""Spans and counters on the serving path, on the profiler's clock.

One recording is open at a time::

    with spans.recording() as rec:
        predictor(audios, one_hot, template)
    rec.spans      # every span, in the order opened
    rec.counters   # {name: int}

While no recording is open, ``span`` and ``count`` cost one check of a
module attribute: ``span`` returns a shared no-op and nothing is recorded
(no ``torch.profiler.record_function`` either).

A span holds its name, its start and end on ``time.time_ns()`` (the epoch
clock the PyTorch profiler stamps its events with, so spans and device
events share one timeline), its parent (an index into ``rec.spans``, from a
stack per thread), its request id and its thread. The outermost span of a
thread (the predictors' ``predict``, one a call) takes a new request id,
which every span opened inside it shares, and also holds the process's CPU
time (``time.process_time_ns``) over its extent. Counters are plain
integers.

Everything stays in memory; the caller reads the recording once it is
closed. A span still open when the recording closes keeps ``end_ns``
``None``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int] = None
    parent: Optional[int] = None  # index into Recording.spans
    request: Optional[int] = None
    thread: int = 0
    # outermost spans only: the process's CPU time over the span
    cpu_ns: Optional[int] = None


class Recording:
    """The spans and counters recorded while it was open."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._requests = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, sp: Span, outermost: bool) -> int:
        with self._lock:
            if outermost:
                sp.request = self._requests
                self._requests += 1
            self.spans.append(sp)
            return len(self.spans) - 1

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)


class _Open:
    """The context manager of one span while a recording is open."""

    __slots__ = ("rec", "name", "index", "cpu0")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> None:
        rec = self.rec
        stack = rec._stack()
        sp = Span(self.name, 0, thread=threading.get_ident())
        if stack:
            sp.parent = stack[-1]
            sp.request = rec.spans[sp.parent].request
        else:
            self.cpu0 = time.process_time_ns()
        self.index = rec._append(sp, outermost=not stack)
        stack.append(self.index)
        sp.start_ns = time.time_ns()

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        rec = self.rec
        sp = rec.spans[self.index]
        sp.end_ns = end
        stack = rec._stack()
        stack.pop()
        if not stack:
            sp.cpu_ns = time.process_time_ns() - self.cpu0


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()
_active: Optional[Recording] = None
_open_lock = threading.Lock()


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Open the process's recording; a second one open at once raises."""
    global _active
    rec = Recording()
    with _open_lock:
        if _active is not None:
            raise RuntimeError("a span recording is already open")
        _active = rec
    try:
        yield rec
    finally:
        with _open_lock:
            _active = None


def span(name: str):
    """``with span(name):`` marks a span of the open recording."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return _Open(rec, name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the open recording's counter ``name``."""
    rec = _active
    if rec is not None:
        rec.count(name, n)
