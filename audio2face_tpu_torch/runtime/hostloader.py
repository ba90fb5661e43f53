"""Native host data-loading runtime: ctypes bindings and the device prefetcher.

Port of ``audio2face_tpu/runtime/hostloader.py``. The C++ functions of
``csrc/hostloader.cpp`` (a copy of the JAX package's source) replace the
reference's 8 DataLoader worker processes for the host's hot path: the
threaded fragment gather with int16 normalization, and the gather of vertex
rows from the memory-mapped array. The source builds with ``g++`` at first
use into ``build/torch_kernels/``, under a name that carries a digest of the
source and flags, so an edited source rebuilds; a missing compiler or a
failed build or load raises (there is no numpy fallback on the path). The
numpy bodies stay as ``*_reference`` functions, for the tests.

``Prefetcher`` overlaps batch assembly and the host-to-device copies with
the device's work: a worker thread assembles the next batch, copies each
array into a pinned host buffer and issues the copies on a CUDA stream of
its own; the consumer's stream waits on that copy's event. For a ``cpu``
device it hands over plain tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from audio2face_tpu_torch.ops._build import BUILD_DIR
from audio2face_tpu_torch.utils.device import resolve_device

SRC = Path(__file__).resolve().parent / "csrc" / "hostloader.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
RUNTIME_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libhostloader_{h.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile ``csrc/hostloader.cpp`` unless this digest is built, and load
    it. Raises if ``g++`` is missing, the build fails or the library does
    not load."""
    global _lib
    with _lock:
        path = library_path()
        if _lib is not None:
            return path
        if not path.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found on $PATH; the native host loader cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                capture_output=True, text=True, timeout=300,
            )
            (BUILD_DIR / "hostloader.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SRC.name}:\n{(proc.stdout + proc.stderr)[-4000:]}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.a2f_fragment_batch_i16.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.a2f_fragment_batch_i16.restype = None
        lib.a2f_gather_rows_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.a2f_gather_rows_f32.restype = None
        lib.a2f_runtime_version.argtypes = []
        lib.a2f_runtime_version.restype = ctypes.c_int
        version = lib.a2f_runtime_version()
        if version != RUNTIME_VERSION:
            raise RuntimeError(f"{path} is runtime version {version}, expected {RUNTIME_VERSION}")
        _lib = lib
        return path


def _native() -> ctypes.CDLL:
    if _lib is None:
        build_native()
    return _lib


def _default_threads() -> int:
    # the fragmenter's best on the H100 machine's 8-core host, where starting
    # and joining 8 threads costs ~1.4-1.8 ms (tools/torch_hostloader_threads.py)
    return min(4, os.cpu_count() or 1)


def fragment_batch_i16_reference(audio: np.ndarray, starts: np.ndarray, window: int) -> np.ndarray:
    """numpy version of :func:`fragment_batch_i16`."""
    audio = np.asarray(audio, np.int16)
    starts = np.asarray(starts, np.int64)
    idx = starts[:, None] + np.arange(window)[None, :]
    valid = (idx >= 0) & (idx < len(audio))
    out = np.where(valid, audio[np.clip(idx, 0, len(audio) - 1)], 0)
    return (out / 32768.0).astype(np.float32)


def fragment_batch_i16(
    audio: np.ndarray, starts: np.ndarray, window: int, n_threads: Optional[int] = None
) -> np.ndarray:
    """Fragments [start, start + window) of an int16 clip, normalized to
    float32; samples out of range are zero. ``starts`` may be negative."""
    if np.asarray(audio).ndim != 1:
        raise ValueError(f"audio must be 1-D, got shape {np.shape(audio)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    audio = np.ascontiguousarray(audio, dtype=np.int16)
    starts = np.ascontiguousarray(np.asarray(starts).reshape(-1), dtype=np.int64)
    n = len(starts)
    out = np.empty((n, window), np.float32)
    _native().a2f_fragment_batch_i16(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(len(audio)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), ctypes.c_int64(window),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n_threads or _default_threads()),
    )
    return out


def gather_rows_f32_reference(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """numpy version of :func:`gather_rows_f32`."""
    return np.ascontiguousarray(np.asarray(src)[np.asarray(indices, np.int64)], dtype=np.float32)


def gather_rows_f32(
    src: np.ndarray, indices: np.ndarray, n_threads: Optional[int] = None
) -> np.ndarray:
    """``out[i] = src[indices[i]]`` as float32 (e.g. rows of the memory-mapped
    (N, 5023, 3) vertex array): one memcpy per row straight from the page
    cache, on one thread unless ``n_threads`` says otherwise (one thread
    moves a 128-row batch in ~0.6 ms, less than more threads cost to start).
    A source that is not C-contiguous float32 is converted first."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    if src.ndim < 1:
        raise ValueError("src must have a row axis")
    indices = np.ascontiguousarray(np.asarray(indices).reshape(-1), dtype=np.int64)
    if len(indices) and (indices.min() < 0 or indices.max() >= len(src)):
        raise IndexError(f"row indices must lie in [0, {len(src)})")
    row_elems = int(np.prod(src.shape[1:]))
    out = np.empty((len(indices),) + src.shape[1:], np.float32)
    _native().a2f_gather_rows_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(indices)), ctypes.c_int64(row_elems),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(n_threads or 1),
    )
    return out


# ---------------------------------------------------------------------------
# Prefetcher
# ---------------------------------------------------------------------------


def _leaves(item, path=()):
    """(path, array) of every array leaf of a dict/list/tuple tree."""
    if isinstance(item, dict):
        for k, v in item.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(item, (list, tuple)):
        for i, v in enumerate(item):
            yield from _leaves(v, path + (i,))
    elif isinstance(item, (np.ndarray, torch.Tensor)):
        yield path, item


def _rebuild(item, new: dict, path=()):
    """``item`` with the leaf at each path of ``new`` replaced."""
    if isinstance(item, dict):
        return {k: _rebuild(v, new, path + (k,)) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_rebuild(v, new, path + (i,)) for i, v in enumerate(item))
    return new.get(path, item)


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return torch.from_numpy(np.ascontiguousarray(x))


class _PinnedSlot:
    """Pinned host buffers of one item in flight, reused once the copies
    that read them (``event``) have completed."""

    def __init__(self):
        self.buffers: dict = {}
        self.event: Optional[torch.cuda.Event] = None

    def buffer(self, path, host: torch.Tensor) -> torch.Tensor:
        nbytes = host.numel() * host.element_size()
        buf = self.buffers.get(path)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
            self.buffers[path] = buf
        return buf[:nbytes].view(host.dtype).view(host.shape)


_SENTINEL = object()


class Prefetcher:
    """Iterator that prepares the next ``depth`` items on a worker thread
    while the consumer works on the current one, in order; an exception in
    the source iterator or ``transform`` is raised in the consumer.

    ``device=None`` hands over the items as they are (after ``transform``).
    With a device, every numpy array or tensor in the item (nested in
    dicts, lists and tuples) arrives as a tensor on it:

    - ``cuda``: the worker copies each array into a pinned host buffer (a
      ring of ``depth + 2`` items' buffers, each reused only after its last
      copy's event has completed) and issues the host-to-device copies on a
      CUDA stream of its own, followed by an event; ``__next__`` makes
      the consumer's current stream wait on the copy and calls
      ``record_stream`` on each tensor, so the caching allocator does not
      hand its memory back to the copy stream while the consumer reads it;
    - ``cpu``: plain tensors (``torch.from_numpy``), so the CPU tests run
      the same loop.

    With ``record=True`` the copies are also bracketed by timing events and
    ``uploads`` gets one entry per item handed over on CUDA: ``bytes``
    copied, ``pinned`` (every source buffer pinned) and the copy's
    ``start``/``end`` events; ``upload_ms()`` reads their times. Otherwise
    ``uploads`` stays empty. ``close()`` stops the worker (also at the end
    of a ``with`` block)."""

    def __init__(
        self,
        iterator: Iterator,
        transform: Optional[Callable] = None,
        depth: int = 2,
        device=None,
        record: bool = False,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = None if device is None else resolve_device(device, "Prefetcher")
        self._cuda = self.device is not None and self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._record = record
        self.uploads: list[dict] = []
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._done = False
        if self._cuda:
            self._stream = torch.cuda.Stream(device=self.device)
            self._ring = [_PinnedSlot() for _ in range(depth + 2)]
        self._thread = threading.Thread(target=self._work, args=(iterator,), daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- worker

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, iterator) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            slot = 0
            for item in iterator:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                if self._cuda:
                    item = self._upload(item, self._ring[slot])
                    slot = (slot + 1) % len(self._ring)
                elif self.device is not None:
                    item = (_rebuild(item, {p: _host_tensor(x).to(self.device)
                                            for p, x in _leaves(item)}), None)
                if not self._put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            self._err = e
        finally:
            self._put(_SENTINEL)

    def _upload(self, item, slot: _PinnedSlot):
        if slot.event is not None:
            slot.event.synchronize()  # this slot's buffers are free again
        staged = []
        for path, x in _leaves(item):
            host = _host_tensor(x)
            buf = slot.buffer(path, host)
            buf.copy_(host)
            staged.append((path, buf))
        start = torch.cuda.Event(enable_timing=True) if self._record else None
        end = torch.cuda.Event(enable_timing=self._record)
        new = {}
        with torch.cuda.stream(self._stream):
            if start is not None:
                start.record(self._stream)
            for path, buf in staged:
                dev = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
                dev.copy_(buf, non_blocking=True)
                new[path] = dev
            end.record(self._stream)
        slot.event = end
        info = None
        if self._record:
            info = {
                "bytes": sum(b.numel() * b.element_size() for _, b in staged),
                "pinned": all(b.is_pinned() for _, b in staged),
                "start": start, "end": end,
            }
        return _rebuild(item, new), (end, list(new.values()), info)

    # -------------------------------------------------------------- consumer

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        got = self._q.get()
        if got is _SENTINEL:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        if self.device is None:
            return got
        item, copy = got
        if copy is not None:
            event, tensors, info = copy
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
            if info is not None:
                self.uploads.append(info)
        return item

    def upload_ms(self) -> list[float]:
        """Device milliseconds of each handed-over item's copies (CUDA
        events on the copy stream; waits for them)."""
        out = []
        for u in self.uploads:
            u["end"].synchronize()
            out.append(u["start"].elapsed_time(u["end"]))
        return out

    def close(self) -> None:
        """Stop the worker; items not yet handed over are dropped."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=60)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
