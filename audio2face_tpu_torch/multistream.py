"""Multi-stream (batched) live FaceFormer serving: N concurrent streams share
one GPU, one batched encoder call and one decoder pass per step.

Port of ``audio2face_tpu/multistream.py``. The single-stream
``StreamingFaceFormerPredictor`` carries one KV cache, feedback embedding
and frame counter; this module batches that state over a fixed pool of
``n_streams`` slots:

- **encoder**: every ready slot's sliding window is encoded in one
  (S, window) batch per step (K2 and K1 at batch S), with per-slot
  normalization statistics (audio up to chunk end + lookahead, float64 on
  the host, as in ``streaming.py``);
- **decoder**: the KV caches (S, H, T_max + 1, hd), feedback embeddings
  (S, d) and absolute frame counters (S,) advance together, each stream at
  its own frame: the ALiBi bias and causal mask take per-item positions
  (``decode_step_attention`` with a (S,) step) and each stream writes its
  cache row at its own t. Slots with no full chunk buffered ride along with
  ``n_valid = 0``: their writes land in the scratch row T_max (never
  attended) and their carried state is frozen, so an idle or late-joining
  stream equals one that never stepped;
- **flush**: tails are zero-padded to the full window and masked with
  ``n_valid = frame_count(tail)``, so every step has the same shapes.

Per stream, the decoder is the reference's autoregressive loop
(src/model/faceformer.py:154-185) exactly, and the encoder's bounded-context
approximation is ``streaming.py``'s: N interleaved streams reproduce N solo
streams. ``mesh=`` (the JAX pool's slot sharding over chips) is not ported
yet. Runs on the GPU unless ``device="cpu"``; every call that touches the
device runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from audio2face_tpu_torch.models.decoder_step import (
    decoder_step_params,
    make_decoder_step,
    run_decoder_steps,
)
from audio2face_tpu_torch.models.faceformer import (
    AUDIO_SR,
    FEATURE_DIM,
    N_HEADS,
    frame_count,
)
from audio2face_tpu_torch.streaming import _ceil_grain, encode_windows, load_live_faceformer
from audio2face_tpu_torch.utils.device import resolve_device


class _SlotState:
    """Host-side per-stream bookkeeping (audio buffers and norm stats)."""

    __slots__ = (
        "active", "finished", "flushed", "buffer", "history",
        "base_sum", "base_sqsum", "base_n", "pending",
    )

    def __init__(self):
        self.active = False
        self.reset()

    def reset(self):
        self.finished = False  # saw last=True
        self.flushed = False  # tail emitted; stream complete
        self.buffer = np.zeros((0,), np.float32)
        self.history = np.zeros((0,), np.float32)
        self.base_sum = 0.0
        self.base_sqsum = 0.0
        self.base_n = 0
        self.pending: list[np.ndarray] = []


class MultiStreamFaceFormerPredictor:
    """Fixed pool of ``n_streams`` concurrent live streams on one GPU.

    Usage::

        pool = MultiStreamFaceFormerPredictor(variables, n_verts, n_streams=8)
        a = pool.open_stream(one_hot_a, template_a)
        b = pool.open_stream(one_hot_b, template_b)
        frames_a = pool.push(a, audio_chunk)          # may be empty
        frames_b = pool.push(b, more_audio, last=True)
        pool.close_stream(a)

    ``push`` advances every slot that has a full chunk buffered (one batched
    step serves the whole pool); frames produced for other slots are kept
    and returned by their own next ``push``/``poll``. Weights as
    ``StreamingFaceFormerPredictor``'s."""

    def __init__(
        self,
        variables: Optional[dict] = None,
        n_verts: int = 15069,
        *,
        state_dict: Optional[dict] = None,
        n_streams: int = 8,
        n_onehot: int = 12,
        chunk_seconds: float = 1.0,
        left_seconds: float = 2.0,
        lookahead_seconds: float = 0.5,
        max_seconds: float = 120.0,
        dtype: Optional[torch.dtype] = None,
        unit_scale: float = 100.0,
        seed: int = 0,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= serving is not ported yet (ROADMAP.md queue 1 item 4: parallelism)")
        self.device = resolve_device(device, "MultiStreamFaceFormerPredictor")
        self.model = load_live_faceformer(
            variables, state_dict, n_verts, n_onehot, dtype, seed, self.device)
        self.n_verts = n_verts
        self.n_onehot = n_onehot
        self.n_streams = int(n_streams)
        self.sr = AUDIO_SR  # ingest clock (wire surfaces validate against it)
        self.fps = 60  # vocaset animation clock
        self.dtype = dtype
        self.unit_scale = float(unit_scale)
        self.chunk = _ceil_grain(int(chunk_seconds * AUDIO_SR))
        self.left = _ceil_grain(int(left_seconds * AUDIO_SR))
        self.lookahead = _ceil_grain(int(lookahead_seconds * AUDIO_SR))
        self.t_max = frame_count(_ceil_grain(int(max_seconds * AUDIO_SR)))
        self.chunk_frames = frame_count(self.chunk)

        s, hd, dev = self.n_streams, FEATURE_DIM // N_HEADS, self.device
        self._slots = [_SlotState() for _ in range(s)]
        with torch.inference_mode():
            self._p = decoder_step_params(self.model)
            self._emb = torch.zeros((s, FEATURE_DIM), device=dev)
            # row t_max is the scratch row idle slots write to (never attended)
            self._k_cache = torch.zeros((s, N_HEADS, self.t_max + 1, hd), device=dev)
            self._v_cache = torch.zeros((s, N_HEADS, self.t_max + 1, hd), device=dev)
            self._styles = torch.zeros((s, FEATURE_DIM), device=dev)
            self._templates = torch.zeros((s, n_verts // 3, 3), device=dev)
        self._t0 = np.zeros((s,), np.int64)

    # ------------------------------------------------------------------
    # stream lifecycle
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def open_stream(self, one_hot: np.ndarray, template: np.ndarray) -> int:
        """Claim a free slot for a new stream; returns its slot id."""
        free = next((i for i, sl in enumerate(self._slots) if not sl.active), None)
        if free is None:
            raise RuntimeError(
                f"all {self.n_streams} stream slots are busy; close_stream() "
                "one or provision a larger pool"
            )
        sl = self._slots[free]
        sl.active = True
        sl.reset()
        one_hot = torch.as_tensor(np.asarray(one_hot, np.float32).reshape(self.n_onehot),
                                  device=self.device)
        style = F.linear(one_hot, self.model.obj_vector.weight.float())
        self._styles[free] = style
        self._emb[free] = style  # emb_0 = the style embedding
        self._templates[free] = torch.as_tensor(
            np.asarray(template, np.float32).reshape(-1, 3), device=self.device) * self.unit_scale
        self._t0[free] = 0
        return free

    def close_stream(self, slot: int) -> None:
        """Release a slot (pending frames are discarded)."""
        self._slots[slot].active = False

    def poll(self, slot: int) -> np.ndarray:
        """Collect frames produced for ``slot`` by other streams' pushes."""
        return self._drain(slot)

    # ------------------------------------------------------------------
    # data path
    # ------------------------------------------------------------------

    def feed(self, slot: int, audio: np.ndarray, *, last: bool = False) -> None:
        """Buffer audio for ``slot`` without stepping the pool: callers that
        coordinate several streams feed every slot first, then ``pump()``
        once, so that each batched step carries all of them."""
        sl = self._slots[slot]
        if not sl.active:
            raise RuntimeError(f"slot {slot} is not open")
        if sl.finished:
            raise RuntimeError("stream was flushed (last=True); open a new one")
        audio = np.asarray(audio, np.float32).reshape(-1)
        if frame_count(sl.base_n + len(sl.buffer) + len(audio)) > self.t_max:
            raise RuntimeError(
                f"stream exceeds max_seconds capacity ({self.t_max} frames); "
                "raise max_seconds or open a new stream"
            )
        sl.buffer = np.concatenate([sl.buffer, audio])
        if last:
            sl.finished = True

    def pump(self) -> None:
        """Advance the pool until no stream has a full chunk buffered (and
        every flushing stream's tail is emitted)."""
        while any(
            self._chunk_ready(sl) or self._flush_ready(sl) for sl in self._slots
        ):
            self._step()

    def push(self, slot: int, audio: np.ndarray, *, last: bool = False) -> np.ndarray:
        """Feed audio into ``slot``; advances every chunk-ready stream by
        batched steps. Returns this slot's newly decoded vertices
        (T_new, V, 3) in data units (possibly empty)."""
        self.feed(slot, audio, last=last)
        self._pump(slot)
        return self._drain(slot)

    def flush(self, slot: int) -> np.ndarray:
        """Decode everything still buffered for ``slot`` (end of stream)."""
        return self.push(slot, np.zeros((0,), np.float32), last=True)

    # ------------------------------------------------------------------

    def _chunk_ready(self, sl: _SlotState) -> bool:
        return sl.active and len(sl.buffer) >= self.chunk + self.lookahead

    def _flush_ready(self, sl: _SlotState) -> bool:
        return sl.active and sl.finished and not sl.flushed

    def _pump(self, slot: int) -> None:
        sl = self._slots[slot]
        while self._chunk_ready(sl) or self._flush_ready(sl):
            self._step()

    @torch.inference_mode()
    def _step(self) -> None:
        """One batched (encoder, decoder) step over the whole pool."""
        s = self.n_streams
        window = self.left + self.chunk + self.lookahead
        norm = np.zeros((s, window), np.float32)
        n_valid = np.zeros((s,), np.int64)

        for i, sl in enumerate(self._slots):
            if self._chunk_ready(sl):
                n_chunk, span = self.chunk, self.chunk + self.lookahead
            elif self._flush_ready(sl) and len(sl.buffer) > self.chunk:
                # end of stream with more than a chunk left but less than a
                # full lookahead: a whole chunk against the partial
                # (zero-padded) lookahead
                n_chunk, span = self.chunk, len(sl.buffer)
            elif self._flush_ready(sl):
                n_chunk = span = len(sl.buffer)
                sl.flushed = True
                if frame_count(n_chunk) == 0:  # sub-frame tail: drop
                    sl.buffer = sl.buffer[:0]
                    continue
            else:
                continue
            win = sl.buffer[:span]
            tot_n = sl.base_n + win.size
            tot_sum = sl.base_sum + float(win.sum(dtype=np.float64))
            tot_sq = sl.base_sqsum + float(np.square(win, dtype=np.float64).sum())
            mean = tot_sum / max(tot_n, 1)
            var = max(tot_sq / max(tot_n, 1) - mean * mean, 0.0)
            hist = sl.history[-self.left:] if self.left else sl.history[:0]
            if len(hist) < self.left:
                hist = np.concatenate(
                    [np.zeros(self.left - len(hist), np.float32), hist]
                )
            raw = np.concatenate(
                [hist, win, np.zeros(window - self.left - win.size, np.float32)]
            )
            norm[i] = (raw - mean) / np.sqrt(var + 1e-7)
            n_valid[i] = frame_count(n_chunk)
            # advance the host-side stream state
            chunk_samples = sl.buffer[:n_chunk]
            sl.base_n += chunk_samples.size
            sl.base_sum += float(chunk_samples.sum(dtype=np.float64))
            sl.base_sqsum += float(np.square(chunk_samples, dtype=np.float64).sum())
            if self.left:
                sl.history = np.concatenate([sl.history, chunk_samples])[-self.left:]
            sl.buffer = sl.buffer[n_chunk:]

        if not n_valid.any():
            return

        keep_from = frame_count(self.left)
        cross = encode_windows(
            self.model, norm, frame_count(window), keep_from, keep_from + self.chunk_frames,
            self.device, use_kernels=True)
        dev = self.device
        step = make_decoder_step(
            self._p, styles=self._styles, t0=torch.as_tensor(self._t0, device=dev),
            n_valid=torch.as_tensor(n_valid, device=dev), t_scratch=self.t_max,
        )
        (self._emb, self._k_cache, self._v_cache), hs = run_decoder_steps(
            step, (self._emb, self._k_cache, self._v_cache), cross)
        verts = self.model.vertex_head(hs, self._templates) / self.unit_scale
        # one device-to-host copy of the rows that hold frames, whatever the
        # number of slots served
        served = np.flatnonzero(n_valid)
        verts_np = verts[torch.as_tensor(served, device=dev)].cpu().numpy()
        for row, i in enumerate(served):
            self._slots[i].pending.append(verts_np[row, : n_valid[i]])
        self._t0 += n_valid

    def _drain(self, slot: int) -> np.ndarray:
        sl = self._slots[slot]
        if not sl.pending:
            return np.zeros((0, self.n_verts // 3, 3), np.float32)
        out = np.concatenate(sl.pending)
        sl.pending = []
        return out


class StreamingSession:
    """One live caller's handle onto a ``StreamingServer`` slot."""

    def __init__(self, server: "StreamingServer", slot: int):
        self._server = server
        self._slot = slot
        self._chunks: list[np.ndarray] = []  # frames routed by others' pushes
        self._closed = False

    def push(self, audio: np.ndarray, *, last: bool = False) -> np.ndarray:
        """Feed audio; returns every frame decoded for this session and not
        yet returned (its own chunks plus any produced while other
        sessions' pushes advanced the shared pool)."""
        if self._closed:
            raise RuntimeError("session is closed")
        return self._server._push(self, audio, last)

    def flush(self) -> np.ndarray:
        return self.push(np.zeros((0,), np.float32), last=True)

    def poll(self) -> np.ndarray:
        """Collect piggybacked frames without feeding audio."""
        if self._closed:
            raise RuntimeError("session is closed")
        return self._server._poll(self)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._server._close(self)


class StreamingServer:
    """Thread-safe live-serving front end over a shared multi-stream pool.

    Concurrent callers each open a session; every push is serialized onto
    the pool under one lock, and each batched step advances every
    chunk-ready session, so N live callers share one GPU at batch
    efficiency (the live counterpart of ``serving_queue.BatchingServer``).
    Frames a step produces for other sessions are routed to them at once and
    returned by their next push()/poll(). ``open_session`` raises when all
    slots are busy unless ``wait=True``.

    Any pool with ``n_streams``/``n_verts``/``open_stream``/``close_stream``/
    ``push``/``poll`` serves: pass ``pool=`` to front a
    ``frame_stream.FrameStreamPool`` instead of the FaceFormer pool built
    from ``variables``/``n_verts``/``pool_kwargs`` (``state_dict=`` or a
    seeded random init in place of ``variables``, as the pool takes them)."""

    def __init__(
        self,
        variables: Optional[dict] = None,
        n_verts: Optional[int] = None,
        *,
        pool=None,
        **pool_kwargs,
    ):
        if pool is None:
            if n_verts is None:
                raise TypeError(
                    "StreamingServer needs either a prebuilt pool= or n_verts "
                    "(and the weights) for the FaceFormer pool"
                )
            pool = MultiStreamFaceFormerPredictor(
                variables, n_verts, **pool_kwargs
            )
        elif variables is not None or n_verts is not None or pool_kwargs:
            raise TypeError("pass either pool= or FaceFormer pool arguments, not both")
        self._pool = pool
        self._lock = threading.Lock()
        self._free = threading.Condition(self._lock)
        self._sessions: dict[int, StreamingSession] = {}

    @property
    def n_streams(self) -> int:
        return self._pool.n_streams

    @property
    def n_verts(self) -> int:
        return self._pool.n_verts

    @property
    def n_onehot(self) -> int:
        return self._pool.n_onehot

    @property
    def sample_rate(self) -> int:
        """The pool's ingest clock: wire clients must send PCM at it."""
        return int(getattr(self._pool, "sr", 16000))

    @property
    def fps(self) -> int:
        return int(getattr(self._pool, "fps", 60))

    def open_session(
        self, one_hot: np.ndarray, template: np.ndarray,
        *, wait: bool = False, timeout: Optional[float] = None,
    ) -> StreamingSession:
        with self._free:
            if wait:
                ok = self._free.wait_for(
                    lambda: len(self._sessions) < self._pool.n_streams,
                    timeout=timeout,
                )
                if not ok:
                    raise TimeoutError("no free stream slot")
            slot = self._pool.open_stream(one_hot, template)
            sess = StreamingSession(self, slot)
            self._sessions[slot] = sess
            return sess

    # ------------------------------------------------------------------

    def _route(self, pusher_slot: int) -> None:
        """Move frames other sessions produced this step into their queues."""
        for slot, sess in self._sessions.items():
            if slot != pusher_slot:
                got = self._pool.poll(slot)
                if got.size:
                    sess._chunks.append(got)

    def _push(self, sess: StreamingSession, audio, last: bool) -> np.ndarray:
        with self._lock:
            got = self._pool.push(sess._slot, audio, last=last)
            self._route(sess._slot)
            mine = sess._chunks
            sess._chunks = []
            mine.append(got)
            return np.concatenate([c for c in mine if c.size]) if any(
                c.size for c in mine
            ) else got

    def _poll(self, sess: StreamingSession) -> np.ndarray:
        with self._lock:
            sess._chunks.append(self._pool.poll(sess._slot))
            mine = [c for c in sess._chunks if c.size]
            sess._chunks = []
            if not mine:
                return np.zeros((0, self._pool.n_verts // 3, 3), np.float32)
            return np.concatenate(mine)

    def _close(self, sess: StreamingSession) -> None:
        with self._free:
            self._pool.close_stream(sess._slot)
            self._sessions.pop(sess._slot, None)
            self._free.notify_all()
