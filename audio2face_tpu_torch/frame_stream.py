"""Live multi-stream serving for the frame models (Audio2Mesh, VOCA,
Song2Face): N concurrent callers share one GPU and one batched forward.

Port of ``audio2face_tpu/frame_stream.py``, over the port's
``FramePredictor`` (its model and feature extractor). The frame models are
per-frame functions of a 0.52 s window (src/dataset/vocaset.py:408-430), so
live streaming needs no carried decoder state and is exact: every emitted
frame sees the same window, features and weights as the offline
``FramePredictor`` for the same clip, tail frames included (the offline
fragmenter zero-pads past the clip's end, and so does the pool's flush).

Each batched step advances ``frame_batch`` frames for every ready slot
through one (n_streams, span) forward. The audio of frames [f0, f0 + fb)
spans ``(fb - 1) * sr // fps + 2 * n_pad + 1`` samples whatever f0; the
per-slot frame offsets go to the device as an (S,) int64 tensor and each
frame's window is gathered there. ``mesh=`` shards the slot axis over the
mesh's ``data`` axis: every rank runs the same calls and keeps every slot's
bookkeeping, runs the forward on its own slots (``shard_map_data``) and
gathers the vertices. Runs on the GPU unless ``device="cpu"``; every
forward runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

FPS = 60
FRAGMENT_SECONDS = 0.52


class _FrameSlot:
    """Host-side per-stream bookkeeping."""

    __slots__ = ("active", "finished", "flushed", "buffer", "h0",
                 "n_total", "f_done", "pending")

    def __init__(self):
        self.active = False
        self.reset()

    def reset(self):
        self.finished = False
        self.flushed = False
        self.buffer = np.zeros((0,), np.float32)
        self.h0 = 0  # absolute sample index of buffer[0]
        self.n_total = 0  # samples received so far
        self.f_done = 0  # frames emitted so far
        self.pending: list[np.ndarray] = []


def window_offsets(f0: torch.Tensor, fb: int, sr: int) -> torch.Tensor:
    """(S, fb) start of frame f0 + j's window relative to its slot's window
    origin ``f0 * sr // FPS - n_pad``: ``(f0 + j) * sr // FPS - f0 * sr //
    FPS``, computed through ``r = f0 % FPS`` as ``(r + j) * sr // FPS - r *
    sr // FPS`` (exact: with f0 = q * FPS + r both floors share q * sr), so
    the products stay small however long a stream runs. int64."""
    j = torch.arange(fb, device=f0.device)
    r = (f0.to(torch.int64) % FPS)[:, None]
    return (r + j[None, :]) * sr // FPS - r * sr // FPS


class FrameStreamPool:
    """Fixed pool of ``n_streams`` live frame-model streams on one GPU.

    Usage::

        pool = FrameStreamPool(config, variables, n_streams=8)
        a = pool.open_stream(one_hot_a, template_a)
        frames = pool.push(a, audio_chunk)            # (T_new, V, 3)
        tail = pool.push(a, more_audio, last=True)
        pool.close_stream(a)

    ``push`` advances every slot with ``frame_batch`` decodable frames in
    one batched step; frames produced for other slots are kept and returned
    by their own next ``push``/``poll``. Weights: ``variables`` (the JAX
    model's numpy ``{"params", "batch_stats"}``), ``state_dict`` (the
    port's) or a random init from ``seed``, as ``FramePredictor``."""

    def __init__(
        self,
        config,
        variables: Optional[dict] = None,
        *,
        state_dict: Optional[dict] = None,
        n_streams: int = 8,
        frame_batch: int = 32,
        seed: int = 0,
        unit_scale: float = 100.0,
        mesh=None,
        device="cuda",
    ):
        from audio2face_tpu_torch.serving import FramePredictor

        if mesh is not None:
            from audio2face_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

            n_data = axis_size(mesh, DATA_AXIS)
            if int(n_streams) % n_data != 0:
                raise ValueError(
                    f"n_streams={n_streams} must be divisible by the mesh data axis "
                    f"({n_data}) so each rank hosts a whole slot slice")
        # FramePredictor builds the model and extractor, with their weights
        # (on a mesh the first rank's, on every rank); its batch cap, which
        # the pool does not use, is the slot count, a multiple of the axis
        self._base = FramePredictor(
            config, variables=variables, state_dict=state_dict, frame_batch=frame_batch,
            seed=seed, unit_scale=unit_scale, device=device, mesh=mesh, max_batch=int(n_streams),
        )
        self._forward = self.forward
        if mesh is not None:
            from audio2face_tpu_torch.parallel.mesh import DATA_AXIS, shard_map_data

            d = (DATA_AXIS,)
            self._forward = shard_map_data(mesh, self.forward, in_specs=(d, d, d, d),
                                           out_specs=d)
        self.device = self._base.device
        self.config = config
        self.sr = config.sample_rate
        self.fps = FPS  # vocaset animation clock (frame models are 60 fps)
        self.n_verts = config.vertex_count
        self.n_onehot = config.one_hot_size
        self.n_streams = int(n_streams)
        self.fb = int(frame_batch)
        self.unit_scale = float(unit_scale)
        self.n_pad = int(self.sr * FRAGMENT_SECONDS / 2)
        # fixed window covering fb frames at any offset (floor-div jitter + 1)
        self.span = (self.fb - 1) * self.sr // FPS + 2 * self.n_pad + 1
        self.steps = 0  # batched steps run
        self._slots = [_FrameSlot() for _ in range(self.n_streams)]
        self._one_hot = np.zeros((self.n_streams, self.n_onehot), np.float32)
        self._template = np.zeros(
            (self.n_streams, self.n_verts // 3, 3), np.float32
        )

    # ------------------------------------------------------------------
    # stream lifecycle
    # ------------------------------------------------------------------

    def open_stream(self, one_hot: np.ndarray, template: np.ndarray) -> int:
        free = next((i for i, s in enumerate(self._slots) if not s.active), None)
        if free is None:
            raise RuntimeError(
                f"all {self.n_streams} stream slots are busy; close_stream() "
                "one or provision a larger pool"
            )
        sl = self._slots[free]
        sl.active = True
        sl.reset()
        self._one_hot[free] = np.asarray(one_hot, np.float32).reshape(self.n_onehot)
        self._template[free] = np.asarray(template, np.float32).reshape(-1, 3)
        return free

    def close_stream(self, slot: int) -> None:
        self._slots[slot].active = False

    def poll(self, slot: int) -> np.ndarray:
        """Collect frames produced for ``slot`` by other streams' pushes."""
        return self._drain(slot)

    # ------------------------------------------------------------------
    # data path
    # ------------------------------------------------------------------

    def push(self, slot: int, audio: np.ndarray, *, last: bool = False) -> np.ndarray:
        sl = self._slots[slot]
        if not sl.active:
            raise RuntimeError(f"slot {slot} is not open")
        if sl.finished:
            raise RuntimeError("stream was flushed (last=True); open a new one")
        audio = np.asarray(audio, np.float32).reshape(-1)
        sl.buffer = np.concatenate([sl.buffer, audio])
        sl.n_total += len(audio)
        if last:
            sl.finished = True
        while any(
            self._ready_frames(s) >= self.fb or self._flush_ready(s)
            for s in self._slots
        ):
            self._step()
        return self._drain(slot)

    def flush(self, slot: int) -> np.ndarray:
        return self.push(slot, np.zeros((0,), np.float32), last=True)

    # ------------------------------------------------------------------

    def _total_frames(self, sl: _FrameSlot) -> int:
        # the offline frame count (FramePredictor.__call__)
        return sl.n_total * FPS // self.sr

    def _ready_frames(self, sl: _FrameSlot) -> int:
        """Frames decodable from the buffered samples (window fully real)."""
        if not sl.active:
            return 0
        # frame f needs samples through f * sr // FPS + n_pad
        f_hi = max((sl.n_total - self.n_pad) * FPS // self.sr + 2, 0)
        while f_hi > 0 and (f_hi - 1) * self.sr // FPS + self.n_pad > sl.n_total:
            f_hi -= 1
        return min(f_hi, self._total_frames(sl)) - sl.f_done

    def _flush_ready(self, sl: _FrameSlot) -> bool:
        return (
            sl.active and sl.finished and not sl.flushed
            and sl.f_done < self._total_frames(sl)
        )

    def _step(self) -> None:
        """One batched step: every ready slot advances ``fb`` frames."""
        s, fb, span, n_pad = self.n_streams, self.fb, self.span, self.n_pad
        windows = np.zeros((s, span), np.float32)
        f0 = np.zeros((s,), np.int64)
        n_valid = np.zeros((s,), np.int64)

        for i, sl in enumerate(self._slots):
            ready = self._ready_frames(sl)
            if ready >= fb:
                n = fb
            elif self._flush_ready(sl):
                # tail: at most fb frames a step; windows past the clip's
                # end are zero-filled as the offline fragmenter fills them
                n = min(self._total_frames(sl) - sl.f_done, fb)
                if sl.f_done + n == self._total_frames(sl):
                    sl.flushed = True
            else:
                continue
            f0[i] = sl.f_done
            n_valid[i] = n
            origin = sl.f_done * self.sr // FPS - n_pad  # may be < 0 early
            # the buffered samples overlapping [origin, origin + span); zeros
            # elsewhere reproduce the offline fragmenter's padding
            lo = max(origin, sl.h0)
            hi = min(origin + span, sl.h0 + len(sl.buffer), sl.n_total)
            if hi > lo:
                windows[i, lo - origin : hi - origin] = sl.buffer[
                    lo - sl.h0 : hi - sl.h0
                ]
            sl.f_done += n
            # drop samples no later window can need
            keep_from = sl.f_done * self.sr // FPS - n_pad
            if keep_from > sl.h0:
                sl.buffer = sl.buffer[keep_from - sl.h0 :]
                sl.h0 = keep_from

        if not n_valid.any():
            return

        out = self._forward(windows, self._one_hot, self._template, f0)
        self.steps += 1
        served = np.flatnonzero(n_valid)
        out_np = out[torch.as_tensor(served, device=self.device)].cpu().numpy()
        for row, i in enumerate(served):
            self._slots[i].pending.append(out_np[row, : n_valid[i]])

    def _drain(self, slot: int) -> np.ndarray:
        sl = self._slots[slot]
        if not sl.pending:
            return np.zeros((0, self.n_verts // 3, 3), np.float32)
        got = np.concatenate(sl.pending)
        sl.pending = []
        return got

    # ------------------------------------------------------------------
    # the batched forward
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward(self, windows: np.ndarray, one_hot: np.ndarray, template: np.ndarray,
                f0: np.ndarray) -> torch.Tensor:
        """(S, fb, V, 3) f32 vertices in data units, on the device, of frames
        f0[i] .. f0[i] + fb - 1 of every slot i, from the slots' audio
        ``windows`` (S, span) whose sample 0 is frame f0's window start."""
        dev, fb, scale = self.device, self.fb, self.unit_scale
        window = 2 * self.n_pad
        windows = torch.as_tensor(windows, device=dev)
        s = windows.shape[0]
        rel = window_offsets(torch.as_tensor(f0, device=dev), fb, self.sr)  # (S, fb)
        gather = rel[..., None] + torch.arange(window, device=dev)[None, None, :]
        frags = torch.gather(windows, 1, gather.reshape(s, fb * window)).reshape(s * fb, window)
        feats = self._base.extractor(frags)
        oh = torch.as_tensor(one_hot, device=dev).repeat_interleave(fb, dim=0)
        tmpl = (torch.as_tensor(template, device=dev) * scale).repeat_interleave(fb, dim=0)
        out = self._base.model(feats, oh, tmpl, train=False)
        return out.reshape(s, fb, -1, 3) / scale
