"""Streaming (chunked, bounded-lookahead) FaceFormer inference.

Port of ``audio2face_tpu/streaming.py``. The reference decodes a whole clip
offline (src/model/faceformer.py:137-188); this module decodes audio as it
arrives, chunk by chunk, with bounded latency, in two halves:

- **encoder (approximate, bounded context).** wav2vec2 is bidirectional,
  so each chunk is encoded inside a sliding [left | chunk | lookahead]
  window and only the chunk's frames are kept. The window is the port's
  ``Wav2Vec2Encoder``, which launches the conv encoder kernel (K2) and the
  flash-attention kernel (K1) in bf16, followed by the audio map and the
  cross term in f32. The Wav2Vec2Processor normalization uses statistics
  over exactly the audio up to the window's end, kept as float64 sums on
  the host: deterministic in (audio, config) whatever the push sizes, and
  equal to the offline statistics at the last chunk. One window covering a
  grain-aligned clip gives the offline encoder output.
- **decoder (exact).** The decoder is causal, so streaming it is exact: the
  KV cache, the feedback embedding and the absolute frame counter carry
  across chunks (``models/decoder_step.py``, in f32 whatever the encoder's
  dtype). Chunk boundaries land on whole frames: window sizes are
  multiples of 800 samples = 3 frames at 60 fps / 16 kHz.

The final flush pads its tail window with zeros to the next 800-sample
grain, as JAX does to bound its compiled shapes; the port keeps the same
windows so that its frames equal JAX's. Runs on the GPU unless
``device="cpu"``; every call runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from audio2face_tpu_torch.compat.jax_params import faceformer_state_dict_from_jax
from audio2face_tpu_torch.models.decoder_step import (
    check_live_width,
    decoder_step_params,
    make_decoder_step,
    run_decoder_steps,
)
from audio2face_tpu_torch.models.faceformer import (
    AUDIO_SR,
    FEATURE_DIM,
    N_HEADS,
    FaceFormer,
    frame_count,
)
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, config_from_state_dict
from audio2face_tpu_torch.serving import load_model
from audio2face_tpu_torch.utils.device import resolve_device

# frame-exact granularity: 800 samples == 3 frames (800 * 60 / 16000)
GRAIN = 800

# one frame-count rule for the whole pipeline (faceformer.py frame_count)
samples_to_frames = frame_count

_BIWI_MESSAGE = (
    "streaming supports only dataset='vocaset' checkpoints (the sliding "
    "windows assume the 60 fps adapter); this is a BIWI-trained FaceFormer: "
    "decode it offline via FaceFormerPredictor(dataset='biwi')"
)


def _ceil_grain(n: int) -> int:
    return ((n + GRAIN - 1) // GRAIN) * GRAIN


def _live_state_dict(variables: dict) -> dict:
    """The port's state dict of JAX FaceFormer variables; BIWI's are refused."""
    if "cross_q_kernel" in variables["params"]:
        raise ValueError(_BIWI_MESSAGE)
    return faceformer_state_dict_from_jax(variables["params"])


def load_live_faceformer(
    variables: Optional[dict], state_dict: Optional[dict], n_verts: int, n_onehot: int,
    dtype: Optional[torch.dtype], seed: int, device: torch.device,
) -> FaceFormer:
    """The vocaset FaceFormer of a live predictor, in eval mode on ``device``:
    weights from the JAX variables (numpy ``{"params": ...}``), a port state
    dict, or a random init from ``seed`` (``serving.load_model``). BIWI
    weights are refused, and so are a decoder of another width than 64 and
    another encoder than wav2vec2-base."""

    def make(state_dict):
        if state_dict is not None:
            if "cross_q.weight" in state_dict:
                raise ValueError(_BIWI_MESSAGE)
            check_live_width(state_dict["audio_feature_map.weight"].shape[0])
            if config_from_state_dict(state_dict, "audio_encoder.") != Wav2Vec2Config():
                raise ValueError(
                    "the live paths run the wav2vec2-base encoder; these weights hold "
                    "another (WavLM's gated relative-position bias serves offline only): "
                    "decode them via FaceFormerPredictor")
        return FaceFormer(n_verts=n_verts, n_onehot=n_onehot, dtype=dtype)

    return load_model(make, variables, state_dict, _live_state_dict, seed, device)


@torch.inference_mode()
def encode_windows(model: FaceFormer, norm: np.ndarray, n_frames: int, keep_from: int,
                   keep_to: int, device, use_kernels: bool) -> torch.Tensor:
    """Normalized windows (B, window) -> the cross term of frames
    [keep_from, keep_to), (B, F, d) f32 on ``device``: FaceFormer's encoder
    block on each window (the encoder, then the audio map and the cross
    v/out projections in f32)."""
    x = torch.as_tensor(norm, device=device)
    hidden = model.audio_encoder(
        x, output_len=n_frames, dtype=model.dtype or torch.float32, use_kernels=use_kernels)

    def mm(t, layer):
        return F.linear(t, layer.weight, layer.bias)

    memory = mm(hidden.float(), model.audio_feature_map)
    cross = mm(mm(memory, model.cross_v), model.cross_out)
    return cross[:, keep_from:keep_to].float()


class StreamingFaceFormerPredictor:
    """Incremental FaceFormer decoding with bounded lookahead.

    Parameters
    ----------
    variables: the JAX FaceFormer's ``{"params": ...}`` as numpy arrays (any
        trained or converted checkpoint streams unchanged); or
        ``state_dict``, the port's; or neither: a random init from ``seed``.
    chunk_seconds: audio consumed per emission step.
    left_seconds: encoder left context (larger: closer to offline output).
    lookahead_seconds: encoder right context, the algorithmic latency.
    max_seconds: decoder KV-cache capacity.
    dtype: the encoder's compute dtype (``torch.bfloat16`` or None for f32).
    unit_scale: the x100 training-unit convention (template * scale in,
        vertices / scale out); 1.0 for raw-unit models.
    use_kernels: False runs the plain versions of the encoder's kernels.
    """

    def __init__(
        self,
        variables: Optional[dict] = None,
        n_verts: int = 15069,
        *,
        state_dict: Optional[dict] = None,
        n_onehot: int = 12,
        chunk_seconds: float = 1.0,
        left_seconds: float = 2.0,
        lookahead_seconds: float = 0.5,
        max_seconds: float = 120.0,
        dtype: Optional[torch.dtype] = None,
        unit_scale: float = 100.0,
        seed: int = 0,
        device="cuda",
        use_kernels: bool = True,
    ):
        self.device = resolve_device(device, "StreamingFaceFormerPredictor")
        self.model = load_live_faceformer(
            variables, state_dict, n_verts, n_onehot, dtype, seed, self.device)
        self.n_verts = n_verts
        self.n_onehot = n_onehot
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.unit_scale = float(unit_scale)
        self.chunk = _ceil_grain(int(chunk_seconds * AUDIO_SR))
        self.left = _ceil_grain(int(left_seconds * AUDIO_SR))
        self.lookahead = _ceil_grain(int(lookahead_seconds * AUDIO_SR))
        self.t_max = samples_to_frames(_ceil_grain(int(max_seconds * AUDIO_SR)))
        with torch.inference_mode():
            self._p = decoder_step_params(self.model)
        self.reset()

    # ------------------------------------------------------------------
    # stream state
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def reset(self) -> None:
        hd = FEATURE_DIM // N_HEADS
        self._buffer = np.zeros((0,), np.float32)  # unconsumed audio
        self._history = np.zeros((0,), np.float32)  # encoder left context
        self._finished = False  # set by a last=True push/flush
        # normalization statistics over consumed samples [0, consumed), in
        # float64; each emission extends them with its own window tail, so
        # they are a function of (audio, config), never of push sizes
        self._base_sum = 0.0
        self._base_sqsum = 0.0
        self._base_n = 0
        self._t0 = 0  # absolute frame counter
        self._emb = None  # decoder feedback carry (set on the first chunk)
        self._k_cache = torch.zeros((1, N_HEADS, self.t_max, hd), device=self.device)
        self._v_cache = torch.zeros((1, N_HEADS, self.t_max, hd), device=self.device)
        self._style_ctx = None  # (style, scaled template) bound at start_stream

    @torch.inference_mode()
    def start_stream(self, one_hot: np.ndarray, template: np.ndarray) -> None:
        """Bind speaker identity and template; resets any previous stream."""
        self.reset()
        one_hot = torch.as_tensor(np.asarray(one_hot, np.float32).reshape(1, self.n_onehot),
                                  device=self.device)
        template = torch.as_tensor(np.asarray(template, np.float32).reshape(1, -1, 3),
                                   device=self.device) * self.unit_scale
        style = F.linear(one_hot, self.model.obj_vector.weight.float())
        self._style_ctx = (style, template)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def push(self, audio: np.ndarray, *, last: bool = False) -> np.ndarray:
        """Feed audio; returns newly decoded vertices (T_new, V, 3) in data
        units (possibly empty). ``last=True`` flushes the remainder."""
        if self._style_ctx is None:
            raise RuntimeError("call start_stream(one_hot, template) first")
        if self._finished:
            raise RuntimeError(
                "stream was flushed (last=True); start_stream() a new one"
            )
        audio = np.asarray(audio, np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, audio])

        outs = []
        while len(self._buffer) >= self.chunk + self.lookahead:
            outs.append(self._emit(self.chunk))
        if last:
            self._finished = True
        if last and len(self._buffer) > 0:
            # consumed samples are grain-aligned, so frame_count(consumed +
            # n) - frames emitted == frame_count(n): any tail gives the
            # offline frame count (a tail under 267 samples gives none)
            n = len(self._buffer)
            if samples_to_frames(n) > 0:
                outs.append(self._emit(n, final=True))
            else:
                self._buffer = self._buffer[:0]
        if not outs:
            return np.zeros((0, self.n_verts // 3, 3), np.float32)
        return np.concatenate(outs)

    def flush(self) -> np.ndarray:
        """Decode everything still buffered (end of stream)."""
        return self.push(np.zeros((0,), np.float32), last=True)

    def _emit(self, n_chunk: int, final: bool = False) -> np.ndarray:
        lookahead = 0 if final else self.lookahead
        # the window is always full width: missing left context at the start
        # of a stream is zero-padded
        left = self.left
        # the final tail is zero-padded to the next grain (the kept frames
        # stay the true frame count; grain-aligned tails get no padding)
        n_pad = _ceil_grain(n_chunk) if final else n_chunk
        window = left + n_pad + lookahead

        # normalization statistics over audio [0, chunk_end + lookahead)
        win = self._buffer[: n_chunk + lookahead]
        tot_n = self._base_n + win.size
        tot_sum = self._base_sum + float(win.sum(dtype=np.float64))
        tot_sq = self._base_sqsum + float(np.square(win, dtype=np.float64).sum())
        mean = tot_sum / max(tot_n, 1)
        var = max(tot_sq / max(tot_n, 1) - mean * mean, 0.0)
        hist = self._history_tail(left)
        raw = np.concatenate(
            [hist, win, np.zeros(n_pad - n_chunk, np.float32)]
        )
        norm = ((raw - mean) / np.sqrt(var + 1e-7)).astype(np.float32)

        n_frames = samples_to_frames(window)
        keep_from = samples_to_frames(left)
        keep_to = keep_from + samples_to_frames(n_chunk)
        if self._t0 + (keep_to - keep_from) > self.t_max:
            raise RuntimeError(
                f"stream exceeds max_seconds capacity ({self.t_max} frames): "
                f"decoded {self._t0}, next chunk adds {keep_to - keep_from}; "
                "raise max_seconds or reset()/start_stream() a new stream"
            )
        cross = encode_windows(self.model, norm[None], n_frames, keep_from, keep_to,
                               self.device, self.use_kernels)

        style, template = self._style_ctx
        if self._emb is None:
            self._emb = style.clone()
        n_new = keep_to - keep_from
        step = make_decoder_step(
            self._p, styles=style, t0=torch.full((1,), self._t0, device=self.device))
        (self._emb, self._k_cache, self._v_cache), hs = run_decoder_steps(
            step, (self._emb, self._k_cache, self._v_cache), cross)
        self._t0 += n_new

        verts = self.model.vertex_head(hs, template) / self.unit_scale
        out = verts[0].cpu().numpy()

        consumed_now = self._buffer[:n_chunk]
        self._base_n += consumed_now.size
        self._base_sum += float(consumed_now.sum(dtype=np.float64))
        self._base_sqsum += float(np.square(consumed_now, dtype=np.float64).sum())
        if self.left:
            self._history = np.concatenate(
                [self._history, consumed_now]
            )[-self.left :]
        self._buffer = self._buffer[n_chunk:]
        return out

    def _history_tail(self, left: int) -> np.ndarray:
        if left == 0:
            return np.zeros((0,), np.float32)
        have = self._history[-left:]
        if len(have) < left:  # stream start: zero-pad the missing context
            have = np.concatenate([np.zeros(left - len(have), np.float32), have])
        return have
