"""Inference/serving API: bucketed, batched prediction.

Port of ``audio2face_tpu/serving.py``: ``FaceFormerPredictor`` and, for the
frame models (Audio2Mesh, VOCA, Song2Face), ``FramePredictor``.
``FaceFormerPredictor``:

- clips are sorted by length and grouped up to ``max_batch``; each group is
  padded to an audio bucket (seconds rounded up to a grid) and to a batch
  size on the power-of-two grid, with per-item ``lengths`` masking inside
  the model (exact: the fps adapter and group norm are length-aware);
- the vertex head runs per time chunk of at most 512 MB of output, so
  device memory stays bounded whatever the clip length;
- outputs are in data units: checkpoints are trained with the x100 vertex
  convention, so the predictor feeds ``template * 100`` and returns
  ``output / 100`` (``unit_scale``).

Both run on the card unless ``device="cpu"`` is asked for. Weights come
from a reference PyTorch/Lightning checkpoint (``from_torch_checkpoint``),
the port trainer's checkpoint (``from_checkpoint``), carried JAX variables,
a port state dict, or a seeded random init. ``dataset="biwi"`` serves
FaceFormer's BIWI mode (25 fps, period 25, 2-way cross softmax). The JAX
trainer's orbax checkpoints are not read: orbax imports JAX. Multi-device
meshes are not ported yet (``ROADMAP.md`` queue 1 item 4).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

import torch.nn.functional as F

from audio2face_tpu_torch.compat.jax_params import (
    faceformer_state_dict_from_jax,
    frame_model_state_dict_from_jax,
)
from audio2face_tpu_torch.models.faceformer import AUDIO_SR, FaceFormer
from audio2face_tpu_torch.ops.dsp import fragment_starts, resample
from audio2face_tpu_torch.utils.device import resolve_device
from audio2face_tpu_torch.utils.shapes import round_up as _round_up


def _batch_grid(max_batch: int) -> list[int]:
    """The batch-shape grid: powers of two below ``max_batch``, and
    ``max_batch``."""
    grid = set()
    p = 1
    while p < max_batch:
        grid.add(p)
        p *= 2
    grid.add(max_batch)
    return sorted(grid)


def _pad_batch(b: int, max_batch: int) -> int:
    """Smallest grid batch size >= the request group's size ``b``."""
    for g in _batch_grid(max_batch):
        if g >= b:
            return g
    raise ValueError(f"group of {b} clips exceeds max_batch={max_batch}")


def _warmup_predictor(predictor, max_seconds: float, batches: Optional[Sequence[int]],
                      sample_rate: int) -> int:
    """Run every (batch, bucket) shape a deployment will hit once on zero
    audio: builds the kernels and warms the library kernels' caches before
    live traffic. ``batches=None`` covers the full batch grid. Returns the
    number of warm calls made."""
    if batches is None:
        batches = _batch_grid(predictor.max_batch)
    bucket = predictor.bucket_samples
    n_buckets = max(1, -(-int(max_seconds * sample_rate) // bucket))
    template = np.zeros((predictor.n_verts // 3, 3), np.float32)
    calls = 0
    for b in batches:
        for k in range(1, n_buckets + 1):
            audios = [np.zeros(k * bucket, np.float32)] * b
            predictor(audios, np.zeros((b, predictor.n_onehot), np.float32), template)
            calls += 1
    return calls


def _resampled(audios, sample_rate: int, target: int, device) -> list:
    """The clips at ``target`` Hz (the resampler runs on ``device``)."""
    if sample_rate == target:
        return list(audios)
    return [
        resample(torch.as_tensor(np.asarray(a, np.float32), device=device), sample_rate, target)
        .cpu().numpy()
        for a in audios
    ]


class FaceFormerPredictor:
    """Batched speech -> vertex-animation inference for FaceFormer."""

    # device-memory budget for one (B, chunk, V, 3) f32 vertex-head output
    _VERTEX_CHUNK_BYTES = 512 * 1024 * 1024

    def __init__(
        self,
        n_verts: int = 15069,
        n_onehot: int = 12,
        variables: Optional[dict] = None,
        *,
        state_dict: Optional[dict] = None,
        bf16: bool = True,
        max_batch: int = 8,
        bucket_seconds: float = 5.0,
        seed: int = 0,
        unit_scale: float = 100.0,
        dataset: str = "vocaset",
        device="cuda",
        use_kernels: bool = True,
    ):
        """``variables``: the JAX FaceFormer's ``{"params": ...}`` as numpy
        arrays; ``state_dict``: the port's own; neither: random init from
        ``seed``. ``use_kernels=False`` runs the plain PyTorch versions of
        every kernel (a reference run on the card)."""
        if variables is not None and state_dict is not None:
            raise ValueError("pass variables= or state_dict=, not both")
        self.device = resolve_device(device, "FaceFormerPredictor")
        self.dataset = dataset
        # animation clock of the returned (T, V, 3) tracks: VOCASET animates
        # at 60 fps, BIWI at 25
        self.fps = 25 if dataset == "biwi" else 60
        self.n_onehot = n_onehot
        self.n_verts = n_verts
        self.max_batch = max_batch
        self.unit_scale = float(unit_scale)
        self.bucket_samples = int(bucket_seconds * AUDIO_SR)
        self.use_kernels = use_kernels
        self.model = FaceFormer(
            n_verts=n_verts, n_onehot=n_onehot,
            dtype=torch.bfloat16 if bf16 else None,
            # BIWI animates at 25 fps; the upstream FaceFormer uses the frame
            # rate as the PPE/ALiBi period (matches the trainer's model)
            **({"dataset": "biwi", "period": 25} if dataset == "biwi" else {}),
        )
        if variables is not None:
            state_dict = faceformer_state_dict_from_jax(variables["params"])
        if state_dict is not None:
            # BIWI weights served as vocaset would run frames at the wrong
            # clock and replace the trained 2-way softmax with the diagonal
            # cross attention, so the mismatch is an error either way
            has_cross = "cross_q.weight" in state_dict
            if has_cross != (dataset == "biwi"):
                want = "biwi" if has_cross else "vocaset"
                raise ValueError(
                    f"the weights are a dataset={want!r} FaceFormer (cross_q/cross_k "
                    f"{'present' if has_cross else 'absent'}) but the predictor was "
                    f"built with dataset={dataset!r}: pass dataset={want!r}"
                )
            self.model.load_state_dict(state_dict)
        else:
            self.model.init_parameters(torch.Generator().manual_seed(seed))
        self.model.eval().to(self.device)

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kwargs) -> "FaceFormerPredictor":
        """Load a reference PyTorch/Lightning checkpoint. Pass
        ``dataset="biwi"`` for BIWI-trained weights: the converter then also
        carries the live cross-attention q/k projections."""
        from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer
        from audio2face_tpu_torch.compat.torch_convert import load_torch_checkpoint

        state_dict = convert_faceformer(
            load_torch_checkpoint(path), dataset=kwargs.get("dataset", "vocaset"))
        return cls(state_dict=state_dict, **kwargs)

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "FaceFormerPredictor":
        """Load a checkpoint written by the port's trainer
        (``Audio2FaceExperiment.save_checkpoint``). The dataset family is
        detected from the weights: BIWI checkpoints carry the live
        ``cross_q``/``cross_k`` projections, vocaset's have none."""
        state_dict = torch.load(path, map_location="cpu", weights_only=True)["model"]
        kwargs.setdefault("dataset", "biwi" if "cross_q.weight" in state_dict else "vocaset")
        return cls(state_dict=state_dict, **kwargs)

    @torch.inference_mode()
    def _hidden(self, audio, one_hot, lengths):
        return self.model(
            audio, one_hot, None, lengths, return_hidden=True, use_kernels=self.use_kernels
        )

    @torch.inference_mode()
    def _vertex_chunk(self, hs: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
        """FaceFormer.vertex_head on a time slice, with the x100-in /
        /100-out unit convention."""
        scale = self.unit_scale
        return self.model.vertex_head(hs, template * scale) / scale

    def _emit_vertices(self, hs, tmpl, idx, n_valid, results):
        """Apply the vertex head per time chunk, copying each chunk into its
        clip's host buffer; the tail window is realigned, not shortened."""
        b_pad, t, _ = hs.shape
        for j, i in enumerate(idx):
            results[i] = np.empty((int(n_valid[j]), self.n_verts // 3, 3), np.float32)
        t_need = int(n_valid.max()) if len(n_valid) else 0
        width = min(t, max(1, self._VERTEX_CHUNK_BYTES // (b_pad * self.n_verts * 4)))
        for lo in range(0, t_need, width):
            start = min(lo, t - width)
            chunk = self._vertex_chunk(hs[:, start : start + width], tmpl).cpu().numpy()
            off = lo - start
            for j, i in enumerate(idx):
                m = min(int(n_valid[j]), lo + width - off) - lo
                if m > 0:
                    results[i][lo : lo + m] = chunk[j, off : off + m]

    def __call__(
        self,
        audios: Sequence[np.ndarray],
        one_hot: np.ndarray,
        template: np.ndarray,
        sample_rate: int = AUDIO_SR,
    ) -> list[np.ndarray]:
        """Decode a batch of clips.

        audios: list of 1-D float waveforms (any lengths); one_hot: (N, 12);
        template: (N, V, 3) or (V, 3) shared. Returns per-clip (T_i, V, 3)
        vertex animations at ``self.fps`` (60; BIWI 25)."""
        n = len(audios)
        if one_hot.shape[0] != n:
            raise ValueError(f"one_hot batch {one_hot.shape[0]} != {n} clips")
        if template.ndim == 2:
            template = np.broadcast_to(template[None], (n, *template.shape))

        audios = _resampled(audios, sample_rate, AUDIO_SR, self.device)

        results: list[Optional[np.ndarray]] = [None] * n
        order = sorted(range(n), key=lambda i: len(audios[i]))
        for lo in range(0, n, self.max_batch):
            idx = order[lo : lo + self.max_batch]
            group = [audios[i] for i in idx]
            max_len = max(len(a) for a in group)
            samples = _round_up(max(max_len, self.bucket_samples), self.bucket_samples)
            b = len(group)
            b_pad = _pad_batch(b, self.max_batch)
            audio_pad = np.zeros((b_pad, samples), np.float32)
            # dummy rows (batch-grid padding) get a short valid length: 800
            # samples decode 3 frames each (BIWI: 1), discarded below
            lengths = np.full((b_pad,), min(800, samples), np.int64)
            oh = np.zeros((b_pad, one_hot.shape[1]), np.float32)
            tmpl = np.zeros((b_pad,) + template.shape[1:], np.float32)
            for j, a in enumerate(group):
                audio_pad[j, : len(a)] = a
                lengths[j] = len(a)
            oh[:b] = one_hot[idx]
            tmpl[:b] = template[idx].astype(np.float32)
            dev = self.device
            hs, mask = self._hidden(
                torch.as_tensor(audio_pad, device=dev), torch.as_tensor(oh, device=dev),
                torch.as_tensor(lengths, device=dev),
            )
            n_valid = mask.sum(dim=1).cpu().numpy().astype(int)
            self._emit_vertices(hs, torch.as_tensor(tmpl, device=dev), idx, n_valid, results)
        return results  # type: ignore[return-value]

    def warmup(self, max_seconds: float = 60.0, *, batches: Optional[Sequence[int]] = None) -> int:
        """Run every (batch, bucket) shape a deployment will hit once on zero
        audio (``_warmup_predictor``). Returns the number of warm calls."""
        return _warmup_predictor(self, max_seconds, batches, AUDIO_SR)

    def realtime_factor(self, seconds: float = 60.0, batch: Optional[int] = None) -> float:
        """Measured decode throughput in multiples of real time (one warm
        call, then one timed call; the result is on the host when it ends)."""
        batch = batch or self.max_batch
        rng = np.random.default_rng(0)
        audios = [rng.normal(size=int(seconds * AUDIO_SR)).astype(np.float32) * 0.1] * batch
        one_hot = np.eye(self.n_onehot, dtype=np.float32)[rng.integers(0, self.n_onehot, batch)]
        template = rng.normal(size=(self.n_verts // 3, 3)).astype(np.float32)
        self(audios, one_hot, template)
        tic = time.perf_counter()
        self(audios, one_hot, template)
        wall = time.perf_counter() - tic
        return batch * seconds / wall


# the frame models' clock and per-frame window (data/vocaset.py: 60 fps,
# 0.52 s windows centred on each frame)
FPS = 60
FRAGMENT_SECONDS = 0.52


class FramePredictor:
    """Batched speech -> per-frame vertex inference for the frame models
    (audio2mesh, voca, song2face: every registry model except faceformer).

    - each clip is uploaded once; the 0.52 s per-frame windows (the
      dataset's fragmenter, shift 0) are gathered on the device, one chunk
      of ``frame_batch`` frames per clip at a time, with overflow-safe
      window starts and frames past a clip's end clamped into its pad;
    - MFCC or wav2vec2 features are extracted on the device inside each
      chunk's forward;
    - shapes follow the FaceFormer predictor: audio buckets on a
      ``bucket_seconds`` grid, batches padded to the power-of-two grid;
    - units: checkpoints train against x100 vertices, so templates feed
      ``* 100`` and outputs return ``/ 100`` (``unit_scale``);
    - each chunk is copied to the host as it is done.

    Weights: ``variables`` (the JAX model's ``{"params", "batch_stats"}``
    as numpy arrays), ``state_dict`` (the port's), or a random init from
    ``seed``. The model computes in bf16 when the config asks for
    "16-mixed", with BatchNorm in eval mode."""

    def __init__(
        self,
        config,
        variables: Optional[dict] = None,
        *,
        state_dict: Optional[dict] = None,
        max_batch: int = 8,
        frame_batch: int = 128,
        bucket_seconds: float = 5.0,
        seed: int = 0,
        unit_scale: float = 100.0,
        mesh=None,
        device="cuda",
    ):
        from audio2face_tpu_torch.registry import get_extractor, get_model

        if config.modelname == "faceformer":
            raise ValueError("use FaceFormerPredictor for faceformer")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= serving is not ported yet (ROADMAP.md queue 1 item 4: parallelism)")
        if variables is not None and state_dict is not None:
            raise ValueError("pass variables= or state_dict=, not both")
        self.device = resolve_device(device, "FramePredictor")
        self.config = config
        self.fps = FPS
        self.sample_rate = config.sample_rate
        self.n_verts = config.vertex_count
        self.n_onehot = config.one_hot_size
        self.max_batch = max_batch
        self.frame_batch = frame_batch
        self.unit_scale = float(unit_scale)
        self.bucket_samples = int(bucket_seconds * config.sample_rate)
        self.n_pad = int(config.sample_rate * FRAGMENT_SECONDS / 2)
        self.window = 2 * self.n_pad

        dtype = torch.bfloat16 if config.bf16_compute else None
        self.model = get_model(config.modelname)(
            n_verts=config.vertex_count, n_onehot=config.one_hot_size, dtype=dtype)
        if variables is not None:
            state_dict = frame_model_state_dict_from_jax(config.modelname, variables)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            self.model.init_parameters(torch.Generator().manual_seed(seed))
        self.model.eval().to(self.device)
        self.extractor = get_extractor(config.feature_extractor)(
            sample_rate=config.sample_rate, n_feature=config.n_feature, out_dim=config.out_dim,
            win_length=config.win_length, hop_length=config.hop_length, n_fft=1024,
        ).to(self.device)

    @classmethod
    def from_torch_checkpoint(cls, path: str, config, **kwargs) -> "FramePredictor":
        """Load a reference PyTorch/Lightning checkpoint for this model."""
        from audio2face_tpu_torch.compat.torch_convert import (
            convert_state_dict,
            load_torch_checkpoint,
        )

        state_dict = convert_state_dict(config.modelname, load_torch_checkpoint(path))
        return cls(config, state_dict=state_dict, **kwargs)

    @classmethod
    def from_checkpoint(cls, path: str, config, **kwargs) -> "FramePredictor":
        """Load a checkpoint written by the port's trainer
        (``Audio2FaceExperiment.save_checkpoint``): weights and BatchNorm
        running statistics."""
        state_dict = torch.load(path, map_location="cpu", weights_only=True)["model"]
        return cls(config, state_dict=state_dict, **kwargs)

    @torch.inference_mode()
    def forward_chunk(self, padded: torch.Tensor, one_hot: torch.Tensor,
                      template: torch.Tensor, frame0: int) -> torch.Tensor:
        """Vertices of frames ``frame0 .. frame0 + frame_batch - 1`` of every
        clip, (B, frame_batch, V, 3) f32 in data units, on the device.

        ``padded``: (B, n_pad + samples + window) clips with ``n_pad`` zeros
        before and a window of zeros after; ``one_hot``: (B * frame_batch,
        n); ``template``: (B * frame_batch, V, 3), already scaled by
        ``unit_scale``."""
        b = padded.shape[0]
        fb = self.frame_batch
        f = frame0 + torch.arange(fb, device=padded.device)
        starts = fragment_starts(f, self.fps, self.sample_rate)
        idx = starts[:, None] + torch.arange(self.window, device=padded.device)[None, :]
        frags = padded[:, idx.clamp(max=padded.shape[1] - 1)].reshape(b * fb, self.window)
        feats = self.extractor(frags)
        out = self.model(feats, one_hot, template, train=False)
        return out.reshape(b, fb, -1, 3) / self.unit_scale

    def prepare(self, group: Sequence[np.ndarray], one_hot: np.ndarray,
                template: np.ndarray) -> tuple:
        """One group's device inputs: the clips padded to their audio bucket
        and the batch grid, uploaded once, plus the one-hot and scaled
        template rows of ``forward_chunk``."""
        b = len(group)
        samples = _round_up(max(max(len(a) for a in group), self.bucket_samples),
                            self.bucket_samples)
        b_pad = _pad_batch(b, self.max_batch)
        audio = np.zeros((b_pad, samples), np.float32)
        for j, a in enumerate(group):
            audio[j, : len(a)] = a
        oh = np.zeros((b_pad, one_hot.shape[1]), np.float32)
        tmpl = np.zeros((b_pad,) + template.shape[1:], np.float32)
        oh[:b] = one_hot
        tmpl[:b] = template
        dev, fb = self.device, self.frame_batch
        padded = F.pad(torch.as_tensor(audio, device=dev), (self.n_pad, self.window))
        oh_rows = torch.as_tensor(oh, device=dev).repeat_interleave(fb, dim=0)
        tmpl_rows = (torch.as_tensor(tmpl, device=dev) * self.unit_scale).repeat_interleave(fb, dim=0)
        return padded, oh_rows, tmpl_rows

    def warmup(self, max_seconds: float = 60.0, *, batches: Optional[Sequence[int]] = None) -> int:
        """Run every (batch, bucket) shape once (``_warmup_predictor``).
        Returns the number of warm calls."""
        return _warmup_predictor(self, max_seconds, batches, self.sample_rate)

    def __call__(
        self,
        audios: Sequence[np.ndarray],
        one_hot: np.ndarray,
        template: np.ndarray,
        sample_rate: Optional[int] = None,
    ) -> list[np.ndarray]:
        """Decode a batch of clips to per-frame vertices.

        audios: 1-D float waveforms (any lengths) at ``sample_rate`` (default:
        the config's rate; other rates are resampled); one_hot: (N,
        one_hot_size); template: (N, V, 3) or (V, 3) shared. Returns per-clip
        (T_i, V, 3) vertex animations at 60 fps in data units."""
        n = len(audios)
        if one_hot.shape[0] != n:
            raise ValueError(f"one_hot batch {one_hot.shape[0]} != {n} clips")
        if template.ndim == 2:
            template = np.broadcast_to(template[None], (n, *template.shape))
        if sample_rate is not None:
            audios = _resampled(audios, sample_rate, self.sample_rate, self.device)

        results: list[Optional[np.ndarray]] = [None] * n
        order = sorted(range(n), key=lambda i: len(audios[i]))
        for lo in range(0, n, self.max_batch):
            idx = order[lo : lo + self.max_batch]
            group = [audios[i] for i in idx]
            n_frames = [len(a) * self.fps // self.sample_rate for a in group]
            for j, i in enumerate(idx):
                results[i] = np.empty((n_frames[j], self.n_verts // 3, 3), np.float32)
            inputs = self.prepare(group, one_hot[idx], template[idx].astype(np.float32))
            for f0 in range(0, max(n_frames), self.frame_batch):
                chunk = self.forward_chunk(*inputs, f0).cpu().numpy()
                for j, i in enumerate(idx):
                    m = min(n_frames[j], f0 + self.frame_batch) - f0
                    if m > 0:
                        results[i][f0 : f0 + m] = chunk[j, :m]
        return results  # type: ignore[return-value]
