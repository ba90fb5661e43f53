"""Inference/serving API: bucketed, batched FaceFormer prediction.

Port of ``audio2face_tpu/serving.py`` (``FaceFormerPredictor``):

- clips are sorted by length and grouped up to ``max_batch``; each group is
  padded to an audio bucket (seconds rounded up to a grid) and to a batch
  size on the power-of-two grid, with per-item ``lengths`` masking inside
  the model (exact: the fps adapter and group norm are length-aware);
- the vertex head runs per time chunk of at most 512 MB of output, so
  device memory stays bounded whatever the clip length;
- outputs are in data units: checkpoints are trained with the x100 vertex
  convention, so the predictor feeds ``template * 100`` and returns
  ``output / 100`` (``unit_scale``).

Runs on the card unless ``device="cpu"`` is asked for. Weights come from
carried JAX variables, a port state dict, or a seeded random init.
Multi-device meshes and checkpoint loading are not ported yet.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from audio2face_tpu_torch.compat.jax_params import faceformer_state_dict_from_jax
from audio2face_tpu_torch.models.faceformer import AUDIO_SR, FaceFormer
from audio2face_tpu_torch.ops.dsp import resample
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
        if dataset != "vocaset":
            raise NotImplementedError(f"dataset={dataset!r} serving is not ported yet")
        self.device = resolve_device(device, "FaceFormerPredictor")
        self.n_onehot = n_onehot
        self.n_verts = n_verts
        self.max_batch = max_batch
        self.unit_scale = float(unit_scale)
        self.bucket_samples = int(bucket_seconds * AUDIO_SR)
        self.use_kernels = use_kernels
        self.model = FaceFormer(
            n_verts=n_verts, n_onehot=n_onehot,
            dtype=torch.bfloat16 if bf16 else None,
        )
        if variables is not None:
            state_dict = faceformer_state_dict_from_jax(variables["params"])
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            self.model.init_parameters(torch.Generator().manual_seed(seed))
        self.model.eval().to(self.device)

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
        vertex animations at 60 fps."""
        n = len(audios)
        if one_hot.shape[0] != n:
            raise ValueError(f"one_hot batch {one_hot.shape[0]} != {n} clips")
        if template.ndim == 2:
            template = np.broadcast_to(template[None], (n, *template.shape))

        if sample_rate != AUDIO_SR:
            audios = [
                resample(
                    torch.as_tensor(np.asarray(a, np.float32), device=self.device),
                    sample_rate, AUDIO_SR,
                ).cpu().numpy()
                for a in audios
            ]

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
            # samples decode 3 frames each, discarded below
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
        audio: builds the kernels and warms the library kernels' caches
        before live traffic. ``batches=None`` covers the full batch grid.
        Returns the number of warm calls made."""
        if batches is None:
            batches = _batch_grid(self.max_batch)
        bucket = self.bucket_samples
        n_buckets = max(1, -(-int(max_seconds * AUDIO_SR) // bucket))
        template = np.zeros((self.n_verts // 3, 3), np.float32)
        calls = 0
        for b in batches:
            for k in range(1, n_buckets + 1):
                audios = [np.zeros(k * bucket, np.float32)] * b
                self(audios, np.zeros((b, self.n_onehot), np.float32), template)
                calls += 1
        return calls

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
