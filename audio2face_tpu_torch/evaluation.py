"""Evaluation metrics for speech-driven 3D facial animation.

Port of ``audio2face_tpu/evaluation.py``. The region-based metrics the field
compares models with (FaceFormer, CodeTalker and successors):

- **LVE** (lip vertex error): per frame, the maximum squared L2 distance
  over the lip-region vertices; averaged over frames.
- **FDD** (upper-face dynamics deviation): for each upper-face vertex, the
  standard deviation over time of its squared displacement from the neutral
  template, compared between prediction and ground truth (signed) and
  averaged over the region.
- **MVE** (mean vertex error): mean L2 distance over all vertices/frames.
- **max vertex L2**: the repo's parity metric.

Formulas (x = prediction, y = ground truth, T = template, all (T, V, 3) in
dataset units; VOCASET is meters)::

    LVE  = mean_t max_{v in lips} ||x_tv - y_tv||^2
    dyn(z)_v = std_t ||z_tv - T_v||^2          (population std)
    FDD  = mean_{v in upper} ( dyn(x)_v - dyn(y)_v )
    MVE  = mean_{t,v} ||x_tv - y_tv||

Region masks are vertex-index arrays. FLAME's official segmentation masks
are licensed; without them :func:`infer_regions` derives a documented
geometric stand-in from the neutral template (+y up, +z out of the face):
self-consistent across models and checkpoints, but not comparable with
published numbers computed on the official masks.

The metric functions take tensors on any device, or numpy arrays, of shape
(..., T, V, 3) with an optional (..., T) ``frame_mask`` for padded batches,
and compute in f32 on the device of ``pred``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class VertexRegions:
    """Vertex-index arrays for the metric regions (host numpy). ``lip``
    drives LVE, ``upper`` drives FDD."""

    lip: np.ndarray
    upper: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "lip", np.asarray(self.lip, np.int32).ravel())
        object.__setattr__(self, "upper", np.asarray(self.upper, np.int32).ravel())
        if self.lip.size == 0 or self.upper.size == 0:
            raise ValueError("regions must be non-empty index arrays")


def infer_regions(template: np.ndarray) -> VertexRegions:
    """Geometric stand-in for the licensed FLAME segmentation masks.

    Under the FLAME axis convention (+y up, +z toward the viewer):

    - ``lip``: vertices in the lower 45% of the bounding-box height, within
      the frontmost 30% of depth, and within the central half of the width:
      the protruding mouth/chin front.
    - ``upper``: vertices in the top 40% of the bounding-box height:
      forehead/brow/eye region.

    A documented heuristic, not anatomy: numbers computed with it are
    self-consistent but not comparable with published results that use the
    official masks.
    """
    t = np.asarray(template, np.float64).reshape(-1, 3)
    lo, hi = t.min(axis=0), t.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    u = (t - lo) / span  # normalized [0,1]^3 coordinates

    lip = (u[:, 1] < 0.45) & (u[:, 2] > 0.70) & (np.abs(u[:, 0] - 0.5) < 0.25)
    upper = u[:, 1] > 0.60
    # degenerate templates (flat axes, tiny meshes): fall back to halves
    if not lip.any():
        lip = u[:, 1] < 0.5
    if not upper.any():
        upper = u[:, 1] >= 0.5
    return VertexRegions(lip=np.flatnonzero(lip), upper=np.flatnonzero(upper))


# ---------------------------------------------------------------------------
# metric primitives: (..., T, V, 3) arrays, optional (..., T) frame mask
# ---------------------------------------------------------------------------


def _f32(x, device=None) -> torch.Tensor:
    """``x`` (tensor or array) as an f32 tensor on ``device`` (default: its
    own)."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = np.array(x)  # a broadcast view: torch takes writable memory only
    x = torch.as_tensor(x)
    return x.to(device=device if device is not None else x.device, dtype=torch.float32)


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over every axis, mask-weighted."""
    if mask is None:
        return x.mean()
    m = torch.broadcast_to(mask, x.shape)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def lip_vertex_error(pred, gt, lip_ids: np.ndarray, frame_mask=None) -> torch.Tensor:
    """LVE: mean over frames of the max squared L2 over lip vertices.

    ``pred``/``gt``: (..., T, V, 3); ``frame_mask``: (..., T) 1=valid.
    Returns a scalar (batch dims averaged, mask-weighted)."""
    pred = _f32(pred)
    gt, dev = _f32(gt, pred.device), pred.device
    ids = _ids(lip_ids, dev)
    d2 = (pred[..., ids, :] - gt[..., ids, :]).square().sum(dim=-1)
    per_frame = d2.amax(dim=-1)  # (..., T)
    mask = None if frame_mask is None else _f32(frame_mask, dev)
    return _masked_mean(per_frame, mask)


def upper_face_dynamics_deviation(
    pred, gt, template, upper_ids: np.ndarray, frame_mask=None
) -> torch.Tensor:
    """FDD: mean over upper-face vertices of dyn(pred) - dyn(gt), where
    dyn(z)_v = std over frames of ||z_tv - template_v||^2. Signed: positive
    means the prediction over-animates the upper face, negative means it
    under-animates.

    ``template``: (..., V, 3), broadcast over T when it has one axis fewer
    than ``pred``. With a frame mask, the std is computed over valid frames
    only."""
    pred = _f32(pred)
    dev = pred.device
    gt, template = _f32(gt, dev), _f32(template, dev)
    ids = _ids(upper_ids, dev)
    tmpl = template[..., None, :, :] if template.ndim == pred.ndim - 1 else template
    mask = None if frame_mask is None else _f32(frame_mask, dev)

    def dyn(z):
        d2 = (z[..., ids, :] - tmpl[..., ids, :]).square().sum(dim=-1)
        # (..., T, Vu): std over the frame axis, mask-weighted
        if mask is None:
            return torch.std(d2, dim=-2, correction=0)
        m = mask[..., None]
        n = torch.clamp(m.sum(dim=-2), min=1.0)
        mu = (d2 * m).sum(dim=-2) / n
        var = ((d2 - mu[..., None, :]).square() * m).sum(dim=-2) / n
        return var.sqrt()

    return (dyn(pred) - dyn(gt)).mean()


def mean_vertex_error(pred, gt, frame_mask=None) -> torch.Tensor:
    """MVE: mean L2 distance over all vertices and (valid) frames."""
    pred = _f32(pred)
    d = (pred - _f32(gt, pred.device)).square().sum(dim=-1).sqrt()  # (..., T, V)
    mask = None if frame_mask is None else _f32(frame_mask, pred.device)[..., None]
    return _masked_mean(d, mask)


def max_vertex_l2(pred, gt, frame_mask=None) -> torch.Tensor:
    """The repo's parity metric: max L2 distance over every vertex/frame
    (masked frames count as 0)."""
    pred = _f32(pred)
    d = (pred - _f32(gt, pred.device)).square().sum(dim=-1).sqrt()
    if frame_mask is not None:
        d = d * _f32(frame_mask, pred.device)[..., None]
    return d.amax()


METRICS = ("lve", "fdd", "mve", "max_l2")


def animation_metrics(pred, gt, template, regions: VertexRegions, frame_mask=None) -> torch.Tensor:
    """The four metrics of :func:`evaluate_animation` stacked into one (4,)
    f32 tensor on the device of ``pred`` (order: ``METRICS``), without
    reading them back."""
    return torch.stack([
        lip_vertex_error(pred, gt, regions.lip, frame_mask),
        upper_face_dynamics_deviation(pred, gt, template, regions.upper, frame_mask),
        mean_vertex_error(pred, gt, frame_mask),
        max_vertex_l2(pred, gt, frame_mask),
    ])


def evaluate_animation(
    pred,
    gt,
    template,
    regions: Optional[VertexRegions] = None,
    frame_mask=None,
) -> dict:
    """All metrics for one (or a batch of) predicted animation(s), as Python
    floats read back in one device-to-host copy. ``regions=None`` infers the
    geometric stand-in from the template (:func:`infer_regions`)."""
    if regions is None:
        host_t = template.detach().cpu().numpy() if isinstance(template, torch.Tensor) \
            else np.asarray(template)
        regions = infer_regions(host_t.reshape(-1, host_t.shape[-2], 3)[0])
    values = animation_metrics(pred, gt, template, regions, frame_mask).tolist()
    return dict(zip(METRICS, values))
