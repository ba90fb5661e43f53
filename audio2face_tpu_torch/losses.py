"""Position + velocity losses.

Port of ``audio2face_tpu/losses.py``. Reconstruction is the batch/vertex
mean of the per-vertex squared L2 norm, velocity pairs consecutive items
along the leading axis (view (-1, 2, V, 3)), weights k_rec=1 / k_vel=10, and
the FaceFormer variant squeezes the batch dim and drops the last frame when
the frame count is odd.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _per_vertex_sq_l2_mean(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    # (N, V, 3) -> mean over N and V of sum over coords of squared error
    return (pred - gt).square().sum(dim=2).mean()


class VocaLoss:
    """Reconstruction + velocity loss."""

    def __init__(self, k_rec: float = 1.0, k_vel: float = 10.0):
        self.k_rec = k_rec
        self.k_vel = k_vel

    def __call__(self, pred: torch.Tensor, gt: torch.Tensor) -> dict[str, torch.Tensor]:
        bs = pred.shape[0]
        pred = pred.reshape(bs, -1, 3).float()
        gt = gt.reshape(bs, -1, 3).float()
        n_verts = pred.shape[1]

        rec_loss = _per_vertex_sq_l2_mean(pred, gt)

        # velocity over consecutive leading-axis pairs: view (-1, 2, V, 3)
        pred_pairs = pred.reshape(-1, 2, n_verts, 3)
        gt_pairs = gt.reshape(-1, 2, n_verts, 3)
        v_pred = pred_pairs[:, 1] - pred_pairs[:, 0]
        v_gt = gt_pairs[:, 1] - gt_pairs[:, 0]
        vel_loss = _per_vertex_sq_l2_mean(v_pred, v_gt)

        return {
            "loss": rec_loss * self.k_rec + vel_loss * self.k_vel,
            "rec_loss": rec_loss,
            "vel_loss": vel_loss,
        }


class FaceFormerLoss:
    """Sequence loss: squeeze batch, drop a trailing odd frame, delegate to
    VocaLoss so velocity pairs are (t, t+1)."""

    def __init__(self) -> None:
        self.loss = VocaLoss()

    def __call__(self, pred: torch.Tensor, gt: torch.Tensor) -> dict[str, torch.Tensor]:
        pred = pred.squeeze(0)
        gt = gt.squeeze(0)
        if gt.shape[0] % 2 != 0:
            pred = pred[:-1]
            gt = gt[:-1]
        return self.loss(pred, gt)


def masked_faceformer_loss(
    pred: torch.Tensor, gt: torch.Tensor, frame_mask: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Padded-batch generalisation of FaceFormerLoss.

    ``pred``/``gt`` are (B, T, V, 3) padded to one T; ``frame_mask`` is
    (B, T) with 1.0 on valid frames. Matches FaceFormerLoss exactly for B=1
    when the valid frames fill the buffer: per-vertex squared-L2 means for
    reconstruction, and velocity over *non-overlapping* frame pairs
    ((0,1), (2,3), ...; an odd trailing frame drops)."""
    pred = pred.float()
    gt = gt.float()
    per_frame = (pred - gt).square().sum(dim=-1).mean(dim=-1)  # (B, T)
    denom = frame_mask.sum().clamp(min=1.0)
    rec_loss = (per_frame * frame_mask).sum() / denom

    t_even = (pred.shape[1] // 2) * 2
    v_pred = pred[:, 1:t_even:2] - pred[:, 0:t_even:2]
    v_gt = gt[:, 1:t_even:2] - gt[:, 0:t_even:2]
    vmask = frame_mask[:, 1:t_even:2] * frame_mask[:, 0:t_even:2]
    vsq = (v_pred - v_gt).square().sum(dim=-1).mean(dim=-1)
    vdenom = vmask.sum().clamp(min=1.0)
    vel_loss = (vsq * vmask).sum() / vdenom

    return {
        "loss": rec_loss + 10.0 * vel_loss,
        "rec_loss": rec_loss,
        "vel_loss": vel_loss,
    }


def mse_error(
    pred: torch.Tensor,
    gt: torch.Tensor,
    n_verts: int = 5023,
    frame_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Validation "err" metric: mean over items of the mean squared
    difference over the flattened (n_verts*3,) vertex vector. ``frame_mask``
    restricts the item mean to valid frames in padded batches."""
    p = pred.reshape(-1, n_verts * 3).float()
    g = gt.reshape(-1, n_verts * 3).float()
    per_item = (p - g).square().mean(dim=1)
    if frame_mask is None:
        return per_item.mean()
    mask = frame_mask.reshape(-1)
    return (per_item * mask).sum() / mask.sum().clamp(min=1.0)


def chunked_faceformer_head_loss(
    hs: torch.Tensor,  # (B, T, 64) decoder hidden states
    kernel: torch.Tensor,  # (64, 3V) vertice_map_r, (in, out)
    bias: torch.Tensor,  # (3V,)
    template: torch.Tensor,  # (B, V, 3), training units
    gt: torch.Tensor,  # (B, T, V, 3), training units
    frame_mask: torch.Tensor,  # (B, T)
    *,
    n_verts: int,
    chunk: int = 128,
):
    """``masked_faceformer_loss`` + ``mse_error`` WITHOUT materializing the
    (B, T, V, 3) prediction.

    The vertex head is a row-parallel product and every loss term is a sum
    over frames (velocity pairs are non-overlapping), so an even-sized frame
    chunking decomposes both exactly: each checkpointed chunk projects
    ``chunk`` frames and returns its masked sums, and the backward
    recomputes one chunk of vertices at a time. Peak memory is
    O(B * chunk * V) instead of O(B * T * V). The product runs in f32, as
    the f32 parameters promote it in the JAX package.

    Returns ``({"loss", "rec_loss", "vel_loss"}, err)`` equal (up to f32
    summation order) to the unchunked pair."""
    b, t, d = hs.shape
    # the chunk must be even (velocity pairs may not straddle chunks) and
    # must divide the even prefix exactly; an odd trailing frame is handled
    # apart (it can never be in a velocity pair)
    t_even = (t // 2) * 2
    c = min(chunk, max(t_even, 2))
    while t_even % c or c % 2:
        c -= 1  # ends at 2 (t_even is even)
    tmpl_flat = template.reshape(b, 1, -1).float()

    def head(hsc):
        p = (hsc.reshape(-1, d).float() @ kernel.float() + bias.float()).reshape(
            b, hsc.shape[1], -1)
        return (p + tmpl_flat).reshape(b, hsc.shape[1], n_verts, 3)

    def rec_and_err(pred, gtc, mc):
        diff = pred - gtc
        rec = (diff.square().sum(dim=-1).mean(dim=-1) * mc).sum()
        err = (diff.reshape(b, diff.shape[1], -1).square().mean(dim=-1) * mc).sum()
        return rec, err

    def chunk_sums(hsc, gtc, mc, kernel_, bias_):  # kernel_/bias_: checkpoint inputs
        pred = head(hsc)
        gtc = gtc.float()
        rec, err = rec_and_err(pred, gtc, mc)
        v_pred = pred[:, 1::2] - pred[:, 0::2]
        v_gt = gtc[:, 1::2] - gtc[:, 0::2]
        vmask = mc[:, 1::2] * mc[:, 0::2]
        vel = ((v_pred - v_gt).square().sum(dim=-1).mean(dim=-1) * vmask).sum()
        return torch.stack([rec, mc.sum(), vel, vmask.sum(), err])

    sums = torch.zeros(5, dtype=torch.float32, device=hs.device)
    for lo in range(0, t_even, c):
        sums = sums + checkpoint(
            chunk_sums, hs[:, lo : lo + c], gt[:, lo : lo + c], frame_mask[:, lo : lo + c],
            kernel, bias, use_reentrant=False,
        )
    rec_n, m_n, vel_n, vm_n, err_n = sums.unbind()
    if t_even < t:  # odd trailing frame: rec + err terms only, never paired
        m_t = frame_mask[:, t_even:t]
        rec_t, err_t = rec_and_err(head(hs[:, t_even:t]), gt[:, t_even:t].float(), m_t)
        rec_n, m_n, err_n = rec_n + rec_t, m_n + m_t.sum(), err_n + err_t
    denom = m_n.clamp(min=1.0)
    rec_loss = rec_n / denom
    vel_loss = vel_n / vm_n.clamp(min=1.0)
    return (
        {"loss": rec_loss + 10.0 * vel_loss, "rec_loss": rec_loss, "vel_loss": vel_loss},
        err_n / denom,
    )
