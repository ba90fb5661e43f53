"""Multi-head attention: a hand-written CUDA flash kernel + its plain version.

Port of ``audio2face_tpu/ops/attention.py``. ``flash_attention`` launches the
CUDA kernel ``csrc/flash_attention.cu`` for CUDA tensors (the TPU's
``flash_attention_pallas``) and runs ``mha_reference`` for CPU tensors. Both
support, in any combination: causal masking, the FaceFormer period-bucketed
ALiBi bias ``-slope_h * ((i - j) // period)``, and per-batch KV lengths.
Inference only: attention dropout arrives with training.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from audio2face_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -1e30
_HEAD_DIMS = (16, 32, 64, 128)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """ALiBi head slopes: 2^(-8/n), 2^(-16/n), ... for power-of-two n; other
    n interleave the closest power of two's slopes, per the ALiBi paper."""

    def pow2_slopes(n: int) -> list[float]:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        slopes = (
            pow2_slopes(closest)
            + pow2_slopes(2 * closest)[0::2][: n_heads - closest]
        )
    return np.asarray(slopes, dtype=np.float32)


def alibi_period_bias(
    n_heads: int, t_q: int, t_k: int, period: int, device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Dense (H, Tq, Tk) bias: -slope_h * ((i - j) // period)."""
    slopes = torch.as_tensor(alibi_slopes(n_heads), device=device)
    i = torch.arange(t_q, device=device)[:, None]
    j = torch.arange(t_k, device=device)[None, :]
    dist = torch.div(i - j, period, rounding_mode="floor")
    return -slopes[:, None, None] * dist[None].to(torch.float32)


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    alibi_period: Optional[int] = None,
    kv_lengths: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain multi-head attention. q, k, v: (B, H, T, D) -> (B, H, Tq, D).

    Scores and softmax in f32; the probabilities are cast to v's dtype for
    the value product, as the kernel does. ``return_lse`` also returns the
    per-row logsumexp (B, H, Tq) f32."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    i = torch.arange(t_q, device=q.device)[:, None]
    j = torch.arange(t_k, device=q.device)[None, :]
    if alibi_period is not None:
        s = s + alibi_period_bias(h, t_q, t_k, alibi_period, q.device)[None]
    mask = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (j <= i)
    mask = mask[None, None].expand(b, h, t_q, t_k)
    if kv_lengths is not None:
        mask = mask & (j[None, None] < kv_lengths.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def _flash_attention_cuda(q, k, v, causal, alibi_period, kv_lengths, sm_scale):
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {_HEAD_DIMS}, got {d}")
    qf, kf, vf = q.contiguous(), k.contiguous(), v.contiguous()
    if kv_lengths is None:
        kvlen = torch.full((b,), t_k, dtype=torch.int32, device=q.device)
    else:
        kvlen = kv_lengths.to(device=q.device, dtype=torch.int32).clamp(0, t_k).contiguous()
    slopes = torch.as_tensor(alibi_slopes(h), device=q.device)
    out = torch.empty((b, h, t_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", "a2f_flash_attention_fwd", _ARGTYPES)
    rc = fn(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), lse.data_ptr(),
        kvlen.data_ptr(), slopes.data_ptr(), b, h, t_q, t_k, d,
        int(q.dtype == torch.bfloat16), int(causal), int(alibi_period or 0),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    alibi_period: Optional[int] = None,
    kv_lengths: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Fused MHA. q, k, v: (B, H, T, D) f32 or bf16 -> (B, H, Tq, D).

    CUDA tensors launch the flash kernel; CPU tensors run ``mha_reference``.
    ``return_lse`` also returns the per-row logsumexp (B, H, Tq) f32. Rows
    of a query whose keys are all masked are finite padding."""
    if alibi_period is not None and alibi_period <= 0:
        raise ValueError(f"alibi_period must be positive, got {alibi_period}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return mha_reference(
            q, k, v, causal=causal, alibi_period=alibi_period,
            kv_lengths=kv_lengths, sm_scale=sm_scale, return_lse=return_lse,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    out, lse = _flash_attention_cuda(q, k, v, causal, alibi_period, kv_lengths, sm_scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
