"""FaceFormer decode loop: a hand-written CUDA kernel + its plain version.

Port of ``audio2face_tpu/ops/decode_kernel.py`` (vocaset variant).
``faceformer_decode_loop`` runs the whole autoregressive loop: for CUDA
tensors in one launch of ``csrc/decode_loop.cu`` (one block per batch item,
weights in shared memory, the KV cache in device memory), for CPU tensors
as ``decode_loop_reference``, a Python loop over t (``decode_steps`` in f32;
``decode_steps`` is also the differentiable loop that training runs, with
dropout masks and chunk checkpointing). Each step:

  x_t   = emb_t + PPE[t mod period]
  attn  = softmax_{j<=t}(q_t . k_j / sqrt(hd) - slope_h * ((t-j) // period)) v_j
  h     = LN1(x_t + W_o attn)
  h     = LN2(h + cross_t)            # diagonal cross-attention, precomputed
  h     = LN3(h + W_2 relu(W_1 h))
  emb_{t+1} = h @ (W_r W_m) + b + style

Weights use the JAX kernel's dict keys, kernels in (in, out) order:
``{q,k,v,o,f1,f2,fb}_{kernel,bias}`` and ``ln{1,2,3}_{scale,bias}``.
The kernel is inference only; the BIWI variant (``mem_k``/``mem_v``) is not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from audio2face_tpu_torch.ops import _build
from audio2face_tpu_torch.ops.attention import alibi_slopes

D = 64
N_HEADS = 4
HD = D // N_HEADS
FF = 2 * D

# order of the packed f32 weight buffer of csrc/decode_loop.cu
_PACK_ORDER = (
    "qkv_kernel", "qkv_bias", "o_kernel", "o_bias", "f1_kernel", "f1_bias",
    "f2_kernel", "f2_bias", "fb_kernel", "fb_bias", "ln1_scale", "ln1_bias",
    "ln2_scale", "ln2_bias", "ln3_scale", "ln3_bias",
)
# shared memory the kernel needs per block (csrc/decode_loop.cu SMEM_BYTES):
# the packed weights plus per-step scratch, independent of T
SMEM_BYTES = 4 * (
    3 * D * D + 3 * D + D * D + D + D * FF + FF + FF * D + D + D * D + D
    + 6 * D + 5 * D + FF + 8 * (2 + HD) + 8
)
# shared memory one block may use on sm_90 (H100/H200)
SM90_SMEM_PER_BLOCK = 232448


def smem_fits(device: torch.device) -> bool:
    """True iff the kernel's shared-memory need fits one block of ``device``."""
    limit = getattr(
        torch.cuda.get_device_properties(device), "shared_memory_per_block_optin",
        SM90_SMEM_PER_BLOCK,
    )
    return SMEM_BYTES <= limit


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in x's dtype (one fused call:
    the loop below is bound by its launch count)."""
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, 1e-5).to(x.dtype)


def decode_steps(
    cross: torch.Tensor,  # (B, T, 64) precomputed cross term
    style: torch.Tensor,  # (B, 64)
    pe: torch.Tensor,  # (period, 64)
    weights: dict,
    *,
    period: int = 60,
    masks: Optional[dict] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """The KV-cached decode step of FaceFormer, one Python iteration per
    frame, differentiable (no in-place cache writes), in the compute dtype
    of its inputs (products in ``cross.dtype``; LayerNorm, scores and softmax
    in f32), with optional dropout ``masks``: keep-multipliers (T, B, width)
    under the keys ``m_pe``, ``m_sa``, ``m_ca``, ``m_ff1`` (128 wide) and
    ``m_ff2``. Returns (B, T, 64).

    ``chunk`` frames at a time run under ``torch.utils.checkpoint``: only
    each chunk's carry (next embedding and the K/V prefix) is kept, and the
    backward recomputes one chunk's steps at a time, so residual memory is
    O(T^2 / chunk) instead of O(T^2). ``chunk=None`` keeps every step's
    residuals."""
    bsz, n_frames, d = cross.shape
    nh, hd = N_HEADS, HD
    w = weights
    qkv_k = torch.cat([w["q_kernel"], w["k_kernel"], w["v_kernel"]], dim=1)
    qkv_b = torch.cat([w["q_bias"], w["k_bias"], w["v_bias"]])
    slopes = torch.as_tensor(alibi_slopes(nh), device=cross.device)
    pos = torch.arange(n_frames, device=cross.device)
    sm_scale = 1.0 / math.sqrt(hd)
    mask_keys = sorted(masks) if masks else []
    fb_bias_style = w["fb_bias"] + style  # (B, 64): the feedback's constant part

    def run(t0, t1, emb, k_cache, v_cache, cross_c, *mask_c):
        m = dict(zip(mask_keys, mask_c))
        # ALiBi bias of this run of frames, -slope_h * ((t - j) // period): (H, t1 - t0, t1)
        dist = torch.div(pos[t0:t1, None] - pos[None, :t1], period, rounding_mode="floor")
        bias = -slopes[:, None, None] * dist[None].float()
        hs = []
        for t in range(t0, t1):
            i = t - t0
            x = emb + pe[t % period]
            if m:
                x = x * m["m_pe"][i]
            qkv = torch.addmm(qkv_b, x, qkv_k)  # (B, 192); columns are head*hd + lane
            q = qkv[:, :d].reshape(bsz, nh, hd)
            k_cache = torch.cat([k_cache, qkv[:, None, d : 2 * d]], dim=1)  # (B, t+1, 64)
            v_cache = torch.cat([v_cache, qkv[:, None, 2 * d :]], dim=1)
            kmat = k_cache.reshape(bsz, t + 1, nh, hd)
            vmat = v_cache.reshape(bsz, t + 1, nh, hd)
            s = torch.einsum("bhd,bthd->bht", q.float(), kmat.float()) * sm_scale
            s = s + bias[:, i, : t + 1]
            p = torch.softmax(s, dim=-1)
            attn = torch.einsum("bht,bthd->bhd", p.to(vmat.dtype), vmat).reshape(bsz, d)
            sa = torch.addmm(w["o_bias"], attn, w["o_kernel"])
            if m:
                sa = sa * m["m_sa"][i]
            h = _layer_norm(x + sa, w["ln1_scale"], w["ln1_bias"])
            ca = cross_c[:, i]
            if m:
                ca = ca * m["m_ca"][i]
            h = _layer_norm(h + ca, w["ln2_scale"], w["ln2_bias"])
            ff = torch.relu(torch.addmm(w["f1_bias"], h, w["f1_kernel"]))
            if m:
                ff = ff * m["m_ff1"][i]
            ff = torch.addmm(w["f2_bias"], ff, w["f2_kernel"])
            if m:
                ff = ff * m["m_ff2"][i]
            h = _layer_norm(h + ff, w["ln3_scale"], w["ln3_bias"])
            hs.append(h)
            emb = torch.addmm(fb_bias_style, h, w["fb_kernel"])
        return emb, k_cache, v_cache, torch.stack(hs, dim=1)

    emb = style
    k_cache = cross.new_zeros((bsz, 0, d))
    v_cache = cross.new_zeros((bsz, 0, d))
    step = n_frames if chunk is None else chunk
    out = []
    for t0 in range(0, n_frames, step):
        t1 = min(t0 + step, n_frames)
        args = (emb, k_cache, v_cache, cross[:, t0:t1], *(masks[key][t0:t1] for key in mask_keys))
        if chunk is None or not torch.is_grad_enabled():
            emb, k_cache, v_cache, hs = run(t0, t1, *args)
        else:
            emb, k_cache, v_cache, hs = checkpoint(run, t0, t1, *args, use_reentrant=False)
        out.append(hs)
    return torch.cat(out, dim=1)


def decode_loop_reference(
    cross: torch.Tensor, style: torch.Tensor, pe: torch.Tensor, weights: dict,
    *, period: int = 60,
) -> torch.Tensor:
    """Plain version of the kernel: ``decode_steps`` in f32 (the kernel
    computes in f32 whatever its inputs' type). Returns (B, T, 64) in
    ``cross.dtype``."""
    w = {k: v.float() for k, v in weights.items()}
    return decode_steps(cross.float(), style.float(), pe.float(), w, period=period).to(cross.dtype)


def _pack_weights(weights: dict, device) -> torch.Tensor:
    w = {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}
    w["qkv_kernel"] = torch.cat([w["q_kernel"], w["k_kernel"], w["v_kernel"]], dim=1)
    w["qkv_bias"] = torch.cat([w["q_bias"], w["k_bias"], w["v_bias"]])
    return torch.cat([w[name].reshape(-1) for name in _PACK_ORDER]).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _decode_loop_cuda(cross, style, pe, weights, period):
    b, t_steps, d = cross.shape
    dev = cross.device
    packed = _pack_weights(weights, dev)
    n_weights = _build.function("decode_loop", "a2f_decode_n_weights", [])()
    smem = _build.function("decode_loop", "a2f_decode_smem_bytes", [])()
    if packed.numel() != n_weights or smem != SMEM_BYTES:
        raise RuntimeError(
            f"decode kernel layout mismatch: {packed.numel()} packed floats vs "
            f"{n_weights}, {SMEM_BYTES} shared bytes vs {smem}"
        )
    cross32 = cross.to(torch.float32).contiguous()
    style32 = style.to(device=dev, dtype=torch.float32).contiguous()
    pe32 = pe.to(device=dev, dtype=torch.float32).contiguous()
    slopes = torch.as_tensor(alibi_slopes(N_HEADS), device=dev)
    kv = torch.empty((b, t_steps, 2 * D), dtype=torch.float32, device=dev)
    out = torch.empty((b, t_steps, D), dtype=torch.float32, device=dev)
    fn = _build.function("decode_loop", "a2f_decode_loop", _ARGTYPES)
    rc = fn(
        cross32.data_ptr(), style32.data_ptr(), pe32.data_ptr(), packed.data_ptr(),
        slopes.data_ptr(), kv.data_ptr(), out.data_ptr(), b, t_steps, period,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "faceformer_decode_loop")
    faceformer_decode_loop.launches += 1
    return out.to(cross.dtype)


def faceformer_decode_loop(
    cross: torch.Tensor,  # (B, T, 64) precomputed cross term
    style: torch.Tensor,  # (B, 64)
    pe: torch.Tensor,  # (period, 64)
    weights: dict,
    *,
    period: int = 60,
) -> torch.Tensor:
    """Run the decode loop; returns hidden states (B, T, 64) in
    ``cross.dtype``. CUDA tensors launch the kernel, which is inference
    only: with gradients enabled and an input that requires one it raises.
    CPU tensors run the plain loop."""
    b, t_steps, d = cross.shape
    if d != D or style.shape != (b, D) or pe.shape != (period, D):
        raise ValueError(
            f"shapes cross {tuple(cross.shape)} style {tuple(style.shape)} "
            f"pe {tuple(pe.shape)} (period {period})"
        )
    if cross.device.type == "cpu":
        return decode_loop_reference(cross, style, pe, weights, period=period)
    if cross.device.type != "cuda":
        raise ValueError(f"faceformer_decode_loop runs on cuda or cpu, not {cross.device}")
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (cross, style, *weights.values())
    ):
        raise RuntimeError(
            "faceformer_decode_loop has no backward: call it under torch.no_grad(), or "
            "ask for the differentiable step loop (FaceFormer(..., differentiable=True), "
            "decode_steps)"
        )
    return _decode_loop_cuda(cross, style, pe, weights, period)


faceformer_decode_loop.launches = 0
