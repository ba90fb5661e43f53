"""FaceFormer decode loop: a hand-written CUDA kernel + its plain version.

Port of ``audio2face_tpu/ops/decode_kernel.py``, both variants.
``faceformer_decode_loop`` runs the whole autoregressive loop: for CUDA
tensors in one launch of ``csrc/decode_loop.cu`` (one block per batch item,
weights in shared memory, the KV cache in device memory), for CPU tensors
as ``decode_loop_reference``, a Python loop over t (``decode_steps`` in f32;
``decode_steps`` is also the differentiable loop that training runs, with
dropout masks and chunk checkpointing). Each step:

  x_t   = emb_t + PPE[t mod period]
  attn  = softmax_{j<=t}(q_t . k_j / sqrt(hd) - slope_h * ((t-j) // period)) v_j
  h     = LN1(x_t + W_o attn)
  h     = LN2(h + ca_t)
  h     = LN3(h + W_2 relu(W_1 h))
  emb_{t+1} = h @ (W_r W_m) + b + style

vocaset passes ``cross``: the diagonal cross attention, precomputed, is
``ca_t = cross[:, t]``. BIWI passes ``mem_k``/``mem_v`` (B, 4, 2T, 16), the
cross key/value projections of the 50 fps latents, and each step runs a true
2-way softmax per head over the latents {2t, 2t+1}:

  qc    = h W_cq + b_cq
  ca_t  = (softmax_{j in {2t, 2t+1}}(qc . mem_k_j / sqrt(hd)) mem_v_j) W_co + b_co

Weights use the JAX kernel's dict keys, kernels in (in, out) order:
``{q,k,v,o,f1,f2,fb}_{kernel,bias}`` and ``ln{1,2,3}_{scale,bias}``; BIWI adds
``{cq,co}_{kernel,bias}``. The kernel is inference only.
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
# the BIWI variant's buffer continues with its cross-attention projections
_PACK_ORDER_BIWI = _PACK_ORDER + ("cq_kernel", "cq_bias", "co_kernel", "co_bias")
# shared memory the kernel needs per block (csrc/decode_loop.cu SMEM_BYTES):
# the packed weights plus per-step scratch, independent of T
SMEM_BYTES = 4 * (
    3 * D * D + 3 * D + D * D + D + D * FF + FF + FF * D + D + D * D + D
    + 6 * D + 5 * D + FF + 8 * (2 + HD) + 8
)
# BIWI: W_cq, b_cq, W_co, b_co, and scratch for qc, the two mem_k and mem_v
# rows of the step and the per-head value sum
SMEM_BYTES_BIWI = SMEM_BYTES + 4 * (2 * (D * D + D) + D + 2 * D + 2 * D + D)
# shared memory one block may use on sm_90 (H100/H200)
SM90_SMEM_PER_BLOCK = 232448


def smem_bytes(biwi: bool = False) -> int:
    """Shared memory per block that the kernel variant needs."""
    return SMEM_BYTES_BIWI if biwi else SMEM_BYTES


def smem_fits(device: torch.device, biwi: bool = False) -> bool:
    """True iff the variant's shared-memory need fits one block of ``device``."""
    limit = getattr(
        torch.cuda.get_device_properties(device), "shared_memory_per_block_optin",
        SM90_SMEM_PER_BLOCK,
    )
    return smem_bytes(biwi) <= limit


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in x's dtype (one fused call:
    the loop below is bound by its launch count)."""
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, 1e-5).to(x.dtype)


def _flat_heads(mem: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) -> (B, S, H*hd): the decode loop's column order h*hd + i."""
    b, _, s, _ = mem.shape
    return mem.transpose(1, 2).reshape(b, s, D)


def decode_steps(
    cross: Optional[torch.Tensor],  # (B, T, 64) precomputed cross term (vocaset)
    style: torch.Tensor,  # (B, 64)
    pe: torch.Tensor,  # (period, 64)
    weights: dict,
    *,
    period: int = 60,
    masks: Optional[dict] = None,
    chunk: Optional[int] = None,
    mem_k: Optional[torch.Tensor] = None,  # (B, 4, 2T, 16) BIWI cross keys
    mem_v: Optional[torch.Tensor] = None,  # (B, 4, 2T, 16) BIWI cross values
) -> torch.Tensor:
    """The KV-cached decode step of FaceFormer, one Python iteration per
    frame, differentiable (no in-place cache writes), in the compute dtype
    of its inputs (products in that dtype; LayerNorm, scores and softmax
    in f32), with optional dropout ``masks``: keep-multipliers (T, B, width)
    under the keys ``m_pe``, ``m_sa``, ``m_ca``, ``m_ff1`` (128 wide) and
    ``m_ff2``. Returns (B, T, 64). BIWI passes ``cross=None`` and
    ``mem_k``/``mem_v``: the cross term of step t is the 2-way softmax over
    the latents {2t, 2t+1}, computed inside the step.

    ``chunk`` frames at a time run under ``torch.utils.checkpoint``: only
    each chunk's carry (next embedding and the K/V prefix) is kept, and the
    backward recomputes one chunk's steps at a time, so residual memory is
    O(T^2 / chunk) instead of O(T^2). ``chunk=None`` keeps every step's
    residuals."""
    biwi = mem_k is not None
    if biwi:
        # each frame's latent pair, keys beside values: (B, 2T, 128) -> (B, T, 2, 128)
        per_frame = torch.cat([_flat_heads(mem_k), _flat_heads(mem_v)], dim=-1)
        per_frame = per_frame.reshape(per_frame.shape[0], -1, 2, 2 * D)
    else:
        per_frame = cross
    bsz, n_frames = per_frame.shape[:2]
    d, nh, hd = D, N_HEADS, HD
    w = weights
    qkv_k = torch.cat([w["q_kernel"], w["k_kernel"], w["v_kernel"]], dim=1)
    qkv_b = torch.cat([w["q_bias"], w["k_bias"], w["v_bias"]])
    slopes = torch.as_tensor(alibi_slopes(nh), device=style.device)
    pos = torch.arange(n_frames, device=style.device)
    sm_scale = 1.0 / math.sqrt(hd)
    mask_keys = sorted(masks) if masks else []
    fb_bias_style = w["fb_bias"] + style  # (B, 64): the feedback's constant part

    def run(t0, t1, emb, k_cache, v_cache, frame_c, *mask_c):
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
            if biwi:
                qc = torch.addmm(w["cq_bias"], h, w["cq_kernel"]).reshape(bsz, nh, hd)
                k2 = frame_c[:, i, :, :d].reshape(bsz, 2, nh, hd)
                v2 = frame_c[:, i, :, d:].reshape(bsz, 2, nh, hd)
                s2 = torch.einsum("bhe,bkhe->bhk", qc.float(), k2.float()) * sm_scale
                p2 = torch.softmax(s2, dim=-1).to(v2.dtype)
                ca = torch.einsum("bhk,bkhe->bhe", p2, v2).reshape(bsz, d)
                ca = torch.addmm(w["co_bias"], ca, w["co_kernel"])
            else:
                ca = frame_c[:, i]
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
    k_cache = style.new_zeros((bsz, 0, d))
    v_cache = style.new_zeros((bsz, 0, d))
    step = n_frames if chunk is None else chunk
    out = []
    for t0 in range(0, n_frames, step):
        t1 = min(t0 + step, n_frames)
        args = (emb, k_cache, v_cache, per_frame[:, t0:t1], *(masks[key][t0:t1] for key in mask_keys))
        if chunk is None or not torch.is_grad_enabled():
            emb, k_cache, v_cache, hs = run(t0, t1, *args)
        else:
            emb, k_cache, v_cache, hs = checkpoint(run, t0, t1, *args, use_reentrant=False)
        out.append(hs)
    return torch.cat(out, dim=1)


def decode_loop_reference(
    cross: Optional[torch.Tensor], style: torch.Tensor, pe: torch.Tensor, weights: dict,
    *, period: int = 60,
    mem_k: Optional[torch.Tensor] = None, mem_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel: ``decode_steps`` in f32 (the kernel
    computes in f32 whatever its inputs' type). Returns (B, T, 64) in the
    type of ``cross`` (BIWI: of ``mem_k``)."""
    w = {k: v.float() for k, v in weights.items()}
    if mem_k is not None:
        return decode_steps(
            None, style.float(), pe.float(), w, period=period,
            mem_k=mem_k.float(), mem_v=mem_v.float(),
        ).to(mem_k.dtype)
    return decode_steps(cross.float(), style.float(), pe.float(), w, period=period).to(cross.dtype)


def _pack_weights(weights: dict, device, biwi: bool = False) -> torch.Tensor:
    w = {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}
    w["qkv_kernel"] = torch.cat([w["q_kernel"], w["k_kernel"], w["v_kernel"]], dim=1)
    w["qkv_bias"] = torch.cat([w["q_bias"], w["k_bias"], w["v_bias"]])
    order = _PACK_ORDER_BIWI if biwi else _PACK_ORDER
    return torch.cat([w[name].reshape(-1) for name in order]).contiguous()


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGTYPES_BIWI = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _decode_loop_cuda(cross, style, pe, weights, period, mem_k=None, mem_v=None):
    biwi = mem_k is not None
    data = mem_k if biwi else cross
    b, dev = data.shape[0], data.device
    t_steps = mem_k.shape[2] // 2 if biwi else cross.shape[1]
    packed = _pack_weights(weights, dev, biwi)
    n_weights = _build.function("decode_loop", "a2f_decode_n_weights", [ctypes.c_int])(int(biwi))
    smem = _build.function("decode_loop", "a2f_decode_smem_bytes", [ctypes.c_int])(int(biwi))
    if packed.numel() != n_weights or smem != smem_bytes(biwi):
        raise RuntimeError(
            f"decode kernel layout mismatch: {packed.numel()} packed floats vs "
            f"{n_weights}, {smem_bytes(biwi)} shared bytes vs {smem}"
        )
    style32 = style.to(device=dev, dtype=torch.float32).contiguous()
    pe32 = pe.to(device=dev, dtype=torch.float32).contiguous()
    slopes = torch.as_tensor(alibi_slopes(N_HEADS), device=dev)
    kv = torch.empty((b, t_steps, 2 * D), dtype=torch.float32, device=dev)
    out = torch.empty((b, t_steps, D), dtype=torch.float32, device=dev)
    tail = (
        style32.data_ptr(), pe32.data_ptr(), packed.data_ptr(), slopes.data_ptr(),
        kv.data_ptr(), out.data_ptr(), b, t_steps, period,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if biwi:
        # one conversion to f32 outside the loop, rows in the loop's h*hd + i order
        memk32 = _flat_heads(mem_k).to(torch.float32).contiguous()
        memv32 = _flat_heads(mem_v).to(torch.float32).contiguous()
        fn = _build.function("decode_loop", "a2f_decode_loop_biwi", _ARGTYPES_BIWI)
        rc = fn(memk32.data_ptr(), memv32.data_ptr(), *tail)
        _build.check(rc, "faceformer_decode_loop (biwi)")
        faceformer_decode_loop.biwi_launches += 1
    else:
        cross32 = cross.to(torch.float32).contiguous()
        fn = _build.function("decode_loop", "a2f_decode_loop", _ARGTYPES)
        rc = fn(cross32.data_ptr(), *tail)
        _build.check(rc, "faceformer_decode_loop")
        faceformer_decode_loop.launches += 1
    return out.to(data.dtype)


def faceformer_decode_loop(
    cross: Optional[torch.Tensor],  # (B, T, 64) precomputed cross term (vocaset)
    style: torch.Tensor,  # (B, 64)
    pe: torch.Tensor,  # (period, 64)
    weights: dict,
    *,
    period: int = 60,
    mem_k: Optional[torch.Tensor] = None,  # (B, 4, 2T, 16) BIWI cross keys
    mem_v: Optional[torch.Tensor] = None,  # (B, 4, 2T, 16) BIWI cross values
) -> torch.Tensor:
    """Run the decode loop; returns hidden states (B, T, 64) in the type of
    ``cross`` (BIWI: of ``mem_k``). vocaset passes ``cross``; BIWI passes
    ``cross=None`` with ``mem_k``/``mem_v`` and the ``cq``/``co`` weights.
    CUDA tensors launch the kernel variant (counted in ``launches`` and
    ``biwi_launches``), which is inference only: with gradients enabled and
    an input that requires one it raises. CPU tensors run the plain loop."""
    biwi = mem_k is not None
    if biwi:
        if cross is not None or mem_v is None:
            raise ValueError("the BIWI variant takes cross=None with mem_k and mem_v")
        b, nh, s, hd = mem_k.shape
        if (nh, hd) != (N_HEADS, HD) or s % 2 or mem_v.shape != mem_k.shape:
            raise ValueError(
                f"shapes mem_k {tuple(mem_k.shape)} mem_v {tuple(mem_v.shape)}: "
                f"want (B, {N_HEADS}, 2T, {HD})"
            )
        missing = [k for k in _PACK_ORDER_BIWI[-4:] if k not in weights]
        if missing:
            raise ValueError(f"the BIWI variant needs the weights {missing}")
        data, what = mem_k, f"mem_k {tuple(mem_k.shape)}"
    else:
        if cross is None or cross.ndim != 3 or cross.shape[2] != D:
            raise ValueError("the vocaset variant takes cross (B, T, 64)")
        b = cross.shape[0]
        data, what = cross, f"cross {tuple(cross.shape)}"
    if style.shape != (b, D) or pe.shape != (period, D):
        raise ValueError(
            f"shapes {what} style {tuple(style.shape)} pe {tuple(pe.shape)} (period {period})"
        )
    if data.device.type == "cpu":
        return decode_loop_reference(
            cross, style, pe, weights, period=period, mem_k=mem_k, mem_v=mem_v)
    if data.device.type != "cuda":
        raise ValueError(f"faceformer_decode_loop runs on cuda or cpu, not {data.device}")
    inputs = (mem_k, mem_v) if biwi else (cross,)
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (*inputs, style, *weights.values())
    ):
        raise RuntimeError(
            "faceformer_decode_loop has no backward: call it under torch.no_grad(), or "
            "ask for the differentiable step loop (FaceFormer(..., differentiable=True), "
            "decode_steps)"
        )
    return _decode_loop_cuda(cross, style, pe, weights, period, mem_k, mem_v)


faceformer_decode_loop.launches = 0
faceformer_decode_loop.biwi_launches = 0
