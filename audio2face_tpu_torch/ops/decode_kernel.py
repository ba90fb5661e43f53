"""FaceFormer decode loop: a hand-written CUDA kernel + its plain version.

Port of ``audio2face_tpu/ops/decode_kernel.py`` (vocaset variant).
``faceformer_decode_loop`` runs the whole autoregressive loop: for CUDA
tensors in one launch of ``csrc/decode_loop.cu`` (one block per batch item,
weights in shared memory, the KV cache in device memory), for CPU tensors
as ``decode_loop_reference``, a Python loop over t. Each step:

  x_t   = emb_t + PPE[t mod period]
  attn  = softmax_{j<=t}(q_t . k_j / sqrt(hd) - slope_h * ((t-j) // period)) v_j
  h     = LN1(x_t + W_o attn)
  h     = LN2(h + cross_t)            # diagonal cross-attention, precomputed
  h     = LN3(h + W_2 relu(W_1 h))
  emb_{t+1} = h @ (W_r W_m) + b + style

Weights use the JAX kernel's dict keys, kernels in (in, out) order:
``{q,k,v,o,f1,f2,fb}_{kernel,bias}`` and ``ln{1,2,3}_{scale,bias}``.
Inference only; the BIWI variant (``mem_k``/``mem_v``) is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

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


def _layer_norm(x: torch.Tensor, scale, bias) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias


def decode_loop_reference(
    cross: torch.Tensor, style: torch.Tensor, pe: torch.Tensor, weights: dict,
    *, period: int = 60,
) -> torch.Tensor:
    """Plain version: the KV-cached decode step of FaceFormer's inference
    loop, in f32, one Python iteration per frame. Returns (B, T, 64) in
    ``cross.dtype``."""
    b, t_steps, d = cross.shape
    w = {k: v.float() for k, v in weights.items()}
    qkv_k = torch.cat([w["q_kernel"], w["k_kernel"], w["v_kernel"]], dim=1)
    qkv_b = torch.cat([w["q_bias"], w["k_bias"], w["v_bias"]])
    slopes = torch.as_tensor(alibi_slopes(N_HEADS), device=cross.device)
    cross32, pe32 = cross.float(), pe.float()
    style32 = style.float()
    kv = torch.zeros((b, t_steps, 2 * d), device=cross.device)
    pos = torch.arange(t_steps, device=cross.device)
    emb = style32
    hs = []
    for t in range(t_steps):
        x = emb + pe32[t % period]
        qkv = x @ qkv_k + qkv_b
        q = qkv[:, :d].reshape(b, N_HEADS, HD)
        kv[:, t] = qkv[:, d:]
        kmat = kv[:, : t + 1, :d].reshape(b, t + 1, N_HEADS, HD)
        vmat = kv[:, : t + 1, d:].reshape(b, t + 1, N_HEADS, HD)
        s = torch.einsum("bhd,bthd->bht", q, kmat) * (1.0 / HD**0.5)
        dist = torch.div(t - pos[: t + 1], period, rounding_mode="floor").float()
        s = s - slopes[None, :, None] * dist[None, None, :]
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("bht,bthd->bhd", p, vmat).reshape(b, d)
        h = _layer_norm(x + attn @ w["o_kernel"] + w["o_bias"], w["ln1_scale"], w["ln1_bias"])
        h = _layer_norm(h + cross32[:, t], w["ln2_scale"], w["ln2_bias"])
        ff = torch.relu(h @ w["f1_kernel"] + w["f1_bias"]) @ w["f2_kernel"] + w["f2_bias"]
        h = _layer_norm(h + ff, w["ln3_scale"], w["ln3_bias"])
        hs.append(h)
        emb = h @ w["fb_kernel"] + w["fb_bias"] + style32
    return torch.stack(hs, dim=1).to(cross.dtype)


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
    ``cross.dtype``. CUDA tensors launch the kernel; CPU tensors run the
    plain loop."""
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
    return _decode_loop_cuda(cross, style, pe, weights, period)


faceformer_decode_loop.launches = 0
