"""Multi-head attention: hand-written CUDA flash kernels + their plain versions.

Port of ``audio2face_tpu/ops/attention.py``. ``flash_attention`` launches the
CUDA kernel ``csrc/flash_attention.cu`` for CUDA tensors (the TPU's
``flash_attention_pallas``) and runs ``mha_reference`` for CPU tensors. Both
support, in any combination: causal masking, the FaceFormer period-bucketed
ALiBi bias ``-slope_h * ((i - j) // period)``, per-batch KV lengths, and
attention-probability dropout in torch semantics (drop softmax weights,
scale the survivors by ``1/(1-p)``; the logsumexp never sees the mask).

The dropout mask is no random stream: each position's keep bit is a hash of
``(seed, batch*head, row, col)`` (``dropout_keep_mask``, bit for bit the JAX
package's ``_dropout_keep_tile``), so the forward kernel, the backward
kernels and the plain versions all drop the same positions and no mask is
ever stored. ``hash_index=(batch offset, head offset, total heads)`` says
which slice of a larger call's batch and heads a call computes (a data- or
tensor-parallel rank's share): the hash then takes the whole call's
``batch*head``, so the rank drops what the whole call drops there.

When an input requires grad, ``flash_attention`` goes through a
``torch.autograd.Function`` whose backward is ``flash_attention_bwd``: for
CUDA tensors the two kernels of ``csrc/flash_attention_bwd.cu`` (the TPU's
``flash_attention_bwd_pallas``; the first also computes ``delta =
rowsum(dO * O)``, whose plain version is ``attention_delta_reference``),
whatever the shape, and for CPU tensors ``flash_attention_bwd_reference``.

bf16 launches multiply with Hopper's ``wgmma`` (register accumulators,
tiles filled by ``cp.async``). f32 launches take CUDA-core FMAs, so that f32
keeps f32 accuracy: the forward on one of two paths chosen by ``t_k``
(``f32_forward_path``): a short-key kernel for ``t_k <= 64`` (the wav2vec2
frame windows) and a register-tiled one above; the backward on two
register-tiled kernels. ``flash_attention.f32_launches`` and
``flash_attention_bwd.f32_launches`` count the f32 launches among
``launches``.

``rel_table`` (H, 2R + 1) and ``rel_gate`` (B, H, Tq), both f32, add
WavLM's gated relative-position bias ``gate[b, h, i] * table[h, clamp(j -
i, -R, R) + R]`` to each scaled score (no TPU counterpart: the JAX package
has no WavLM). bf16 CUDA launches compute it inside the wgmma forward
(``a2f_flash_attention_fwd_relpos``, head dim 64) from the table in shared
memory and two gate values a thread, so no (Tq, Tk) tensor exists;
``mha_reference`` builds the dense bias. The bias serves only: a call
under autograd, with dropout, a causal mask or ALiBi, an f32 launch, and
the backward refuse it.

``rel_pos`` (H, 2R + 1, D) and ``rel_pos_bias`` (H, 2R + 1) f32 make the
attention Transformer-XL's relative-position attention (Dai et al.,
arXiv:1901.02860 §3.3), as the wav2vec2-Conformer computes it: the score
of query i and key j in head h is ``sm_scale * (q_i . k_j + q_i .
rel_pos[h, i - j + R] + rel_pos_bias[h, i - j + R])``, with the caller's
``pos_bias_u`` folded into q and ``rel_pos_bias = (v - u) . r`` (no TPU
counterpart: the JAX package has no Conformer). bf16 CUDA launches compute
both terms inside ``csrc/flash_attention_xl.cu`` (head dim 64, R at least
``max(Tq, Tk) - 1``), so no (Tq, Tk) or (Tq, 2R + 1) tensor exists;
``mha_reference`` builds the dense term. Like the gated bias it serves
only, and refuses the same options.

``decode_step_attention`` (one KV-cached decode step of the live decoders)
is plain torch operations, as the JAX package's is XLA einsums.
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
# the longest key sequence the f32 forward's short-key kernel takes
# (SK_MAX_TK in csrc/flash_attention.cu)
F32_SHORT_MAX_TK = 64


def f32_forward_path(t_k: int) -> str:
    """The f32 forward kernel a call with ``t_k`` keys launches: ``"short"``
    (one pass over each query row's scores in registers) for ``t_k <= 64``,
    else ``"tiled"`` (register-tiled online softmax over 32-key tiles)."""
    return "short" if t_k <= F32_SHORT_MAX_TK else "tiled"


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


_device_slopes: dict[tuple[int, torch.device], torch.Tensor] = {}


def device_alibi_slopes(n_heads: int, device: torch.device) -> torch.Tensor:
    """``alibi_slopes(n_heads)`` as an f32 tensor on ``device``, made once per
    (heads, device) and then reused, so that a kernel launch copies nothing
    from the host (a pageable host-to-device copy waits for the device)."""
    key = (n_heads, torch.device(device))
    if key not in _device_slopes:
        _device_slopes[key] = torch.as_tensor(alibi_slopes(n_heads)).to(device)
    return _device_slopes[key]


def alibi_period_bias(
    n_heads: int, t_q: int, t_k: int, period: int, device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Dense (H, Tq, Tk) bias: -slope_h * ((i - j) // period)."""
    slopes = torch.as_tensor(alibi_slopes(n_heads), device=device)
    i = torch.arange(t_q, device=device)[:, None]
    j = torch.arange(t_k, device=device)[None, :]
    dist = torch.div(i - j, period, rounding_mode="floor")
    return -slopes[:, None, None] * dist[None].to(torch.float32)


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit constant,
    in two 16-bit halves so that no int64 product overflows."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dropout_threshold(rate: float) -> int:
    """The hash value below which a position is dropped, computed once in
    double: ``min(int(rate * 2^31), 2^31 - 1)``."""
    return min(int(rate * float(1 << 31)), (1 << 31) - 1)


def dropout_keep_mask(seed, bh, row, col, rate: float) -> torch.Tensor:
    """Dropout keep multiplier, 0 or ``1/(1-rate)`` as f32, of the positions
    ``(bh, row, col)`` (broadcast integer tensors; ``bh = batch*H + head``;
    ``row`` and ``col`` are global indices) under the int32 ``seed``.

    The plain version of the kernels' hash: a murmur3-style finalizer over
    wrapping 32-bit multiplies and logical right shifts. Torch has no uint32
    arithmetic and ``>>`` on int32 is arithmetic, so this computes in int64
    and masks to 32 bits after every multiply and add."""
    bh, row, col = (torch.as_tensor(x).to(torch.int64) for x in (bh, row, col))
    seed = torch.as_tensor(seed, device=row.device).to(torch.int64).reshape(()) & _M32
    h = (
        _mul32(row & _M32, 0x9E3779B9)
        ^ _mul32(col & _M32, 0x85EBCA6B)
        ^ ((seed + _mul32(bh & _M32, 0xC2B2AE35)) & _M32)
    )
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x8363F812)
    h = h ^ (h >> 16)
    keep = (h & 0x7FFFFFFF) >= dropout_threshold(rate)
    return keep.to(torch.float32) * float(np.float32(1.0 / (1.0 - rate)))


def hash_batch_heads(b: int, h: int, hash_index=None, device=None) -> torch.Tensor:
    """(B, H, 1, 1) int64: the hash's ``batch*head`` index of each (batch,
    head) of a call on ``b`` x ``h`` slices. ``hash_index=(b0, h0, heads)``
    places the call at batch offset b0 and head offset h0 of a call with
    ``heads`` heads in all; ``None`` is ``(0, 0, h)``."""
    b0, h0, heads = (0, 0, h) if hash_index is None else hash_index
    rows = torch.arange(b, device=device).reshape(b, 1, 1, 1) + b0
    return rows * heads + h0 + torch.arange(h, device=device).reshape(1, h, 1, 1)


def attention_keep_mask(b, h, t_q, t_k, seed, rate, device, hash_index=None) -> torch.Tensor:
    """(B, H, Tq, Tk) keep multipliers of one attention call (``hash_index``
    as in ``hash_batch_heads``)."""
    bh = hash_batch_heads(b, h, hash_index, device)
    row = torch.arange(t_q, device=device).reshape(1, 1, t_q, 1)
    col = torch.arange(t_k, device=device).reshape(1, 1, 1, t_k)
    return dropout_keep_mask(seed, bh, row, col, rate)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 sums for f32 and bf16 inputs; f64 inputs (gradient checks) stay f64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def relative_position_bias(rel_table: torch.Tensor, rel_gate: torch.Tensor, t_k: int
                           ) -> torch.Tensor:
    """Dense (B, H, Tq, Tk) gated relative-position bias: ``gate[b, h, i] *
    table[h, clamp(j - i, -R, R) + R]``, for the plain versions."""
    r = (rel_table.shape[1] - 1) // 2
    t_q = rel_gate.shape[2]
    dev = rel_table.device
    off = torch.arange(t_k, device=dev)[None, :] - torch.arange(t_q, device=dev)[:, None]
    toeplitz = rel_table[:, off.clamp(-r, r) + r]  # (H, Tq, Tk)
    return rel_gate[..., None] * toeplitz[None]


def _check_rel_bias(q, rel_table, rel_gate, causal, alibi_period, dropout_rate):
    """Refuse what the gated relative-position bias is not for, and shapes
    that do not fit q."""
    if (rel_table is None) != (rel_gate is None):
        raise ValueError("rel_table and rel_gate go together")
    if rel_table is None:
        return
    b, h, t_q, _ = q.shape
    if causal or alibi_period is not None or dropout_rate > 0.0:
        raise ValueError("the gated relative-position bias takes no causal mask, ALiBi or dropout")
    if rel_table.dim() != 2 or rel_table.shape[0] != h or rel_table.shape[1] % 2 != 1:
        raise ValueError(f"rel_table {tuple(rel_table.shape)}: want ({h}, 2R + 1)")
    if tuple(rel_gate.shape) != (b, h, t_q):
        raise ValueError(f"rel_gate {tuple(rel_gate.shape)}: want {(b, h, t_q)}")
    if rel_table.dtype != torch.float32 or rel_gate.dtype != torch.float32:
        raise TypeError("rel_table and rel_gate are f32")


def relative_position_scores(q: torch.Tensor, rel_pos: torch.Tensor, rel_pos_bias: torch.Tensor,
                             t_k: int) -> torch.Tensor:
    """Dense (B, H, Tq, Tk) Transformer-XL term ``q_i . rel_pos[h, i - j +
    R] + rel_pos_bias[h, i - j + R]``, unscaled, in the accumulation type,
    for the plain versions: the (B, H, Tq, 2R + 1) product, then the pick
    of offset i - j for each score (HF's shift)."""
    acc = _acc_dtype(q)
    r = (rel_pos.shape[1] - 1) // 2
    t_q = q.shape[2]
    full = torch.einsum("bhqd,hmd->bhqm", q.to(acc), rel_pos.to(acc))
    full = full + rel_pos_bias.to(acc)[None, :, None]
    dev = q.device
    off = torch.arange(t_q, device=dev)[:, None] - torch.arange(t_k, device=dev)[None, :] + r
    idx = off[None, None].expand(q.shape[0], q.shape[1], t_q, t_k)
    return torch.gather(full, 3, idx)


def _check_rel_pos(q, k, rel_pos, rel_pos_bias, rel_table, causal, alibi_period, dropout_rate):
    """Refuse what Transformer-XL attention is not for, and shapes that do
    not fit q and k."""
    if (rel_pos is None) != (rel_pos_bias is None):
        raise ValueError("rel_pos and rel_pos_bias go together")
    if rel_pos is None:
        return
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if causal or alibi_period is not None or dropout_rate > 0.0 or rel_table is not None:
        raise ValueError("relative-position attention takes no causal mask, ALiBi, dropout or "
                         "gated bias")
    shape = tuple(rel_pos.shape)
    if len(shape) != 3 or (shape[0], shape[2]) != (h, d) or shape[1] % 2 != 1:
        raise ValueError(f"rel_pos {tuple(rel_pos.shape)}: want ({h}, 2R + 1, {d})")
    if (rel_pos.shape[1] - 1) // 2 < max(t_q, t_k) - 1:
        raise ValueError(f"rel_pos holds offsets to {(rel_pos.shape[1] - 1) // 2}; "
                         f"{t_q} queries and {t_k} keys need {max(t_q, t_k) - 1}")
    if tuple(rel_pos_bias.shape) != tuple(rel_pos.shape[:2]):
        raise ValueError(
            f"rel_pos_bias {tuple(rel_pos_bias.shape)}: want {tuple(rel_pos.shape[:2])}")
    if rel_pos.dtype != q.dtype or rel_pos_bias.dtype != torch.float32:
        raise TypeError("rel_pos is in q's dtype, rel_pos_bias f32")


def _masked_scores(q, k, causal, alibi_period, kv_lengths, sm_scale, rel_table=None,
                   rel_gate=None, rel_pos=None, rel_pos_bias=None):
    """Scaled, biased scores (B, H, Tq, Tk) in the accumulation type, masked
    positions at ``DEFAULT_MASK_VALUE``, and the boolean validity mask."""
    b, h, t_q, _ = q.shape
    t_k = k.shape[2]
    acc = _acc_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc))
    if rel_pos is not None:
        s = s + relative_position_scores(q, rel_pos, rel_pos_bias, t_k)
    s = s * sm_scale
    i = torch.arange(t_q, device=q.device)[:, None]
    j = torch.arange(t_k, device=q.device)[None, :]
    if alibi_period is not None:
        s = s + alibi_period_bias(h, t_q, t_k, alibi_period, q.device)[None].to(acc)
    if rel_table is not None:
        s = s + relative_position_bias(rel_table, rel_gate, t_k).to(acc)
    mask = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (j <= i)
    mask = mask[None, None].expand(b, h, t_q, t_k)
    if kv_lengths is not None:
        mask = mask & (j[None, None] < kv_lengths.to(q.device)[:, None, None, None])
    return torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE)), mask


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
    dropout_rate: float = 0.0,
    dropout_seed=None,
    hash_index=None,
    rel_table: Optional[torch.Tensor] = None,
    rel_gate: Optional[torch.Tensor] = None,
    rel_pos: Optional[torch.Tensor] = None,
    rel_pos_bias: Optional[torch.Tensor] = None,
):
    """Plain multi-head attention. q, k, v: (B, H, T, D) -> (B, H, Tq, D).

    Scores and softmax in f32; the probabilities are cast to v's dtype for
    the value product, as the kernel does. ``return_lse`` also returns the
    per-row logsumexp (B, H, Tq) f32. With ``dropout_rate`` > 0 and an int32
    ``dropout_seed`` (int or one-element tensor) the normalized
    probabilities are multiplied by the hash mask of ``dropout_keep_mask``
    (``hash_index`` as in ``hash_batch_heads``). ``rel_table`` and
    ``rel_gate``: the gated relative-position bias (module note), dense;
    ``rel_pos`` and ``rel_pos_bias``: Transformer-XL's term (module note),
    dense."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    rate = dropout_rate if dropout_seed is not None else 0.0
    _check_rel_bias(q, rel_table, rel_gate, causal, alibi_period, rate)
    _check_rel_pos(q, k, rel_pos, rel_pos_bias, rel_table, causal, alibi_period, rate)
    acc = _acc_dtype(q)
    s, _ = _masked_scores(q, k, causal, alibi_period, kv_lengths, sm_scale, rel_table, rel_gate,
                          rel_pos, rel_pos_bias)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0 and dropout_seed is not None:
        p = p * attention_keep_mask(
            b, h, t_q, t_k, dropout_seed, dropout_rate, q.device, hash_index).to(acc)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc)).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def attention_delta_reference(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(g * out)`` (B, H, Tq) in the accumulation type: the
    per-row term of the backward (``ds = p (dp - delta) scale``); plain
    version of what the dq kernel computes for its rows."""
    acc = _acc_dtype(out)
    return (g.to(acc) * out.to(acc)).sum(dim=-1)


def flash_attention_bwd_reference(
    q, k, v, out, lse, g, *, causal=False, alibi_period=None, kv_lengths=None,
    sm_scale=None, dropout_rate: float = 0.0, dropout_seed=None, hash_index=None,
):
    """Plain version of the backward kernels: (dq, dk, dv) in q's dtype from
    the saved ``out`` and ``lse`` and the output gradient ``g``, in the
    closed form the kernels compute (m = dropout keep multiplier):

      p = exp(s - lse), zeroed where masked;   delta = rowsum(g * out)
      dv = (m p)^T g;   ds = p (m (g v^T) - delta) scale;   dq = ds k;   dk = ds^T q

    ``m p`` and ``ds`` are rounded to the input dtype before their products."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    acc = _acc_dtype(q)
    s, mask = _masked_scores(q, k, causal, alibi_period, kv_lengths, sm_scale)
    p = torch.where(mask, torch.exp(s - lse.to(acc)[..., None]), torch.zeros_like(s))
    g32, q32, k32, v32 = (x.to(acc) for x in (g, q, k, v))
    dp = torch.einsum("bhqd,bhkd->bhqk", g32, v32)
    pm = p
    if dropout_rate > 0.0 and dropout_seed is not None:
        m = attention_keep_mask(
            b, h, t_q, t_k, dropout_seed, dropout_rate, q.device, hash_index).to(acc)
        pm, dp = p * m, dp * m
    delta = attention_delta_reference(out, g)[..., None]
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).to(acc)
    dv = torch.einsum("bhqk,bhqd->bhkd", pm.to(q.dtype).to(acc), g32)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# trailing arguments shared by the forward and backward entry points:
# batch, heads, t_q, t_k, head_dim, is_bf16, causal, period, sm_scale, seed,
# drop_thr, keep_scale, hash_b0, hash_h0, hash_heads, stream
_TAIL_ARGTYPES = [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_uint, ctypes.c_float,
] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# q, k, v, o, lse, kv_len, slopes
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + _TAIL_ARGTYPES
# q, k, v, out, dout, lse, delta, dq, dk, dv, kv_len, slopes
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + _TAIL_ARGTYPES
# q, k, v, o, lse, kv_len, rel_table, rel_gate; batch, heads, t_q, t_k,
# head_dim, radius; sm_scale; stream
_RELPOS_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_void_p])
# q, k, v, o, lse, kv_len, rel; batch, heads, t_q, t_k, head_dim, radius;
# sm_scale; stream
_XL_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
# head_dim, int info[4]
_OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_void_p]
# head_dim, batch_heads, t_q, t_k, int info[5]
_F32_PLAN_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check_kernel_inputs(what, q, k, v):
    b, h, _, d = q.shape
    t_k = k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes f32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dims {_HEAD_DIMS}, got {d}")


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned base, as the kernels' 16-byte
    asynchronous copies need (a contiguous view may start anywhere)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _kernel_side_inputs(q, t_k, kv_lengths, dropout_rate, dropout_seed, hash_index=None):
    """What both kernels' launches take beside q, k, v: clamped int32 KV
    lengths, ALiBi slopes (cached on the device), the (1,) int32 seed, the
    dropout threshold and keep scale (0 and 1 when dropout is off), and the
    hash's (batch offset, head offset, total heads)."""
    b, h = q.shape[:2]
    if kv_lengths is None:
        kvlen = torch.full((b,), t_k, dtype=torch.int32, device=q.device)
    else:
        kvlen = kv_lengths.to(device=q.device, dtype=torch.int32).clamp(0, t_k).contiguous()
    slopes = device_alibi_slopes(h, q.device)
    if dropout_rate > 0.0 and dropout_seed is not None:
        seed = torch.as_tensor(dropout_seed, device=q.device).to(torch.int32).reshape(1)
        thr, keep_scale = dropout_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate)
    else:
        seed = torch.zeros(1, dtype=torch.int32, device=q.device)
        thr, keep_scale = 0, 1.0
    hix = (0, 0, h) if hash_index is None else tuple(int(x) for x in hash_index)
    return kvlen, slopes, seed, thr, keep_scale, hix


def _flash_attention_cuda(
    q, k, v, causal, alibi_period, kv_lengths, sm_scale, dropout_rate=0.0, dropout_seed=None,
    hash_index=None,
):
    _check_kernel_inputs("flash_attention", q, k, v)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    qf, kf, vf = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    kvlen, slopes, seed, thr, keep_scale, hix = _kernel_side_inputs(
        q, t_k, kv_lengths, dropout_rate, dropout_seed, hash_index)
    out = torch.empty((b, h, t_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", "a2f_flash_attention_fwd", _FWD_ARGTYPES)
    rc = fn(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), lse.data_ptr(),
        kvlen.data_ptr(), slopes.data_ptr(), b, h, t_q, t_k, d,
        int(q.dtype == torch.bfloat16), int(causal), int(alibi_period or 0),
        float(sm_scale), seed.data_ptr(), thr, keep_scale, *hix,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.f32_launches += int(q.dtype == torch.float32)
    return out, lse


def _flash_attention_relpos_cuda(q, k, v, kv_lengths, sm_scale, rel_table, rel_gate):
    """(out, lse) of the bf16 forward with the gated relative-position bias
    computed in the kernel."""
    _check_kernel_inputs("flash_attention", q, k, v)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if q.dtype != torch.bfloat16 or d != 64:
        raise ValueError(
            "the gated relative-position bias runs in the bf16 kernel at head dim 64, "
            f"not {q.dtype} at {d}")
    qf, kf, vf = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    kvlen = _kernel_side_inputs(q, t_k, kv_lengths, 0.0, None)[0]
    table, gate = rel_table.contiguous(), rel_gate.contiguous()
    out = torch.empty((b, h, t_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention", "a2f_flash_attention_fwd_relpos", _RELPOS_ARGTYPES)
    rc = fn(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), lse.data_ptr(),
        kvlen.data_ptr(), table.data_ptr(), gate.data_ptr(), b, h, t_q, t_k, d,
        (table.shape[1] - 1) // 2, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.relpos_launches += 1
    return out, lse


def xl_position_rows(rel_pos: torch.Tensor, rel_pos_bias: torch.Tensor) -> torch.Tensor:
    """The (H, 2R + 1, 80) bf16 rows the Transformer-XL kernel reads:
    ``rel_pos`` (64), then ``rel_pos_bias`` as ``c_hi + c_lo`` (two bf16
    columns, which the kernel's ones operand adds to each score's f32 sum),
    then 14 zeros."""
    h, n, d = rel_pos.shape
    rows = torch.zeros((h, n, d + 16), dtype=torch.bfloat16, device=rel_pos.device)
    rows[..., :d] = rel_pos
    hi = rel_pos_bias.to(torch.bfloat16)
    rows[..., d] = hi
    rows[..., d + 1] = (rel_pos_bias - hi.float()).to(torch.bfloat16)
    return rows


def _flash_attention_xl_cuda(q, k, v, kv_lengths, sm_scale, rel_pos, rel_pos_bias):
    """(out, lse) of the bf16 forward with Transformer-XL's relative-position
    term computed in the kernel."""
    _check_kernel_inputs("flash_attention", q, k, v)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if q.dtype != torch.bfloat16 or d != 64 or not sm_scale > 0:
        raise ValueError(
            "relative-position attention runs in the bf16 kernel at head dim 64 with a positive "
            f"scale, not {q.dtype} at {d}, scale {sm_scale}")
    qf, kf, vf = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    kvlen = _kernel_side_inputs(q, t_k, kv_lengths, 0.0, None)[0]
    rows = xl_position_rows(rel_pos, rel_pos_bias)
    out = torch.empty((b, h, t_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_xl", "a2f_flash_attention_fwd_xl", _XL_ARGTYPES)
    rc = fn(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), lse.data_ptr(),
        kvlen.data_ptr(), rows.data_ptr(), b, h, t_q, t_k, d, (rel_pos.shape[1] - 1) // 2,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_attention_xl")
    flash_attention.launches += 1
    flash_attention.xl_launches += 1
    return out, lse


def xl_occupancy() -> dict[str, int]:
    """Shared memory per block (bytes) and resident blocks per SM of the
    Transformer-XL kernel, as the CUDA runtime reports them."""
    info = (ctypes.c_int * 2)()
    fn = _build.function("flash_attention_xl", "a2f_flash_attention_fwd_xl_occupancy",
                         [ctypes.c_void_p])
    _build.check(fn(info), "a2f_flash_attention_fwd_xl_occupancy")
    return {"smem_bytes": info[0], "blocks_per_sm": info[1]}


def _flash_attention_bwd_cuda(
    q, k, v, out, lse, g, causal, alibi_period, kv_lengths, sm_scale, dropout_rate, dropout_seed,
    hash_index=None,
):
    """(dq, dk, dv, delta) from the two backward kernels."""
    _check_kernel_inputs("flash_attention_bwd", q, k, v)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if out.shape != q.shape or g.shape != q.shape or lse.shape != (b, h, t_q):
        raise ValueError(
            f"shapes out {tuple(out.shape)} g {tuple(g.shape)} lse {tuple(lse.shape)} "
            f"for q {tuple(q.shape)}"
        )
    # autograd hands over strided views (after a transpose); the kernels
    # take contiguous (B*H, T, D) slabs
    qf, kf, vf = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    of, gf = _kernel_layout(out.to(q.dtype)), _kernel_layout(g.to(q.dtype))
    lsef = lse.to(torch.float32).contiguous()
    delta = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)  # written by the dq kernel
    kvlen, slopes, seed, thr, keep_scale, hix = _kernel_side_inputs(
        q, t_k, kv_lengths, dropout_rate, dropout_seed, hash_index)
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    fn = _build.function("flash_attention_bwd", "a2f_flash_attention_bwd", _BWD_ARGTYPES)
    rc = fn(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), of.data_ptr(), gf.data_ptr(),
        lsef.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        kvlen.data_ptr(), slopes.data_ptr(), b, h, t_q, t_k, d,
        int(q.dtype == torch.bfloat16), int(causal), int(alibi_period or 0),
        float(sm_scale), seed.data_ptr(), thr, keep_scale, *hix,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.f32_launches += int(q.dtype == torch.float32)
    return dq, dk, dv, delta


def wgmma_occupancy(head_dim: int) -> dict[str, dict[str, int]]:
    """Shared memory per block (bytes) and resident blocks per SM of the bf16
    attention kernels at ``head_dim``, as the CUDA runtime reports them."""
    info = (ctypes.c_int * 4)()
    out = {}
    for lib, symbol, names in (
        ("flash_attention", "a2f_flash_attention_fwd_occupancy", ("flash_fwd_wgmma_kernel",)),
        ("flash_attention_bwd", "a2f_flash_attention_bwd_occupancy",
         ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel")),
    ):
        fn = _build.function(lib, symbol, _OCCUPANCY_ARGTYPES)
        _build.check(fn(head_dim, info), symbol)
        for i, name in enumerate(names):
            out[name] = {"smem_bytes": info[2 * i], "blocks_per_sm": info[2 * i + 1]}
    return out


def f32_kernel_plan(head_dim: int, batch_heads: int, t_q: int, t_k: int) -> dict:
    """The f32 kernels' launch plan at a shape, as the CUDA runtime reports
    it: the forward's path (``f32_forward_path``), shared memory a block,
    resident blocks per SM, blocks launched and query rows a block computes
    at once; the backward kernels' shared memory a block and resident
    blocks per SM. Launches nothing."""
    info = (ctypes.c_int * 5)()
    fn = _build.function("flash_attention", "a2f_flash_attention_fwd_f32_plan", _F32_PLAN_ARGTYPES)
    _build.check(fn(head_dim, batch_heads, t_q, t_k, info), "a2f_flash_attention_fwd_f32_plan")
    fwd = {"path": "short" if info[0] == 1 else "tiled", "smem_bytes": info[1],
           "blocks_per_sm": info[2], "grid": info[3], "query_rows": info[4]}
    fn = _build.function("flash_attention_bwd", "a2f_flash_attention_bwd_f32_occupancy",
                         _OCCUPANCY_ARGTYPES)
    _build.check(fn(head_dim, info), "a2f_flash_attention_bwd_f32_occupancy")
    return {"forward": fwd,
            "flash_bwd_dq_f32_kernel": {"smem_bytes": info[0], "blocks_per_sm": info[1]},
            "flash_bwd_dkdv_f32_kernel": {"smem_bytes": info[2], "blocks_per_sm": info[3]}}


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    *,
    causal: bool = False,
    alibi_period: Optional[int] = None,
    kv_lengths: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    hash_index=None,
    rel_table: Optional[torch.Tensor] = None,
    rel_gate: Optional[torch.Tensor] = None,
    rel_pos: Optional[torch.Tensor] = None,
    rel_pos_bias: Optional[torch.Tensor] = None,
):
    """Backward of ``flash_attention``: (dq, dk, dv) in q's dtype from the
    forward's ``out`` and ``lse`` and the output gradient ``g``.

    CUDA tensors launch the two backward kernels (dq with delta, then dk/dv)
    for every shape; CPU tensors run ``flash_attention_bwd_reference``. With
    dropout, ``dropout_seed`` and ``hash_index`` must be the forward's. The
    gated relative-position bias and Transformer-XL's term have no
    backward: ``rel_table``, ``rel_gate``, ``rel_pos`` or ``rel_pos_bias``
    raises."""
    if rel_table is not None or rel_gate is not None:
        raise ValueError("the gated relative-position bias serves only: it has no backward")
    if rel_pos is not None or rel_pos_bias is not None:
        raise ValueError("relative-position attention serves only: it has no backward")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, out, lse, g, causal=causal, alibi_period=alibi_period,
            kv_lengths=kv_lengths, sm_scale=sm_scale, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, hash_index=hash_index,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    return _flash_attention_bwd_cuda(
        q, k, v, out, lse, g, causal, alibi_period, kv_lengths, sm_scale,
        dropout_rate, dropout_seed, hash_index,
    )[:3]


flash_attention_bwd.launches = 0
flash_attention_bwd.f32_launches = 0


class _FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward saves q, k, v, out,
    lse, the KV lengths and the dropout seed; the backward is
    ``flash_attention_bwd`` (the kernels on CUDA, always)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, dropout_seed, causal, alibi_period, sm_scale,
                dropout_rate, hash_index):
        out, lse = _flash_attention_forward(
            q, k, v, causal, alibi_period, kv_lengths, sm_scale, dropout_rate, dropout_seed,
            hash_index)
        ctx.save_for_backward(q, k, v, out, lse, kv_lengths, dropout_seed)
        ctx.options = (causal, alibi_period, sm_scale, dropout_rate, hash_index)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse, kv_lengths, dropout_seed = ctx.saved_tensors
        causal, alibi_period, sm_scale, dropout_rate, hash_index = ctx.options
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, g, causal=causal, alibi_period=alibi_period,
            kv_lengths=kv_lengths, sm_scale=sm_scale, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, hash_index=hash_index,
        )
        return dq, dk, dv, None, None, None, None, None, None, None


def _flash_attention_forward(
    q, k, v, causal, alibi_period, kv_lengths, sm_scale, dropout_rate, dropout_seed, hash_index,
    rel_table=None, rel_gate=None, rel_pos=None, rel_pos_bias=None,
):
    """(out, lse): the kernel for CUDA tensors, the plain version for CPU."""
    if q.device.type == "cpu":
        return mha_reference(
            q, k, v, causal=causal, alibi_period=alibi_period, kv_lengths=kv_lengths,
            sm_scale=sm_scale, return_lse=True, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, hash_index=hash_index, rel_table=rel_table,
            rel_gate=rel_gate, rel_pos=rel_pos, rel_pos_bias=rel_pos_bias,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if rel_pos is not None:
        return _flash_attention_xl_cuda(q, k, v, kv_lengths, sm_scale, rel_pos, rel_pos_bias)
    if rel_table is not None:
        return _flash_attention_relpos_cuda(q, k, v, kv_lengths, sm_scale, rel_table, rel_gate)
    return _flash_attention_cuda(
        q, k, v, causal, alibi_period, kv_lengths, sm_scale, dropout_rate, dropout_seed,
        hash_index)


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
    dropout_rate: float = 0.0,
    dropout_seed=None,
    hash_index=None,
    rel_table: Optional[torch.Tensor] = None,
    rel_gate: Optional[torch.Tensor] = None,
    rel_pos: Optional[torch.Tensor] = None,
    rel_pos_bias: Optional[torch.Tensor] = None,
):
    """Fused MHA. q, k, v: (B, H, T, D) f32 or bf16 -> (B, H, Tq, D).

    CUDA tensors launch the flash kernel; CPU tensors run ``mha_reference``.
    ``return_lse`` also returns the per-row logsumexp (B, H, Tq) f32. Rows
    of a query whose keys are all masked are finite padding.

    ``dropout_rate`` > 0 with an int32 ``dropout_seed`` (an int or a
    one-element integer tensor, drawn once per call by the caller) drops
    attention probabilities by the hash mask; ``hash_index=(batch offset,
    head offset, total heads)`` places this call's batch and heads in a
    larger call's (``hash_batch_heads``). Differentiable in q, k and v: the
    backward is ``flash_attention_bwd``. ``rel_table`` (H, 2R + 1) and
    ``rel_gate`` (B, H, Tq), f32: WavLM's gated relative-position bias
    (module note), in inference only. ``rel_pos`` (H, 2R + 1, D) in q's
    dtype and ``rel_pos_bias`` (H, 2R + 1) f32: Transformer-XL's
    relative-position term (module note), in inference only."""
    if alibi_period is not None and alibi_period <= 0:
        raise ValueError(f"alibi_period must be positive, got {alibi_period}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if dropout_rate == 0.0 or dropout_seed is None:
        dropout_rate, dropout_seed, hash_index = 0.0, None, None
    _check_rel_bias(q, rel_table, rel_gate, causal, alibi_period, dropout_rate)
    _check_rel_pos(q, k, rel_pos, rel_pos_bias, rel_table, causal, alibi_period, dropout_rate)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if rel_table is not None:
            raise ValueError("the gated relative-position bias serves only: it has no backward")
        if rel_pos is not None:
            raise ValueError("relative-position attention serves only: it has no backward")
        if dropout_seed is not None:
            dropout_seed = torch.as_tensor(dropout_seed, device=q.device).to(torch.int32).reshape(1)
        out, lse = _FlashAttentionFunction.apply(
            q, k, v, kv_lengths, dropout_seed, causal, alibi_period, sm_scale, dropout_rate,
            hash_index)
    else:
        out, lse = _flash_attention_forward(
            q, k, v, causal, alibi_period, kv_lengths, sm_scale, dropout_rate, dropout_seed,
            hash_index, rel_table, rel_gate, rel_pos, rel_pos_bias)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.f32_launches = 0
flash_attention.relpos_launches = 0
flash_attention.xl_launches = 0


# ---------------------------------------------------------------------------
# KV-cached single-step decode attention
# ---------------------------------------------------------------------------


def decode_step_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    step,
    *,
    alibi_period: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """One autoregressive decode step against a padded KV cache.

    q: (B, H, D), the query at position ``step``; k_cache, v_cache:
    (B, H, Tmax, D), valid on [0, step]; step: an int or 0-d tensor (one
    position for the batch), or a (B,) tensor of per-item positions (pooled
    streams sit at different frames of their own caches).

    The attention the reference's per-frame recompute loop performs for its
    newest position: causal over the prefix, with the period-bucketed ALiBi
    bias ``-slope_h * floor((step - j) / period)`` (floored division, as
    everywhere in the port), and rows past the step at
    ``DEFAULT_MASK_VALUE``. Plain torch operations (the JAX package runs it
    as XLA einsums, not a kernel); scores and softmax in f32."""
    b, hh, t_max, d = k_cache.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    acc = _acc_dtype(q)
    s = torch.einsum("bhd,bhkd->bhk", q.to(acc), k_cache.to(acc)) * sm_scale
    j = torch.arange(t_max, device=q.device)[None, None, :]
    step = torch.as_tensor(step, device=q.device)
    if step.ndim == 1:  # per-item positions, broadcast over (B, H, Tmax)
        step = step[:, None, None]
    if alibi_period is not None:
        slopes = device_alibi_slopes(hh, q.device).to(acc)
        dist = torch.div(step - j, alibi_period, rounding_mode="floor").to(acc)
        s = s - slopes[None, :, None] * dist
    s = torch.where(j <= step, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p.to(v_cache.dtype).to(acc), v_cache.to(acc)).to(q.dtype)
