"""FaceFormer decode loop: a hand-written CUDA kernel + its plain version.

Port of ``audio2face_tpu/ops/decode_kernel.py``, both variants.
``faceformer_decode_loop`` runs the whole autoregressive loop: for CUDA
tensors in one launch of ``csrc/decode_loop.cu`` (a thread-block cluster of
CL CTAs per batch item, the KV cache rows spread over the cluster's shared
memory, weights in shared memory in the caller's storage type: all of them
in every CTA at width 64, each CTA its rows' share of every matrix at width
128, with each matvec's outputs exchanged over the cluster), for CPU
tensors as ``decode_loop_reference``, a Python loop over t (``decode_steps``
in f32; ``decode_steps`` is also the differentiable loop that training runs,
with dropout masks and chunk checkpointing). Each step, at decoder width
d (4 heads of hd = d / 4, FFN 2d; the kernel runs d = 64 and d = 128, the
plain loop any):

  x_t   = emb_t + PPE[t mod period]
  attn  = softmax_{j<=t}(q_t . k_j / sqrt(hd) - slope_h * ((t-j) // period)) v_j
  h     = LN1(x_t + W_o attn)
  h     = LN2(h + ca_t)
  h     = LN3(h + W_2 relu(W_1 h))
  emb_{t+1} = h @ (W_r W_m) + b + style

vocaset passes ``cross``: the diagonal cross attention, precomputed, is
``ca_t = cross[:, t]``. BIWI passes ``mem_k``/``mem_v`` (B, 4, 2T, hd), the
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
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from audio2face_tpu_torch.ops import _build
from audio2face_tpu_torch.ops.attention import device_alibi_slopes
from audio2face_tpu_torch.utils import spans

D = 64  # the repo's FaceFormer width; the kernel also runs WIDTHS[1], the published BIWI decoder's
WIDTHS = (64, 128)
N_HEADS = 4

# the packed weight buffer of csrc/decode_loop.cu, in the storage type:
# each matrix stored (out, in), i.e. its (in, out) kernel transposed, then
# its bias; (name, offset in elements) as the C constants WQKV ... BCO
_PACK_ORDER = (
    "qkv_kernel", "qkv_bias", "o_kernel", "o_bias", "f1_kernel", "f1_bias",
    "f2_kernel", "f2_bias", "fb_kernel", "fb_bias",
)
# the BIWI variant's buffer continues with its cross-attention projections
_PACK_ORDER_BIWI = _PACK_ORDER + ("cq_kernel", "cq_bias", "co_kernel", "co_bias")
# the layer-norm parameters, a separate f32 buffer (C: LN1S ... LN3B)
_LN_ORDER = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "ln3_scale", "ln3_bias")
N_WARPS = 8  # 256 threads a CTA
MAX_CLUSTER = 16
# shared memory one block may use on sm_90 (H100/H200)
SM90_SMEM_PER_BLOCK = 232448


@dataclass(frozen=True)
class Layout:
    """The kernel's numbers at decoder width ``width`` (csrc/decode_loop.cu
    ``Layout<D>`` and ``home_of``): packed weights, the layer-norm
    parameters, a CTA's f32 scratch (q, attention output, style, two
    matvec outputs, each warp's own row, two mbarriers and the step's rows
    prefetched a step ahead: 2 parities x the pe row and the cross row, or
    BIWI's pe row and 4 latent rows), a warp's attention partial (max, sum,
    head_dim value sums), every CTA's partials of a step (2 parities x 8
    warps), and one cache row. ``split``: a CTA holds only its rows' share
    of each matrix (plus every bias) and exchanges each matvec's outputs
    (``exchange`` floats: the exchanges' mbarriers and 2 parities of every
    result); else every CTA holds every weight."""

    width: int
    n_weights: int
    n_weights_biwi: int
    n_matrix: int
    n_matrix_biwi: int
    n_bias: int
    n_bias_biwi: int
    n_ln: int
    part: int
    scratch: int
    scratch_biwi: int
    gather: int
    exchange: int
    row_bytes: int
    split: bool


@functools.lru_cache(maxsize=None)
def layout(width: int = D) -> Layout:
    if width not in WIDTHS:
        raise ValueError(f"the decode kernel runs widths {WIDTHS}, not {width}")
    d, ff, hd = width, 2 * width, width // N_HEADS
    n_matrix = 3 * d * d + d * d + ff * d + d * ff + d * d
    n_bias = 3 * d + d + ff + d + d
    head = 3 * d + 2 * ff + N_WARPS * d + 4  # S_Q ... S_XBAR and its two mbarriers
    return Layout(
        width=d, n_weights=n_matrix + n_bias, n_weights_biwi=n_matrix + n_bias + 2 * (d * d + d),
        n_matrix=n_matrix, n_matrix_biwi=n_matrix + 2 * d * d, n_bias=n_bias,
        n_bias_biwi=n_bias + 2 * d, n_ln=6 * d, part=2 + hd,
        scratch=head + 2 * 2 * d, scratch_biwi=head + 2 * 5 * d,
        gather=2 * N_WARPS * (2 + hd), exchange=32 + 2 * (3 * d + 4 * d + ff + d),
        row_bytes=2 * d * 4, split=width != 64,
    )


# the width-64 layout under the names the C constants had before the
# kernel took a width
_L64 = layout(D)
N_WEIGHTS, N_WEIGHTS_BIWI, N_LN = _L64.n_weights, _L64.n_weights_biwi, _L64.n_ln
PART, GATHER_FLOATS, ROW_BYTES = _L64.part, _L64.gather, _L64.row_bytes
SCRATCH_FLOATS, SCRATCH_FLOATS_BIWI = _L64.scratch, _L64.scratch_biwi


def fixed_smem_bytes(
    biwi: bool = False, bf16_weights: bool = False, cluster: int = 1, width: int = D,
) -> int:
    """Shared memory a CTA of a cluster of ``cluster`` needs besides its
    cache rows: the weights it holds (2 or 4 bytes each: all of them, or
    at width 128 its rows' share of each matrix and every bias), the f32
    layer-norm parameters, the scratch, the exchanges (width 128) and the
    gathered partials of the cluster."""
    lay = layout(width)
    if lay.split:
        n_w = (lay.n_matrix_biwi if biwi else lay.n_matrix) // cluster + (
            lay.n_bias_biwi if biwi else lay.n_bias)
    else:
        n_w = lay.n_weights_biwi if biwi else lay.n_weights
    scratch = (lay.scratch_biwi if biwi else lay.scratch) + (lay.exchange if lay.split else 0)
    return n_w * (2 if bf16_weights else 4) + 4 * lay.n_ln + 4 * (scratch + cluster * lay.gather)


def smem_bytes(biwi: bool = False, width: int = D) -> int:
    """Shared memory a CTA of the kernel variant needs at least (f32
    weights, the cluster size that needs least; cache rows that do not fit
    stay in device memory)."""
    return min(fixed_smem_bytes(biwi, False, cl, width) for cl in (1, 2, 4, 8, MAX_CLUSTER))


# the least a CTA needs at width 64 (f32 weights, a cluster of 1, no cache row in shared memory)
SMEM_BYTES = smem_bytes(False)
SMEM_BYTES_BIWI = smem_bytes(True)


def smem_fits(device: torch.device, biwi: bool = False, width: int = D) -> bool:
    """True iff the variant's least shared-memory need fits one block of ``device``."""
    limit = getattr(
        torch.cuda.get_device_properties(device), "shared_memory_per_block_optin",
        SM90_SMEM_PER_BLOCK,
    )
    return smem_bytes(biwi, width) <= limit


def cluster_plan(
    n_steps: int, cluster: int, biwi: bool = False, bf16_weights: bool = False,
    smem_limit: int = SM90_SMEM_PER_BLOCK, width: int = D,
) -> dict:
    """The shared-memory plan of one CTA for a cluster of ``cluster`` CTAs
    per item (csrc/decode_loop.cu ``rows_per_cta``): cache row j belongs to
    CTA j mod cluster, which holds its rows in shared memory up to as many
    as fit beside the fixed part (and no more than its share of T); later
    rows stay in device memory. Raises if the fixed part does not fit."""
    fixed = fixed_smem_bytes(biwi, bf16_weights, cluster, width)
    row_bytes = layout(width).row_bytes
    capacity = (smem_limit - fixed) // row_bytes
    if capacity < 0:
        raise RuntimeError(
            f"the decode kernel needs {fixed} bytes of shared memory per block, "
            f"more than the {smem_limit} a block may use"
        )
    rows = min(capacity, -(-n_steps // cluster))
    return {
        "cluster": cluster, "rows_per_cta": rows, "smem_bytes": fixed + rows * row_bytes,
        "rows_resident": min(n_steps, cluster * rows), "capacity_rows": cluster * capacity,
    }


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in x's dtype (one fused call:
    the loop below is bound by its launch count)."""
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, 1e-5).to(x.dtype)


def _flat_heads(mem: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) -> (B, S, H*hd): the decode loop's column order h*hd + i."""
    b, h, s, hd = mem.shape
    return mem.transpose(1, 2).reshape(b, s, h * hd)


def decode_steps(
    cross: Optional[torch.Tensor],  # (B, T, d) precomputed cross term (vocaset)
    style: torch.Tensor,  # (B, d)
    pe: torch.Tensor,  # (period, d)
    weights: dict,
    *,
    period: int = 60,
    masks: Optional[dict] = None,
    chunk: Optional[int] = None,
    mem_k: Optional[torch.Tensor] = None,  # (B, 4, 2T, d / 4) BIWI cross keys
    mem_v: Optional[torch.Tensor] = None,  # (B, 4, 2T, d / 4) BIWI cross values
) -> torch.Tensor:
    """The KV-cached decode step of FaceFormer, one Python iteration per
    frame, differentiable (no in-place cache writes), in the compute dtype
    of its inputs (products in that dtype; LayerNorm, scores and softmax
    in f32), with optional dropout ``masks``: keep-multipliers (T, B, width)
    under the keys ``m_pe``, ``m_sa``, ``m_ca``, ``m_ff1`` (2d wide) and
    ``m_ff2``. Returns (B, T, d), d the width of ``style``. BIWI passes ``cross=None`` and
    ``mem_k``/``mem_v``: the cross term of step t is the 2-way softmax over
    the latents {2t, 2t+1}, computed inside the step.

    ``chunk`` frames at a time run under ``torch.utils.checkpoint``: only
    each chunk's carry (next embedding and the K/V prefix) is kept, and the
    backward recomputes one chunk's steps at a time, so residual memory is
    O(T^2 / chunk) instead of O(T^2). ``chunk=None`` keeps every step's
    residuals."""
    biwi = mem_k is not None
    d = style.shape[-1]
    nh = N_HEADS
    hd = d // nh
    if biwi:
        # each frame's latent pair, keys beside values: (B, 2T, 2d) -> (B, T, 2, 2d)
        per_frame = torch.cat([_flat_heads(mem_k), _flat_heads(mem_v)], dim=-1)
        per_frame = per_frame.reshape(per_frame.shape[0], -1, 2, 2 * d)
    else:
        per_frame = cross
    bsz, n_frames = per_frame.shape[:2]
    w = weights
    qkv_k = torch.cat([w["q_kernel"], w["k_kernel"], w["v_kernel"]], dim=1)
    qkv_b = torch.cat([w["q_bias"], w["k_bias"], w["v_bias"]])
    slopes = device_alibi_slopes(nh, style.device)
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
            qkv = torch.addmm(qkv_b, x, qkv_k)  # (B, 3d); columns are head*hd + lane
            q = qkv[:, :d].reshape(bsz, nh, hd)
            k_cache = torch.cat([k_cache, qkv[:, None, d : 2 * d]], dim=1)  # (B, t+1, d)
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
    computes in f32 whatever its inputs' type). Returns (B, T, d) in the
    type of ``cross`` (BIWI: of ``mem_k``)."""
    w = {k: v.float() for k, v in weights.items()}
    if mem_k is not None:
        return decode_steps(
            None, style.float(), pe.float(), w, period=period,
            mem_k=mem_k.float(), mem_v=mem_v.float(),
        ).to(mem_k.dtype)
    return decode_steps(cross.float(), style.float(), pe.float(), w, period=period).to(cross.dtype)


def _stores_bf16(weights: dict, biwi: bool) -> bool:
    """bf16 storage is exact iff every matrix and bias the kernel packs is
    bf16 (as ``FaceFormer.decoder_weights(torch.bfloat16)`` gives them)."""
    names = [f"{k}_{part}" for k in ("q", "k", "v", "o", "f1", "f2", "fb")
             + (("cq", "co") if biwi else ()) for part in ("kernel", "bias")]
    return all(weights[n].dtype == torch.bfloat16 for n in names)


def _pack_weights(weights: dict, device, biwi: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(packed weights in the storage type, f32 layer-norm parameters) in
    the layout of csrc/decode_loop.cu. The storage type is bf16 where every
    matrix and bias is bf16 (exact), else f32."""
    dtype = torch.bfloat16 if _stores_bf16(weights, biwi) else torch.float32
    w = {k: v.to(device=device, dtype=dtype) for k, v in weights.items() if k not in _LN_ORDER}
    w["qkv_kernel"] = torch.cat([w["q_kernel"], w["k_kernel"], w["v_kernel"]], dim=1)
    w["qkv_bias"] = torch.cat([w["q_bias"], w["k_bias"], w["v_bias"]])
    order = _PACK_ORDER_BIWI if biwi else _PACK_ORDER
    packed = torch.cat([(w[n].T if n.endswith("kernel") else w[n]).reshape(-1) for n in order])
    ln = torch.cat([weights[n].to(device=device, dtype=torch.float32).reshape(-1) for n in _LN_ORDER])
    return packed.contiguous(), ln.contiguous()


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ARGTYPES_BIWI = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_PLAN_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p]
_LAYOUT_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_plans: dict[tuple, dict] = {}


def kernel_cluster_plan(
    batch: int, n_steps: int, device, biwi: bool = False, bf16_weights: bool = True,
    width: int = D,
) -> dict:
    """The launch plan the kernel takes on ``device``: the cluster size CL
    (the largest of 16, 8, ... that keeps min(batch, 8) items resident at
    once, by ``cudaOccupancyMaxActiveClusters``), the cache rows a CTA
    holds, shared bytes a CTA, resident clusters and the block's shared
    memory limit. Checked against ``cluster_plan``, the Python mirror of its
    arithmetic; made once per shape and device."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (batch, n_steps, biwi, bf16_weights, dev, width)
    if key not in _plans:
        lay = layout(width)
        got = (ctypes.c_int * 3)()
        _build.function("decode_loop", "a2f_decode_layout", _LAYOUT_ARGTYPES)(
            int(biwi), int(bf16_weights), width, MAX_CLUSTER, ctypes.addressof(got))
        want = [lay.n_weights_biwi if biwi else lay.n_weights,
                fixed_smem_bytes(biwi, bf16_weights, MAX_CLUSTER, width), lay.row_bytes]
        if list(got) != want:
            raise RuntimeError(f"decode kernel layout mismatch: C {list(got)} vs Python {want}")
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(dev):
            rc = _build.function("decode_loop", "a2f_decode_plan", _PLAN_ARGTYPES)(
                int(biwi), int(bf16_weights), width, batch, n_steps, ctypes.addressof(out))
        _build.check(rc, "faceformer_decode_loop: no cluster size fits")
        cl, rows, smem, active, limit = list(out)
        plan = cluster_plan(n_steps, cl, biwi, bf16_weights, limit, width)
        if (plan["rows_per_cta"], plan["smem_bytes"]) != (rows, smem):
            raise RuntimeError(f"decode kernel plan mismatch: C {list(out)} vs Python {plan}")
        _plans[key] = dict(plan, max_active_clusters=active, smem_limit=limit)
    return _plans[key]


def _decode_loop_cuda(cross, style, pe, weights, period, mem_k=None, mem_v=None):
    biwi = mem_k is not None
    data = mem_k if biwi else cross
    b, dev = data.shape[0], data.device
    width = style.shape[1]
    t_steps = mem_k.shape[2] // 2 if biwi else cross.shape[1]
    packed, ln = _pack_weights(weights, dev, biwi)
    bf16 = packed.dtype == torch.bfloat16
    plan = kernel_cluster_plan(b, t_steps, dev, biwi, bf16, width)
    spans.count("decode_rows_spilled", b * (t_steps - plan["rows_resident"]))
    style32 = style.to(device=dev, dtype=torch.float32).contiguous()
    pe32 = pe.to(device=dev, dtype=torch.float32).contiguous()
    slopes = device_alibi_slopes(N_HEADS, dev)
    # rows past the cluster's shared memory: their owner keeps them here
    kv = torch.empty((b, t_steps, 2 * width), dtype=torch.float32, device=dev)
    out = torch.empty((b, t_steps, width), dtype=torch.float32, device=dev)
    tail = (
        style32.data_ptr(), pe32.data_ptr(), packed.data_ptr(), ln.data_ptr(), slopes.data_ptr(),
        kv.data_ptr(), out.data_ptr(), b, t_steps, period, width, int(bf16), plan["cluster"],
        plan["rows_per_cta"], torch.cuda.current_stream(dev).cuda_stream,
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
    cross: Optional[torch.Tensor],  # (B, T, d) precomputed cross term (vocaset)
    style: torch.Tensor,  # (B, d)
    pe: torch.Tensor,  # (period, d)
    weights: dict,
    *,
    period: int = 60,
    mem_k: Optional[torch.Tensor] = None,  # (B, 4, 2T, d / 4) BIWI cross keys
    mem_v: Optional[torch.Tensor] = None,  # (B, 4, 2T, d / 4) BIWI cross values
) -> torch.Tensor:
    """Run the decode loop; returns hidden states (B, T, d) in the type of
    ``cross`` (BIWI: of ``mem_k``). vocaset passes ``cross``; BIWI passes
    ``cross=None`` with ``mem_k``/``mem_v`` and the ``cq``/``co`` weights.
    CUDA tensors launch the kernel variant (counted in ``launches`` and
    ``biwi_launches``; widths 64 and 128), which is inference only: with
    gradients enabled and an input that requires one it raises. CPU tensors
    run the plain loop. The width d is that of ``style``."""
    biwi = mem_k is not None
    d = style.shape[-1]
    if biwi:
        if cross is not None or mem_v is None:
            raise ValueError("the BIWI variant takes cross=None with mem_k and mem_v")
        b, nh, s, hd = mem_k.shape
        if (nh, hd) != (N_HEADS, d // N_HEADS) or s % 2 or mem_v.shape != mem_k.shape:
            raise ValueError(
                f"shapes mem_k {tuple(mem_k.shape)} mem_v {tuple(mem_v.shape)}: "
                f"want (B, {N_HEADS}, 2T, {d // N_HEADS})"
            )
        missing = [k for k in _PACK_ORDER_BIWI[-4:] if k not in weights]
        if missing:
            raise ValueError(f"the BIWI variant needs the weights {missing}")
        data, what = mem_k, f"mem_k {tuple(mem_k.shape)}"
    else:
        if cross is None or cross.ndim != 3 or cross.shape[2] != d:
            raise ValueError(f"the vocaset variant takes cross (B, T, {d})")
        b = cross.shape[0]
        data, what = cross, f"cross {tuple(cross.shape)}"
    if style.shape != (b, d) or pe.shape != (period, d):
        raise ValueError(
            f"shapes {what} style {tuple(style.shape)} pe {tuple(pe.shape)} (period {period})"
        )
    if data.device.type == "cpu":
        return decode_loop_reference(
            cross, style, pe, weights, period=period, mem_k=mem_k, mem_v=mem_v)
    if data.device.type != "cuda":
        raise ValueError(f"faceformer_decode_loop runs on cuda or cpu, not {data.device}")
    if d not in WIDTHS:
        raise ValueError(f"the decode kernel runs widths {WIDTHS}, not {d}")
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
