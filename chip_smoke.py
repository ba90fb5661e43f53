#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (audio2face_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each of
which raises (exit code != 0) on failure:

1. device: requires CUDA; prints the card's name and power limit; turns
   TF32 off for the f32 products of the plain versions;
2. build: compiles the port's CUDA sources (``build/torch_kernels/``);
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes its main path gives it (the flagship request,
   60 s x batch 8; the BIWI request, 30 s x batch 8; a transfer batch of 64
   frames of the 5,023-vertex head at 800 x 800), with a stated tolerance;
   times kernel, plain version and (attention) one
   ``scaled_dot_product_attention`` call with CUDA events;
4. serving path: the full-width FaceFormerPredictor (wav2vec2-base,
   15069-wide vertex head, bf16, random weights from a seed) answers three
   requests (8 x 60 s, 5 clips of 3-45 s, one 44.1 kHz clip); the forward
   kernels must have launched during them; one 2 x 10 s batch is held
   against the same weights run through the plain versions;
5. clip to rendered frames: the same predictor's vertices for a 3.5 s clip
   on the synthetic head go through ``Renderer.render`` (pipelined, cropped
   copies into pinned buffers); the rasterizer must have launched, the
   frames must equal full-frame renders, an enlarged frame must take the
   full-frame re-render;
6. BIWI serving: FaceFormerPredictor(dataset="biwi"), 70110-wide vertex
   head, period 25, answers 8 x 30 s and a mixed-length request at 25 fps
   through the decode kernel's BIWI variant (the vocaset variant must not
   launch); one 2 x 10 s batch against the plain versions; one BIWI training
   step (batch 8 x 10 s) launches no decode kernel;
7. training path: the full-width Audio2FaceExperiment (the vocaset model,
   bf16 compute, batch 8 x 10 s with mixed lengths) takes three optimizer
   steps; attention forward (with dropout) and backward kernels must have
   launched, the inference-only kernels must not; the loss falls; then the
   gradients of an f32 model through the kernels are held against the plain
   versions;
8. prints the ``{"kernels": [...]}`` line, then, last,
   ``{"ok": true, "device": {...}}``.

Gradients are off process-wide (the inference phases build no autograd
graph); the training phases turn them on in their own scope.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

# published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, seconds_of_ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_HBM_BYTES
    if t_bytes >= seconds_of_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * seconds_of_ops, "operations"


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def row_scaled_err(out, ref, floor: float = 0.0) -> float:
    """Largest |out - ref| over the largest |ref| of its row (last axis); a
    row's scale is at least ``floor`` times the largest |ref| of all."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(max(floor * ref.abs().max().item(), 1e-30))
    return (diff / scale).max().item()


# K1 in bf16 against its plain version: each output element may differ by
# this share of the largest |output| of its row. Both round the attention
# probabilities to bf16 (2^-9 relative, the kernel before normalizing, the
# plain version after) and round each output to bf16 (up to one step,
# 2^-8 of the row's largest value, apart).
K1_BF16_ROW_TOL = 0.02
# K4 in bf16 against its plain version, per gradient (dq, dk, dv): each
# element may differ by this share of the largest |value| of its row. Both
# sides round m.p and dS to bf16 before their products and each gradient to
# bf16 at the end; the kernel's exp is __expf. Readings at the training
# shape are 0.007-0.008 (one output step, 2^-8 of the row's largest value,
# plus the roundings before the products), so the bar is ~2.5x above them.
# A row whose gradient vanishes analytically (a causal first row's dq) is
# rounding noise: its scale is floored at 1e-3 of the tensor's largest.
K4_BF16_ROW_TOL, K4_ROW_FLOOR = 0.02, 1e-3
# K4 in f32: the bar of the JAX package's tests for its backward kernels
K4_F32_RTOL, K4_F32_ATOL = 2e-3, 2e-4
# gradients of the f32 model through the kernels against the plain versions,
# per parameter leaf: largest |difference| over the leaf's largest |value|
# (floored at 1e-4 of the largest of any leaf, for leaves that vanish
# analytically). f32 arithmetic in another summation order through 12
# layers and 120 decode steps
GRAD_LEAF_TOL = 1e-3
# K3 in bf16: f32 math on both sides that differs by summation order (the
# f32 bar, 2e-4), then one rounding to bf16 each: at most one bf16 step,
# 2^-7 of |ref|, apart
K3_F32_TOL, K3_BF16_STEP = 2e-4, 2.0**-7
# K5 against its plain version: both evaluate the planes in one order with
# no fused multiply-add, and a maximum does not depend on its order, so the
# int32 keys are equal on every pixel
K5_DIFFERING_PIXELS = 0
# K5's image against the exact banded oracle: the JAX package's bar for its
# rasterizers against each other (depth keys are quantized to 22 bits, and
# tied depths resolve to the brightest shade): share of pixels off by more
# than 3 grey levels
ORACLE_OFF_SHARE = 0.01
# f32 operations K5 spends on one pixel x triangle test: four plane
# increments, two subtractions for the third barycentric, and the 16
# operations of a strip's first row spread over its 16 rows
K5_OPS_PER_TEST = 7.0


def counter(row: dict) -> str:
    return row.get("counter", "launches")


def reset_counts(rows: list) -> None:
    """Set every kernel's launch count to 0."""
    for r in rows:
        setattr(r["wrapper"], counter(r), 0)


def read_count(row: dict) -> int:
    return getattr(row["wrapper"], counter(row))


def main() -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test needs a GPU",
              file=sys.stderr)
        return 1
    from audio2face_tpu_torch.data.synthetic import generate_synthetic_face_obj
    from audio2face_tpu_torch.models.faceformer import (
        frame_count, normalize_waveform, periodic_positional_encoding)
    from audio2face_tpu_torch.ops import _build
    from audio2face_tpu_torch.ops import attention as attn_ops
    from audio2face_tpu_torch.ops import conv_encoder as ce
    from audio2face_tpu_torch.ops import decode_kernel as dk
    from audio2face_tpu_torch.ops import rasterizer as rz
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.serving import FaceFormerPredictor
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment
    from audio2face_tpu_torch.utils import renderer as rd
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)  # process-wide; the training phases enable it in scope

    # ---- 2. build -------------------------------------------------------
    tic = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - tic:.1f} s", flush=True)

    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(device=dev, dtype=dtype)

    # the full-width predictor of phase 4; phase 3 feeds its kernels its weights
    n_verts = 15069
    tic = time.perf_counter()
    pred = FaceFormerPredictor(n_verts=n_verts, bf16=True, max_batch=8, bucket_seconds=5.0, seed=0)
    with torch.no_grad():  # trained-like motion maps (the init zeroes them)
        for lin in (pred.model.vertice_map, pred.model.vertice_map_r):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.02)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.02)
    print(f"predictor built: {time.perf_counter() - tic:.1f} s", flush=True)

    rows = []

    # ---- 3a. K1 flash attention: the encoder's self-attention -------------
    b, h, t, d = 8, 12, 3600, 64
    q, k, v = (randn(b, h, t, d, dtype=torch.bfloat16) for _ in range(3))
    kvl = torch.tensor([3600, 3600, 2700, 1800, 3600, 900, 3600, 180], dtype=torch.int32, device=dev)
    out = attn_ops.flash_attention(q, k, v, kv_lengths=kvl)
    ref = attn_ops.mha_reference(q, k, v, kv_lengths=kvl)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = row_scaled_err(out, ref)
    print(json.dumps({"check": "flash_attention kv_lengths", "max_abs_err": err,
                      "max_err_over_row_max": rel, "tol": K1_BF16_ROW_TOL}), flush=True)
    require(rel <= K1_BF16_ROW_TOL and bool(torch.isfinite(out.float()).all()),
            f"K1 err {rel} of the row's largest |out| > {K1_BF16_ROW_TOL}")
    ms = cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl), 10)
    plain_ms = cuda_ms(torch, lambda: attn_ops.mha_reference(q, k, v, kv_lengths=kvl), 3)
    sdpa_mask = (torch.arange(t, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    lib_ms = cuda_ms(
        torch,
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask), 10,
    )
    flops = 4.0 * h * d * t * kvl.sum().item()
    # q read and out written whole; k and v only up to each item's KV length
    nbytes = 2 * b * h * t * d * 2 + 2 * h * kvl.sum().item() * d * 2 + b * h * t * 4 + b * 4
    bms, bby = bound(nbytes, flops / PEAK_BF16_FLOPS)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/flash_attention.cu",
        "replaces": "audio2face_tpu/ops/attention.py:342",
        "wrapper": attn_ops.flash_attention, "max_abs_err": err,
        "max_err_over_row_max": rel, "tol_over_row_max": K1_BF16_ROW_TOL, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": lib_ms,
    })
    # causal + period-60 ALiBi (the decoder's mask) at the same shape
    out = attn_ops.flash_attention(q, k, v, causal=True, alibi_period=60)
    ref = attn_ops.mha_reference(q, k, v, causal=True, alibi_period=60)
    torch.cuda.synchronize()
    err_c = (out.float() - ref.float()).abs().max().item()
    rel_c = row_scaled_err(out, ref)
    print(json.dumps({"check": "flash_attention causal period=60", "max_abs_err": err_c,
                      "max_err_over_row_max": rel_c, "tol": K1_BF16_ROW_TOL}), flush=True)
    require(rel_c <= K1_BF16_ROW_TOL and bool(torch.isfinite(out.float()).all()),
            f"K1 causal/period err {rel_c} of the row's largest |out| > {K1_BF16_ROW_TOL}")
    del q, k, v, out, ref

    # ---- 3b. K2 conv feature encoder: 8 x 60 s with mixed lengths ---------
    b, n = 8, 960000
    x = randn(b, n, scale=1.0)
    lens = torch.tensor([960000, 960000, 720000, 480000, 960000, 240000, 960000, 48000],
                        dtype=torch.int32, device=dev)
    fe = pred.model.audio_encoder.feature_encoder
    kernels = [conv.weight.permute(2, 1, 0) for conv in fe.conv_layers]
    gscale, gbias = fe.group_norm.weight, fe.group_norm.bias
    out = ce.fused_conv_encoder(x, kernels, gscale, gbias, lens)
    ref = ce.conv_encoder_reference(x, kernels, gscale, gbias, lens)
    torch.cuda.synchronize()
    errs = []
    for i, length in enumerate(lens.tolist()):
        nv = ce.stack_output_length(length)
        errs.append((out[i, :nv].float() - ref[i, :nv].float()).abs().max().item())
    err = max(errs)
    # bf16 activations between the 7 layers: the repo's bound for the fused
    # encoder against its reference (tests/test_conv_encoder.py)
    tol = 0.05 * ref.float().abs().max().item()
    require(err <= tol and bool(torch.isfinite(out.float()).all()), f"K2 err {err} > {tol}")
    ms = cuda_ms(torch, lambda: ce.fused_conv_encoder(x, kernels, gscale, gbias, lens), 5)
    plain_ms = cuda_ms(torch, lambda: ce.conv_encoder_reference(x, kernels, gscale, gbias, lens), 2)
    t_l, gemm_flops = (n - 10) // 5 + 1, 0.0
    l0_flops = 2.0 * b * t_l * 10 * ce.C
    for kk, ss in zip(ce.CONV_KERNEL[1:], ce.CONV_STRIDE[1:]):
        t_l = (t_l - kk) // ss + 1
        gemm_flops += 2.0 * b * t_l * kk * ce.C * ce.C
    w_bytes = 10 * ce.C * 4 + sum(kk * ce.C * ce.C * 2 for kk in ce.CONV_KERNEL[1:]) + 2 * ce.C * 4
    nbytes = b * n * 4 + b * 4 + w_bytes + b * t_l * ce.C * 2
    # every layer multiplies bf16 operands with f32 sums, layer 0 included
    bms, bby = bound(nbytes, (l0_flops + gemm_flops) / PEAK_BF16_FLOPS)
    rows.append({
        "name": "fused_conv_encoder", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/conv_encoder.cu",
        "replaces": "audio2face_tpu/ops/conv_encoder.py:295",
        "wrapper": ce.fused_conv_encoder, "max_abs_err": err, "tol": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None,
    })
    del x, out, ref

    # ---- 3c. K3 decode loop: 8 x 3600 frames, as the bf16 predictor calls it
    b, t = 8, 3600
    bf = torch.bfloat16
    weights = pred.model.decoder_weights(bf)
    cross = randn(b, t, 64, scale=0.5, dtype=bf)
    style = randn(b, 64, scale=0.5, dtype=bf)
    pe = torch.as_tensor(periodic_positional_encoding(), device=dev)
    pe16 = pe.to(bf)
    out = dk.faceformer_decode_loop(cross, style, pe16, weights)
    ref = dk.decode_loop_reference(cross, style, pe16, weights)
    torch.cuda.synchronize()
    require(out.dtype == bf, f"K3 output dtype {out.dtype}")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    over = (diff - K3_BF16_STEP * ref.float().abs()).max().item()
    print(json.dumps({"check": "faceformer_decode_loop bf16", "max_abs_err": err,
                      "max_err_less_one_bf16_step": over, "tol": K3_F32_TOL}), flush=True)
    require(over <= K3_F32_TOL and bool(torch.isfinite(out.float()).all()),
            f"K3 err beyond one bf16 step {over} > {K3_F32_TOL}")
    ms = cuda_ms(torch, lambda: dk.faceformer_decode_loop(cross, style, pe16, weights), 3)
    plain_ms = cuda_ms(torch, lambda: dk.decode_loop_reference(cross, style, pe16, weights), 1)
    dense_flops = 2.0 * (64 * 192 + 64 * 64 + 64 * 128 + 128 * 64 + 64 * 64)
    flops = b * (t * dense_flops + 256.0 * t * (t + 1) / 2)
    nbytes = (2 * (2 * b * t * 64 + b * 64 + pe16.numel())
              + sum(w.numel() * w.element_size() for w in weights.values()))
    bms, bby = bound(nbytes, flops / PEAK_F32_FLOPS)
    rows.append({
        "name": "faceformer_decode_loop", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/decode_loop.cu",
        "replaces": "audio2face_tpu/ops/decode_kernel.py:259",
        "wrapper": dk.faceformer_decode_loop, "max_abs_err": err,
        "max_err_less_one_bf16_step": over, "tol": K3_F32_TOL,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None,
    })
    del cross, out, ref, diff
    torch.cuda.empty_cache()


    # ---- 3e. K1 with dropout, at the training shape ------------------------
    b, h, t, d = 8, 12, 600, 64
    bf = torch.bfloat16
    q, k, v, go = (randn(b, h, t, d, dtype=bf) for _ in range(4))
    kvl = torch.tensor([600, 600, 450, 300, 600, 150, 600, 30], dtype=torch.int32, device=dev)
    seed = torch.tensor([20240607], dtype=torch.int32, device=dev)
    drop = dict(dropout_rate=0.1, dropout_seed=seed)
    out, lse = attn_ops.flash_attention(q, k, v, kv_lengths=kvl, return_lse=True, **drop)
    ref = attn_ops.mha_reference(q, k, v, kv_lengths=kvl, **drop)
    torch.cuda.synchronize()
    err_d = (out.float() - ref.float()).abs().max().item()
    rel_d = row_scaled_err(out, ref)
    require(rel_d <= K1_BF16_ROW_TOL and bool(torch.isfinite(out.float()).all()),
            f"K1 dropout err {rel_d} of the row's largest |out| > {K1_BF16_ROW_TOL}")
    # rate 0 is the no-dropout launch bit for bit
    same = torch.equal(attn_ops.flash_attention(q, k, v, kv_lengths=kvl, dropout_rate=0.0, dropout_seed=seed),
                       attn_ops.flash_attention(q, k, v, kv_lengths=kvl))
    require(same, "K1 with dropout_rate 0 differs from the launch without dropout")
    # the kernel's mask itself: with q = 0 every probability is 1/600, and
    # v[j] = onehot(j mod 64) makes out[row, c] count the kept keys j = c
    # (mod 64), exactly; the plain hash must keep the very same positions
    probe_v = torch.eye(64, device=dev, dtype=bf).repeat(10, 1)[:t].expand(b, h, t, d).contiguous()
    counted = attn_ops.flash_attention(torch.zeros_like(q), k, probe_v, **drop).float()
    kept_kernel = torch.round(counted * t / float(torch.tensor(1.0 / 0.9).to(bf))).to(torch.int64)
    keep = attn_ops.attention_keep_mask(b, h, t, t, seed, 0.1, dev) > 0
    kept_plain = torch.nn.functional.pad(keep.to(torch.int32), (0, 640 - t)).reshape(
        b, h, t, 10, 64).sum(dim=3)
    dropped_share = 1.0 - keep.float().mean().item()
    require(torch.equal(kept_kernel, kept_plain), "K1's dropout mask differs from the plain hash")
    require(0.09 < dropped_share < 0.11, f"dropped share {dropped_share} at rate 0.1")
    print(json.dumps({"check": "flash_attention dropout 0.1 (8,12,600,64)", "max_abs_err": err_d,
                      "max_err_over_row_max": rel_d, "tol": K1_BF16_ROW_TOL,
                      "kept_counts_equal": True, "dropped_share": dropped_share,
                      "rate0_bit_identical": same}), flush=True)
    del counted, keep, kept_plain, kept_kernel, probe_v
    k1 = rows[0]
    k1["train_shape"] = [b, h, t, d]
    k1["dropout_max_abs_err"], k1["dropout_max_err_over_row_max"] = err_d, rel_d
    k1["dropout_ms"] = cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl, **drop), 20)
    k1["train_shape_ms"] = cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl), 20)
    k1["dropout_plain_ms"] = cuda_ms(torch, lambda: attn_ops.mha_reference(q, k, v, kv_lengths=kvl, **drop), 3)

    # ---- 3f. K4 flash attention backward, same shape, dropout + kv_lengths --
    def k4_errs(got, want):
        return {n: (row_scaled_err(a, w, K4_ROW_FLOOR), (a.float() - w.float()).abs().max().item())
                for n, a, w in zip(("dq", "dk", "dv"), got, want)}

    bwd_kw = dict(kv_lengths=kvl, **drop)
    got = attn_ops.flash_attention_bwd(q, k, v, out, lse, go, **bwd_kw)
    want = attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, go, **bwd_kw)
    torch.cuda.synchronize()
    errs = k4_errs(got, want)
    print(json.dumps({"check": "flash_attention_bwd dropout kv_lengths (8,12,600,64)",
                      "row_err_and_abs_err": errs, "tol": K4_BF16_ROW_TOL}), flush=True)
    require(all(e[0] <= K4_BF16_ROW_TOL for e in errs.values())
            and all(bool(torch.isfinite(x.float()).all()) for x in got),
            f"K4 err {errs} of the row's largest |gradient| > {K4_BF16_ROW_TOL}")
    # keys past an item's KV length get no gradient
    require(all(not x[i, :, n:].any() for x in got[1:] for i, n in enumerate(kvl.tolist())),
            "K4 gave a gradient to keys past the KV length")
    ms = cuda_ms(torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, **bwd_kw), 20)
    ms_nodrop = cuda_ms(torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, kv_lengths=kvl), 20)
    plain_ms = cuda_ms(torch, lambda: attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, go, **bwd_kw), 3)
    sdpa_mask = (torch.arange(t, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    with torch.enable_grad():
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)
        lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True), 20)
    del leaves, lib_out
    pairs = float(h * t * kvl.sum().item())  # unmasked (query, key) pairs
    # q, out, dO read and dq, dk, dv written whole (dk and dv past the KV
    # length are zeros that must be written); k and v read only up to each
    # item's KV length; lse and delta
    nbytes = 6 * b * h * t * d * 2 + 2 * h * kvl.sum().item() * d * 2 + 2 * b * h * t * 4 + b * 4
    bms, bby = bound(nbytes, 10.0 * d * pairs / PEAK_BF16_FLOPS)
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "audio2face_tpu/ops/attention.py:662",
        "wrapper": attn_ops.flash_attention_bwd,
        "max_abs_err": max(e[1] for e in errs.values()),
        "max_err_over_row_max": max(e[0] for e in errs.values()), "tol_over_row_max": K4_BF16_ROW_TOL,
        "ms": ms, "no_dropout_ms": ms_nodrop, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
        "library_ms": lib_ms, "train_shape": [b, h, t, d],
    })
    # causal + period-60 ALiBi with dropout at the same shape
    kw = dict(causal=True, alibi_period=60, **drop)
    out_c, lse_c = attn_ops.flash_attention(q, k, v, return_lse=True, **kw)
    errs = k4_errs(attn_ops.flash_attention_bwd(q, k, v, out_c, lse_c, go, **kw),
                   attn_ops.flash_attention_bwd_reference(q, k, v, out_c, lse_c, go, **kw))
    print(json.dumps({"check": "flash_attention_bwd causal period=60 dropout (8,12,600,64)",
                      "row_err_and_abs_err": errs, "tol": K4_BF16_ROW_TOL}), flush=True)
    require(all(e[0] <= K4_BF16_ROW_TOL for e in errs.values()), f"K4 causal/period err {errs}")
    del q, k, v, go, out, lse, ref, got, want, out_c, lse_c
    # both attention kernels at the serving length, for the record
    q, k, v, go = (randn(8, 12, 3600, 64, dtype=bf) for _ in range(4))
    out, lse = attn_ops.flash_attention(q, k, v, return_lse=True, **drop)
    k1["long_shape_dropout_ms"] = cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v, **drop), 5)
    rows[-1]["long_shape_ms"] = cuda_ms(
        torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, **drop), 3)
    del q, k, v, go, out, lse
    torch.cuda.empty_cache()
    # K4's variants off the main path at small shapes: f32 (CUDA-core path,
    # rtol 2e-3 / atol 2e-4), head dims 16/32/128, t_q != t_k, a zero-length item
    for dtype, (b, h, tq, tk, d), kw, rate in [
        (torch.float32, (2, 3, 130, 130, 64), dict(causal=True, alibi_period=60), 0.1),
        (torch.float32, (2, 4, 90, 150, 16), dict(alibi_period=60), 0.0),
        (torch.float32, (2, 2, 100, 70, 128), dict(kv_lengths=torch.tensor([70, 0])), 0.1),
        (torch.float32, (2, 2, 100, 70, 32), dict(kv_lengths=torch.tensor([33, 70]), causal=True), 0.5),
        (bf, (2, 4, 300, 200, 128), dict(kv_lengths=torch.tensor([200, 57])), 0.1),
        (bf, (3, 2, 77, 77, 32), dict(causal=True), 0.1),
        (bf, (2, 2, 77, 99, 16), dict(alibi_period=60, kv_lengths=torch.tensor([0, 99])), 0.0),
    ]:
        q, go = randn(b, h, tq, d, dtype=dtype), randn(b, h, tq, d, dtype=dtype)
        k, v = randn(b, h, tk, d, dtype=dtype), randn(b, h, tk, d, dtype=dtype)
        kw = dict(kw, dropout_rate=rate, dropout_seed=77)
        out, lse = attn_ops.flash_attention(q, k, v, return_lse=True, **kw)
        ref = attn_ops.mha_reference(q, k, v, **kw)
        got = attn_ops.flash_attention_bwd(q, k, v, out, lse, go, **kw)
        want = attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, go, **kw)
        # rows of a zero-length item are padding in the forward: not compared
        live = torch.ones(b, dtype=torch.bool) if "kv_lengths" not in kw else kw["kv_lengths"] > 0
        if dtype == torch.float32:
            fwd_err = (out[live] - ref[live]).abs().max().item()
            fwd_tol = 1e-5 + 1e-4 * ref[live].abs().max().item()
            err = max(((a - w).abs() - K4_F32_RTOL * w.abs()).max().item() for a, w in zip(got, want))
            tol = K4_F32_ATOL
        else:
            fwd_err, fwd_tol = row_scaled_err(out[live], ref[live]), K1_BF16_ROW_TOL
            err = max(row_scaled_err(a, w, K4_ROW_FLOOR) for a, w in zip(got, want))
            tol = K4_BF16_ROW_TOL
        finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
        zero_ok = all(not x[~live].any() for x in got[1:])  # zero-length item: dk = dv = 0
        print(json.dumps({"check": f"K1 dropout + K4 {str(dtype)[6:]} {(b, h, tq, tk, d)} rate {rate}",
                          "fwd_err": fwd_err, "fwd_tol": fwd_tol, "bwd_err": err, "bwd_tol": tol}), flush=True)
        require(fwd_err <= fwd_tol and err <= tol and finite and zero_ok,
                f"K1/K4 {dtype} {(b, h, tq, tk, d)} {kw}: fwd {fwd_err} > {fwd_tol} or bwd {err} > {tol} "
                f"or finite {finite} or zero-length {zero_ok}")
    del q, k, v, go, out, lse, ref, got, want
    torch.cuda.empty_cache()

    # ---- 3d. the variants off the main path, at small shapes ---------------
    # f32 attention (a bf16=False model) is held to tests/test_attention.py's
    # rtol 1e-4 / atol 1e-5; bf16 to K1_BF16_ROW_TOL
    for dtype, (b, h, tq, tk, d), kw in [
        (torch.float32, (2, 3, 130, 130, 64), dict(causal=True, alibi_period=60)),
        (torch.float32, (2, 4, 90, 150, 16), dict(alibi_period=60)),  # negative i - j
        (torch.bfloat16, (2, 4, 300, 200, 128), dict(kv_lengths=torch.tensor([200, 57]))),
        (torch.bfloat16, (3, 2, 77, 77, 32), dict(causal=True)),
    ]:
        q = randn(b, h, tq, d, dtype=dtype)
        k, v = randn(b, h, tk, d, dtype=dtype), randn(b, h, tk, d, dtype=dtype)
        out, lse = attn_ops.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = attn_ops.mha_reference(q, k, v, return_lse=True, **kw)
        lse_err = (lse - ref_lse).abs().max().item()
        if dtype == torch.float32:
            err = (out - ref).abs().max().item()
            tol = 1e-5 + 1e-4 * ref.abs().max().item()
        else:
            err, tol = row_scaled_err(out, ref), K1_BF16_ROW_TOL
        lse_tol = 1e-5 + 1e-4 * ref_lse.abs().max().item()
        print(json.dumps({"check": f"flash_attention {str(dtype)[6:]} {(b, h, tq, tk, d)}",
                          "err": err, "tol": tol, "lse_err": lse_err}), flush=True)
        require(err <= tol and lse_err <= lse_tol,
                f"K1 {dtype} {(b, h, tq, tk, d)} {kw}: err {err} > {tol} or lse {lse_err} > {lse_tol}")
    x = randn(2, 2503)  # not a multiple of 5, and a zero-length row
    lens = torch.tensor([2503, 0], dtype=torch.int32, device=dev)
    out = ce.fused_conv_encoder(x, kernels, gscale, gbias, lens)
    ref = ce.conv_encoder_reference(x, kernels, gscale, gbias, lens)
    nv = ce.stack_output_length(2503)
    err = (out[0, :nv].float() - ref[0, :nv].float()).abs().max().item()
    require(err <= 0.05 * ref.float().abs().max().item() and bool(torch.isfinite(out.float()).all()),
            f"K2 short clip err {err}")
    # K3 in f32 (a bf16=False model): the bar of tests/test_decode_kernel.py
    weights = pred.model.decoder_weights(torch.float32)
    for b, t in [(6, 37), (2, 150)]:
        cross, style = randn(b, t, 64, scale=0.5), randn(b, 64, scale=0.5)
        err = (dk.faceformer_decode_loop(cross, style, pe, weights)
               - dk.decode_loop_reference(cross, style, pe, weights)).abs().max().item()
        require(err <= K3_F32_TOL, f"K3 f32 ({b}, {t}) err {err} > {K3_F32_TOL}")
    # an f32 predictor (bf16=False): K1's f32 path and K3, against the plain
    # versions; the repo's conversion bar
    f32_kw = dict(n_verts=n_verts, bf16=False, max_batch=2, bucket_seconds=1.0,
                  state_dict=pred.model.state_dict())
    rng = np.random.default_rng(1)
    audios = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in (32000, 21000)]
    one_hot = np.eye(12, dtype=np.float32)[[0, 1]]
    template = rng.normal(size=(n_verts // 3, 3)).astype(np.float32)
    got = FaceFormerPredictor(**f32_kw)(audios, one_hot, template)
    want = FaceFormerPredictor(**f32_kw, use_kernels=False)(audios, one_hot, template)
    l2 = max(float(np.linalg.norm(a - b, axis=-1).max()) for a, b in zip(got, want))
    require(l2 < 1e-4, f"f32 predictor vs plain: max per-vertex L2 {l2}")
    print(json.dumps({"check": "variants: K1 f32/d16/d32/d128, K2 short, K3 small, f32 predictor",
                      "f32_predictor_max_vertex_l2": l2}), flush=True)
    torch.cuda.empty_cache()

    # ---- 3g. K3's BIWI variant: 8 x 750 frames (30 s at 25 fps) -------------
    # the full-width BIWI predictor of phase 6: 23,370 vertices, period 25
    n_verts_biwi = 70110
    tic = time.perf_counter()
    biwi = FaceFormerPredictor(n_verts=n_verts_biwi, bf16=True, max_batch=8, bucket_seconds=5.0,
                               seed=1, dataset="biwi")
    with torch.no_grad():  # trained-like motion maps and cross biases (the init zeroes them)
        for lin in (biwi.model.vertice_map, biwi.model.vertice_map_r):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.02)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.02)
        for lin in (biwi.model.cross_q, biwi.model.cross_k, biwi.model.cross_v):
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.3)
    print(f"BIWI predictor built: {time.perf_counter() - tic:.1f} s", flush=True)
    pe25 = torch.as_tensor(periodic_positional_encoding(25), device=dev)
    w32 = biwi.model.decoder_weights(torch.float32)
    for b, t in [(6, 37), (2, 150)]:  # f32, small: the bar of the vocaset variant
        mem_k, mem_v = randn(b, 4, 2 * t, 16, scale=0.5), randn(b, 4, 2 * t, 16, scale=0.5)
        style = randn(b, 64, scale=0.5)
        err = (dk.faceformer_decode_loop(None, style, pe25, w32, period=25, mem_k=mem_k, mem_v=mem_v)
               - dk.decode_loop_reference(None, style, pe25, w32, period=25, mem_k=mem_k, mem_v=mem_v)
               ).abs().max().item()
        require(err <= K3_F32_TOL, f"K3 BIWI f32 ({b}, {t}) err {err} > {K3_F32_TOL}")
    # the serving shape, mem_k / mem_v as the bf16 predictor computes them
    # from 8 x 30 s of audio with mixed lengths: the encoder's 50 fps latents,
    # trimmed or zero-padded to 2 latents per frame, projected per head
    b, n, t = 8, 480000, 750
    x = randn(b, n, scale=0.1)
    lens = torch.tensor([480000, 480000, 360000, 240000, 480000, 120000, 480000, 24000], device=dev)
    m = biwi.model
    hidden = m.audio_encoder(normalize_waveform(x, lens), output_len=t, lengths=lens,
                             dataset="biwi", dtype=bf)
    hidden = torch.nn.functional.pad(hidden, (0, 0, 0, max(2 * t - hidden.shape[1], 0)))[:, : 2 * t]
    memory = torch.nn.functional.linear(hidden.float(), m.audio_feature_map.weight, m.audio_feature_map.bias)
    mem_k, mem_v = (
        torch.nn.functional.linear(memory, lin.weight, lin.bias).reshape(b, 2 * t, 4, 16)
        .transpose(1, 2).to(bf) for lin in (m.cross_k, m.cross_v))
    del x, hidden, memory
    weights = m.decoder_weights(bf)
    style = randn(b, 64, scale=0.5, dtype=bf)
    pe25_16 = pe25.to(bf)
    kw = dict(period=25, mem_k=mem_k, mem_v=mem_v)
    out = dk.faceformer_decode_loop(None, style, pe25_16, weights, **kw)
    ref = dk.decode_loop_reference(None, style, pe25_16, weights, **kw)
    torch.cuda.synchronize()
    require(out.dtype == bf and tuple(out.shape) == (b, t, 64), f"K3 BIWI output {out.dtype} {tuple(out.shape)}")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    over = (diff - K3_BF16_STEP * ref.float().abs()).max().item()
    print(json.dumps({"check": "faceformer_decode_loop BIWI bf16 (8, 750)", "max_abs_err": err,
                      "max_err_less_one_bf16_step": over, "tol": K3_F32_TOL}), flush=True)
    require(over <= K3_F32_TOL and bool(torch.isfinite(out.float()).all()),
            f"K3 BIWI err beyond one bf16 step {over} > {K3_F32_TOL}")
    ms = cuda_ms(torch, lambda: dk.faceformer_decode_loop(None, style, pe25_16, weights, **kw), 5)
    plain_ms = cuda_ms(torch, lambda: dk.decode_loop_reference(None, style, pe25_16, weights, **kw), 1)
    # per step: the vocaset step's products, W_cq and W_co, and per head two
    # 16-wide scores and the 2-way value sum
    dense_flops = 2.0 * (64 * 192 + 64 * 64 + 64 * 128 + 128 * 64 + 64 * 64 + 2 * 64 * 64 + 4 * 64)
    flops = b * (t * dense_flops + 256.0 * t * (t + 1) / 2)
    nbytes = (2 * (2 * b * 2 * t * 64 + b * t * 64 + b * 64 + pe25_16.numel())
              + sum(w.numel() * w.element_size() for w in weights.values()))
    bms, bby = bound(nbytes, flops / PEAK_F32_FLOPS)
    rows.append({
        "name": "faceformer_decode_loop_biwi", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/decode_loop.cu",
        "replaces": "audio2face_tpu/ops/decode_kernel.py:259",
        "wrapper": dk.faceformer_decode_loop, "counter": "biwi_launches", "max_abs_err": err,
        "max_err_less_one_bf16_step": over, "tol": K3_F32_TOL, "shape": [b, t, 64],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None,
    })
    del mem_k, mem_v, out, ref, diff
    torch.cuda.empty_cache()

    # ---- 3h. K5 tile rasterizer: one transfer batch, 64 frames at 800 x 800 --
    height, width = rd.FRUSTUM["height"], rd.FRUSTUM["width"]
    mesh = FaceMesh.load(generate_synthetic_face_obj("build/chip_smoke_assets/head.obj"))
    renderer = rd.Renderer(mesh)
    head = np.asarray(mesh.verts, np.float32)  # 5,023 vertices, 9,940 triangles
    faces_p, valid_p, lights = renderer._faces_padded, renderer._face_valid, renderer.lights
    frames = head[None] * (1.0 + 0.01 * np.sin(np.arange(64) / 5.0))[:, None, None].astype(np.float32)
    frames[5] = np.nan  # an all-NaN frame: background
    frames[9] = head * 3.0  # triangles leave the screen
    vd = torch.as_tensor(frames, device=dev)
    coefs, bbox = rz.plane_coefficients(
        *rd.project_and_shade(vd, faces_p, lights), faces_p, valid_p, height=height, width=width)
    keys = rz.rasterize_keys(coefs, bbox, height=height, width=width)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()  # the plain version is a host loop over frames and chunks: timed in its one run
    ref = rz.rasterize_keys_reference(coefs, bbox, height=height, width=width)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    differing = int((keys != ref).sum())
    err = int((keys.long() - ref.long()).abs().max())
    covered = (keys != 0).float().mean(dim=(1, 2))
    print(json.dumps({"check": "rasterize_keys (64, 800, 800), 10240 triangles", "differing_pixels": differing,
                      "of": keys.numel(), "max_abs_key_err": err, "tol_differing_pixels": K5_DIFFERING_PIXELS,
                      "covered_share_frame0": covered[0].item()}), flush=True)
    require(differing <= K5_DIFFERING_PIXELS, f"K5: {differing} pixels differ from the plain version")
    require(covered[0].item() > 0.05 and covered[5].item() == 0.0 and covered[9].item() > covered[0].item(),
            f"K5 coverage: frame 0 {covered[0].item()}, NaN frame {covered[5].item()}, enlarged {covered[9].item()}")
    # against the exact banded oracle, one frame
    img = rd.keys_to_image(keys[0]).cpu().numpy().astype(np.int32)
    oracle = renderer._render_frame(frames[0])[:, :, 0].astype(np.int32)
    off_share = float((np.abs(img - oracle) > 3).mean())
    print(json.dumps({"check": "rasterize_keys image vs banded oracle", "share_off_by_more_than_3": off_share,
                      "tol": ORACLE_OFF_SHARE}), flush=True)
    require(off_share < ORACLE_OFF_SHARE, f"K5 vs banded oracle: {off_share} of the pixels off by > 3")
    # a tiny mesh with a zero-area triangle, and its NaN frame
    tiny = np.array([[-0.05, -0.05, 0.5], [0.05, -0.05, 0.5], [0.0, 0.05, 0.5],
                     [-0.08, 0.08, 0.4], [0.0, 0.08, 0.4], [0.08, 0.08, 0.4]], np.float32)
    tiny_faces = torch.zeros((rz.TRI_CHUNK, 3), dtype=torch.int32, device=dev)
    tiny_faces[0] = torch.tensor([0, 1, 2])
    tiny_faces[1] = torch.tensor([3, 4, 5])  # collinear: zero area
    tiny_valid = torch.arange(rz.TRI_CHUNK, device=dev) < 2
    tv = torch.as_tensor(np.stack([tiny, np.full_like(tiny, np.nan)]), device=dev)
    tc, tb = rz.plane_coefficients(*rd.project_and_shade(tv, tiny_faces, lights), tiny_faces, tiny_valid,
                                   height=height, width=width)
    tk = rz.rasterize_keys(tc, tb, height=height, width=width)
    require(torch.equal(tk, rz.rasterize_keys_reference(tc, tb, height=height, width=width)),
            "K5 differs from its plain version on the tiny mesh")
    solo = rd.render_frames_tiled(tv[:1], tiny_faces, torch.arange(rz.TRI_CHUNK, device=dev) < 1, lights)
    require(bool((tk[0] != 0).any()) and not bool(tk[1].any())
            and torch.equal(rd.keys_to_image(tk[0]), solo[0]),
            "K5: the zero-area triangle drew, or the NaN frame is not background")
    ms = cuda_ms(torch, lambda: rz.rasterize_keys(coefs, bbox, height=height, width=width), 10)
    # the in-package alternative on the same 16 ordinary frames, projection included
    v16 = vd[16:32].contiguous()
    tiled_16_ms = cuda_ms(torch, lambda: rd.render_frames_tiled(v16, faces_p, valid_p, lights), 5)
    scatter_16_ms = cuda_ms(torch, lambda: rd.render_frames_u8(
        v16, faces_p, valid_p, lights, patch_h=16, patch_w=24), 2)
    # the tests this run's boxes ask for: every pixel of a tile against every
    # triangle of every chunk whose box overlaps the tile
    n_strips, n_xblocks = height // rz.STRIP_H, -(-width // rz.XBLOCK)
    pairs = 0
    for frame_boxes in bbox.cpu().tolist():
        for xmin, xmax, ymin, ymax in frame_boxes:
            s0, s1 = rz.tile_range(ymin, ymax, rz.STRIP_H, n_strips)
            x0, x1 = rz.tile_range(xmin, xmax, rz.XBLOCK, n_xblocks)
            pairs += max(s1 - s0 + 1, 0) * max(x1 - x0 + 1, 0)
    tests = float(pairs) * rz.TRI_CHUNK * rz.STRIP_H * rz.XBLOCK
    nbytes = coefs.numel() * 4 + bbox.numel() * 4 + keys.numel() * 4
    bms, bby = bound(nbytes, K5_OPS_PER_TEST * tests / PEAK_F32_FLOPS)
    rows.append({
        "name": "rasterize_keys", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/rasterizer.cu",
        "replaces": "audio2face_tpu/ops/rasterizer.py:202",
        "wrapper": rz.rasterize_keys, "max_abs_err": err, "differing_pixels": differing,
        "tol_differing_pixels": K5_DIFFERING_PIXELS, "oracle_share_off_by_more_than_3": off_share,
        "shape": [64, height, width], "triangles": int(coefs.shape[1]), "tile_chunk_pairs": pairs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None,
        "tiled_16_frames_ms": tiled_16_ms, "scatter_16_frames_ms": scatter_16_ms,
    })
    del coefs, bbox, keys, ref, vd
    torch.cuda.empty_cache()

    # ---- 4. serving path: the full-width predictor --------------------------
    rng = np.random.default_rng(0)

    def clip(seconds, sr=16000):
        return (rng.normal(size=int(seconds * sr)) * 0.1).astype(np.float32)

    template = rng.normal(size=(n_verts // 3, 3)).astype(np.float32)
    pred([clip(1.0)], np.eye(12, dtype=np.float32)[[0]], template)  # library warm-up
    torch.cuda.synchronize()

    by_name = {r["name"]: r for r in rows}
    serving_rows = [by_name[n] for n in ("flash_attention", "fused_conv_encoder", "faceformer_decode_loop")]
    reset_counts(rows)
    # flagship: 8 clips x 60 s
    audios = [clip(60.0) for _ in range(8)]
    one_hot = np.eye(12, dtype=np.float32)[rng.integers(0, 12, 8)]
    tic = time.perf_counter()
    res = pred(audios, one_hot, template)
    wall = time.perf_counter() - tic
    for a, y in zip(audios, res):
        require(y.shape == (frame_count(len(a)), n_verts // 3, 3), f"flagship shape {y.shape}")
        require(bool(np.isfinite(y).all()), "flagship output not finite")
    frames = sum(y.shape[0] for y in res)
    print(json.dumps({"flagship": {
        "clips": 8, "seconds_each": 60, "wall_s": wall, "mesh_frames_per_s": frames / wall,
        "realtime_factor": 8 * 60.0 / wall, "card": smi,
    }}), flush=True)
    # mixed lengths, padded to the batch grid and the 5 s buckets
    secs = [3.0, 12.5, 27.3, 45.0, 8.8]
    audios = [clip(s) for s in secs]
    res = pred(audios, np.eye(12, dtype=np.float32)[[1, 3, 5, 7, 9]], template)
    for a, y in zip(audios, res):
        require(y.shape == (frame_count(len(a)), n_verts // 3, 3), f"mixed shape {y.shape}")
        require(bool(np.isfinite(y).all()), "mixed output not finite")
    # one 44.1 kHz clip through the resampler
    a44 = clip(7.0, 44100)
    res = pred([a44], np.eye(12, dtype=np.float32)[[2]], template, sample_rate=44100)
    n16 = math.ceil(len(a44) * 160 / 441)
    require(res[0].shape == (frame_count(n16), n_verts // 3, 3), f"44.1 kHz shape {res[0].shape}")
    require(bool(np.isfinite(res[0]).all()), "44.1 kHz output not finite")
    torch.cuda.synchronize()
    for r in serving_rows:
        r["launches"] = read_count(r)
        require(r["launches"] > 0, f"{r['name']} never launched on the serving path")
    require(attn_ops.flash_attention_bwd.launches == 0, "the backward kernels ran while serving")
    require(dk.faceformer_decode_loop.biwi_launches == 0 and rz.rasterize_keys.launches == 0,
            "the BIWI decode kernel or the rasterizer ran while serving vocaset")

    # the same weights through the plain versions on the card
    plain = FaceFormerPredictor(
        n_verts=n_verts, bf16=True, max_batch=8, bucket_seconds=5.0,
        state_dict=pred.model.state_dict(), use_kernels=False,
    )
    audios = [clip(10.0), clip(7.5)]
    one_hot = np.eye(12, dtype=np.float32)[[4, 8]]
    got = pred(audios, one_hot, template)
    want = plain(audios, one_hot, template)
    l2 = max(float(np.linalg.norm(a - b, axis=-1).max()) for a, b in zip(got, want))
    disp = max(float(np.abs(b - template).max()) for b in want)
    # bf16 encoder: the kernels round at other places than the plain
    # versions, and the decoder feeds its output back 600 times; the
    # vertex offsets from the template are ~disp, so allow 5% of them
    tol = 0.05 * disp
    print(json.dumps({"check": "predictor kernels vs plain, 2 clips", "max_vertex_l2": l2,
                      "max_offset": disp, "tol": tol}), flush=True)
    require(l2 <= tol, f"predictor vs plain: max per-vertex L2 {l2} > {tol}")


    del plain, got, want
    torch.cuda.empty_cache()

    # ---- 5. path 1: a clip's predicted vertices to rendered frames -----------
    one0 = np.eye(12, dtype=np.float32)[[0]]
    speech = clip(3.5)  # 210 frames: three whole transfer batches and a padded fourth
    pred([speech], one0, head)  # warm the bucket's library kernels and the pinned allocator
    renderer.render(pred([speech], one0, head)[0][:64])
    torch.cuda.synchronize()
    reset_counts(rows)
    tic = time.perf_counter()
    verts = pred([speech], one0, head)[0]
    t_pred = time.perf_counter() - tic
    images = renderer.render(verts)
    wall = time.perf_counter() - tic
    n_img = len(images)
    for r in serving_rows:
        require(read_count(r) > 0, f"{r['name']} never launched on the clip-to-frames path")
    k5 = by_name["rasterize_keys"]
    k5["launches"] = read_count(k5)
    # every frame fits its crop window: one launch per transfer batch, none for a re-render
    require(n_img == verts.shape[0] == 210 and k5["launches"] == -(-n_img // renderer.TRANSFER_BATCH),
            f"{n_img} frames of {verts.shape[0]}, K5 launched {k5['launches']} times")
    require(all(im.shape == (height, width, 3) and im.dtype == np.uint8 for im in images), "frame shape or type")
    face_share = min(float((im[:, :, 0] != rd.BG_COLOR).mean()) for im in images)
    require(face_share > 0.05, f"the face covers {face_share} of a frame")
    require(not np.array_equal(images[0], images[100]), "the animation does not move")
    picks = [0, 100, n_img - 1]
    for i, full in zip(picks, renderer._render_frames_tiled(verts[picks])):
        require(np.array_equal(images[i], full), f"frame {i} differs from its full-frame render")
    # a deliberately enlarged frame exceeds the crop window: only it is rendered again, full-frame
    big = verts[:70].copy()
    big[3] = big[3] * 1.6
    before = rz.rasterize_keys.launches
    big_images = renderer.render(big)
    require(rz.rasterize_keys.launches - before == 3, "the unfit frame did not take one full-frame re-render")
    for i, full in zip((2, 3, 4), renderer._render_frames_tiled(big[2:5])):
        require(np.array_equal(big_images[i], full), f"enlarged clip: frame {i} differs from its full-frame render")
    require(float((big_images[3][:, :, 0] != rd.BG_COLOR).mean()) > 1.5 * face_share, "the enlarged frame is not larger")
    # the split of one transfer batch: device work, copy into a pinned buffer, host paste
    batch = torch.as_tensor(verts[:64], device=dev)
    device_ms = cuda_ms(torch, lambda: rd.render_frames_tiled_packed(batch, faces_p, valid_p, lights), 5)
    packed = rd.render_frames_tiled_packed(batch, faces_p, valid_p, lights)
    pinned = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    copy_ms = cuda_ms(torch, lambda: pinned.copy_(packed, non_blocking=True), 5)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    crops, offs, fit = rd.unpack_rendered(pinned.numpy())
    pasted = [rd.paste_crop(crops[i], offs[i], height, width) for i in range(64)]
    paste_ms = 1e3 * (time.perf_counter() - tic)
    require(bool(fit.all()) and np.array_equal(pasted[0], images[0]), "the packed batch does not unpack to the frames")
    print(json.dumps({"clip_to_frames": {
        "frames": n_img, "predict_s": t_pred, "render_s": wall - t_pred, "wall_s": wall,
        "rendered_frames_per_s": n_img / (wall - t_pred), "frames_per_s_of_wall": n_img / wall,
        "per_batch_of_64_ms": {"device": device_ms, "copy": copy_ms, "host_paste": paste_ms},
        "k5_launches": k5["launches"], "min_face_share": face_share, "card": smi,
    }}), flush=True)
    del images, big_images, pasted, packed, pinned, batch

    # ---- 6. path 2: BIWI serving, and one BIWI training step ------------------
    template_biwi = rng.normal(size=(n_verts_biwi // 3, 3)).astype(np.float32)
    biwi([clip(1.0)], one0, template_biwi)  # library warm-up
    torch.cuda.synchronize()
    reset_counts(rows)
    audios = [clip(30.0) for _ in range(8)]
    one_hot = np.eye(12, dtype=np.float32)[rng.integers(0, 12, 8)]
    tic = time.perf_counter()
    res = biwi(audios, one_hot, template_biwi)
    wall = time.perf_counter() - tic
    for a, y in zip(audios, res):
        require(y.shape == (frame_count(len(a), 25), n_verts_biwi // 3, 3) and y.shape[0] == 750,
                f"BIWI shape {y.shape}")
        require(bool(np.isfinite(y).all()), "BIWI output not finite")
    print(json.dumps({"biwi_request": {
        "clips": 8, "seconds_each": 30, "wall_s": wall, "mesh_frames_per_s": 8 * 750 / wall,
        "realtime_factor": 8 * 30.0 / wall, "card": smi,
    }}), flush=True)
    del res
    secs = [3.0, 12.5, 27.3, 8.8, 0.5]
    audios = [clip(s_) for s_ in secs]
    res = biwi(audios, np.eye(12, dtype=np.float32)[[1, 3, 5, 7, 9]], template_biwi)
    for a, y in zip(audios, res):
        require(y.shape == (frame_count(len(a), 25), n_verts_biwi // 3, 3), f"BIWI mixed shape {y.shape}")
        require(bool(np.isfinite(y).all()), "BIWI mixed output not finite")
    del res
    kb = by_name["faceformer_decode_loop_biwi"]
    kb["launches"] = read_count(kb)
    require(kb["launches"] == 2 and dk.faceformer_decode_loop.launches == 0,
            f"BIWI serving launched its decode variant {kb['launches']} times and the vocaset one "
            f"{dk.faceformer_decode_loop.launches} times")
    require(attn_ops.flash_attention.launches > 0 and ce.fused_conv_encoder.launches > 0,
            "BIWI serving did not run the encoder's kernels")
    # the same weights through the plain versions on the card
    plain = FaceFormerPredictor(
        n_verts=n_verts_biwi, bf16=True, max_batch=8, bucket_seconds=5.0, dataset="biwi",
        state_dict=biwi.model.state_dict(), use_kernels=False,
    )
    audios = [clip(10.0), clip(7.5)]
    one_hot = np.eye(12, dtype=np.float32)[[4, 8]]
    got = biwi(audios, one_hot, template_biwi)
    want = plain(audios, one_hot, template_biwi)
    l2 = max(float(np.linalg.norm(a - b, axis=-1).max()) for a, b in zip(got, want))
    disp = max(float(np.abs(b - template_biwi).max()) for b in want)
    tol = 0.05 * disp  # the bf16 predictor's bar of phase 4
    print(json.dumps({"check": "BIWI predictor kernels vs plain, 2 clips", "max_vertex_l2": l2,
                      "max_offset": disp, "tol": tol}), flush=True)
    require(l2 <= tol, f"BIWI predictor vs plain: max per-vertex L2 {l2} > {tol}")
    del plain, got, want
    torch.cuda.empty_cache()
    # one BIWI training step: batch 8 x 10 s, 250 frames at 25 fps
    cfg_biwi = ExpConfig(
        batch_size=8, modelname="faceformer", one_hot_size=12, feature_extractor=None,
        sample_rate=16000, vertex_count=n_verts_biwi, split_frame=False, n_feature=32, out_dim=52,
        win_length=440, percision="16-mixed", lr=1e-3, seed=0, dataset="biwi",
    )
    exp = Audio2FaceExperiment(cfg_biwi, log_dir="build/chip_smoke_logs")
    exp.model.load_state_dict(biwi.model.state_dict())
    rng_b = np.random.default_rng(4)
    tmpl = (rng_b.normal(size=(8, n_verts_biwi // 3, 3)) * 0.1).astype(np.float32)
    batch = {
        "audio": (rng_b.normal(size=(8, 160000)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[rng_b.integers(0, 12, 8)],
        "verts": (torch.randn((8, 250, n_verts_biwi), generator=g).numpy() * 0.002 + tmpl.reshape(8, 1, -1)),
        "template_vert": tmpl,
        "audio_lengths": np.asarray([160000, 160000, 120000, 80000, 160000, 40000, 160000, 8000], np.int32),
    }
    reset_counts(rows)
    tic = time.perf_counter()
    with torch.enable_grad():
        metrics = exp.train_step(batch)
        torch.cuda.synchronize()
    step_wall = time.perf_counter() - tic
    require(all(math.isfinite(float(v_)) for v_ in metrics.values()), f"BIWI training step: {metrics}")
    for name in ("cross_q", "cross_k"):
        grad = getattr(exp.model, name).weight.grad
        require(grad is not None and bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0,
                f"no finite, non-zero gradient on {name}")
    require(dk.faceformer_decode_loop.launches == 0 and dk.faceformer_decode_loop.biwi_launches == 0
            and ce.fused_conv_encoder.launches == 0,
            "an inference-only kernel was launched in the BIWI training step")
    require(attn_ops.flash_attention.launches > 0
            and attn_ops.flash_attention_bwd.launches == attn_ops.flash_attention.launches,
            "the BIWI training step did not run the attention kernels forward and backward")
    print(json.dumps({"biwi_training_step": {
        "batch": 8, "seconds_each": 10, "frames": 250, "step_wall_s": step_wall,
        "loss": float(metrics["loss"]), "k1_launches": attn_ops.flash_attention.launches,
        "k4_launches": attn_ops.flash_attention_bwd.launches, "card": smi,
    }}), flush=True)
    del exp, batch, tmpl, biwi
    torch.cuda.empty_cache()

    # ---- 7. training path: the full-width experiment -------------------------
    n_clip, n_frames = 160000, 600  # 10 s
    cfg = ExpConfig(
        batch_size=8, modelname="faceformer", one_hot_size=12, feature_extractor=None,
        sample_rate=16000, vertex_count=n_verts, split_frame=False, n_feature=32, out_dim=52,
        win_length=440, percision="16-mixed", lr=1e-3, seed=0,
    )  # lr above the configs' 1e-4 so that three steps move the loss visibly
    tic = time.perf_counter()
    exp = Audio2FaceExperiment(cfg, log_dir="build/chip_smoke_logs")
    exp.model.load_state_dict(pred.model.state_dict())  # random weights, motion maps randomized
    rng = np.random.default_rng(2)
    tmpl = (rng.normal(size=(8, n_verts // 3, 3)) * 0.1).astype(np.float32)
    # a target the model can learn: a fixed offset per vertex, plus a little motion
    motion = torch.randn((8, n_frames, n_verts), generator=g).numpy() * 0.002
    motion += (rng.normal(size=(1, 1, n_verts)) * 0.01).astype(np.float32)
    batch = {
        "audio": (rng.normal(size=(8, n_clip)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[rng.integers(0, 12, 8)],
        "verts": motion + tmpl.reshape(8, 1, -1),
        "template_vert": tmpl,
        "audio_lengths": np.asarray([160000, 160000, 120000, 80000, 160000, 40000, 160000, 8000], np.int32),
    }
    del motion
    print(f"experiment and batch built: {time.perf_counter() - tic:.1f} s", flush=True)
    before = {k_: float(v_) for k_, v_ in exp.eval_step(batch).items()}
    start_params = {k_: v_.detach().clone() for k_, v_ in exp.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(rows)
    step_s, train_losses = [], []
    with torch.enable_grad():
        for i in range(3):
            tic = time.perf_counter()
            metrics = exp.train_step(batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - tic)
            train_losses.append(float(metrics["loss"]))
            require(all(math.isfinite(float(v_)) for v_ in metrics.values()), f"step {i}: {metrics}")
            if i == 0:  # the gradients of the first step, before the next one clears them
                bad = [k_ for k_, p_ in exp.model.named_parameters()
                       if p_.grad is not None and not bool(torch.isfinite(p_.grad).all())]
                require(not bad, f"non-finite gradients in {bad[:5]}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in rows:
        r["train_launches"] = read_count(r)
    n_fwd, n_bwd = by_name["flash_attention"]["train_launches"], by_name["flash_attention_bwd"]["train_launches"]
    by_name["flash_attention_bwd"]["launches"] = n_bwd
    # 12 attention calls a step less LayerDrop's skips, each with its backward
    require(0 < n_fwd <= 36 and n_bwd == n_fwd, f"training launched K1 {n_fwd} and K4 {n_bwd} times")
    require(all(by_name[n]["train_launches"] == 0 for n in (
        "fused_conv_encoder", "faceformer_decode_loop", "faceformer_decode_loop_biwi", "rasterize_keys")),
            "an inference-only kernel was launched in training")
    moved = {part: max(float((p_.detach() - start_params[k_]).abs().max())
                       for k_, p_ in exp.model.named_parameters() if k_.startswith(prefix))
             for part, prefix in (("encoder", "audio_encoder."), ("decoder", "dec_q."),
                                  ("head", "vertice_map_r."))}
    require(all(m > 0 for m in moved.values()), f"parameters that did not change: {moved}")
    after = {k_: float(v_) for k_, v_ in exp.eval_step(batch).items()}
    require(math.isfinite(after["loss"]) and after["loss"] < before["loss"],
            f"loss on the repeated batch did not fall: {before['loss']} -> {after['loss']}")
    require(ce.fused_conv_encoder.launches > 0 and dk.faceformer_decode_loop.launches > 0,
            "eval_step did not run the inference kernels")
    print(json.dumps({"training": {
        "batch": 8, "seconds_each": 10, "frames": n_frames, "steps": 3, "step_wall_s": step_s,
        "peak_device_memory_gb": peak_gb, "train_losses": train_losses,
        "eval_loss_before": before["loss"], "eval_loss_after": after["loss"],
        "k1_launches": n_fwd, "k4_launches": n_bwd, "max_param_change": moved, "card": smi,
    }}), flush=True)
    del exp, start_params, batch
    torch.cuda.empty_cache()

    # the same full-width model in f32, batch 2 of 2 s: gradients through the
    # kernels against the plain versions, same weights, same random streams
    cfg32 = cfg.model_copy(update={"percision": "32", "batch_size": 2})
    rng = np.random.default_rng(3)
    small = {
        "audio": (rng.normal(size=(2, 32000)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[[3, 7]],
        "verts": (rng.normal(size=(2, 120, n_verts)) * 0.01).astype(np.float32) + tmpl[:2].reshape(2, 1, -1),
        "template_vert": tmpl[:2],
        "audio_lengths": np.asarray([32000, 21000], np.int32),
    }
    grads = []
    for use_kernels in (True, False):
        e32 = Audio2FaceExperiment(cfg32, log_dir="build/chip_smoke_logs", use_kernels=use_kernels)
        e32.model.load_state_dict(pred.model.state_dict())
        reset_counts(rows)
        with torch.enable_grad():
            e32.accumulate_gradients(small)
        require((attn_ops.flash_attention_bwd.launches > 0) == use_kernels,
                f"use_kernels={use_kernels}: K4 launched {attn_ops.flash_attention_bwd.launches} times")
        grads.append({k_: p_.grad.detach().clone() for k_, p_ in e32.model.named_parameters()
                      if p_.grad is not None})
        del e32
    require(set(grads[0]) == set(grads[1]), "the two runs skipped different layers")
    largest = max(float(g_.abs().max()) for g_ in grads[1].values())
    worst_leaf, worst = "", 0.0
    for k_, ref in grads[1].items():
        rel = float((grads[0][k_] - ref).abs().max()) / max(float(ref.abs().max()), 1e-4 * largest)
        if rel > worst:
            worst_leaf, worst = k_, rel
    print(json.dumps({"check": "f32 gradients through the kernels vs plain, 2 x 2 s",
                      "leaves": len(grads[1]), "max_rel_err_of_a_leaf": worst, "leaf": worst_leaf,
                      "tol": GRAD_LEAF_TOL}), flush=True)
    require(worst <= GRAD_LEAF_TOL, f"gradient of {worst_leaf} differs by {worst} of its largest value")
    del grads

    # ---- 8. results -----------------------------------------------------
    for r in rows:
        del r["wrapper"]
        r.pop("counter", None)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
