#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (audio2face_tpu_torch) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each of
which raises (exit code != 0) on failure:

1. device: requires CUDA; prints the card's name and power limit; turns
   TF32 off for the f32 products of the plain versions;
2. build: compiles the port's CUDA sources (``build/torch_kernels/``) and
   prints the bf16 attention kernels' registers and spills (``-Xptxas -v``),
   shared memory per block and resident blocks per SM (CUDA runtime), and
   the conv encoder's and decode loop's registers and spills, the
   rasterizer's registers, spills and shared memory a block, and the f32
   attention kernels' registers and spills and launch plans (path, shared
   memory a block, blocks per SM) at the frame-window, training and
   predictor shapes;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes its main path gives it (the flagship request,
   60 s x batch 8; the BIWI request, 30 s x batch 8; a transfer batch of 64
   frames of the 5,023-vertex head at 800 x 800), with a stated tolerance;
   times kernel, plain version and (attention) one
   ``scaled_dot_product_attention`` call with CUDA events, and at the
   training shape K1, K4 and SDPA's forward and backward by the profiler's
   device time (5 repeats, SDPA's backend named); K5 also on adversarial
   frames (slivers, huge and edge-touching triangles, a NaN frame), its
   registers, spills and shared memory, and its work (box pixels, tile-chunk
   pairs, evaluated sub-tile pairs) under its bound; K1 and K4 also
   over head dims 16, 32, 64 and 128 in bf16 and f32 with their options at
   small shapes (f32 also at t_k = 1, 25, 33, 64 and 65, both sides of the
   short-key path's bound), and K4's delta against its plain version; (3i)
   K1 and K4 in f32 at the frame window (1024, 12, 25, 64), the f32
   training shape (8, 12, 600, 64, dropout 0 and 0.1) and the f32
   predictor's shape (8, 12, 3600, 64), against their plain versions and
   timed beside their bounds, plain versions and SDPA's f32 forward and
   backward (the profiler's device time); K2's launches
   split by the profiler; K3's cluster plan (cluster size, resident
   clusters, cache rows and shared memory a CTA) and us a step, and K3 (both
   variants) also at small f32 shapes, past the cluster's shared-memory
   capacity (bf16 and f32, a batch of 1) and at a batch of 20;
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
9. the frame models and checkpoint I/O: (a) the default configuration
   (``config.yaml``: Audio2Mesh, MFCC at 22 kHz, bf16, 15069-wide head)
   through FramePredictor (``max_batch`` 8, ``frame_batch`` 128) on 8 x 60 s
   of synthetic speech, wall time, frames/s and the request replayed with
   the model call and the copy-out split, then the bf16 predictor against
   its f32 run on 2 clips; (b) VOCA and Song2Face (``configs/``), 2 x 10 s
   each, against their f32 runs; (c) Audio2Mesh with the wav2vec2
   extractor, 2 x 10 s, which must launch the flash-attention kernel and
   nothing else, and that kernel in f32 at the frame-window shape (B x 128,
   12, 25, 64) against its plain version, timed beside its bound, its plain
   version and SDPA; (d) two Audio2Mesh training steps on 128 fragments
   (bf16), the BatchNorm running variance moving, a ``save_checkpoint``
   loaded by ``FramePredictor.from_checkpoint`` equal to the trainer's
   ``predict``; (e) FaceFormer trainer checkpoints (vocaset and BIWI) into
   ``FaceFormerPredictor.from_checkpoint`` (dataset detected) giving the
   same vertices as the predictor built from the same weights, through the
   forward kernels;
10. the data pipeline: the native loader (``g++``) against its numpy
   reference at the default configuration's shapes (128 fragments x 11,440
   samples, rows of 5,023 x 3); a synthetic VOCASET (5,023 vertices, 4
   sentences of 2 s a subject) through one epoch of ``fit`` for FaceFormer
   (full width, bf16, clip batches of 8: K1 with dropout and K4) and
   Audio2Mesh (``config.yaml``, frame batches of 128), every training batch
   a CUDA tensor copied from pinned memory by the ``Prefetcher`` (step wall,
   bytes, side-stream copy ms); one ``BiwiDataModule`` batch through a BIWI
   training step;
11. live serving with phase 4's weights: (a) ``StreamingFaceFormerPredictor``
   (default windows, a 10 s clip in 0.25 s pieces: chunk latency, one
   chunk's launches and idle share by the profiler, against its
   plain-version run; one window against the offline predictor); K2 at
   (1, 56,000) and K1 at (1, 12, 210, 64) against their plain versions,
   timed; (b) an 8-slot ``MultiStreamFaceFormerPredictor`` (8 streams of
   4-12 s, one late joiner) against solo streams; K2 and K1 at batch 8;
   (c) ``FrameStreamPool`` on ``config.yaml`` (8 streams) against the
   offline ``FramePredictor``; (d) ``ServingDaemon`` (8 concurrent 5 s WAV
   requests, coalesced) and ``LiveStreamingDaemon`` (2 ``LiveClient`` s)
   over loopback, ``/healthz`` naming ``cuda``;
12. the command lines at full width on 10b's synthetic VOCASET (FaceFormer,
   ``configs/faceformer.yaml``, bf16): (a) ``cli.train`` in process, one
   epoch at batch 8 with ``--skip-render`` (K1 with dropout and K4 in the
   steps), predicting and scoring one test sentence into
   ``pred_verts.npy``; (b) the ``cli.evaluate`` sweep of its checkpoint
   over the test split (seconds and frames/s a sentence; K1-K3), the same
   sweep through the plain versions on the card, and ``evaluate_animation``
   on the card against a float64 numpy evaluation; (c) ``cli.evaluate``'s
   diff of ``pred_verts.npy`` against the sentence's ground truth; (d)
   ``cli.export`` reloaded by ``FaceFormerPredictor.from_torch_checkpoint``
   against ``from_checkpoint`` (weights, f32 predictions); (e) ``cli.serve``
   as a subprocess with ``--warmup-seconds 10`` and ``--live-port``: two
   concurrent 5 s POSTs against direct calls, ``/stats``, one 5 s live
   session, then terminated;
13. parallelism (``parallel/``) on a one-rank NCCL group (the machine has
   one card; NCCL puts no two ranks on one device), every sharded path at
   full width against its solo run and timed beside it, each asserting
   its kernels and a collective count above zero: (a) the trainer with
   mesh (1, 1), tensor parallelism and FSDP (FSDP2-sharded parameters),
   two bf16 steps of 8 x 10 s (K1 with dropout, K4); (b) sequence- and
   pipeline-parallel encodes of 8 x 60 s (K2, K1); (c)
   ``FaceFormerPredictor(mesh=)`` and ``(sp_mesh=)`` on the flagship
   request (K1-K3); (d) ``FramePredictor(mesh=)`` on config.yaml, the
   slot-sharded ``MultiStreamFaceFormerPredictor`` and ``FrameStreamPool``;
   (e) K1 and K4, bf16 and f32, with a hash offset, against their plain
   versions; each row gains ``parallel_launches``;
14. prints the ``{"kernels": [...]}`` line (each kernel's launches on the
   serving, training, frame, checkpoint, data, live, CLI and parallel
   paths; K1 f32 and K4 f32 have rows of their own, counted by the
   wrappers' ``f32_launches`` on the wav2vec2 frame request and the f32
   gradient check), then, last, ``{"ok": true, "device": {...}}``.

Gradients are off process-wide (the inference phases build no autograd
graph); the training phases turn them on in their own scope.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# f32 operations one pixel x triangle test needs: four plane increments,
# two subtractions for the third barycentric, and the 16 operations of a
# strip's first row spread over its 16 rows. K5's bound counts them over the
# pixels in each live triangle's screen box (what the inputs need), not over
# the pairs a design evaluates.
K5_OPS_PER_PIXEL = 7.0


def counter(row: dict) -> str:
    return row.get("counter", "launches")


def reset_counts(rows: list) -> None:
    """Set every kernel's launch count to 0."""
    for r in rows:
        setattr(r["wrapper"], counter(r), 0)


def read_count(row: dict) -> int:
    return getattr(row["wrapper"], counter(row))


def k3_check(torch, dk, label: str, cross, style, pe, weights, **kw) -> dict:
    """K3 against its plain version on the same inputs: f32 outputs within
    K3_F32_TOL, bf16 outputs within one bf16 step more; raises on a miss."""
    out = dk.faceformer_decode_loop(cross, style, pe, weights, **kw)
    ref = dk.decode_loop_reference(cross, style, pe, weights, **kw)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    step = K3_BF16_STEP if out.dtype == torch.bfloat16 else 0.0
    over = (diff - step * ref.float().abs()).max().item()
    finite = bool(torch.isfinite(out.float()).all())
    require(out.shape == ref.shape and out.dtype == ref.dtype and finite and over <= K3_F32_TOL,
            f"K3 {label}: err {over} > {K3_F32_TOL} (finite {finite}, {out.dtype} {tuple(out.shape)})")
    return {"check": f"faceformer_decode_loop {label}", "max_abs_err": diff.max().item(),
            "err_less_bf16_step" if step else "err": over, "tol": K3_F32_TOL}


K2_KERNELS = ("conv0_moments", "gn_fold", "conv0_gelu", "conv_gemm_wgmma")


def k2_launch_ms(torch, fn) -> list:
    """K2's launches in one call of ``fn``, in order, with their device ms
    (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[next(k for k in K2_KERNELS if k in ev.name), ev.time_range.elapsed_us() / 1e3]
            for ev in prof.events() if any(k in ev.name for k in K2_KERNELS)
            and ev.time_range.elapsed_us() > 0]


def profiled_ms(torch, fn, calls: int, repeats: int = 5) -> tuple[list, list]:
    """Device time of one call of ``fn``, by the profiler: the summed device
    time of the kernels and memsets it launches over ``calls`` calls, divided
    by ``calls`` (host gaps between the launches are not in it), in
    ``repeats`` windows after a warm call; and the names of those kernels.
    Each window starts and ends with a marker kernel (``torch.cuda._sleep``,
    not counted): the profiler on the GPU machine has lost one device event
    at a window's edge in most windows (K1's 60 events a window read 59 in
    58 of 60 windows). The windows timed are those with the event count
    most windows recorded (ties to the larger): a window that still lost
    events, or that recorded extra ones (a library call's occasional extra
    kernels: a plain version's cuDNN convs read 330 events in 4 windows of
    60 and 321 in the rest), is taken again, up to 12 x ``repeats``
    windows in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    windows, names = [], set()
    for _ in range(12 * repeats):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        windows.append((len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls))
        names |= {e.name for e in events}
        counts = [n_ for n_, _ in windows]
        full = max(counts, key=lambda c: (counts.count(c), c))
        if counts.count(full) >= repeats:
            break
    times = [t_ for n_, t_ in windows if n_ == full][:repeats]
    require(full > 0 and len(times) == repeats,
            f"the profiler recorded {[n_ for n_, _ in windows]} device events of {sorted(names)}")
    return times, sorted(names)


def sdpa_backend(kernel_names: list) -> str:
    """The backend ``scaled_dot_product_attention`` took, from its kernels' names."""
    joined = " ".join(kernel_names).lower()
    for key, backend in (("cudnn", "cudnn"), ("fmha_cutlass", "efficient (CUTLASS)"), ("flash", "flash")):
        if key in joined:
            return backend
    return "math"


def k3_extra_shapes(dk, dev, biwi: bool) -> list:
    """(dtype, batch, T) of K3's checks off the serving shape: a batch of 1
    with T at least 1.5x the cluster's shared-memory capacity, in bf16 and
    f32 weights (rows past it stay in device memory), and a batch of 20
    (more clusters than are resident at once)."""
    import torch

    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        capacity = dk.kernel_cluster_plan(1, 1, dev, biwi, dtype == torch.bfloat16)["capacity_rows"]
        shapes.append((dtype, 1, -(-3 * capacity // 2)))
    return shapes + [(torch.bfloat16, 20, 200)]


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel: ``_Z<len><name>...`` or, in an
    anonymous namespace, ``_ZN<len><namespace><len><name>...``, with its
    template arguments: integers and booleans as numbers (the attention
    kernels' head dim: ``flash_fwd_wgmma_kernel<64>``), ``float`` and named
    types (``decode_cluster_kernel<1, __nv_bfloat16>``)."""
    import re

    nested = mangled.startswith("_ZN")
    rest, parts = mangled[3 if nested else 2:], []
    while len(parts) < (2 if nested else 1) and (n := re.match(r"\d+", rest)):
        parts.append(rest[n.end(): n.end() + int(n.group(0))])
        rest = rest[n.end() + int(n.group(0)):]
    if not rest.startswith("I"):
        return parts[-1]
    args, i = [], 1
    while i < len(rest) and rest[i] != "E":
        if m := re.match(r"L[ib](\d+)E", rest[i:]):
            args.append(m.group(1))
            i += m.end()
        elif rest[i] == "f":
            args.append("float")
            i += 1
        elif m := re.match(r"\d+", rest[i:]):
            args.append(rest[i + m.end(): i + m.end() + int(m.group(0))])
            i += m.end() + int(m.group(0))
        else:
            break
    return f"{parts[-1]}<{', '.join(args)}>"


def ptxas_report(log_text: str) -> dict:
    """Registers, stack and spill bytes and static shared memory of each
    kernel in an ``nvcc -Xptxas -v`` log, keyed by ``kernel_name``, and
    whether ptxas serialized its ``wgmma`` (its C75xx notes: the products
    then do not overlap)."""
    import re

    report, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            report.setdefault(name, {})
            continue
        m = re.search(r"wgmma.mma_async instructions are serialized.*function '(_Z\w+)'", line)
        if m:
            report.setdefault(kernel_name(m.group(1)), {})["wgmma_serialized"] = True
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report[name].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            report[name]["static_smem_bytes"] = int(m.group(1))
    return report


def kernel_bwd_with_delta(attn_ops, q, k, v, out, lse, g, causal=False, alibi_period=None,
                          kv_lengths=None, dropout_rate=0.0, dropout_seed=None):
    """K4's (dq, dk, dv, delta): delta = rowsum(g * out) as its dq kernel wrote it."""
    return attn_ops._flash_attention_bwd_cuda(
        q, k, v, out, lse, g, causal, alibi_period, kv_lengths, 1.0 / math.sqrt(q.shape[-1]),
        dropout_rate, dropout_seed)


def attention_variant_checks(torch, attn_ops, randn) -> dict:
    """K1 and K4 against their plain versions at small shapes, off the main
    path's d = 64 bf16: head dims 16, 32, 64 and 128 in bf16 and in f32, each
    plain, with kv_lengths and dropout, and causal with period-60 ALiBi and
    dropout, with and without kv_lengths; then t_q != t_k, ALiBi without
    causality, zero-length items and rate 0.5; then f32 at t_k = 1, 25, 33,
    64 and 65 (both sides of the short-key path's bound) with every option.
    Checks out, lse, dq/dk/dv and the backward's delta; raises on the first
    miss. Returns the worst err/tol of each check over the cases, per dtype."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for dtype in (bf, f32):
        for d in (16, 32, 64, 128):
            cases += [
                (dtype, (2, 2, 90, 150, d), {}, 0.0),
                (dtype, (2, 2, 90, 150, d), dict(kv_lengths=[150, 57]), 0.1),
                (dtype, (2, 2, 130, 130, d), dict(causal=True, alibi_period=60), 0.1),
                (dtype, (2, 2, 130, 130, d), dict(causal=True, alibi_period=60, kv_lengths=[130, 33]), 0.1),
            ]
    cases += [
        (f32, (2, 3, 130, 130, 64), dict(causal=True, alibi_period=60), 0.0),
        (f32, (2, 4, 90, 150, 16), dict(alibi_period=60), 0.0),  # negative i - j
        (f32, (2, 2, 100, 70, 128), dict(kv_lengths=[70, 0]), 0.1),
        (f32, (2, 2, 100, 70, 32), dict(kv_lengths=[33, 70], causal=True), 0.5),
        (bf, (2, 4, 300, 200, 128), dict(kv_lengths=[200, 57]), 0.0),
        (bf, (2, 4, 300, 200, 128), dict(kv_lengths=[200, 57]), 0.1),
        (bf, (3, 2, 77, 77, 32), dict(causal=True), 0.0),
        (bf, (3, 2, 77, 77, 32), dict(causal=True), 0.1),
        (bf, (2, 2, 77, 99, 16), dict(alibi_period=60, kv_lengths=[0, 99]), 0.0),
    ]
    # f32 at the forward's short-key boundary (t_k <= 64 takes the short
    # kernel, 65 the tiled one), t_q != t_k, every option
    cases += [
        (f32, (2, 3, 25, 25, 64), {}, 0.0),
        (f32, (2, 3, 25, 25, 64), dict(causal=True, alibi_period=25, kv_lengths=[25, 0]), 0.1),
        (f32, (3, 2, 1, 1, 16), {}, 0.0),
        (f32, (3, 2, 40, 1, 32), dict(kv_lengths=[1, 0, 1]), 0.1),
        (f32, (2, 2, 7, 64, 32), dict(alibi_period=25, kv_lengths=[64, 40]), 0.1),  # negative i - j
        (f32, (2, 2, 64, 64, 128), dict(causal=True, alibi_period=25), 0.1),
        (f32, (1, 4, 300, 33, 64), dict(kv_lengths=[20]), 0.1),
        (f32, (2, 2, 100, 65, 64), dict(causal=True, kv_lengths=[65, 1]), 0.1),
        (f32, (2, 2, 65, 65, 128), dict(alibi_period=25), 0.0),
        (f32, (2, 2, 30, 65, 16), dict(alibi_period=25, kv_lengths=[65, 0]), 0.1),
    ]
    worst = {}
    for dtype, (b, h, tq, tk, d), kw, rate in cases:
        q, go = randn(b, h, tq, d, dtype=dtype), randn(b, h, tq, d, dtype=dtype)
        k, v = randn(b, h, tk, d, dtype=dtype), randn(b, h, tk, d, dtype=dtype)
        kw = dict(kw, dropout_rate=rate, dropout_seed=77)
        if "kv_lengths" in kw:
            kw["kv_lengths"] = torch.tensor(kw["kv_lengths"])
        out, lse = attn_ops.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = attn_ops.mha_reference(q, k, v, return_lse=True, **kw)
        *got, delta = kernel_bwd_with_delta(attn_ops, q, k, v, out, lse, go, **kw)
        want = attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, go, **kw)
        want_delta = attn_ops.attention_delta_reference(out, go)
        # rows of a zero-length item are padding in the forward: not compared
        live = torch.ones(b, dtype=torch.bool) if "kv_lengths" not in kw else kw["kv_lengths"] > 0
        if dtype == f32:
            # tests/test_attention.py's rtol 1e-4 / atol 1e-5; the JAX package's
            # bar for its backward kernels, rtol 2e-3 / atol 2e-4
            fwd = ((out[live] - ref[live]).abs().max().item(), 1e-5 + 1e-4 * ref[live].abs().max().item())
            bwd = (max(((a - w).abs() - K4_F32_RTOL * w.abs()).max().item() for a, w in zip(got, want)),
                   K4_F32_ATOL)
        else:
            fwd = (row_scaled_err(out[live], ref[live]), K1_BF16_ROW_TOL)
            bwd = (max(row_scaled_err(a, w, K4_ROW_FLOOR) for a, w in zip(got, want)), K4_BF16_ROW_TOL)
        lse_chk = ((lse[live] - ref_lse[live]).abs().max().item(), 1e-5 + 1e-4 * ref_lse[live].abs().max().item())
        # f32 sums of the same products in another order
        delta_chk = ((delta - want_delta).abs().max().item(), 1e-5 + 1e-4 * want_delta.abs().max().item())
        finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
        zero_ok = all(not x[~live].any() for x in got[1:])  # zero-length item: dk = dv = 0
        checks = {"out": fwd, "lse": lse_chk, "grads": bwd, "delta": delta_chk}
        for name, (err, tol) in checks.items():
            key = f"{str(dtype)[6:]} {name}"
            worst[key] = max(worst.get(key, 0.0), err / tol)
        require(all(err <= tol for err, tol in checks.values()) and finite and zero_ok,
                f"K1/K4 {dtype} {(b, h, tq, tk, d)} {kw}: {checks}, finite {finite}, zero-length {zero_ok}")
    return {"cases": len(cases), "worst_err_over_tol": worst}


def f32_attention_readings(torch, attn_ops, randn, smi) -> dict:
    """K1 and K4 in f32 at the f32 training shape (8, 12, 600, 64) with
    kv_lengths 30-600, dropout 0 and 0.1: each against its plain version
    (K1: rtol 1e-4 / atol 1e-5 of tests/test_attention.py, out and lse; K4:
    K4_F32_RTOL / K4_F32_ATOL), then by the profiler's device time beside the
    bound of this call's work (the unmasked pairs), the plain version (CUDA
    events) and SDPA's f32 forward and backward under the same boolean mask
    (device time); K1 f32 at the frame window (1024, 12, 25, 64) by device
    time beside SDPA; and K1 f32 at the f32 predictor's encoder shape (8, 12,
    3600, 64, kv_lengths 180-3600) by CUDA events beside its bound, plain
    version and SDPA. Raises on a miss."""
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {"card": smi}
    b, h, t, d = 8, 12, 600, 64
    q, k, v, go = (randn(b, h, t, d) for _ in range(4))
    kvl = torch.tensor([600, 600, 450, 300, 600, 150, 600, 30], dtype=torch.int32, device=dev)
    seed = torch.tensor([20240607], dtype=torch.int32, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    pairs = float(h * t * kvl.sum().item())  # unmasked (query, key) pairs
    kv_bytes = 2 * h * kvl.sum().item() * d * 4  # k and v read up to each KV length
    k1_bound = bound(2 * b * h * t * d * 4 + kv_bytes + b * h * t * 4 + b * 4,
                     4.0 * d * pairs / PEAK_F32_FLOPS)
    k4_bound = bound(6 * b * h * t * d * 4 + kv_bytes + 2 * b * h * t * 4 + b * 4,
                     10.0 * d * pairs / PEAK_F32_FLOPS)
    for rate in (0.0, 0.1):
        kw = dict(kv_lengths=kvl, dropout_rate=rate, dropout_seed=seed)
        out, lse = attn_ops.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = attn_ops.mha_reference(q, k, v, return_lse=True, **kw)
        got = attn_ops.flash_attention_bwd(q, k, v, out, lse, go, **kw)
        want = attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, go, **kw)
        torch.cuda.synchronize()
        fwd = ((out - ref).abs().max().item(), 1e-5 + 1e-4 * ref.abs().max().item())
        lse_chk = ((lse - ref_lse).abs().max().item(), 1e-5 + 1e-4 * ref_lse.abs().max().item())
        bwd = (max(((a - w).abs() - K4_F32_RTOL * w.abs()).max().item() for a, w in zip(got, want)),
               K4_F32_ATOL)
        require(fwd[0] <= fwd[1] and lse_chk[0] <= lse_chk[1] and bwd[0] <= bwd[1]
                and all(bool(torch.isfinite(x).all()) for x in (out, *got)),
                f"K1/K4 f32 at the training shape, rate {rate}: out {fwd} lse {lse_chk} grads {bwd}")
        k1_dev, k1_names = profiled_ms(torch, lambda: attn_ops.flash_attention(q, k, v, **kw), 20)
        k4_dev, k4_names = profiled_ms(
            torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, **kw), 20)
        res[f"train_shape_rate{rate}"] = {
            "shape": [b, h, t, d], "k1_out_err_and_tol": fwd, "k1_lse_err_and_tol": lse_chk,
            "k4_err_less_rtol_and_atol": bwd, "k4_shape": [b, h, t, d],
            "k4_max_abs_err": max((a - w).abs().max().item() for a, w in zip(got, want)),
            "k1_device_ms": k1_dev, "k1_ms": sorted(k1_dev)[2], "k1_kernels": k1_names,
            "k1_plain_ms": cuda_ms(torch, lambda: attn_ops.mha_reference(q, k, v, **kw), 3),
            "k4_device_ms": k4_dev, "k4_ms": sorted(k4_dev)[2], "k4_kernels": k4_names,
            "k4_plain_ms": cuda_ms(
                torch, lambda: attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, go, **kw), 3),
        }
    lib_fwd, fwd_names = profiled_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask), 20)
    with torch.enable_grad():
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = sdpa(*leaves, attn_mask=mask)
        lib_bwd, bwd_names = profiled_ms(
            torch, lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True), 20)
    del leaves, lib_out
    res["train_shape_sdpa"] = {
        "forward_device_ms": lib_fwd, "forward_ms": sorted(lib_fwd)[2],
        "forward_backend": sdpa_backend(fwd_names), "backward_device_ms": lib_bwd,
        "backward_ms": sorted(lib_bwd)[2], "backward_backend": sdpa_backend(bwd_names),
        "k1_bound_ms": k1_bound[0], "k1_bound_by": k1_bound[1],
        "k4_bound_ms": k4_bound[0], "k4_bound_by": k4_bound[1],
    }
    del q, k, v, go, out, lse, ref, ref_lse, got, want
    # the frame window by device time
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1024, 12, 25, 64, generator=g).to(dev) for _ in range(3))
    out = attn_ops.flash_attention(q, k, v)
    ref = attn_ops.mha_reference(q, k, v)
    torch.cuda.synchronize()
    rel = row_scaled_err(out, ref)
    require(rel <= K1_F32_ROW_TOL and bool(torch.isfinite(out).all()),
            f"K1 f32 at the frame window: err {rel} of the row's largest |out| > {K1_F32_ROW_TOL}")
    k1_dev, _ = profiled_ms(torch, lambda: attn_ops.flash_attention(q, k, v), 20)
    lib_dev, names = profiled_ms(torch, lambda: sdpa(q, k, v), 20)
    n_ = q.numel()
    bms, bby = bound(4 * n_ * 4 + n_ // 64 * 4, 4.0 * n_ * 25 / PEAK_F32_FLOPS)
    res["frame_window_device"] = {
        "shape": [1024, 12, 25, 64], "max_abs_err": (out - ref).abs().max().item(),
        "max_err_over_row_max": rel, "k1_device_ms": k1_dev, "k1_ms": sorted(k1_dev)[2],
        "plain_ms": cuda_ms(torch, lambda: attn_ops.mha_reference(q, k, v), 10),
        "sdpa_device_ms": lib_dev, "sdpa_ms": sorted(lib_dev)[2], "sdpa_backend": sdpa_backend(names),
        "bound_ms": bms, "bound_by": bby}
    del q, k, v, out, ref
    # the f32 predictor's encoder attention
    b, h, t, d = 8, 12, 3600, 64
    q, k, v = (randn(b, h, t, d) for _ in range(3))
    kvl = torch.tensor([3600, 3600, 2700, 1800, 3600, 900, 3600, 180], dtype=torch.int32, device=dev)
    out = attn_ops.flash_attention(q, k, v, kv_lengths=kvl)
    ref = attn_ops.mha_reference(q, k, v, kv_lengths=kvl)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-5 + 1e-4 * ref.abs().max().item()
    require(err <= tol and bool(torch.isfinite(out).all()), f"K1 f32 at (8, 12, 3600, 64): {err} > {tol}")
    del ref
    torch.cuda.empty_cache()
    mask = (torch.arange(t, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    pairs = float(h * t * kvl.sum().item())
    bms, bby = bound(2 * b * h * t * d * 4 + 2 * h * kvl.sum().item() * d * 4 + b * h * t * 4 + b * 4,
                     4.0 * d * pairs / PEAK_F32_FLOPS)
    res["predictor_shape"] = {
        "shape": [b, h, t, d], "max_abs_err": err, "tol": tol,
        "k1_ms": cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl), 3),
        "k1_plain_ms": cuda_ms(torch, lambda: attn_ops.mha_reference(q, k, v, kv_lengths=kvl), 1),
        "sdpa_ms": cuda_ms(torch, lambda: sdpa(q, k, v, attn_mask=mask), 3),
        "bound_ms": bms, "bound_by": bby,
    }
    del q, k, v, out
    torch.cuda.empty_cache()
    return res


# the bf16 frame predictors against their f32 runs on the same weights and
# clips: the vertex offsets from the template are ~disp; bf16 activations
# through ~10 convs and BatchNorms (no autoregressive feedback), so allow 5%
# of them, the bf16 FaceFormer predictor's bar
FRAME_BF16_SHARE = 0.05
# K1 in f32 at the wav2vec2 extractor's frame-window shape against its plain
# version (TF32 off): the largest |difference| over the largest |out| of its
# row; tests/test_attention.py's f32 rtol
K1_F32_ROW_TOL = 1e-4
# a FramePredictor loaded from the trainer's checkpoint against the
# trainer's predict on the same fragments, same bf16 weights: data units
FRAME_CHECKPOINT_TOL = 1e-5


def frame_request_split(torch, predictor, audios, one_hot, template) -> dict:
    """The FramePredictor request replayed chunk by chunk with the device
    synchronized between stages: upload and pad, the model call (window
    gather, features, model) and the copy-out (device to host, then into
    each clip's array)."""
    n = len(audios)
    template = np.broadcast_to(template[None], (n, *template.shape))
    split = {"upload_s": 0.0, "model_s": 0.0, "copy_out_s": 0.0, "chunks": 0}
    order = sorted(range(n), key=lambda i: len(audios[i]))
    for lo in range(0, n, predictor.max_batch):
        idx = order[lo : lo + predictor.max_batch]
        group = [audios[i] for i in idx]
        n_frames = [len(a) * predictor.fps // predictor.sample_rate for a in group]
        results = [np.empty((f, predictor.n_verts // 3, 3), np.float32) for f in n_frames]
        t0 = time.perf_counter()
        inputs = predictor.prepare(group, one_hot[idx], template[idx].astype(np.float32))
        torch.cuda.synchronize()
        split["upload_s"] += time.perf_counter() - t0
        for f0 in range(0, max(n_frames), predictor.frame_batch):
            t0 = time.perf_counter()
            out = predictor.forward_chunk(*inputs, f0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            chunk = out.cpu().numpy()
            for j in range(len(idx)):
                m = min(n_frames[j], f0 + predictor.frame_batch) - f0
                if m > 0:
                    results[j][f0 : f0 + m] = chunk[j, :m]
            split["model_s"] += t1 - t0
            split["copy_out_s"] += time.perf_counter() - t1
            split["chunks"] += 1
    return split


def frame_bf16_vs_f32(torch, cfg, predictor, audios, one_hot, template, label: str) -> dict:
    """The bf16 predictor against an f32 one with the same weights."""
    from audio2face_tpu_torch.serving import FramePredictor

    f32 = FramePredictor(cfg.model_copy(update={"percision": "32"}), max_batch=8,
                         state_dict=predictor.model.state_dict())
    got = predictor(audios, one_hot, template)
    want = f32(audios, one_hot, template)
    l2 = max(float(np.linalg.norm(a - b, axis=-1).max()) for a, b in zip(got, want))
    disp = max(float(np.abs(b - template).max()) for b in want)
    tol = FRAME_BF16_SHARE * disp
    check = {"check": f"{label}: bf16 predictor vs f32, {len(audios)} clips", "max_vertex_l2": l2,
             "max_offset": disp, "tol": tol}
    print(json.dumps(check), flush=True)
    require(all(bool(np.isfinite(y).all()) for y in got), f"{label}: output not finite")
    require(l2 <= tol, f"{label}: bf16 vs f32 max per-vertex L2 {l2} > {tol}")
    return check


def frame_model_phases(torch, rows, by_name, smi, pred, biwi_state, n_verts_biwi) -> None:
    """9a-9e: the default frame configuration's request, VOCA and Song2Face,
    the wav2vec2 extractor (K1 at the frame-window shape), two training
    steps with a checkpoint into the predictor, and FaceFormer checkpoints
    (vocaset and BIWI) into FaceFormerPredictor.from_checkpoint. Records
    each kernel's launches on these paths in its row."""
    from concurrent.futures import ThreadPoolExecutor

    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.data.synthetic import synthesize_speech_like
    from audio2face_tpu_torch.ops import attention as attn_ops
    from audio2face_tpu_torch.ops import dsp
    from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    dev = torch.device("cuda")
    for r in rows:
        r["frame_launches"] = 0

    def add_frame_launches():
        for r in rows:
            r["frame_launches"] += read_count(r)

    # ---- 9a. the default configuration (config.yaml): Audio2Mesh, MFCC ----
    cfg = ExpConfig.from_yaml("config.yaml")  # PyYAML or the flat reader
    require(cfg.modelname == "audio2mesh" and cfg.feature_extractor == "mfcc" and cfg.bf16_compute
            and (cfg.sample_rate, cfg.n_feature, cfg.out_dim, cfg.win_length) == (22000, 32, 52, 440),
            f"config.yaml is not the default frame configuration: {cfg}")
    sr, n_v = cfg.sample_rate, cfg.vertex_count
    tic = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        speech = list(ex.map(lambda s_: synthesize_speech_like(60.0, sr, seed=s_), range(8)))
    print(f"8 x 60 s of synthetic speech: {time.perf_counter() - tic:.1f} s", flush=True)
    rng = np.random.default_rng(7)
    template = (rng.normal(size=(n_v // 3, 3)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[rng.integers(0, 12, 8)]
    a2m = FramePredictor(cfg, max_batch=8, frame_batch=128, seed=0)
    a2m([s_[:sr] for s_ in speech], one_hot, template)  # warm-up: the request's chunk shapes
    torch.cuda.synchronize()
    reset_counts(rows)
    tic = time.perf_counter()
    res = a2m(speech, one_hot, template)
    wall = time.perf_counter() - tic
    add_frame_launches()
    frames = sum(y.shape[0] for y in res)
    for a, y in zip(speech, res):
        require(y.shape == (len(a) * 60 // sr, n_v // 3, 3) and bool(np.isfinite(y).all()),
                f"frame request: shape {y.shape} or not finite")
    require(frames == 28800, f"frame request: {frames} frames")
    del res
    split = frame_request_split(torch, a2m, speech, one_hot, template)
    print(json.dumps({"frame_request": {
        "model": "audio2mesh", "extractor": "mfcc", "clips": 8, "seconds_each": 60, "frames": frames,
        "max_batch": 8, "frame_batch": 128, "wall_s": wall, "mesh_frames_per_s": frames / wall,
        "realtime_factor": 8 * 60.0 / wall, "split_replayed": split,
        "output_bytes": frames * n_v * 4, "card": smi,
    }}), flush=True)
    clips2 = [speech[0][: 10 * sr], speech[1][: int(7.5 * sr)]]
    frame_bf16_vs_f32(torch, cfg, a2m, clips2, one_hot[:2], template, "audio2mesh mfcc")
    del a2m, speech
    torch.cuda.empty_cache()

    # ---- 9b. VOCA and Song2Face (configs/), 2 clips x 10 s each ------------
    clips10 = [synthesize_speech_like(10.0, sr, seed=10 + i) for i in range(2)]
    for name in ("voca", "song2face"):
        cfg_m = ExpConfig.from_yaml(f"configs/{name}.yaml")
        require(cfg_m.modelname == name, f"configs/{name}.yaml names {cfg_m.modelname}")
        model = FramePredictor(cfg_m, max_batch=8, frame_batch=128, seed=1)
        model([c_[:sr] for c_ in clips10], one_hot[:2], template)  # warm-up
        torch.cuda.synchronize()
        reset_counts(rows)
        tic = time.perf_counter()
        res = model(clips10, one_hot[:2], template)
        wall = time.perf_counter() - tic
        add_frame_launches()
        require(all(y.shape == (600, n_v // 3, 3) for y in res), f"{name}: shapes {[y.shape for y in res]}")
        print(json.dumps({f"{name}_request": {
            "clips": 2, "seconds_each": 10, "frames": 1200, "wall_s": wall,
            "mesh_frames_per_s": 1200 / wall, "card": smi}}), flush=True)
        frame_bf16_vs_f32(torch, cfg_m, model, clips10, one_hot[:2], template, name)
        del model
    torch.cuda.empty_cache()

    # ---- 9c. the wav2vec2 extractor: K1 in f32 at the frame-window shape -----
    cfg_w = cfg.model_copy(update={"feature_extractor": "wav2vec"})
    w2v = FramePredictor(cfg_w, max_batch=8, frame_batch=128, seed=2)
    w2v([c_[:sr] for c_ in clips10], one_hot[:2], template)  # warm-up
    torch.cuda.synchronize()
    reset_counts(rows)
    tic = time.perf_counter()
    res = w2v(clips10, one_hot[:2], template)
    wall = time.perf_counter() - tic
    k1, k1f = by_name["flash_attention"], by_name["flash_attention_f32"]
    k1_path, k1f["launches"] = read_count(k1), read_count(k1f)
    add_frame_launches()
    require(all(y.shape == (600, n_v // 3, 3) and bool(np.isfinite(y).all()) for y in res),
            "wav2vec frame request: shapes or values")
    # 12 layers a chunk, 5 chunks of 2 x 128 frames, all in f32 (short-key path)
    require(k1_path == k1f["launches"] == 12 * 5,
            f"the wav2vec2 extractor launched K1 {k1_path} times, {k1f['launches']} in f32")
    require(all(read_count(r) == 0 for r in rows if r is not k1 and r is not k1f),
            "the wav2vec2 frame path launched a kernel other than K1")
    print(json.dumps({"wav2vec_frame_request": {
        "clips": 2, "seconds_each": 10, "frames": 1200, "wall_s": wall,
        "mesh_frames_per_s": 1200 / wall, "k1_launches": k1_path, "card": smi}}), flush=True)
    frame_bf16_vs_f32(torch, cfg_w, w2v, clips10, one_hot[:2], template, "audio2mesh wav2vec")
    del w2v, res
    torch.cuda.empty_cache()
    # the shape the path gives K1: (B * frame_batch, 12, T, 64), T = 25
    # positions of one 0.52 s window resampled to 16 kHz (8,320 samples);
    # the request above gave B = 2, a full batch of the grid gives 8
    t_w = 25
    g = torch.Generator().manual_seed(5)
    frame_window = {}
    for b in (2 * 128, 8 * 128):
        q, k, v = ((torch.randn(b, 12, t_w, 64, generator=g)).to(dev) for _ in range(3))
        out = attn_ops.flash_attention(q, k, v)
        ref = attn_ops.mha_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        rel = row_scaled_err(out, ref)
        entry = {"shape": [b, 12, t_w, 64], "dtype": "float32", "max_abs_err": err,
                 "max_err_over_row_max": rel, "tol_over_row_max": K1_F32_ROW_TOL}
        require(rel <= K1_F32_ROW_TOL and bool(torch.isfinite(out).all()),
                f"K1 f32 at {entry['shape']}: err {rel} of the row's largest |out| > {K1_F32_ROW_TOL}")
        if b == 8 * 128:
            entry["ms"] = cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v), 20)
            entry["plain_ms"] = cuda_ms(torch, lambda: attn_ops.mha_reference(q, k, v), 10)
            entry["library_ms"] = cuda_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 20)
            flops = 4.0 * b * 12 * t_w * t_w * 64
            nbytes = 4 * b * 12 * t_w * 64 * 4 + b * 12 * t_w * 4  # q, k, v read; out written; lse
            entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops / PEAK_F32_FLOPS)
        frame_window[str(b)] = entry
    print(json.dumps({"check": "flash_attention f32 at the frame-window shape", **frame_window}),
          flush=True)
    k1["frame_window_f32"] = frame_window
    del q, k, v, out, ref

    # ---- 9d. two Audio2Mesh training steps, checkpoint into the predictor --
    # batch 128 fragments (config.yaml's batch_size), bf16: the 128 frames of
    # one clip, gathered by the fragmenter
    n_clip = -(-128 * sr // 60)
    clip_t = torch.as_tensor(clips10[0][:n_clip], device=dev)
    frags = dsp.batched_audio_fragments(clip_t, torch.arange(128, device=dev), sample_rate=sr)
    motion = (rng.normal(size=(128, n_v)) * 0.002 + rng.normal(size=(1, n_v)) * 0.01).astype(np.float32)
    batch = {
        "audio": frags.cpu().numpy(),
        "one_hot": np.broadcast_to(one_hot[3], (128, 12)).copy(),
        "verts": motion + template.reshape(1, -1),
        "template_vert": np.broadcast_to(template, (128, n_v // 3, 3)).copy(),
    }
    exp = Audio2FaceExperiment(cfg.model_copy(update={"lr": 1e-3}), log_dir="build/chip_smoke_logs/frame")
    bn = exp.model.artic4_pre_bn.bn
    var_before = bn.running_var.clone()
    reset_counts(rows)
    step_s, losses = [], []
    with torch.enable_grad():
        for _ in range(2):
            tic = time.perf_counter()
            metrics = exp.train_step(batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - tic)
            losses.append(float(metrics["loss"]))
    add_frame_launches()
    require(all(math.isfinite(x) for x in losses), f"frame training losses {losses}")
    require(all(read_count(r) == 0 for r in rows), "the MFCC frame-model step launched a kernel")
    var_change = float((bn.running_var - var_before).abs().max())
    require(var_change > 0, "BatchNorm running variance did not change in train mode")
    path = exp.save_checkpoint(epoch=0)
    want, _ = exp.predict(batch)
    loaded = FramePredictor.from_checkpoint(path, cfg, max_batch=1, frame_batch=128)
    got = loaded([clips10[0][:n_clip]], one_hot[3:4], template)[0]
    diff = float(np.abs(got - want.cpu().numpy()).max())
    require(got.shape == (128, n_v // 3, 3) and diff <= FRAME_CHECKPOINT_TOL,
            f"FramePredictor.from_checkpoint vs the trainer's predict: {got.shape}, max |diff| {diff}")
    print(json.dumps({"frame_training": {
        "model": "audio2mesh", "batch": 128, "steps": 2, "step_wall_s": step_s, "losses": losses,
        "artic4_pre_bn_running_var_max_change": var_change,
        "checkpoint_vs_trainer_predict_max_abs": diff, "tol": FRAME_CHECKPOINT_TOL, "card": smi,
    }}), flush=True)
    del exp, loaded, batch, frags
    torch.cuda.empty_cache()

    # ---- 9e. FaceFormer checkpoints of the trainer into the predictor ------
    for r in rows:
        r["checkpoint_launches"] = 0
    rng_e = np.random.default_rng(8)
    audios16 = [(rng_e.normal(size=n_) * 0.1).astype(np.float32) for n_ in (160000, 120000)]
    one_e = np.eye(12, dtype=np.float32)[[4, 8]]
    for dataset, nv, direct in (("vocaset", pred.n_verts, pred), ("biwi", n_verts_biwi, None)):
        state = pred.model.state_dict() if direct is not None else biwi_state
        cfg_f = ExpConfig(batch_size=2, modelname="faceformer", one_hot_size=12, feature_extractor=None,
                          sample_rate=16000, vertex_count=nv, split_frame=False, n_feature=32,
                          out_dim=52, win_length=440, percision="16-mixed", dataset=dataset)
        exp = Audio2FaceExperiment(cfg_f, log_dir=f"build/chip_smoke_logs/ckpt_{dataset}")
        exp.model.load_state_dict(state)
        path = exp.save_checkpoint(epoch=0)
        del exp
        if direct is None:
            direct = FaceFormerPredictor(n_verts=nv, bf16=True, max_batch=8, dataset=dataset,
                                         state_dict=state)
        loaded = FaceFormerPredictor.from_checkpoint(path, n_verts=nv, bf16=True, max_batch=8)
        require(loaded.dataset == dataset, f"from_checkpoint detected {loaded.dataset}, not {dataset}")
        tmpl_e = (rng_e.normal(size=(nv // 3, 3)) * 0.1).astype(np.float32)
        want = direct(audios16, one_e, tmpl_e)
        reset_counts(rows)
        got = loaded(audios16, one_e, tmpl_e)
        for r in rows:
            r["checkpoint_launches"] += read_count(r)
        diff = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        print(json.dumps({"check": f"FaceFormer {dataset} trainer checkpoint -> from_checkpoint",
                          "max_abs_diff": diff, "frames": [y.shape[0] for y in got]}), flush=True)
        require(diff == 0.0, f"{dataset}: the checkpoint-loaded predictor differs by {diff}")
        del loaded, direct, got, want
        torch.cuda.empty_cache()
    for name in ("flash_attention", "fused_conv_encoder", "faceformer_decode_loop",
                 "faceformer_decode_loop_biwi"):
        require(by_name[name]["checkpoint_launches"] > 0,
                f"{name} did not launch on the checkpoint-loaded predictors")



# the live paths on the card: a pooled stream (batch 8) against its solo run
# (batch 1), a stream against its plain-version run and the single window
# against the offline predictor, all with the bf16 encoder. cuBLAS and cuDNN
# may pick other algorithms at another batch, the kernels round at other
# places than the plain versions, and the offline predictor decodes with
# bf16 weights (K3) where the stream's decoder step runs in f32; the decoder
# feeds each frame back into the next. The vertex offsets from the template
# are ~disp, so allow 5% of them: the bf16 predictor's bar of phase 4.
LIVE_BF16_SHARE = 0.05


def max_l2_and_bar(got: list, want: list, template) -> tuple[float, float, float]:
    """(max per-vertex L2 of got - want, max offset of want from the
    template, the bar LIVE_BF16_SHARE x that offset)."""
    l2 = max(float(np.linalg.norm(a - b, axis=-1).max()) for a, b in zip(got, want))
    disp = max(float(np.abs(b - template).max()) for b in want)
    return l2, disp, LIVE_BF16_SHARE * disp


# a pooled stream's tail against its solo run's: the pool pads its last
# window to the full width (zeros where the lookahead was) and masks it,
# the solo stream encodes the remainder without lookahead, so the last
# chunk's encoder windows differ (the bidirectional encoder's
# bounded-context approximation); tests/test_multistream.py's bar for the
# masked tail: 30% of the offsets
LIVE_TAIL_SHARE = 0.3


def pooled_vs_solo(got: list, want: list, clips: list, template, chunk: int, lookahead: int,
                   chunk_frames: int) -> dict:
    """Pooled streams against their solo runs: the frames of the chunks both
    emit from the same windows (every chunk emitted while chunk + lookahead
    samples were buffered) at LIVE_BF16_SHARE of the offsets, the tail at
    LIVE_TAIL_SHARE."""
    n_same = [max(0, (len(c) - lookahead) // chunk) * chunk_frames for c in clips]
    l2, disp, tol = max_l2_and_bar([g[:n] for g, n in zip(got, n_same)],
                                   [w[:n] for w, n in zip(want, n_same)], template)
    tail = max(float(np.linalg.norm(g[n:] - w[n:], axis=-1).max(initial=0.0))
               for g, w, n in zip(got, want, n_same))
    return {"same_window_frames": n_same, "max_vertex_l2": l2, "max_offset": disp, "tol": tol,
            "tail_max_vertex_l2": tail, "tail_tol": LIVE_TAIL_SHARE * disp}


def fit_through_prefetcher(torch, rows, exp, dm, label: str, smi: str) -> dict:
    """One epoch of ``exp.fit(dm)``, each training step timed (synchronized)
    and checked to receive its batch as CUDA tensors; the Prefetcher's
    copies (bytes, pinned sources, side-stream ms by CUDA events). Returns
    each kernel's launches in the training steps; adds the whole fit's
    (validation included) to ``data_launches``."""
    walls, on_card, train_counts = [], [], {r["name"]: 0 for r in rows}
    train_step = exp.train_step

    def timed(batch):
        on_card.append(all(isinstance(v, torch.Tensor) and v.is_cuda for v in batch.values()))
        before = {r["name"]: read_count(r) for r in rows}
        torch.cuda.synchronize()
        tic = time.perf_counter()
        metrics = train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tic)
        for r in rows:
            train_counts[r["name"]] += read_count(r) - before[r["name"]]
        return metrics

    exp.train_step = timed
    # the fit's own Prefetcher, with its copies' timing events recorded
    from audio2face_tpu_torch.training import trainer as trainer_module

    made, plain_prefetcher = [], trainer_module.Prefetcher

    class Recorded(plain_prefetcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, record=True, **kwargs)
            made.append(self)

    trainer_module.Prefetcher = Recorded
    reset_counts(rows)
    tic = time.perf_counter()
    try:
        with torch.enable_grad():
            _, result = exp.fit(dm, max_epochs=1, checkpoint=False)
        torch.cuda.synchronize()
    finally:
        trainer_module.Prefetcher = plain_prefetcher
    wall = time.perf_counter() - tic
    for r in rows:
        r["data_launches"] += read_count(r)
    require(len(made) == 1, f"{label}: fit made {len(made)} Prefetchers for one epoch")
    uploads = made[0].uploads
    copy_ms = made[0].upload_ms()
    hist = result.history[0]
    require(len(walls) == len(uploads) == hist["steps"] > 0 and all(on_card),
            f"{label}: {len(walls)} steps, {len(uploads)} uploads, {hist['steps']} in the history, "
            f"CUDA batches {on_card}")
    require(all(u["pinned"] for u in uploads), f"{label}: a batch was not copied from pinned memory")
    require(math.isfinite(hist["train/err"]) and math.isfinite(hist["val/err"]), f"{label}: {hist}")
    print(json.dumps({label: {
        "steps": hist["steps"], "step_wall_s": walls, "bytes_uploaded": [u["bytes"] for u in uploads],
        "copy_ms_side_stream": copy_ms, "fit_wall_s": wall, "train_err": hist["train/err"],
        "val_err": hist["val/err"], "train_launches": {k_: v_ for k_, v_ in train_counts.items() if v_},
        "card": smi,
    }}), flush=True)
    return train_counts


def synthetic_vocaset(root: str, smi: str) -> str:
    """10b's synthetic VOCASET, 12 subjects x 4 sentences x 2.0 s at 5,023
    vertices, written under ``root``; phases 10 and 12 share it."""
    from audio2face_tpu_torch.data.synthetic import generate_synthetic_vocaset

    tic = time.perf_counter()
    vdir = generate_synthetic_vocaset(os.path.join(root, "vocaset"), n_verts=5023,
                                      sentences_per_subject=2, seconds_per_sentence=2.0)
    print(json.dumps({"synthetic_vocaset": {
        "n_verts": 5023, "sentences_per_subject": "2 + 2 in the validation range",
        "seconds_each": 2.0, "generate_s": time.perf_counter() - tic,
        "data_verts_bytes": os.path.getsize(os.path.join(vdir, "data_verts.npy")), "card": smi,
    }}), flush=True)
    return vdir


def data_phases(torch, rows, smi, pred, biwi_state, n_verts_biwi, vdir: str) -> None:
    """10: the native loader against its numpy reference at the default
    configuration's shapes; one epoch of fit on the synthetic VOCASET at
    ``vdir`` for FaceFormer (clip batches) and Audio2Mesh (frame batches),
    every training batch through the Prefetcher; one BiwiDataModule batch
    through a BIWI training step. Records each kernel's launches as
    ``data_launches``."""
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.data.biwi import DEFAULT_TRAIN_SUBJECTS, BiwiDataModule, generate_synthetic_biwi
    from audio2face_tpu_torch.data.vocaset import VocaDataModule
    from audio2face_tpu_torch.runtime import (
        Prefetcher,
        build_native,
        fragment_batch_i16,
        fragment_batch_i16_reference,
        gather_rows_f32,
        gather_rows_f32_reference,
    )
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    dev = torch.device("cuda")
    for r in rows:
        r["data_launches"] = 0

    # ---- 10a. the native loader: g++ build, native == numpy reference ------
    tic = time.perf_counter()
    build_native()
    build_s = time.perf_counter() - tic
    rng = np.random.default_rng(10)
    sr, window, n_pad = 22000, 11440, 5720  # config.yaml: 0.52 s windows at 22 kHz
    clip = rng.integers(-32768, 32768, 60 * sr).astype(np.int16)
    frames = np.concatenate([[0, 3599], rng.integers(0, 3600, 126)])
    shifts = np.concatenate([[500, -500], rng.integers(-500, 501, 126)])
    starts = frames * sr // 60 - n_pad - shifts  # the first starts before the clip, the second runs past it
    native = fragment_batch_i16(clip, starts, window)
    ref = fragment_batch_i16_reference(clip, starts, window)
    require(native.shape == (128, window) and np.array_equal(native, ref),
            "the native fragmenter differs from its numpy reference")
    verts = rng.normal(size=(2000, 5023, 3)).astype(np.float32)
    idx = rng.integers(0, 2000, 128)
    rows_native = gather_rows_f32(verts, idx)
    require(np.array_equal(rows_native, gather_rows_f32_reference(verts, idx)),
            "the native row gather differs from its numpy reference")

    def host_ms(fn, reps=20):
        fn()
        tic_ = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - tic_) / reps

    print(json.dumps({"native_loader": {
        "build_s": build_s, "fragments": [128, window], "rows": [128, 5023, 3],
        "fragment_ms": host_ms(lambda: fragment_batch_i16(clip, starts, window)),
        "fragment_reference_ms": host_ms(lambda: fragment_batch_i16_reference(clip, starts, window)),
        "gather_ms": host_ms(lambda: gather_rows_f32(verts, idx)),
        "gather_reference_ms": host_ms(lambda: gather_rows_f32_reference(verts, idx)),
        "equal_to_reference": True, "host_cpus": os.cpu_count(), "card": smi,
    }}), flush=True)
    del clip, native, ref, verts, rows_native

    tmp = tempfile.mkdtemp(prefix="a2f_smoke_data_")
    try:
        # ---- 10b. the synthetic VOCASET: 12 subjects x 4 sentences x 2.0 s ----
        # FaceFormer at full width, bf16, clip batches of 8
        cfg_ff = ExpConfig(
            batch_size=8, modelname="faceformer", one_hot_size=12, feature_extractor=None,
            sample_rate=16000, vertex_count=pred.n_verts, split_frame=False, n_feature=32,
            out_dim=52, win_length=440, percision="16-mixed", lr=1e-4, seed=0,
        )
        dm = VocaDataModule(vdir, batch_size=8, split_frame=False)
        dm.setup()
        exp = Audio2FaceExperiment(cfg_ff, log_dir=os.path.join(tmp, "logs_faceformer"))
        exp.model.load_state_dict(pred.model.state_dict())
        require(exp.model.audio_encoder.config.attention_dropout > 0, "the training encoder has no attention dropout")
        counts = fit_through_prefetcher(torch, rows, exp, dm, "fit_faceformer_vocaset", smi)
        n_fwd, n_bwd = counts["flash_attention"], counts["flash_attention_bwd"]
        require(n_fwd > 0 and n_bwd == n_fwd, f"FaceFormer fit: K1 (dropout) {n_fwd}, K4 {n_bwd} launches")
        require(all(counts[n_] == 0 for n_ in ("fused_conv_encoder", "faceformer_decode_loop",
                                                "faceformer_decode_loop_biwi", "rasterize_keys")),
                f"an inference-only kernel was launched in a training step: {counts}")
        del exp, dm
        torch.cuda.empty_cache()

        # Audio2Mesh from config.yaml (MFCC, bf16), frame batches of 128
        cfg_a2m = ExpConfig.from_yaml("config.yaml")
        require(cfg_a2m.batch_size == 128 and cfg_a2m.split_frame, f"config.yaml: {cfg_a2m}")
        dm = VocaDataModule(vdir, batch_size=cfg_a2m.batch_size, split_frame=True)
        dm.setup()
        exp = Audio2FaceExperiment(cfg_a2m, log_dir=os.path.join(tmp, "logs_audio2mesh"))
        fit_through_prefetcher(torch, rows, exp, dm, "fit_audio2mesh_vocaset", smi)
        del exp, dm
        torch.cuda.empty_cache()

        # ---- 10c. one BiwiDataModule batch through a BIWI training step ------
        bdir = generate_synthetic_biwi(
            os.path.join(tmp, "biwi"), n_verts=n_verts_biwi // 3, subjects=("F2", "M3", "F1"),
            sentences=(1, 2, 33, 37), seconds_per_sentence=2.0,
        )
        # the phase-6 model takes a 12-wide one-hot: 12 of the corpus's subjects
        subjects = DEFAULT_TRAIN_SUBJECTS + ("F1", "F5", "F6", "F7", "F8", "M1")
        bdm = BiwiDataModule(bdir, batch_size=2, train_subjects=subjects)
        bdm.setup()
        cfg_biwi = ExpConfig(
            batch_size=2, modelname="faceformer", one_hot_size=12, feature_extractor=None,
            sample_rate=16000, vertex_count=n_verts_biwi, split_frame=False, n_feature=32,
            out_dim=52, win_length=440, percision="16-mixed", lr=1e-4, seed=0, dataset="biwi",
        )
        exp = Audio2FaceExperiment(cfg_biwi, log_dir=os.path.join(tmp, "logs_biwi"))
        exp.model.load_state_dict(biwi_state)
        with Prefetcher(bdm.train_batches(np.random.default_rng(0)), device=dev, record=True) as pf:
            batch = next(pf)
        require(all(v.is_cuda for v in batch.values()) and pf.uploads[0]["pinned"],
                "the BIWI batch did not arrive on the card from pinned memory")
        reset_counts(rows)
        tic = time.perf_counter()
        with torch.enable_grad():
            metrics = exp.train_step(batch)
            torch.cuda.synchronize()
        step_s = time.perf_counter() - tic
        for r in rows:
            r["data_launches"] += read_count(r)
        require(all(math.isfinite(float(v_)) for v_ in metrics.values()), f"BIWI data step: {metrics}")
        from audio2face_tpu_torch.ops import attention as attn_ops
        from audio2face_tpu_torch.ops import decode_kernel as dk

        require(attn_ops.flash_attention.launches > 0
                and attn_ops.flash_attention_bwd.launches == attn_ops.flash_attention.launches
                and dk.faceformer_decode_loop.biwi_launches == 0,
                "the BIWI data step did not run K1 and K4 alone")
        print(json.dumps({"biwi_data_step": {
            "batch": list(batch["audio"].shape), "frames": int(batch["verts"].shape[1]),
            "bytes_uploaded": pf.uploads[0]["bytes"], "step_wall_s": step_s,
            "loss": float(metrics["loss"]), "card": smi,
        }}), flush=True)
        del exp, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def window_kernel_readings(torch, rows, by_name, smi, stream, batch: int) -> dict:
    """K2 at (batch, window) and K1 at (batch, 12, T, 64), the shapes a
    streaming window gives them (no lengths, no kv_lengths), each against
    its plain version and timed beside its bound (and SDPA for K1): device
    time by the profiler (median of 5 windows of 20 calls), and CUDA events
    around back-to-back calls (``events_ms``, which the host's launch rate
    sets at these sizes)."""
    from audio2face_tpu_torch.models.faceformer import frame_count
    from audio2face_tpu_torch.ops import attention as attn_ops
    from audio2face_tpu_torch.ops import conv_encoder as ce

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(100 + batch)
    n = stream.left + stream.chunk + stream.lookahead
    x = (torch.randn(batch, n, generator=g)).to(dev)
    fe = stream.model.audio_encoder.feature_encoder
    kernels = [conv.weight.permute(2, 1, 0) for conv in fe.conv_layers]
    gscale, gbias = fe.group_norm.weight, fe.group_norm.bias
    out = ce.fused_conv_encoder(x, kernels, gscale, gbias)
    ref = ce.conv_encoder_reference(x, kernels, gscale, gbias)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 0.05 * ref.float().abs().max().item()  # phase 3b's bar
    require(out.shape == ref.shape and err <= tol and bool(torch.isfinite(out.float()).all()),
            f"K2 at ({batch}, {n}): err {err} > {tol}")
    t_l = (n - 10) // 5 + 1
    flops = 2.0 * batch * t_l * 10 * ce.C
    for kk, ss in zip(ce.CONV_KERNEL[1:], ce.CONV_STRIDE[1:]):
        t_l = (t_l - kk) // ss + 1
        flops += 2.0 * batch * t_l * kk * ce.C * ce.C
    w_bytes = 10 * ce.C * 4 + sum(kk * ce.C * ce.C * 2 for kk in ce.CONV_KERNEL[1:]) + 2 * ce.C * 4
    bms, bby = bound(batch * n * 4 + w_bytes + batch * t_l * ce.C * 2, flops / PEAK_BF16_FLOPS)
    # a call this short is timed by the profiler's device time (CUDA events
    # around back-to-back calls would time the host's launches)
    dev_ms, _ = profiled_ms(torch, lambda: ce.fused_conv_encoder(x, kernels, gscale, gbias), 20)
    k2 = {"shape": [batch, n], "rows_out": t_l, "max_abs_err": err, "tol": tol,
          "ms": float(np.median(dev_ms)),
          "events_ms": cuda_ms(torch, lambda: ce.fused_conv_encoder(x, kernels, gscale, gbias), 20),
          "plain_ms": float(np.median(profiled_ms(
              torch, lambda: ce.conv_encoder_reference(x, kernels, gscale, gbias), 5)[0])),
          "bound_ms": bms, "bound_by": bby, "library_ms": None, "card": smi}
    del x, out, ref

    t, h, d = frame_count(n), 12, 64
    q, k, v = (torch.randn(batch, h, t, d, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    out = attn_ops.flash_attention(q, k, v)
    ref = attn_ops.mha_reference(q, k, v)
    torch.cuda.synchronize()
    rel = row_scaled_err(out, ref)
    require(rel <= K1_BF16_ROW_TOL and bool(torch.isfinite(out.float()).all()),
            f"K1 at ({batch}, {h}, {t}, {d}): err {rel} of the row's largest |out| > {K1_BF16_ROW_TOL}")
    # q, k, v read and out written once; every pair's two products at the bf16 peak
    bms, bby = bound(4 * batch * h * t * d * 2, 4.0 * batch * h * t * t * d / PEAK_BF16_FLOPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms, sdpa_names = profiled_ms(torch, lambda: sdpa(q, k, v), 20)
    k1 = {"shape": [batch, h, t, d], "max_abs_err": (out.float() - ref.float()).abs().max().item(),
          "max_err_over_row_max": rel, "tol_over_row_max": K1_BF16_ROW_TOL,
          "ms": float(np.median(profiled_ms(torch, lambda: attn_ops.flash_attention(q, k, v), 20)[0])),
          "events_ms": cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v), 50),
          "plain_ms": float(np.median(profiled_ms(torch, lambda: attn_ops.mha_reference(q, k, v), 20)[0])),
          "bound_ms": bms, "bound_by": bby, "library_ms": float(np.median(sdpa_ms)),
          "library_events_ms": cuda_ms(torch, lambda: sdpa(q, k, v), 50),
          "library_backend": sdpa_backend(sdpa_names), "card": smi}
    print(json.dumps({f"window_kernels_batch_{batch}": {"K2": k2, "K1": k1}}), flush=True)
    by_name["fused_conv_encoder"].setdefault("window_readings", []).append(k2)
    by_name["flash_attention"].setdefault("window_readings", []).append(k1)
    return {"K2": k2, "K1": k1}


def chunk_profile(torch, push) -> dict:
    """One chunk's push under the profiler: its device launches (kernels,
    copies and memsets), their summed device time and the device's idle
    share of the push's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        got = push()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    events = [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    kernels = [e for e in events if "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    return {"frames": int(got.shape[0]), "device_launches": len(events), "kernel_launches": len(kernels),
            "device_busy_ms": busy, "wall_ms_profiled": 1e3 * wall,
            "idle_share": max(0.0, 1.0 - busy / (1e3 * wall))}


def live_phases(torch, rows, by_name, smi, pred) -> None:
    """11: the live serving front ends at full width (phase 4's bf16
    weights): (a) one stream, (b) an 8-slot pool, (c) the frame-model pool
    on config.yaml, (d) the HTTP and live daemons over loopback. Records
    each kernel's launches on the live paths as ``streaming_launches``."""
    import http.client
    import io
    import threading

    import scipy.io.wavfile as wavfile

    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.data.synthetic import synthesize_speech_like
    from audio2face_tpu_torch.frame_stream import FrameStreamPool
    from audio2face_tpu_torch.http_server import ServingDaemon, decode_audio_body
    from audio2face_tpu_torch.live_server import LiveClient, LiveStreamingDaemon
    from audio2face_tpu_torch.models.faceformer import frame_count
    from audio2face_tpu_torch.multistream import MultiStreamFaceFormerPredictor, StreamingServer
    from audio2face_tpu_torch.serving import FramePredictor
    from audio2face_tpu_torch.streaming import StreamingFaceFormerPredictor

    bf = torch.bfloat16
    n_verts, state = pred.n_verts, pred.model.state_dict()
    for r in rows:
        r["streaming_launches"] = 0

    def add_streaming_launches():
        for r in rows:
            r["streaming_launches"] += read_count(r)

    rng = np.random.default_rng(11)
    template = (rng.normal(size=(n_verts // 3, 3)) * 0.1).astype(np.float32)
    eye = np.eye(12, dtype=np.float32)
    speech = [synthesize_speech_like(12.0, 16000, seed=30 + i) for i in range(8)]

    def run_stream(stream, clip, one_hot, piece=4000, latencies=None):
        stream.start_stream(one_hot, template)
        outs = []
        for off in range(0, len(clip), piece):
            tic = time.perf_counter()
            got = stream.push(clip[off : off + piece])
            if got.size and latencies is not None:
                latencies.append(time.perf_counter() - tic)
            outs.append(got)
        outs.append(stream.flush())
        return np.concatenate(outs)

    # ---- 11a. one stream, default windows, 10 s in 0.25 s pieces -----------
    stream = StreamingFaceFormerPredictor(state_dict=state, n_verts=n_verts, dtype=bf)
    clip10 = speech[0][: 10 * 16000]
    run_stream(stream, clip10[: 4 * 16000], eye[0])  # warm: the window and tail shapes
    torch.cuda.synchronize()
    reset_counts(rows)
    lat = []
    tic = time.perf_counter()
    out = run_stream(stream, clip10, eye[0], latencies=lat)
    wall = time.perf_counter() - tic
    add_streaming_launches()
    require(out.shape == (600, n_verts // 3, 3) and bool(np.isfinite(out).all()),
            f"stream: shape {out.shape} or not finite")
    k1_c, k2_c = by_name["flash_attention"]["streaming_launches"], by_name["fused_conv_encoder"]["streaming_launches"]
    require(k1_c > 0 and k2_c > 0, f"the stream launched K1 {k1_c} and K2 {k2_c} times")
    # one chunk's launches and the device's idle share, by the profiler
    stream.start_stream(eye[0], template)
    stream.push(clip10[: stream.chunk + stream.lookahead - 4000])
    prof = chunk_profile(torch, lambda: stream.push(clip10[stream.chunk + stream.lookahead - 4000 :][:4000]))
    require(prof["frames"] == 60, f"the profiled push gave {prof['frames']} frames")
    plain = StreamingFaceFormerPredictor(state_dict=state, n_verts=n_verts, dtype=bf, use_kernels=False)
    want = run_stream(plain, clip10, eye[0])
    l2, disp, tol = max_l2_and_bar([out], [want], template)
    print(json.dumps({"stream": {
        "clip_s": 10.0, "piece_s": 0.25, "chunk_s": 1.0, "left_s": 2.0, "lookahead_s": 0.5,
        "window_samples": stream.left + stream.chunk + stream.lookahead,
        "chunks": len(lat), "chunk_latency_ms_median": 1e3 * float(np.median(lat)),
        "chunk_latency_ms_max": 1e3 * max(lat), "wall_s": wall, "realtime_factor": 10.0 / wall,
        "k1_launches": k1_c, "k2_launches": k2_c, "one_chunk_profiled": prof,
        # the profiler's own host cost lengthens the profiled push: the same
        # device time over the median unprofiled chunk as well
        "idle_share_unprofiled": max(0.0, 1.0 - prof["device_busy_ms"] / (1e3 * float(np.median(lat)))),
        "vs_plain_max_vertex_l2": l2, "max_offset": disp, "tol": tol, "card": smi,
    }}), flush=True)
    require(l2 <= tol, f"stream vs its plain-version run: max per-vertex L2 {l2} > {tol}")
    del plain
    # the single window over a grain-aligned clip against the offline predictor
    single = StreamingFaceFormerPredictor(state_dict=state, n_verts=n_verts, dtype=bf,
                                          chunk_seconds=5.0, left_seconds=0.0, lookahead_seconds=0.0)
    clip5 = speech[1][: 5 * 16000]
    single.start_stream(eye[3], template)
    got = single.push(clip5, last=True)
    want = pred([clip5], eye[[3]], template)[0]
    l2, disp, tol = max_l2_and_bar([got], [want], template)
    print(json.dumps({"check": "single-window stream vs the offline predictor, 5 s, bf16",
                      "max_vertex_l2": l2, "max_offset": disp, "tol": tol, "card": smi}), flush=True)
    require(got.shape == want.shape and l2 <= tol, f"single window vs offline: {l2} > {tol}")
    del single
    window_kernel_readings(torch, rows, by_name, smi, stream, 1)
    del stream
    torch.cuda.empty_cache()

    # ---- 11b. an 8-slot pool: 8 streams of 4-12 s, one late joiner ---------
    secs = [4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 12.0]
    clips = [speech[i][: int(s_ * 16000)] for i, s_ in enumerate(secs)]
    pool = MultiStreamFaceFormerPredictor(state_dict=state, n_verts=n_verts, n_streams=8, dtype=bf)
    warm = pool.open_stream(eye[0], template)  # warm: the pool's one step shape
    pool.push(warm, clips[0][: 4 * 16000], last=True)
    pool.close_stream(warm)
    torch.cuda.synchronize()
    step_s = []
    step = pool._step

    def timed_step():
        tic_ = time.perf_counter()
        step()
        step_s.append(time.perf_counter() - tic_)

    pool._step = timed_step
    reset_counts(rows)
    tic = time.perf_counter()
    slots = {i: pool.open_stream(eye[i], template) for i in range(7)}
    got = {i: [] for i in range(8)}
    offs = [0] * 8
    piece = 4000
    while any(offs[i] < len(c) for i, c in enumerate(clips)):
        for i, c in enumerate(clips):
            if i == 7 and 7 not in slots:
                if offs[0] < 3 * 16000:
                    continue
                slots[7] = pool.open_stream(eye[7], template)  # joins 3 s late
            if offs[i] < len(c):
                j = min(offs[i] + piece, len(c))
                got[i].append(pool.push(slots[i], c[offs[i]:j], last=j == len(c)))
                offs[i] = j
    for i in range(8):
        got[i].append(pool.poll(slots[i]))
        pool.close_stream(slots[i])
    wall = time.perf_counter() - tic
    add_streaming_launches()
    outs = [np.concatenate(got[i]) for i in range(8)]
    for c, o in zip(clips, outs):
        require(o.shape == (frame_count(len(c)), n_verts // 3, 3) and bool(np.isfinite(o).all()),
                f"pool: shape {o.shape} or not finite")
    solo_pred = StreamingFaceFormerPredictor(state_dict=state, n_verts=n_verts, dtype=bf)
    solos = [run_stream(solo_pred, c, eye[i]) for i, c in enumerate(clips)]
    vs_solo = pooled_vs_solo(outs, solos, clips, template, pool.chunk, pool.lookahead, pool.chunk_frames)
    frames = sum(o.shape[0] for o in outs)
    print(json.dumps({"pool": {
        "streams": 8, "seconds": secs, "late_joiner_after_s": 3.0, "piece_s": 0.25,
        "steps": len(step_s), "step_latency_ms_median": 1e3 * float(np.median(step_s)),
        "step_latency_ms_max": 1e3 * max(step_s), "wall_s": wall, "frames": frames,
        "mesh_frames_per_s": frames / wall, "realtime_factor_per_stream": 1.0 / float(np.median(step_s)),
        "realtime_factor_all_streams": sum(secs) / wall, "vs_solo": vs_solo, "card": smi,
    }}), flush=True)
    require(vs_solo["max_vertex_l2"] <= vs_solo["tol"] and vs_solo["tail_max_vertex_l2"] <= vs_solo["tail_tol"],
            f"pool vs solo streams: {vs_solo}")
    window_kernel_readings(torch, rows, by_name, smi, solo_pred, 8)
    del pool, solo_pred
    torch.cuda.empty_cache()

    # ---- 11c. the frame-model pool: config.yaml (Audio2Mesh, MFCC), 8 streams
    cfg = ExpConfig.from_yaml("config.yaml")
    sr = cfg.sample_rate
    offline = FramePredictor(cfg, max_batch=8, frame_batch=128, seed=0)
    fpool = FrameStreamPool(cfg, state_dict=offline.model.state_dict(), n_streams=8)
    fclips = [synthesize_speech_like(s_, sr, seed=50 + i) for i, s_ in enumerate(secs)]
    reset_counts(rows)
    tic = time.perf_counter()
    fslots = [fpool.open_stream(eye[i], template) for i in range(8)]
    fgot = [[] for _ in range(8)]
    offs = [0] * 8
    piece = int(0.1 * sr)
    while any(offs[i] < len(c) for i, c in enumerate(fclips)):
        for i, c in enumerate(fclips):
            if offs[i] < len(c):
                j = min(offs[i] + piece, len(c))
                fgot[i].append(fpool.push(fslots[i], c[offs[i]:j], last=j == len(c)))
                offs[i] = j
    fouts = [np.concatenate(g_ + [fpool.poll(s_)]) for g_, s_ in zip(fgot, fslots)]
    wall = time.perf_counter() - tic
    add_streaming_launches()
    fwant = offline(fclips, eye[:8], template)
    l2, disp, tol = max_l2_and_bar(fouts, fwant, template)
    frames = sum(o.shape[0] for o in fouts)
    print(json.dumps({"frame_pool": {
        "model": "audio2mesh", "streams": 8, "seconds": secs, "piece_s": 0.1, "frame_batch": fpool.fb,
        "steps": fpool.steps, "wall_s": wall, "frames": frames, "mesh_frames_per_s": frames / wall,
        "vs_offline_max_vertex_l2": l2, "max_offset": disp, "tol": tol, "card": smi,
    }}), flush=True)
    require(all(o.shape == w.shape for o, w in zip(fouts, fwant)) and l2 <= tol,
            f"frame pool vs offline: max per-vertex L2 {l2} > {tol}")
    del fpool, offline
    torch.cuda.empty_cache()

    # ---- 11d. the daemons over loopback -------------------------------------
    daemon = ServingDaemon(pred, template, port=0, max_wait_ms=50.0, max_queue=64)
    daemon.start()
    live = None
    try:
        conn = http.client.HTTPConnection("127.0.0.1", daemon.port, timeout=300)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        require(health["backend"] == "cuda", f"/healthz: {health}")
        bodies = []
        for i in range(8):
            buf = io.BytesIO()
            wavfile.write(buf, 16000, (speech[i][: 5 * 16000] * 32767).astype(np.int16))
            bodies.append(buf.getvalue())

        def post(body, subject):
            c = http.client.HTTPConnection("127.0.0.1", daemon.port, timeout=300)
            c.request("POST", f"/v1/infer?subject={subject}", body=body,
                      headers={"Content-Type": "audio/wav"})
            r = c.getresponse()
            data = r.read()
            c.close()
            return r.status, data

        post(bodies[0], 0)  # warm
        before = daemon.stats()
        results, lat = [None] * 8, [0.0] * 8

        def client(i):
            tic_ = time.perf_counter()
            results[i] = post(bodies[i], i)
            lat[i] = time.perf_counter() - tic_

        reset_counts(rows)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        tic = time.perf_counter()
        for t_ in threads:
            t_.start()
        for t_ in threads:
            t_.join(timeout=600)
        wall = time.perf_counter() - tic
        add_streaming_launches()
        after = daemon.stats()
        batches = after["batches"] - before["batches"]
        require(all(r_ is not None and r_[0] == 200 for r_ in results), "an HTTP request failed")
        require(after["ok"] - before["ok"] == 8 and 0 < batches < 8,
                f"/stats: {after['ok'] - before['ok']} answered in {batches} batches")
        got = [np.load(io.BytesIO(r_[1])) for r_ in results]
        want = []
        for i in range(8):
            wav, wsr = decode_audio_body(bodies[i], "audio/wav", None)
            want.append(pred([wav], eye[[i]], template, sample_rate=wsr)[0])
        l2, disp, tol = max_l2_and_bar(got, want, template)
        print(json.dumps({"http_daemon": {
            "requests": 8, "seconds_each": 5.0, "batches": batches, "wall_s": wall,
            "requests_per_s": 8 / wall, "latency_ms_p50": 1e3 * float(np.percentile(lat, 50)),
            "latency_ms_p90": 1e3 * float(np.percentile(lat, 90)), "healthz": health,
            "vs_direct_max_vertex_l2": l2, "max_offset": disp, "tol": tol, "card": smi,
        }}), flush=True)
        require(l2 <= tol, f"HTTP results vs direct calls: max per-vertex L2 {l2} > {tol}")

        live = LiveStreamingDaemon(
            server=StreamingServer(state_dict=state, n_verts=n_verts, n_streams=2, dtype=bf),
            template=template, idle_poll_ms=20.0,
        )
        live.start()
        lclips = [speech[2][: 5 * 16000], speech[3][: 5 * 16000]]
        lout, lerr = [None, None], []

        def live_client(i):
            try:
                with LiveClient(live.port, subject=i, sample_rate=16000, timeout=30.0) as c:
                    parts = [c.send(lclips[i][off : off + 4000]) for off in range(0, len(lclips[i]), 4000)]
                    lout[i] = np.concatenate(parts + [c.finish()])
            except Exception as e:  # reported below
                lerr.append(repr(e))

        reset_counts(rows)
        threads = [threading.Thread(target=live_client, args=(i,)) for i in range(2)]
        tic = time.perf_counter()
        for t_ in threads:
            t_.start()
        for t_ in threads:
            t_.join(timeout=600)
        wall = time.perf_counter() - tic
        add_streaming_launches()
        require(not lerr and all(o is not None for o in lout), f"live clients: {lerr}")
        solo_pred = StreamingFaceFormerPredictor(state_dict=state, n_verts=n_verts, dtype=bf)
        lwant = [run_stream(solo_pred, c, eye[i]) for i, c in enumerate(lclips)]
        require(all(o.shape == w.shape for o, w in zip(lout, lwant)),
                f"live daemon: {[o.shape for o in lout]} frames against {[w.shape for w in lwant]}")
        vs_solo = pooled_vs_solo(lout, lwant, lclips, template, solo_pred.chunk, solo_pred.lookahead, 60)
        print(json.dumps({"live_daemon": {
            "clients": 2, "seconds_each": 5.0, "wall_s": wall, "frames": [o.shape[0] for o in lout],
            "stats": live.stats(), "vs_solo": vs_solo, "card": smi,
        }}), flush=True)
        require(vs_solo["max_vertex_l2"] <= vs_solo["tol"] and vs_solo["tail_max_vertex_l2"] <= vs_solo["tail_tol"],
                f"live daemon vs solo streams: {vs_solo}")
    finally:
        if live is not None:
            live.stop()
        daemon.stop()
    for name in ("flash_attention", "fused_conv_encoder"):
        require(by_name[name]["streaming_launches"] > 0, f"{name} did not launch on the live paths")
    require(by_name["flash_attention_bwd"]["streaming_launches"] == 0, "a backward kernel ran while serving live")


# the checkpoint sweep through the kernels against the same sweep through the
# plain versions (same checkpoint, same sentences): per sentence, the
# predictions within phase 4's bf16 bar (LIVE_BF16_SHARE of the vertex
# offsets from the template, delta); each mean metric within what delta
# moves it by: MVE and max-L2 are distances (delta), LVE a squared distance
# (delta (2 M + delta), M the largest distance), FDD a std of squared
# offsets (delta (2 R + delta), R the largest offset)
# evaluate_animation on the card (f32) against the float64 numpy formulas on
# the same arrays: relative error of each metric; FDD, a difference of two
# means, is taken relative to the size of the terms (mean dyn(pred) + dyn(gt))
METRIC_F64_RTOL = 1e-5
# the exported checkpoint reloaded against the trainer's: each weight within
# 1e-6 of its tensor's largest |value| (the positional conv's weight norm is
# re-derived and folded again); f32 predictions within 1e-5 per-vertex L2
EXPORT_WEIGHT_RTOL = 1e-6
EXPORT_VERTEX_L2 = 1e-5


def metrics_f64(pred, gt, template, lip, upper, mask) -> tuple[dict, float]:
    """LVE, FDD, MVE and max-L2 of one masked clip in float64 numpy, from the
    formulas of ``evaluation.py``'s docstring (pred, gt (T, V, 3), template
    (V, 3), mask (T,)); and FDD's scale, mean dyn(pred) + dyn(gt)."""
    p, g, t = (np.asarray(a, np.float64) for a in (pred, gt, template))
    m = np.asarray(mask, np.float64)
    n = m.sum()
    d2 = ((p - g) ** 2).sum(-1)  # (T, V)
    d = np.sqrt(d2)

    def dyn(z):
        a = ((z[:, upper] - t[upper]) ** 2).sum(-1)  # (T, Vu)
        mu = (a * m[:, None]).sum(0) / n
        return np.sqrt((((a - mu) ** 2) * m[:, None]).sum(0) / n)

    dp, dg = dyn(p), dyn(g)
    return {
        "lve": float((d2[:, lip].max(1) * m).sum() / n),
        "fdd": float((dp - dg).mean()),
        "mve": float((d * m[:, None]).sum() / (n * d.shape[1])),
        "max_l2": float((d * m[:, None]).max()),
    }, float((dp + dg).mean())


def run_cli(main_fn, argv: list) -> str:
    """A CLI's ``main(argv)`` in this process; its standard output, echoed."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main_fn(argv)
    text = out.getvalue()
    sys.stdout.write(text)
    sys.stdout.flush()
    return text


def cli_phases(torch, rows, by_name, smi, vdir: str) -> None:
    """12: the command lines at full width on the card, on 10b's synthetic
    VOCASET: (a) ``cli.train`` (configs/faceformer.yaml, batch 8, one epoch,
    --skip-render), (b) the ``cli.evaluate`` sweep over the test split, and
    the same sweep through the plain versions, (c) ``cli.evaluate`` diff of
    the saved prediction, (d) ``cli.export`` reloaded by
    ``from_torch_checkpoint``, (e) ``cli.serve`` as a subprocess with
    ``--live-port``. Records each kernel's in-process launches as
    ``cli_launches``."""
    import http.client
    import io
    import socket
    import threading

    import scipy.io.wavfile as wavfile

    from audio2face_tpu_torch import evaluation as E
    from audio2face_tpu_torch.cli import evaluate as cli_evaluate
    from audio2face_tpu_torch.cli import export as cli_export
    from audio2face_tpu_torch.cli import train as cli_train
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.data.synthetic import generate_synthetic_face_obj, synthesize_speech_like
    from audio2face_tpu_torch.data.vocaset import VocaDataModule
    from audio2face_tpu_torch.http_server import decode_audio_body
    from audio2face_tpu_torch.live_server import LiveClient
    from audio2face_tpu_torch.serving import FaceFormerPredictor
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment
    from audio2face_tpu_torch.utils.facemesh import FaceMesh, save_obj

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg_path = os.path.join(repo, "configs", "faceformer.yaml")
    config = ExpConfig.from_yaml(cfg_path).apply_faceformer_overrides()
    n_verts = config.vertex_count
    for r in rows:
        r["cli_launches"] = 0

    def add_cli_launches() -> dict:
        counts = {r["name"]: read_count(r) for r in rows}
        for r in rows:
            r["cli_launches"] += counts[r["name"]]
        return {k_: v_ for k_, v_ in counts.items() if v_}

    work = tempfile.mkdtemp(prefix="a2f_smoke_cli_")
    cwd = os.getcwd()
    os.chdir(work)  # the CLIs' default log dir: logs/<config name> under the working directory
    try:
        # ---- 12a. cli.train: one epoch at batch 8, then predict and score ----
        step_counts = {r["name"]: 0 for r in rows}
        plain_step = Audio2FaceExperiment.train_step

        def counted_step(self, batch):
            before = {r["name"]: read_count(r) for r in rows}
            out = plain_step(self, batch)
            for r in rows:
                step_counts[r["name"]] += read_count(r) - before[r["name"]]
            return out

        Audio2FaceExperiment.train_step = counted_step
        reset_counts(rows)
        tic = time.perf_counter()
        try:
            with torch.enable_grad():
                out = run_cli(cli_train.main, [
                    "--config", cfg_path, "--dataset-path", vdir, "--max-epochs", "1",
                    "--batch-size", "8", "--skip-render", "--device", "cuda"])
            torch.cuda.synchronize()
        finally:
            Audio2FaceExperiment.train_step = plain_step
        wall = time.perf_counter() - tic
        launches = add_cli_launches()
        log_dir = os.path.join(work, "logs", config.name())
        epoch_rows = [json.loads(l_) for l_ in open(os.path.join(log_dir, "metrics.jsonl"))
                      if "val/err" in l_]
        lines = out.splitlines()
        printed = [l_ for l_ in lines if l_.startswith("predict metrics: ")]
        require(len(printed) == 1 and len(epoch_rows) == 1, "cli.train printed no metrics")
        metrics = {k_: float(v_) for k_, v_ in
                   (kv.split("=") for kv in printed[0][len("predict metrics: "):].split())}
        rec = [float(l_.split(": ")[1]) for l_ in lines if l_.startswith("predict_rec_loss: ")]
        pred_verts = np.load(os.path.join(log_dir, "pred_verts.npy"))
        n_fwd, n_bwd = step_counts["flash_attention"], step_counts["flash_attention_bwd"]
        steps = epoch_rows[0]["steps"]
        print(json.dumps({"cli_train": {
            "config": "configs/faceformer.yaml", "batch": 8, "wall_s": wall, "steps": steps,
            "k1_step_launches": n_fwd, "k4_step_launches": n_bwd, "launches": launches,
            "predict_rec_loss": rec, "metrics": metrics, "pred_verts": list(pred_verts.shape),
            "card": smi,
        }}), flush=True)
        require(steps > 0 and n_fwd > 0 and n_bwd == n_fwd,
                f"cli.train: {steps} steps, K1 {n_fwd} and K4 {n_bwd} launches in the steps")
        require(len(rec) == 1 and math.isfinite(rec[0]) and all(math.isfinite(v_) for v_ in metrics.values()),
                f"cli.train: predict_rec_loss {rec}, metrics {metrics}")
        require(pred_verts.ndim == 3 and pred_verts.shape[1:] == (n_verts // 3, 3)
                and bool(np.isfinite(pred_verts).all()), f"pred_verts.npy {pred_verts.shape}")
        ckpt_names = sorted((c for c in os.listdir(os.path.join(log_dir, "checkpoints"))
                             if not c.endswith(".tmp")), key=lambda x: int(x.split("=")[-1]))
        trainer_ckpt = os.path.join(log_dir, "checkpoints", ckpt_names[-1])

        # ---- 12b. cli.evaluate: the checkpoint sweep over the test split ------
        recorded: list = []
        plain_predict = Audio2FaceExperiment.predict

        def timed_predict(self, batch):
            torch.cuda.synchronize()
            tic_ = time.perf_counter()
            pred_, err_ = plain_predict(self, batch)
            torch.cuda.synchronize()
            recorded.append({"s": time.perf_counter() - tic_, "batch": batch, "pred": pred_,
                             "frames": int(batch["frame_lengths"][0])})
            return pred_, err_

        Audio2FaceExperiment.predict = timed_predict
        try:
            reset_counts(rows)
            out = run_cli(cli_evaluate.main, ["--config", cfg_path, "--dataset-path", vdir,
                                              "--device", "cuda"])
            torch.cuda.synchronize()
            launches = add_cli_launches()
            swept = recorded[:]
            sweep = json.loads(out.strip().splitlines()[-1])["metrics"]
            # the same sweep through the plain versions on the card
            recorded.clear()
            dm = VocaDataModule(vdir, batch_size=1, split_frame=False)
            dm.setup()
            plain_exp = Audio2FaceExperiment(config, log_dir=log_dir, use_kernels=False)
            plain_exp.load_checkpoint(trainer_ckpt)
            reset_counts(rows)
            plain_sweep = plain_exp.evaluate(dm)
            require(all(read_count(r) == 0 for r in rows), "the plain sweep launched a kernel")
            plain_recorded = recorded[:]
        finally:
            Audio2FaceExperiment.predict = plain_predict
        del plain_exp
        n_sent = sweep["n_sentences"]
        print(json.dumps({"cli_evaluate_sweep": {
            "metrics": sweep, "sentence_s": [r_["s"] for r_ in swept],
            "frames": [r_["frames"] for r_ in swept],
            "frames_per_s": [r_["frames"] / r_["s"] for r_ in swept], "launches": launches,
            "card": smi,
        }}), flush=True)
        require(n_sent == len(swept) == len(plain_recorded) > 0
                and all(math.isfinite(sweep[k_]) for k_ in E.METRICS + ("err",)),
                f"cli.evaluate sweep: {sweep}")
        for name in ("flash_attention", "fused_conv_encoder", "faceformer_decode_loop"):
            require(launches.get(name, 0) > 0, f"the sweep did not launch {name}")
        l2s, disps, largest, offset = [], [], 0.0, 0.0
        for k_run, p_run in zip(swept, plain_recorded):
            n = k_run["frames"]
            got = k_run["pred"][0, :n].float().cpu().numpy()
            want = p_run["pred"][0, :n].float().cpu().numpy()
            tmpl = np.asarray(k_run["batch"]["template_vert"], np.float32)[0]
            gt = np.asarray(k_run["batch"]["verts"], np.float32).reshape(-1, n_verts // 3, 3)[:n]
            l2s.append(float(np.linalg.norm(got - want, axis=-1).max()))
            disps.append(float(np.abs(want - tmpl).max()))
            largest = max(largest, float(np.linalg.norm(got - gt, axis=-1).max()),
                          float(np.linalg.norm(want - gt, axis=-1).max()))
            offset = max(offset, float(np.linalg.norm(got - tmpl, axis=-1).max()),
                         float(np.linalg.norm(want - tmpl, axis=-1).max()))
        delta = LIVE_BF16_SHARE * max(disps)
        bars = {"mve": delta, "max_l2": delta, "lve": delta * (2 * largest + delta),
                "fdd": delta * (2 * offset + delta)}
        diffs = {k_: abs(sweep[k_] - plain_sweep[k_]) for k_ in bars}
        print(json.dumps({"check": "cli.evaluate sweep, kernels vs plain",
                          "max_vertex_l2": max(l2s), "vertex_tol": delta, "metric_diff": diffs,
                          "metric_tol": bars, "plain_metrics": plain_sweep}), flush=True)
        require(max(l2s) <= delta and all(diffs[k_] <= bars[k_] for k_ in bars),
                f"sweep kernels vs plain: L2 {max(l2s)} (bar {delta}), metrics {diffs} (bars {bars})")

        # evaluate_animation on the card against float64 numpy, one sentence
        first = swept[0]
        b0 = first["batch"]
        t_pad = first["pred"].shape[1]
        gt0 = np.asarray(b0["verts"], np.float32).reshape(1, t_pad, n_verts // 3, 3)
        tmpl0 = np.asarray(b0["template_vert"], np.float32)
        mask0 = (np.arange(t_pad)[None] < first["frames"]).astype(np.float32)
        regions = E.infer_regions(tmpl0[0])
        got = E.evaluate_animation(first["pred"], gt0, tmpl0[:, None], regions, frame_mask=mask0)
        want, fdd_scale = metrics_f64(first["pred"][0].float().cpu().numpy(), gt0[0], tmpl0[0],
                                      regions.lip, regions.upper, mask0[0])
        rel = {k_: abs(got[k_] - want[k_]) / (fdd_scale if k_ == "fdd" else abs(want[k_]))
               for k_ in want}
        print(json.dumps({"check": "evaluate_animation on the card vs float64 numpy",
                          "frames": first["frames"], "rel_err": rel, "tol": METRIC_F64_RTOL}),
              flush=True)
        require(max(rel.values()) <= METRIC_F64_RTOL, f"evaluate_animation vs float64: {rel}")

        # ---- 12c. cli.evaluate: diff of the saved prediction -------------------
        pred_pair = [l_ for l_ in lines if l_.startswith("predict subject not in test split; using ")]
        subject, sentence = ("FaceTalk_170908_03277_TA", "sentence02") if not pred_pair else \
            pred_pair[0].rsplit(" ", 1)[1].split("/")
        batch = dm.predict_batch(subject, sentence)
        n = int(batch["frame_lengths"][0])
        gt_path, obj_path = os.path.join(work, "gt_verts.npy"), os.path.join(work, "template.obj")
        np.save(gt_path, np.asarray(batch["verts"], np.float32).reshape(-1, n_verts // 3, 3)[:n])
        faces = FaceMesh.load(generate_synthetic_face_obj(os.path.join(work, "face.obj"),
                                                          n_verts=n_verts // 3)).faces
        save_obj(obj_path, np.asarray(batch["template_vert"])[0], faces)
        reset_counts(rows)
        out = run_cli(cli_evaluate.main, ["--pred", os.path.join(log_dir, "pred_verts.npy"),
                                          "--gt", gt_path, "--template", obj_path, "--device", "cuda"])
        diff = json.loads(out.strip().splitlines()[-1])["metrics"]
        pair = list(dict.fromkeys((r_[0], r_[1]) for r_ in dm.test_dataset.datalist))
        k_run = swept[pair.index((subject, sentence))]
        t_pad = k_run["pred"].shape[1]
        mask = (np.arange(t_pad)[None] < n).astype(np.float32)
        sweep_l2 = E.evaluate_animation(
            k_run["pred"], np.asarray(batch["verts"], np.float32).reshape(1, t_pad, n_verts // 3, 3),
            np.asarray(batch["template_vert"], np.float32)[:, None], regions, frame_mask=mask)["max_l2"]
        print(json.dumps({"cli_evaluate_diff": {
            "sentence": f"{subject}/{sentence}", "metrics": diff, "sweep_max_l2": sweep_l2,
            "card": smi}}), flush=True)
        require(diff["n_frames"] == n and abs(diff["max_l2"] - sweep_l2) <= 1e-6 * sweep_l2,
                f"diff mode max_l2 {diff['max_l2']} vs the sweep's {sweep_l2} ({diff['n_frames']} frames)")
        del swept, plain_recorded, recorded[:]

        # ---- 12d. cli.export, reloaded by from_torch_checkpoint ----------------
        out_ckpt = os.path.join(work, "faceformer.ckpt")
        out = run_cli(cli_export.main, ["--config", cfg_path, "--out", out_ckpt])
        require(out.startswith("exported faceformer step "), f"cli.export: {out}")
        reset_counts(rows)
        exported = FaceFormerPredictor.from_torch_checkpoint(out_ckpt, n_verts=n_verts, bf16=False)
        trained = FaceFormerPredictor.from_checkpoint(trainer_ckpt, n_verts=n_verts, bf16=False)
        sd_e, sd_t = exported.model.state_dict(), trained.model.state_dict()
        require(set(sd_e) == set(sd_t), "the exported checkpoint loads other tensors")
        w_err = max(float((sd_e[k_] - v_).abs().max()) / max(float(v_.abs().max()), 1e-30)
                    for k_, v_ in sd_t.items())
        clips = [synthesize_speech_like(3.0, 16000, seed=40), synthesize_speech_like(4.5, 16000, seed=41)]
        one_hot = np.eye(12, dtype=np.float32)[[2, 9]]
        tmpl = np.asarray(FaceMesh.load(obj_path).verts, np.float32)
        got, want = exported(clips, one_hot, tmpl), trained(clips, one_hot, tmpl)
        torch.cuda.synchronize()
        launches = add_cli_launches()
        l2 = max(float(np.linalg.norm(a - b, axis=-1).max()) for a, b in zip(got, want))
        print(json.dumps({"cli_export": {
            "bytes": os.path.getsize(out_ckpt), "weight_rel_err": w_err, "weight_tol": EXPORT_WEIGHT_RTOL,
            "f32_max_vertex_l2": l2, "vertex_tol": EXPORT_VERTEX_L2, "launches": launches, "card": smi,
        }}), flush=True)
        require(w_err <= EXPORT_WEIGHT_RTOL and l2 <= EXPORT_VERTEX_L2,
                f"exported checkpoint: weights {w_err}, predictions {l2}")
        del exported, trained, sd_e, sd_t
        torch.cuda.empty_cache()

        # ---- 12e. cli.serve as a subprocess: two POSTs, /stats, a live session --
        def free_port() -> int:
            with socket.socket() as s_:
                s_.bind(("127.0.0.1", 0))
                return s_.getsockname()[1]

        port, live_port = free_port(), free_port()
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        serve_log = os.path.join(work, "serve.log")
        log_f = open(serve_log, "w")
        tic = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "audio2face_tpu_torch.cli.serve", "--template", obj_path,
             "--checkpoint", trainer_ckpt, "--port", str(port), "--warmup-seconds", "10",
             "--live-port", str(live_port), "--device", "cuda"],
            cwd=repo, env=env, stdout=log_f, stderr=subprocess.STDOUT)
        try:
            health = None
            while health is None:
                require(proc.poll() is None and time.perf_counter() - tic < 300,
                        "cli.serve exited or did not bind in 300 s:\n" + open(serve_log).read()[-3000:])
                try:
                    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                    c.request("GET", "/healthz")
                    health = json.loads(c.getresponse().read())
                    c.close()
                except OSError:
                    time.sleep(0.5)
            ready_s = time.perf_counter() - tic
            require(health["backend"] == "cuda", f"/healthz: {health}")
            bodies = []
            for i in range(2):
                buf = io.BytesIO()
                wav = synthesize_speech_like(5.0, 16000, seed=50 + i)
                wavfile.write(buf, 16000, (wav * 32767).astype(np.int16))
                bodies.append(buf.getvalue())
            results, lat = [None, None], [0.0, 0.0]

            def post(i):
                tic_ = time.perf_counter()
                c_ = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                c_.request("POST", f"/v1/infer?subject={i}", body=bodies[i],
                           headers={"Content-Type": "audio/wav"})
                r_ = c_.getresponse()
                results[i] = (r_.status, r_.read())
                c_.close()
                lat[i] = time.perf_counter() - tic_

            threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
            for t_ in threads:
                t_.start()
            for t_ in threads:
                t_.join(timeout=300)
            require(all(r_ is not None and r_[0] == 200 for r_ in results), "a POST to cli.serve failed")
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("GET", "/stats")
            stats = json.loads(c.getresponse().read())
            c.close()
            require(stats["ok"] == 2 and "live" in stats, f"/stats: {stats}")
            got = [np.load(io.BytesIO(r_[1])) for r_ in results]
            direct = FaceFormerPredictor.from_checkpoint(trainer_ckpt, n_verts=n_verts)
            eye = np.eye(12, dtype=np.float32)
            want = []
            for i in range(2):
                wav, wsr = decode_audio_body(bodies[i], "audio/wav", None)
                want.append(direct([wav], eye[[i]], tmpl, sample_rate=wsr)[0])
            l2, disp, tol = max_l2_and_bar(got, want, tmpl)
            del direct

            clip = synthesize_speech_like(5.0, 16000, seed=52)
            tic_live = time.perf_counter()
            with LiveClient(live_port, subject=0, sample_rate=16000, timeout=60.0) as lc:
                parts = [lc.send(clip[off : off + 4000]) for off in range(0, len(clip), 4000)]
                live = np.concatenate(parts + [lc.finish()])
            live_s = time.perf_counter() - tic_live
            print(json.dumps({"cli_serve": {
                "ready_s": ready_s, "warmup_seconds": 10, "posts": 2, "seconds_each": 5.0,
                "latency_s": lat, "stats": stats, "vs_direct_max_vertex_l2": l2, "max_offset": disp,
                "tol": tol, "live_frames": live.shape[0], "live_wall_s": live_s, "card": smi,
            }}), flush=True)
            require(l2 <= tol, f"cli.serve vs direct calls: max per-vertex L2 {l2} > {tol}")
            require(live.shape == (300, n_verts // 3, 3) and bool(np.isfinite(live).all()),
                    f"live session: {live.shape}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
            log_f.close()
        with socket.socket() as s_:
            refused = s_.connect_ex(("127.0.0.1", port)) != 0
        require(proc.returncode is not None and refused,
                f"cli.serve still running after terminate (rc {proc.returncode}, port open {not refused})")
        print(json.dumps({"cli_serve_stopped": {"returncode": proc.returncode}}), flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    for name in ("flash_attention", "flash_attention_bwd", "fused_conv_encoder", "faceformer_decode_loop"):
        require(by_name[name]["cli_launches"] > 0, f"{name} did not launch on the CLIs' path")


# one-rank sharded paths against their solo runs (phase 13): the trainer's
# loss and err within the JAX package's rtol; its gradients per leaf within
# GRAD_LEAF_TOL of the leaf's largest value (floored at 1e-4 of the largest
# of any leaf), its parameters and Adam moments within JAX's bars (atol
# 3e-5, rtol 1e-4); the encodes within K1's row bar; the predictors and
# pools within phase 4's bf16 bar. On one rank the sharded paths launch the
# same kernels on the same tensors, so the readings are expected at 0.
PARALLEL_PARAM_ATOL, PARALLEL_PARAM_RTOL = 3e-5, 1e-4


def parallel_phases(torch, rows, by_name, smi, pred) -> None:
    """13: every sharded path at full width on a one-rank NCCL group, each
    against its solo run and timed beside it: (a) the trainer with mesh
    (1, 1), tensor parallelism and FSDP, two steps of the phase-7 batch;
    (b) sequence- and pipeline-parallel encodes of 8 x 60 s; (c)
    ``FaceFormerPredictor(mesh=)`` and ``(sp_mesh=)`` on the flagship
    request; (d) ``FramePredictor(mesh=)`` on config.yaml, then the
    slot-sharded pools; (e) K1 and K4, bf16 and f32, with a hash offset,
    against their plain versions. Records each kernel's launches on these
    paths as ``parallel_launches`` and asserts the collectives ran."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.frame_stream import FrameStreamPool
    from audio2face_tpu_torch.models.faceformer import frame_count, normalize_waveform
    from audio2face_tpu_torch.multistream import MultiStreamFaceFormerPredictor
    from audio2face_tpu_torch.ops import attention as attn_ops
    from audio2face_tpu_torch.parallel import comm, make_mesh
    from audio2face_tpu_torch.parallel.pipeline import pipeline_parallel_encode
    from audio2face_tpu_torch.parallel.sequence import sequence_parallel_encode
    from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    for r in rows:
        r["parallel_launches"] = 0
    report = {"card": smi, "group": "nccl, 1 rank"}

    def counted(part: str, fn, *, kernels: tuple, collectives=("all_reduce",)):
        """fn() with the launch and collective counts set to 0 before and
        read after; the part's kernels and collectives must have run."""
        reset_counts(rows)
        comm.reset_counts()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        launched = {r["name"]: read_count(r) for r in rows}
        for r in rows:
            r["parallel_launches"] += launched[r["name"]]
        for k in kernels:
            require(launched[k] > 0, f"13 {part}: {k} was not launched")
        for c in collectives:
            require(comm.COUNTS[c] > 0, f"13 {part}: no {c} ran")
        report.setdefault("launches", {})[part] = {k: v for k, v in launched.items() if v}
        report.setdefault("collectives", {})[part] = dict(comm.COUNTS)
        return out, wall

    s_ = socket.socket()
    s_.bind(("localhost", 0))
    port = s_.getsockname()[1]
    s_.close()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh((1, 1))
        n_verts = pred.n_verts

        # ---- 13a. the trainer: DP x TP x FSDP on one rank, two steps --------
        cfg = ExpConfig(
            batch_size=8, modelname="faceformer", one_hot_size=12, feature_extractor=None,
            sample_rate=16000, vertex_count=n_verts, split_frame=False, n_feature=32,
            out_dim=52, win_length=440, percision="16-mixed", lr=1e-3, seed=0,
        )
        rng = np.random.default_rng(13)
        tmpl = (rng.normal(size=(8, n_verts // 3, 3)) * 0.1).astype(np.float32)
        batch = {
            "audio": (rng.normal(size=(8, 160000)) * 0.1).astype(np.float32),
            "one_hot": np.eye(12, dtype=np.float32)[rng.integers(0, 12, 8)],
            "verts": rng.standard_normal((8, 600, n_verts), dtype=np.float32) * 0.002
            + tmpl.reshape(8, 1, -1),
            "template_vert": tmpl,
            "audio_lengths": np.asarray([160000, 120000, 160000, 40000, 80000, 160000, 8000,
                                         150000], np.int32),
        }
        solo = Audio2FaceExperiment(cfg, log_dir="build/chip_smoke_logs")
        solo.model.load_state_dict(pred.model.state_dict())
        start = solo.state_dict()
        sharded = Audio2FaceExperiment(cfg, log_dir="build/chip_smoke_logs", mesh=mesh,
                                       tensor_parallel=True, fsdp=True)
        sharded.load_state_dict(start)
        del start
        w = sharded.model.audio_encoder.layers[0].intermediate_dense.weight
        require(isinstance(w, DTensor) and sharded.tensor_parallel and sharded.fsdp,
                f"13a: the trainer's parameters are not FSDP2-sharded: {type(w)}")
        steps = {"solo": [], "sharded": []}

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        def two_steps(exp):
            """Each step's metrics and wall, and each step's gradients."""
            out = []
            with torch.enable_grad():
                for _ in range(2):
                    tic_ = time.perf_counter()
                    m = exp.train_step(batch)
                    torch.cuda.synchronize()
                    wall_ = time.perf_counter() - tic_
                    grads_ = {k: full(p.grad).detach().float().clone()
                              for k, p in exp.model.named_parameters() if p.grad is not None}
                    out.append(({k: float(v) for k, v in m.items()}, wall_, grads_))
            return out

        # deterministic library kernels for the comparison (cuDNN's and
        # PyTorch's nondeterministic backward algorithms part two solo runs
        # by rounding, which Adam scales to lr on leaves whose gradient is
        # rounding noise); on one rank the sharded step then equals the solo
        # step bit for bit
        was = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            reset_counts(rows)
            steps["solo"] = two_steps(solo)
            steps["sharded"], _ = counted("trainer", lambda: two_steps(sharded),
                                          kernels=("flash_attention", "flash_attention_bwd"))
        finally:
            torch.backends.cudnn.deterministic = was[0]
            torch.use_deterministic_algorithms(was[1])
        require(by_name["fused_conv_encoder"]["parallel_launches"] == 0
                and by_name["faceformer_decode_loop"]["parallel_launches"] == 0,
                "13a: an inference-only kernel was launched in training")
        metric_err = max(abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-30)
                         for a, b in zip(steps["sharded"], steps["solo"]) for k in b[0])
        grad_err = 0.0
        for (_, _, ga), (_, _, gb) in zip(steps["sharded"], steps["solo"]):
            require(set(ga) == set(gb), "13a: the two runs skipped different layers")
            largest = max(float(v.abs().max()) for v in gb.values())
            grad_err = max([grad_err] + [
                float((ga[k] - v).abs().max()) / max(float(v.abs().max()), 1e-4 * largest)
                for k, v in gb.items()])
        sp = dict(sharded.model.named_parameters())
        param_excess, moment_excess = 0.0, 0.0
        for k, p in solo.model.named_parameters():
            a, b = full(sp[k].detach()).float(), p.detach().float()
            param_excess = max(param_excess, float(
                ((a - b).abs() - PARALLEL_PARAM_ATOL - PARALLEL_PARAM_RTOL * b.abs()).max()))
            if p in solo.optimizer.state:
                for key in ("exp_avg", "exp_avg_sq"):
                    a_ = full(sharded.optimizer.state[sp[k]][key]).float()
                    b_ = solo.optimizer.state[p][key].float()
                    moment_excess = max(moment_excess, float(
                        ((a_ - b_).abs() - PARALLEL_PARAM_ATOL - PARALLEL_PARAM_RTOL * b_.abs()).max()))
        report["trainer"] = {
            "batch": 8, "seconds_each": 10, "steps": 2, "tensor_parallel": True, "fsdp": True,
            "deterministic_algorithms": True,
            "solo_step_s": [s for _, s, _ in steps["solo"]],
            "sharded_step_s": [s for _, s, _ in steps["sharded"]],
            "solo_metrics": [m for m, _, _ in steps["solo"]],
            "sharded_metrics": [m for m, _, _ in steps["sharded"]],
            "max_metric_rel_err": metric_err, "max_grad_rel_err_of_a_leaf": grad_err,
            "param_excess_over_bar": param_excess, "moment_excess_over_bar": moment_excess,
        }
        print(json.dumps({"parallel_trainer": report["trainer"], "card": smi}), flush=True)
        require(metric_err <= 1e-5, f"13a: loss/err differ by {metric_err} (rtol 1e-5)")
        require(grad_err <= GRAD_LEAF_TOL, f"13a: gradients differ by {grad_err} of a leaf")
        require(param_excess <= 0.0 and moment_excess <= 0.0,
                f"13a: parameters / moments beyond atol 3e-5 + rtol 1e-4: "
                f"{param_excess}, {moment_excess}")
        del solo, sharded, sp, steps, batch
        torch.cuda.empty_cache()

        # ---- 13b. SP and PP encodes of 8 x 60 s against the solo encoder ----
        encoder = pred.model.audio_encoder
        n_samples, n_frames = 960000, frame_count(960000)
        audio = torch.as_tensor((rng.normal(size=(8, n_samples)) * 0.1).astype(np.float32),
                                device=dev)
        with torch.no_grad():
            x = normalize_waveform(audio)
            kw = dict(output_len=n_frames, dtype=bf)
            encoder(x, **kw)  # warm
            want, solo_s = counted("encoder", lambda: encoder(x, **kw),
                                   kernels=("fused_conv_encoder", "flash_attention"),
                                   collectives=())
            sp_out, sp_s = counted(
                "sequence_parallel_encode",
                lambda: sequence_parallel_encode(encoder, x, mesh, config=encoder.config,
                                                 gather_output=True, **kw),
                kernels=("fused_conv_encoder", "flash_attention"), collectives=("all_gather",))
            pp_out, pp_s = counted(
                "pipeline_parallel_encode",
                lambda: pipeline_parallel_encode(encoder, x, mesh, n_micro=1,
                                                 config=encoder.config, **kw),
                kernels=("fused_conv_encoder", "flash_attention"))
        enc_errs = {name: row_scaled_err(got, want) for name, got in
                    (("sequence_parallel", sp_out), ("pipeline_parallel", pp_out))}
        report["encode"] = {"batch": 8, "seconds_each": 60, "frames": n_frames,
                            "solo_ms": 1e3 * solo_s, "sequence_parallel_ms": 1e3 * sp_s,
                            "pipeline_parallel_ms": 1e3 * pp_s, "pipeline_n_micro": 1,
                            "max_err_over_row_max": enc_errs, "tol": K1_BF16_ROW_TOL}
        print(json.dumps({"parallel_encode": report["encode"], "card": smi}), flush=True)
        require(all(e <= K1_BF16_ROW_TOL for e in enc_errs.values()),
                f"13b: sharded encodes against the solo encoder: {enc_errs}")
        del audio, x, want, sp_out, pp_out
        torch.cuda.empty_cache()

        # ---- 13c. FaceFormerPredictor(mesh=) and (sp_mesh=), flagship ------
        eye = np.eye(12, dtype=np.float32)
        one_hot = eye[rng.integers(0, 12, 8)]
        template = (rng.normal(size=(n_verts // 3, 3)) * 0.1).astype(np.float32)
        clips = [(rng.normal(size=n_samples) * 0.1).astype(np.float32) for _ in range(8)]
        state = pred.model.state_dict()
        kw = dict(n_verts=n_verts, bf16=True, max_batch=8, bucket_seconds=5.0, state_dict=state)
        want, solo_s = counted("predictor", lambda: pred(clips, one_hot, template),
                               kernels=("fused_conv_encoder", "flash_attention",
                                        "faceformer_decode_loop"), collectives=())
        served = {}
        for name, extra, coll in (("mesh", {"mesh": mesh}, ("all_gather",)),
                                  ("sp_mesh", {"sp_mesh": mesh}, ("all_gather",))):
            p_ = FaceFormerPredictor(**kw, **extra)
            p_([c[:16000] for c in clips], one_hot, template)  # warm
            got, s = counted(f"predictor_{name}", lambda: p_(clips, one_hot, template),
                             kernels=("fused_conv_encoder", "flash_attention",
                                      "faceformer_decode_loop"), collectives=coll)
            l2, disp, tol = max_l2_and_bar(got, want, template)
            served[name] = {"wall_s": s, "max_vertex_l2": l2, "tol": tol}
            require(all(g.shape == w_.shape for g, w_ in zip(got, want)) and l2 <= tol,
                    f"13c: FaceFormerPredictor({name}=) against the solo predictor: {l2} > {tol}")
            del p_, got
        report["predictors"] = {"request": "8 x 60 s", "solo_wall_s": solo_s, **served}
        print(json.dumps({"parallel_predictors": report["predictors"], "card": smi}), flush=True)
        del want
        torch.cuda.empty_cache()

        # ---- 13d. FramePredictor(mesh=) on config.yaml, then the pools -----
        fcfg = ExpConfig.from_yaml("config.yaml")
        sr = fcfg.sample_rate
        fclips = [(rng.normal(size=20 * sr) * 0.1).astype(np.float32) for _ in range(8)]
        ftemplate = (rng.normal(size=(fcfg.vertex_count // 3, 3)) * 0.1).astype(np.float32)
        solo_f = FramePredictor(fcfg, max_batch=8, frame_batch=128, seed=0)
        mesh_f = FramePredictor(fcfg, max_batch=8, frame_batch=128, seed=0, mesh=mesh)
        for p_ in (solo_f, mesh_f):
            p_([c[:sr] for c in fclips], one_hot, ftemplate)  # warm
        fwant, fsolo_s = counted("frame_predictor", lambda: solo_f(fclips, one_hot, ftemplate),
                                 kernels=(), collectives=())
        fgot, fmesh_s = counted("frame_predictor_mesh", lambda: mesh_f(fclips, one_hot, ftemplate),
                                kernels=(), collectives=("all_gather",))
        fl2, fdisp, ftol = max_l2_and_bar(fgot, fwant, ftemplate)
        require(fl2 <= ftol, f"13d: FramePredictor(mesh=) against solo: {fl2} > {ftol}")

        def pool_run(pool, clips_, tmpl_, piece):
            slots = [pool.open_stream(eye[i], tmpl_) for i in range(len(clips_))]
            got_ = [[] for _ in clips_]
            for off in range(0, max(len(c) for c in clips_), piece):
                for i, c in enumerate(clips_):
                    if off < len(c):
                        got_[i].append(pool.push(slots[i], c[off : off + piece],
                                                 last=off + piece >= len(c)))
            return [np.concatenate(g_ + [pool.poll(s_)]) for g_, s_ in zip(got_, slots)]

        pclips = [c[: 3 * 16000] for c in clips]
        pools = {}
        for name, mk in (("pool", lambda m: MultiStreamFaceFormerPredictor(
                state_dict=state, n_verts=n_verts, n_streams=8, dtype=bf, mesh=m)),):
            pw, ps = counted(f"{name}_solo", lambda: pool_run(mk(None), pclips, template, 4000),
                             kernels=("fused_conv_encoder", "flash_attention"), collectives=())
            pg, pm = counted(f"{name}_mesh", lambda: pool_run(mk(mesh), pclips, template, 4000),
                             kernels=("fused_conv_encoder", "flash_attention"),
                             collectives=("all_gather",))
            l2, disp, tol = max_l2_and_bar(pg, pw, template)
            pools[name] = {"clips": "8 x 3 s", "solo_s": ps, "mesh_s": pm, "max_vertex_l2": l2,
                           "tol": tol}
            require(l2 <= tol, f"13d: the slot-sharded {name} against solo: {l2} > {tol}")
        fpclips = [c[: 3 * sr] for c in fclips]
        fpw, fps = counted("frame_pool_solo", lambda: pool_run(FrameStreamPool(
            fcfg, state_dict=solo_f.model.state_dict(), n_streams=8), fpclips, ftemplate,
            int(0.1 * sr)), kernels=(), collectives=())
        fpg, fpm = counted("frame_pool_mesh", lambda: pool_run(FrameStreamPool(
            fcfg, state_dict=solo_f.model.state_dict(), n_streams=8, mesh=mesh), fpclips,
            ftemplate, int(0.1 * sr)), kernels=(), collectives=("all_gather",))
        l2, disp, tol = max_l2_and_bar(fpg, fpw, ftemplate)
        require(l2 <= tol, f"13d: the slot-sharded frame pool against solo: {l2} > {tol}")
        pools["frame_pool"] = {"clips": "8 x 3 s", "solo_s": fps, "mesh_s": fpm,
                               "max_vertex_l2": l2, "tol": tol}
        report["frame_and_pools"] = {
            "frame_predictor": {"request": "8 x 20 s", "solo_wall_s": fsolo_s,
                                "mesh_wall_s": fmesh_s, "max_vertex_l2": fl2, "tol": ftol},
            **pools}
        print(json.dumps({"parallel_frame_and_pools": report["frame_and_pools"], "card": smi}),
              flush=True)
        del solo_f, mesh_f, fwant, fgot
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # ---- 13e. K1 and K4 with a hash offset against their plain versions -----
    # a (2, 6) slice placed at batch 3 and head 6 of a 12-head call; not
    # counted (launches to compare with the plain version)
    g = torch.Generator().manual_seed(13)
    hix = (3, 6, 12)
    offsets = {}
    for dt in (bf, torch.float32):
        q, k, v, dout = (torch.randn(2, 6, 600, 64, generator=g).to(dev, dt) for _ in range(4))
        kvl = torch.tensor([600, 350], dtype=torch.int32, device=dev)
        opt = dict(kv_lengths=kvl, dropout_rate=0.1, dropout_seed=torch.tensor(
            [987654], dtype=torch.int32, device=dev), hash_index=hix)
        with torch.no_grad():
            out, lse = attn_ops.flash_attention(q, k, v, return_lse=True, **opt)
            ref = attn_ops.mha_reference(q, k, v, **opt)
            grads = attn_ops.flash_attention_bwd(q, k, v, out, lse, dout, **opt)
            ref_grads = attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, dout, **opt)
            # the offset matters: another place in the call drops other keys
            other = attn_ops.mha_reference(q, k, v, **dict(opt, hash_index=(0, 0, 6)))
        torch.cuda.synchronize()
        name = "bf16" if dt == bf else "f32"
        if dt == bf:
            fwd_err = row_scaled_err(out, ref)
            bwd_err = max(row_scaled_err(a_, b_, K4_ROW_FLOOR) for a_, b_ in zip(grads, ref_grads))
            ok = fwd_err <= K1_BF16_ROW_TOL and bwd_err <= K4_BF16_ROW_TOL
        else:  # the bars of phase 3's f32 variant checks
            fwd_err = float((out - ref).abs().max()) / (1e-5 + 1e-4 * float(ref.abs().max()))
            bwd_err = max(float(((a_ - b_).abs() - K4_F32_RTOL * b_.abs()).max())
                          for a_, b_ in zip(grads, ref_grads)) / K4_F32_ATOL
            ok = fwd_err <= 1.0 and bwd_err <= 1.0
        moved = float((other.float() - ref.float()).abs().max())
        offsets[name] = {"k1_err": fwd_err, "k4_err": bwd_err, "other_offset_moves": moved}
        require(ok and moved > 0, f"13e: K1/K4 {name} with hash offsets: {offsets[name]}")
    report["hash_offsets"] = {"shape": [2, 6, 600, 64], "hash_index": list(hix),
                              "dropout": 0.1, **offsets}
    print(json.dumps({"parallel_hash_offsets": report["hash_offsets"], "card": smi}), flush=True)
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"parallel": report}), flush=True)


def main() -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test needs a GPU",
              file=sys.stderr)
        return 1
    from audio2face_tpu_torch.data.synthetic import adversarial_screen_triangles, generate_synthetic_face_obj
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
    # the bf16 attention kernels' registers and spills (-Xptxas -v), shared
    # memory per block and resident blocks per SM (the CUDA runtime)
    resources = {}
    for lib in ("flash_attention", "flash_attention_bwd"):
        for name, rep_ in ptxas_report((_build.BUILD_DIR / f"{lib}.log").read_text()).items():
            if "wgmma" in name:
                resources[name] = rep_
    for d_ in (16, 32, 64, 128):
        for name, occ in attn_ops.wgmma_occupancy(d_).items():
            resources[f"{name}<{d_}>"].update(occ)
    print(json.dumps({"attention_kernel_resources": resources}), flush=True)
    require(all(r_["spill_store_bytes"] == 0 and r_["spill_load_bytes"] == 0
                for n_, r_ in resources.items() if n_.endswith("<64>")),
            "a bf16 attention kernel spills at head dim 64")
    # the f32 attention kernels' registers and spills (-Xptxas -v) and their
    # launch plans at the frame-window, training and predictor shapes
    f32_resources = {}
    for lib in ("flash_attention", "flash_attention_bwd"):
        for name, rep_ in ptxas_report((_build.BUILD_DIR / f"{lib}.log").read_text()).items():
            if "f32" in name:
                f32_resources[name] = rep_
    f32_plans = {f"{bh_}x{t_}": attn_ops.f32_kernel_plan(64, bh_, t_, t_)
                 for bh_, t_ in ((1024 * 12, 25), (96, 600), (96, 3600))}
    print(json.dumps({"f32_attention_kernel_resources": f32_resources, "f32_plans_d64": f32_plans}),
          flush=True)
    # K2's and K3's registers and spills (-Xptxas -v)
    dc_resources = {}
    for lib in ("conv_encoder", "decode_loop"):
        dc_resources.update(ptxas_report((_build.BUILD_DIR / f"{lib}.log").read_text()))
    print(json.dumps({"decode_conv_kernel_resources": dc_resources}), flush=True)
    # K5's registers, spills and shared memory a block (-Xptxas -v)
    k5_resources = ptxas_report((_build.BUILD_DIR / "rasterizer.log").read_text())["raster_subtile_kernel"]
    print(json.dumps({"rasterizer_kernel_resources": k5_resources}), flush=True)

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
        "resources_d64": {"flash_fwd_wgmma_kernel": resources["flash_fwd_wgmma_kernel<64>"]},
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
    launch_ms = k2_launch_ms(torch, lambda: ce.fused_conv_encoder(x, kernels, gscale, gbias, lens))
    gemm_ms = sum(m_ for k_, m_ in launch_ms if k_ == "conv_gemm_wgmma")
    rows.append({
        "name": "fused_conv_encoder", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/conv_encoder.cu",
        "replaces": "audio2face_tpu/ops/conv_encoder.py:295",
        "wrapper": ce.fused_conv_encoder, "max_abs_err": err, "tol": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None,
        "launch_ms": launch_ms, "gemm_share_of_bf16_peak": gemm_flops / PEAK_BF16_FLOPS / (gemm_ms / 1e3),
        "resources": {k_: dc_resources[k_] for k_ in K2_KERNELS},
    })
    print(json.dumps({"check": "fused_conv_encoder (8, 960000) mixed lengths", "max_abs_err": err,
                      "tol": tol, "ms": ms, "launch_ms": launch_ms}), flush=True)
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
    plan = dk.kernel_cluster_plan(b, t, dev, biwi=False, bf16_weights=True)
    rows.append({
        "name": "faceformer_decode_loop", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/decode_loop.cu",
        "replaces": "audio2face_tpu/ops/decode_kernel.py:259",
        "wrapper": dk.faceformer_decode_loop, "max_abs_err": err,
        "max_err_less_one_bf16_step": over, "tol": K3_F32_TOL,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None,
        "us_per_step": 1e3 * ms / t, "cluster_plan": plan,
        "resources": dc_resources["decode_cluster_kernel<0, __nv_bfloat16>"],
    })
    print(json.dumps({"K3 vocaset (8, 3600) bf16": {
        "cluster": plan["cluster"], "max_active_clusters": plan["max_active_clusters"],
        "rows_per_cta": plan["rows_per_cta"], "smem_per_cta": plan["smem_bytes"],
        "rows_resident": plan["rows_resident"], "us_per_step": 1e3 * ms / t, "ms": ms}}), flush=True)
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
    # q read and out written whole, k and v up to each KV length, lse; the
    # unmasked pairs' products at the bf16 peak
    k1["train_shape_bound_ms"], k1["train_shape_bound_by"] = bound(
        2 * b * h * t * d * 2 + 2 * h * kvl.sum().item() * d * 2 + b * h * t * 4 + b * 4,
        4.0 * d * h * t * kvl.sum().item() / PEAK_BF16_FLOPS)
    k1["dropout_plain_ms"] = cuda_ms(torch, lambda: attn_ops.mha_reference(q, k, v, kv_lengths=kvl, **drop), 3)
    sdpa_mask = (torch.arange(t, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    k1["train_shape_library_ms"] = cuda_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask), 20)

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
    # delta = rowsum(dO * O), computed by the dq kernel, against its plain
    # version: f32 sums of the same products in another order
    delta = kernel_bwd_with_delta(attn_ops, q, k, v, out, lse, go, **bwd_kw)[3]
    want_delta = attn_ops.attention_delta_reference(out, go)
    delta_err = (delta - want_delta).abs().max().item()
    delta_tol = 1e-5 + 1e-4 * want_delta.abs().max().item()
    print(json.dumps({"check": "flash_attention_bwd delta (8,12,600,64)", "max_abs_err": delta_err,
                      "tol": delta_tol}), flush=True)
    require(delta_err <= delta_tol, f"K4 delta err {delta_err} > {delta_tol}")
    ms = cuda_ms(torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, **bwd_kw), 20)
    ms_nodrop = cuda_ms(torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, kv_lengths=kvl), 20)
    plain_ms = cuda_ms(torch, lambda: attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, go, **bwd_kw), 3)
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
        "library_ms": lib_ms, "train_shape": [b, h, t, d], "delta_max_abs_err": delta_err,
        "resources_d64": {n_: resources[f"{n_}<64>"] for n_ in ("flash_bwd_dq_wgmma_kernel",
                                                                "flash_bwd_dkdv_wgmma_kernel")},
    })
    # the library yardstick of K1 and K4 at the training shape: SDPA forward
    # and backward with the same boolean kv_lengths mask, and K1 and K4
    # without dropout, each by the profiler's device time of its own kernels
    # (the backward's window holds no forward, and no host gap of the
    # autograd engine counts), 5 repeats of 20 calls
    yard = {}
    yard["k1"], k1_names = profiled_ms(torch, lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl), 20)
    yard["sdpa_forward"], fwd_names = profiled_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask), 20)
    yard["k4"], k4_names = profiled_ms(
        torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, kv_lengths=kvl), 20)
    with torch.enable_grad():
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)
        yard["sdpa_backward"], bwd_names = profiled_ms(
            torch, lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True), 20)
    del leaves, lib_out
    median = {n_: sorted(t_)[len(t_) // 2] for n_, t_ in yard.items()}
    backend = {"forward": sdpa_backend(fwd_names), "backward": sdpa_backend(bwd_names)}
    print(json.dumps({"library_yardstick (8,12,600,64) bf16 kv_lengths": {
        "device_ms_per_call": yard, "median_ms": median, "sdpa_backend": backend,
        "k1_kernels": k1_names, "k4_kernels": k4_names, "sdpa_forward_kernels": fwd_names,
        "sdpa_backward_kernels": bwd_names, "card": smi}}), flush=True)
    k1["train_shape_device_ms"], k1["train_shape_library_device_ms"] = median["k1"], median["sdpa_forward"]
    k1["train_shape_library_spread_ms"] = [min(yard["sdpa_forward"]), max(yard["sdpa_forward"])]
    k1["train_shape_library_backend"] = backend["forward"]
    rows[-1].update({
        "library_events_through_autograd_ms": lib_ms, "library_ms": median["sdpa_backward"],
        "library_spread_ms": [min(yard["sdpa_backward"]), max(yard["sdpa_backward"])],
        "library_backend": backend["backward"], "no_dropout_device_ms": median["k4"],
        "no_dropout_device_spread_ms": [min(yard["k4"]), max(yard["k4"])],
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
    # K1 and K4 off the main path: every head dim, bf16 and f32, the options
    variants = attention_variant_checks(torch, attn_ops, randn)
    print(json.dumps({"check": "K1 + K4 variants (head dims 16/32/64/128, bf16 and f32)", **variants}),
          flush=True)
    torch.cuda.empty_cache()

    # ---- 3i. the f32 attention kernels: frame window, training, predictor ----
    f32r = f32_attention_readings(torch, attn_ops, randn, smi)
    print(json.dumps({"f32_attention": f32r}), flush=True)
    fw, tr, lib = f32r["frame_window_device"], f32r["train_shape_rate0.1"], f32r["train_shape_sdpa"]
    rows.append({
        "name": "flash_attention_f32", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/flash_attention.cu",
        "replaces": "audio2face_tpu/ops/attention.py:342",
        "wrapper": attn_ops.flash_attention, "counter": "f32_launches",
        "shape": fw["shape"], "max_abs_err": fw["max_abs_err"],
        "max_err_over_row_max": fw["max_err_over_row_max"], "tol_over_row_max": K1_F32_ROW_TOL,
        "ms": fw["k1_ms"], "plain_ms": fw["plain_ms"], "bound_ms": fw["bound_ms"],
        "bound_by": fw["bound_by"], "library_ms": fw["sdpa_ms"],
        "path": attn_ops.f32_forward_path(25), "plan": f32_plans["12288x25"],
        "train_shape_ms": f32r["train_shape_rate0.0"]["k1_ms"], "train_shape_dropout_ms": tr["k1_ms"],
        "train_shape_bound_ms": lib["k1_bound_ms"], "train_shape_bound_by": lib["k1_bound_by"],
        "train_shape_plain_ms": f32r["train_shape_rate0.0"]["k1_plain_ms"],
        "train_shape_library_ms": lib["forward_ms"],
        "predictor_shape": f32r["predictor_shape"],
        "resources_d64": {n_: r_ for n_, r_ in f32_resources.items() if "fwd" in n_ and "<64" in n_},
    })
    rows.append({
        "name": "flash_attention_bwd_f32", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "audio2face_tpu/ops/attention.py:662",
        "wrapper": attn_ops.flash_attention_bwd, "counter": "f32_launches",
        "shape": tr["k4_shape"], "max_abs_err": tr["k4_max_abs_err"],
        "err_less_rtol_and_atol": tr["k4_err_less_rtol_and_atol"],
        "ms": tr["k4_ms"], "no_dropout_ms": f32r["train_shape_rate0.0"]["k4_ms"],
        "plain_ms": tr["k4_plain_ms"], "bound_ms": lib["k4_bound_ms"], "bound_by": lib["k4_bound_by"],
        "library_ms": lib["backward_ms"], "library_backend": lib["backward_backend"],
        "plan": {n_: p_ for n_, p_ in f32_plans["96x600"].items() if n_ != "forward"},
        "resources_d64": {n_: r_ for n_, r_ in f32_resources.items() if "bwd" in n_ and "<64" in n_},
    })
    torch.cuda.empty_cache()

    # ---- 3d. the variants off the main path, at small shapes ---------------
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
    # K3 past the cluster's shared memory (a tail of rows in device memory;
    # a batch of 1), bf16 and f32, and a batch of 20 (more than one wave)
    for dtype, b, t in k3_extra_shapes(dk, dev, biwi=False):
        w_ = pred.model.decoder_weights(dtype)
        k3_row = k3_check(torch, dk, f"vocaset {str(dtype)[6:]} ({b}, {t})", randn(b, t, 64, scale=0.5, dtype=dtype),
                          randn(b, 64, scale=0.5, dtype=dtype), pe.to(dtype), w_)
        k3_row["cluster_plan"] = dk.kernel_cluster_plan(b, t, dev, False, dtype == torch.bfloat16)
        print(json.dumps(k3_row), flush=True)
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
    print(json.dumps({"check": "variants: K2 short, K3 small, f32 predictor",
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
    for dtype, b, t in k3_extra_shapes(dk, dev, biwi=True):
        w_ = biwi.model.decoder_weights(dtype)
        kw = dict(period=25, mem_k=randn(b, 4, 2 * t, 16, scale=0.5, dtype=dtype),
                  mem_v=randn(b, 4, 2 * t, 16, scale=0.5, dtype=dtype))
        k3_row = k3_check(torch, dk, f"BIWI {str(dtype)[6:]} ({b}, {t})", None,
                          randn(b, 64, scale=0.5, dtype=dtype), pe25.to(dtype), w_, **kw)
        k3_row["cluster_plan"] = dk.kernel_cluster_plan(b, t, dev, True, dtype == torch.bfloat16)
        print(json.dumps(k3_row), flush=True)
        del kw
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
    plan = dk.kernel_cluster_plan(b, t, dev, biwi=True, bf16_weights=True)
    print(json.dumps({"K3 BIWI (8, 750) bf16": {
        "cluster": plan["cluster"], "max_active_clusters": plan["max_active_clusters"],
        "rows_per_cta": plan["rows_per_cta"], "smem_per_cta": plan["smem_bytes"],
        "rows_resident": plan["rows_resident"], "us_per_step": 1e3 * ms / t, "ms": ms}}), flush=True)
    rows.append({
        "name": "faceformer_decode_loop_biwi", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/decode_loop.cu",
        "replaces": "audio2face_tpu/ops/decode_kernel.py:259",
        "wrapper": dk.faceformer_decode_loop, "counter": "biwi_launches", "max_abs_err": err,
        "max_err_less_one_bf16_step": over, "tol": K3_F32_TOL, "shape": [b, t, 64],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None,
        "us_per_step": 1e3 * ms / t, "cluster_plan": plan,
        "resources": dc_resources["decode_cluster_kernel<1, __nv_bfloat16>"],
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
    proj = rd.project_and_shade(vd, faces_p, lights)
    coefs, bbox = rz.plane_coefficients(*proj, faces_p, valid_p, height=height, width=width)
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
    # adversarial frames: slivers of 1e-9 to 1e-3 px^2, triangles 10^5 px
    # across, vertices and edges on pixel centres and sub-tile borders, and
    # a NaN frame, held to the unculled plain version at the same bar
    adv = [[torch.as_tensor(a, device=dev) for a in adversarial_screen_triangles(s_, height, width)]
           for s_ in range(4)]
    for a in adv[3][:2]:
        a.fill_(float("nan"))
    adv_pairs = [rz.plane_coefficients(*a, height=height, width=width) for a in adv]
    ac, ab = torch.stack([p_[0] for p_ in adv_pairs]), torch.stack([p_[1] for p_ in adv_pairs])
    adv_keys = rz.rasterize_keys(ac, ab, height=height, width=width)
    adv_differing = int((adv_keys != rz.rasterize_keys_reference(ac, ab, height=height, width=width)).sum())
    adv_covered = (adv_keys[:3] != 0).float().mean().item()
    print(json.dumps({"check": "rasterize_keys adversarial (4, 800, 800)", "differing_pixels": adv_differing,
                      "of": adv_keys.numel(), "tol_differing_pixels": K5_DIFFERING_PIXELS,
                      "covered_share": adv_covered}), flush=True)
    require(adv_differing <= K5_DIFFERING_PIXELS and adv_covered > 0.5 and not bool(adv_keys[3].any()),
            f"K5 adversarial frames: {adv_differing} pixels differ, covered {adv_covered}, NaN frame drawn")
    del adv, adv_pairs, ac, ab, adv_keys
    # the work: what the inputs need (pixels in each live triangle's box),
    # what a design without the cull evaluates (chunk-tile pairs x 128
    # triangles), what this kernel evaluates (triangle x 16 x 32 sub-tile
    # pairs its cull keeps)
    box_pixels = rz.triangle_box_pixels(proj[0], proj[1], faces_p, coefs, height=height, width=width)
    tile_pairs = rz.tile_chunk_pairs(bbox, height=height, width=width)
    sub_pairs = rz.subtile_pairs(coefs, bbox, height=height, width=width)
    nbytes = coefs.numel() * 4 + bbox.numel() * 4 + keys.numel() * 4
    bms, bby = bound(nbytes, K5_OPS_PER_PIXEL * box_pixels.sum().item() / PEAK_F32_FLOPS)
    rows.append({
        "name": "rasterize_keys", "route": "cuda",
        "source": "audio2face_tpu_torch/csrc/rasterizer.cu",
        "replaces": "audio2face_tpu/ops/rasterizer.py:202",
        "wrapper": rz.rasterize_keys, "max_abs_err": err, "differing_pixels": differing,
        "tol_differing_pixels": K5_DIFFERING_PIXELS, "adversarial_differing_pixels": adv_differing,
        "oracle_share_off_by_more_than_3": off_share,
        "shape": [64, height, width], "triangles": int(coefs.shape[1]),
        "triangle_box_pixels": box_pixels.sum().item(), "frame0_triangle_box_pixels": box_pixels[0].item(),
        "tile_chunk_pairs": tile_pairs.sum().item(), "frame0_tile_chunk_pairs": tile_pairs[0].item(),
        "subtile_pairs": sub_pairs.sum().item(), "frame0_subtile_pairs": sub_pairs[0].item(),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None,
        "tiled_16_frames_ms": tiled_16_ms, "scatter_16_frames_ms": scatter_16_ms,
        "resources": k5_resources,
    })
    del coefs, bbox, keys, ref, vd, proj
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
    biwi_state = biwi.model.state_dict()  # for the checkpoint phase (9e)
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
        if use_kernels:  # the f32 kernels' path: every launch in f32
            k4f = by_name["flash_attention_bwd_f32"]
            k4f["launches"] = read_count(k4f)
            k4f["f32_forward_launches"] = read_count(by_name["flash_attention_f32"])
            require(k4f["launches"] == attn_ops.flash_attention_bwd.launches == k4f["f32_forward_launches"] > 0,
                    f"the f32 gradient check launched K4 f32 {k4f['launches']} times")
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

    # ---- 9. the frame models and checkpoint I/O ------------------------------
    frame_model_phases(torch, rows, by_name, smi, pred, biwi_state, n_verts_biwi)
    torch.cuda.empty_cache()

    shared = tempfile.mkdtemp(prefix="a2f_smoke_vocaset_")
    try:
        # ---- 10. the data pipeline: native loader, fit through the Prefetcher --
        vdir = synthetic_vocaset(shared, smi)  # 10b's dataset, which phase 12 reuses
        data_phases(torch, rows, smi, pred, biwi_state, n_verts_biwi, vdir)
        del biwi_state
        torch.cuda.empty_cache()

        # ---- 11. live serving: stream, pool, frame pool, daemons ----------------
        live_phases(torch, rows, by_name, smi, pred)
        torch.cuda.empty_cache()

        # ---- 12. the CLIs: train, evaluate, export, serve -----------------------
        cli_phases(torch, rows, by_name, smi, vdir)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(shared, ignore_errors=True)

    # ---- 13. parallelism: every sharded path on a one-rank NCCL group -------
    parallel_phases(torch, rows, by_name, smi, pred)
    torch.cuda.empty_cache()

    # ---- 14. results ----------------------------------------------------
    for r in rows:
        del r["wrapper"]
        r.pop("counter", None)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
