#!/usr/bin/env python3
"""Where the time of the port's flagship request, or of one training step,
goes on one GPU.

``python3 tools/torch_flagship_breakdown.py`` (no argument) serves 8 clips x 60 s through the full-width bf16 FaceFormerPredictor of
audio2face_tpu_torch (random weights from a seed), then:

1. times one request on the host clock, split into the model call that
   returns decoder hidden states (``_hidden``) and the chunked vertex head
   with its device-to-host copies (``_emit_vertices``), each ending in
   ``torch.cuda.synchronize()``;
2. traces one more request with ``torch.profiler`` and sums device time by
   kernel, grouped into the port's kernels, the library calls around them
   and the copies; the device's idle share is 1 - (device busy time / wall
   time), with and without the copies counted as busy.

Prints the profiler's table of the 25 kernels with the most device time,
then, last, one JSON line ``{"breakdown": {...}}``.

``python3 tools/torch_flagship_breakdown.py train`` does the same for one
full-width training step: it builds the port's ``Audio2FaceExperiment``
(same model, bf16 compute, random weights from a seed) and a batch of 8
clips x 10 s with mixed lengths and synthetic vertices, then

1. warms up with one step and times two more on the host clock, each split
   into the forward to the loss (with the encoder's share of it), the
   backward and the optimizer update, every span ending in
   ``torch.cuda.synchronize()``;
2. traces one more step with ``torch.profiler``, sums device time by kernel
   group, and counts the device kernels launched;

and prints the table, then ``{"train_breakdown": {...}}``.

``python3 tools/torch_flagship_breakdown.py render`` splits one 180-frame
render of the synthetic 5,023-vertex head at 800 x 800 through
``Renderer.render`` (the pipelined tile-rasterizer path):

1. one transfer batch of 64 frames taken apart with CUDA events: the copy
   of the vertices to the device, projection and shading, the prepass
   (plane coefficients, chunk boxes, crop window), K5, crop and pack (the
   whole packed render less the parts before it), the copy of the packed
   buffer into pinned host memory; and on the host clock the unpack and
   paste into full frames;
2. the whole render on the host clock (after a warm render), frames per
   second;
3. one more render under ``torch.profiler``: device time by kernel group and
   the device's idle share;

and prints the table, then ``{"render_breakdown": {...}}``. Run from the
repository root.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

GROUPS = (  # (group, substrings of CUDA kernel names)
    ("K1 flash_attention", ("flash_fwd_kernel",)),
    ("K4 flash_attention_bwd", ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")),
    ("K2 conv encoder", ("conv0_moments", "gn_fold", "conv0_gelu", "strided_conv_gemm")),
    ("K3 decode loop", ("decode_loop_kernel",)),
    ("K5 rasterizer", ("raster_kernel",)),
    ("library conv", ("convolve", "cudnn", "winograd", "fft")),
    ("library matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("copies", ("memcpy", "Memcpy", "memset", "Memset")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise/reduction"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_ms_by_group(prof) -> tuple[dict[str, float], float]:
    """A profile's device time in ms by kernel group, and the total in us."""
    by_group: dict[str, float] = {}
    busy_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        # aten:: ops and runtime calls (cudaLaunchKernel...) are host events
        if dev_us <= 0 or ev.key.startswith("aten::") or ev.key.startswith("cuda"):
            continue
        busy_us += dev_us
        grp = group_of(ev.key)
        by_group[grp] = by_group.get(grp, 0.0) + dev_us / 1e3
    return dict(sorted(by_group.items(), key=lambda kv: -kv[1])), busy_us


def profile_table(prof, rows: int = 25) -> str:
    try:
        return prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows)
    except (KeyError, AttributeError, ValueError):  # older profilers name it cuda
        return prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=rows)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flagship_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    card = card_line()
    n_verts = 15069
    pred = FaceFormerPredictor(n_verts=n_verts, bf16=True, max_batch=8, bucket_seconds=5.0, seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for lin in (pred.model.vertice_map, pred.model.vertice_map_r):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.02)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.02)
    rng = np.random.default_rng(0)
    audios = [(rng.normal(size=960000) * 0.1).astype(np.float32) for _ in range(8)]
    one_hot = np.eye(12, dtype=np.float32)[rng.integers(0, 12, 8)]
    template = rng.normal(size=(n_verts // 3, 3)).astype(np.float32)
    pred(audios, one_hot, template)  # builds the kernels, warms the libraries

    spans: dict[str, float] = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - tic
            return out
        return wrapper

    pred._hidden = timed("hidden_states_s", pred._hidden)
    pred._emit_vertices = timed("vertex_head_and_copy_out_s", pred._emit_vertices)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    pred(audios, one_hot, template)
    wall = time.perf_counter() - tic
    frames = 8 * 3600
    del pred._hidden, pred._emit_vertices  # the class's own methods again

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        pred(audios, one_hot, template)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - tic
    by_group, busy_us = device_ms_by_group(prof)
    copy_us = 1e3 * by_group.get("copies", 0.0)
    print(profile_table(prof))

    result = {
        "card": card,
        "request": "8 clips x 60 s, bf16, 15069-wide vertex head",
        "wall_s": wall,
        "mesh_frames_per_s": frames / wall,
        "realtime_factor": 8 * 60.0 / wall,
        **spans,
        "host_other_s": wall - sum(spans.values()),
        "traced_wall_s": traced_wall,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_idle_share": (1.0 - busy_us / 1e6 / traced_wall) if busy_us else None,
        "device_kernel_ms": (busy_us - copy_us) / 1e3 if busy_us else None,
        "kernel_idle_share": (1.0 - (busy_us - copy_us) / 1e6 / traced_wall) if busy_us else None,
        "device_ms_by_group": by_group,
    }
    print(json.dumps({"breakdown": result}))
    return 0


def train_main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flagship_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.ops import attention as attn_ops
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    card = card_line()
    n_verts, n_frames = 15069, 600
    cfg = ExpConfig(
        batch_size=8, modelname="faceformer", one_hot_size=12, feature_extractor=None,
        sample_rate=16000, vertex_count=n_verts, split_frame=False, n_feature=32, out_dim=52,
        win_length=440, percision="16-mixed", lr=1e-4, seed=0,
    )
    exp = Audio2FaceExperiment(cfg, log_dir="build/train_breakdown_logs")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # trained-like motion maps (the init zeroes them)
        for lin in (exp.model.vertice_map, exp.model.vertice_map_r):
            lin.weight.copy_((torch.randn(lin.weight.shape, generator=g) * 0.02).to(lin.weight.device))
            lin.bias.copy_((torch.randn(lin.bias.shape, generator=g) * 0.02).to(lin.bias.device))
    rng = np.random.default_rng(0)
    tmpl = (rng.normal(size=(8, n_verts // 3, 3)) * 0.1).astype(np.float32)
    batch = {
        "audio": (rng.normal(size=(8, 160000)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[rng.integers(0, 12, 8)],
        "verts": torch.randn((8, n_frames, n_verts), generator=g).numpy() * 0.01 + tmpl.reshape(8, 1, -1),
        "template_vert": tmpl,
        "audio_lengths": np.asarray([160000, 160000, 120000, 80000, 160000, 40000, 160000, 8000], np.int32),
    }
    exp.train_step(batch)  # builds the kernels, warms the libraries
    torch.cuda.synchronize()

    spans: dict[str, float] = {}

    def span(name, fn):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - tic
        return out

    encoder = exp.model.audio_encoder
    encoder_forward = encoder.forward
    encoder.forward = lambda *a, **kw: span("encoder_forward_s", lambda: encoder_forward(*a, **kw))
    dev_batch = exp._to_device(batch)
    n_timed = 2
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n_timed):  # train_step, taken apart
        exp.model.train()
        exp.optimizer.zero_grad(set_to_none=True)
        loss, _ = span("forward_to_loss_s", lambda: exp._train_loss(
            dev_batch, exp._generator(cfg.seed, exp.step)))
        span("backward_s", loss["loss"].backward)
        span("optimizer_s", exp.optimizer.step)
        exp.step += 1
    wall = (time.perf_counter() - tic) / n_timed
    spans = {k: v / n_timed for k, v in spans.items()}
    del encoder.forward  # the class's own method again
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    from torch.profiler import ProfilerActivity, profile

    attn_ops.flash_attention.launches = attn_ops.flash_attention_bwd.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        exp.train_step(batch)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - tic
    by_group, busy_us = device_ms_by_group(prof)
    n_kernels = sum(
        ev.count for ev in prof.key_averages()
        if getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0)) > 0
        and not ev.key.startswith("aten::") and not ev.key.startswith("cuda")
    )
    print(profile_table(prof))

    result = {
        "card": card,
        "step": "batch 8 x 10 s (600 frames), bf16 compute, 15069-wide vertex head",
        "step_wall_s": wall,
        **spans,
        "decoder_and_loss_forward_s": spans["forward_to_loss_s"] - spans["encoder_forward_s"],
        "peak_device_memory_gb": peak_gb,
        "traced_step_wall_s": traced_wall,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_idle_share": (1.0 - busy_us / 1e6 / traced_wall) if busy_us else None,
        "device_kernels_launched": n_kernels,
        "k1_launches": attn_ops.flash_attention.launches,
        "k4_launches": attn_ops.flash_attention_bwd.launches,
        "device_ms_by_group": by_group,
    }
    print(json.dumps({"train_breakdown": result}))
    return 0
def render_main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flagship_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.data.synthetic import generate_synthetic_face_obj
    from audio2face_tpu_torch.ops import rasterizer as rz
    from audio2face_tpu_torch.utils import renderer as rd
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    card = card_line()
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    mesh = FaceMesh.load(generate_synthetic_face_obj("build/render_breakdown_assets/head.obj"))
    renderer = rd.Renderer(mesh)
    head = np.asarray(mesh.verts, np.float32)
    # 3 s at 60 fps: the lower half opens and closes like a jaw, the head sways
    n_frames, height, width = 180, rd.FRUSTUM["height"], rd.FRUSTUM["width"]
    t = np.arange(n_frames, dtype=np.float32) / 60.0
    anim = np.repeat(head[None], n_frames, axis=0)
    anim[:, head[:, 1] < 0.0, 1] -= (0.004 * (0.5 - 0.5 * np.cos(2 * np.pi * 2.3 * t)))[:, None]
    anim[:, :, 0] += (0.003 * np.sin(2 * np.pi * 0.5 * t))[:, None]
    renderer.render(anim)  # builds the kernel, warms the allocators

    def events_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out

    faces, valid, lights = renderer._faces_padded, renderer._face_valid, renderer.lights
    chunk = torch.as_tensor(anim[:64])
    stages: dict[str, float] = {}
    stages["vertices_to_device_ms"], vd = events_ms(lambda: chunk.to(dev))
    stages["project_and_shade_ms"], proj = events_ms(lambda: rd.project_and_shade(vd, faces, lights))

    def prepass():
        coefs, bbox = rz.plane_coefficients(*proj, faces, valid, height=height, width=width)
        rd._crop_window(proj[0], proj[1], proj[4], height=height, width=width,
                        crop_h=rd.CROP_H, crop_w=rd.CROP_W)
        return coefs, bbox

    stages["prepass_ms"], (coefs, bbox) = events_ms(prepass)
    stages["k5_rasterize_keys_ms"], _ = events_ms(
        lambda: rz.rasterize_keys(coefs, bbox, height=height, width=width))
    whole_ms, packed = events_ms(lambda: rd.render_frames_tiled_packed(vd, faces, valid, lights))
    stages["crop_and_pack_ms"] = whole_ms - (
        stages["project_and_shade_ms"] + stages["prepass_ms"] + stages["k5_rasterize_keys_ms"])
    pinned = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    stages["copy_to_pinned_host_ms"], _ = events_ms(lambda: pinned.copy_(packed, non_blocking=True))
    torch.cuda.synchronize()
    tic = time.perf_counter()
    crops, offs, fit = rd.unpack_rendered(pinned.numpy())
    frames = [rd.paste_crop(crops[i], offs[i], height, width) for i in range(64)]
    stages["host_unpack_and_paste_ms"] = 1e3 * (time.perf_counter() - tic)
    if not fit.all() or frames[0].shape != (height, width, 3):
        raise AssertionError("the packed batch does not unpack to fitting frames")

    rz.rasterize_keys.launches = 0
    torch.cuda.synchronize()
    tic = time.perf_counter()
    images = renderer.render(anim)
    wall = time.perf_counter() - tic
    launches = rz.rasterize_keys.launches
    if len(images) != n_frames or (images[0][:, :, 0] != rd.BG_COLOR).mean() < 0.05:
        raise AssertionError("the render did not draw the head")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        renderer.render(anim)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - tic
    by_group, busy_us = device_ms_by_group(prof)
    copy_us = 1e3 * by_group.get("copies", 0.0)
    print(profile_table(prof))

    result = {
        "card": card,
        "render": f"{n_frames} frames, {mesh.n_verts} vertices, {mesh.n_faces} triangles, {height} x {width}",
        "wall_s": wall,
        "frames_per_s": n_frames / wall,
        "k5_launches": launches,
        "one_batch_of_64_frames": stages,
        "packed_batch_bytes": packed.numel(),
        "traced_wall_s": traced_wall,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "device_idle_share": (1.0 - busy_us / 1e6 / traced_wall) if busy_us else None,
        "device_kernel_ms": (busy_us - copy_us) / 1e3 if busy_us else None,
        "device_ms_by_group": by_group,
    }
    print(json.dumps({"render_breakdown": result}))
    return 0


if __name__ == "__main__":
    modes = {(): main, ("train",): train_main, ("render",): render_main}
    if tuple(sys.argv[1:]) not in modes:
        sys.exit("usage: torch_flagship_breakdown.py [train|render]")
    sys.exit(modes[tuple(sys.argv[1:])]())
