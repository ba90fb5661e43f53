#!/usr/bin/env python3
"""A short first check of the rasterizer kernel and the decode loop's BIWI
variant on one GPU: build the sources, print the compiler's register,
spill and shared-memory report for the two, run each kernel once at its real
widths against its plain version, hold the rasterizer to its plain version
on adversarial frames (slivers, huge and edge-touching triangles, a NaN
frame), count its work (box pixels, tile-chunk pairs, evaluated sub-tile
pairs) and bound, and time it and one 180-frame render.

``python3 tools/torch_k5_biwi_check.py`` from the repository root. It prints
readings and holds no bars (``chip_smoke.py`` does): it is the first, cheap
run after an edit of ``csrc/rasterizer.cu`` or ``csrc/decode_loop.cu``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k5_biwi_check: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.data.synthetic import adversarial_screen_triangles, generate_synthetic_face_obj
    from audio2face_tpu_torch.models.faceformer import periodic_positional_encoding
    from audio2face_tpu_torch.ops import _build
    from audio2face_tpu_torch.ops import decode_kernel as dk
    from audio2face_tpu_torch.ops import rasterizer as rz
    from audio2face_tpu_torch.utils import renderer as rd
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tic = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - tic:.1f} s")
    from chip_smoke import ptxas_report, PEAK_HBM_BYTES, PEAK_F32_FLOPS, K5_OPS_PER_PIXEL

    for name in ("rasterizer", "decode_loop"):
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        print(json.dumps({f"{name} ptxas": ptxas_report(log)}))

    # ---- the BIWI decode variant, f32, a small shape and the serving shape
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    w = {}
    for name, shape in [("q", (64, 64)), ("k", (64, 64)), ("v", (64, 64)), ("o", (64, 64)),
                        ("cq", (64, 64)), ("co", (64, 64)), ("f1", (64, 128)), ("f2", (128, 64)),
                        ("fb", (64, 64))]:
        # a weak feedback: the autoregression does not amplify rounding differences
        w[f"{name}_kernel"] = randn(*shape, scale=0.05 if name == "fb" else 0.125)
        w[f"{name}_bias"] = randn(shape[1], scale=0.1)
    for i in (1, 2, 3):
        w[f"ln{i}_scale"], w[f"ln{i}_bias"] = 1 + randn(64, scale=0.1), randn(64, scale=0.1)
    pe = torch.as_tensor(periodic_positional_encoding(25), device=dev)
    for b, t in [(3, 40), (8, 750)]:
        kw = dict(period=25, mem_k=randn(b, 4, 2 * t, 16, scale=0.5), mem_v=randn(b, 4, 2 * t, 16, scale=0.5))
        style = randn(b, 64, scale=0.5)
        out = dk.faceformer_decode_loop(None, style, pe, w, **kw)
        ref = dk.decode_loop_reference(None, style, pe, w, **kw)
        torch.cuda.synchronize()
        print(f"K3 BIWI f32 ({b}, {t}): max |kernel - plain| {(out - ref).abs().max().item():.3g}")

    # ---- the rasterizer: 64 frames of the 5,023-vertex head, a NaN and an enlarged frame
    mesh = FaceMesh.load(generate_synthetic_face_obj("build/k5_check_assets/head.obj"))
    renderer = rd.Renderer(mesh)
    head = np.asarray(mesh.verts, np.float32)
    frames = np.stack([head * (1 + 0.002 * i) for i in range(64)])
    frames[5], frames[9] = np.nan, head * 3.0
    faces, valid, lights = renderer._faces_padded, renderer._face_valid, renderer.lights
    proj = rd.project_and_shade(torch.as_tensor(frames, device=dev), faces, lights)
    coefs, bbox = rz.plane_coefficients(*proj, faces, valid, height=800, width=800)
    keys = rz.rasterize_keys(coefs, bbox, height=800, width=800)
    ref = rz.rasterize_keys_reference(coefs, bbox, height=800, width=800)
    torch.cuda.synchronize()
    print(f"K5 (64, 800, 800): {int((keys != ref).sum())} of {keys.numel()} pixels differ from the "
          f"plain version; covered share {(keys != 0).float().mean().item():.4f}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        for _ in range(10):
            rz.rasterize_keys(coefs, bbox, height=800, width=800)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    box_pixels = rz.triangle_box_pixels(proj[0], proj[1], faces, coefs, height=800, width=800)
    sub_pairs = rz.subtile_pairs(coefs, bbox, height=800, width=800)
    tile_pairs = rz.tile_chunk_pairs(bbox, height=800, width=800)
    nbytes = (coefs.numel() + bbox.numel() + keys.numel()) * 4
    bound_ms = 1e3 * max(nbytes / PEAK_HBM_BYTES, K5_OPS_PER_PIXEL * box_pixels.sum().item() / PEAK_F32_FLOPS)
    print(json.dumps({"K5 (64, 800, 800)": {
        "ms_of_5_repeats": times, "bound_ms": bound_ms, "bytes": nbytes,
        "triangle_box_pixels": box_pixels.sum().item(), "frame0_box_pixels": box_pixels[0].item(),
        "tile_chunk_pairs": tile_pairs.sum().item(), "frame0_tile_chunk_pairs": tile_pairs[0].item(),
        "subtile_pairs": sub_pairs.sum().item(), "frame0_subtile_pairs": sub_pairs[0].item()}}))

    # ---- adversarial frames: slivers, huge and edge-touching triangles, a NaN frame
    adv = [[torch.as_tensor(a, device=dev) for a in adversarial_screen_triangles(s, 800, 800)]
           for s in range(4)]
    for a in adv[3][:2]:
        a.fill_(float("nan"))
    pairs = [rz.plane_coefficients(*a, height=800, width=800) for a in adv]
    ac, ab = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    keys = rz.rasterize_keys(ac, ab, height=800, width=800)
    ref = rz.rasterize_keys_reference(ac, ab, height=800, width=800)
    torch.cuda.synchronize()
    print(f"K5 adversarial (4, 800, 800): {int((keys != ref).sum())} of {keys.numel()} pixels differ "
          f"from the plain version; covered share {(keys[:3] != 0).float().mean().item():.4f}; "
          f"NaN frame background {not bool(keys[3].any())}")

    # ---- one clip through the pipelined render, cold then warm
    anim = np.stack([head * (1 + 0.001 * np.sin(i / 10)) for i in range(180)])
    for label in ("cold", "warm"):
        tic = time.perf_counter()
        images = renderer.render(anim)
        print(f"render of 180 frames, {label}: {time.perf_counter() - tic:.3f} s")
    full = renderer._render_frames_tiled(anim[:3])
    print("first frames equal their full-frame renders:",
          all(np.array_equal(a, b) for a, b in zip(full, images)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
