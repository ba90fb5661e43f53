#!/usr/bin/env python3
"""A short first check of the decode loop (K3, both variants, widths 64 and
128) and the conv feature encoder (K2) on one GPU: build the sources, print
each kernel's registers and spills (``-Xptxas -v``), hold K3 and K2 once
against their plain versions at small shapes and at the main path's shapes,
print K3's cluster plan (cluster size, resident clusters, cache rows a CTA,
shared memory a CTA), time K3 with and without its cache walk (and, at
width 128, its plain loop), and split K2's launches by the profiler.

``python3 tools/torch_decode_conv_check.py`` from the repository root. It
prints readings (one JSON object a line) and holds no bars
(``chip_smoke.py`` does): it is the first, cheap run after an edit of
``csrc/decode_loop.cu`` or of K2 (``csrc/conv_encoder*``). The cache walk is taken
out in a copy of ``csrc/decode_loop.cu`` built into
``build/decode_conv_variants/`` (each CTA then attends to row 0 alone: wrong
results on purpose), which gives the dense chain's own time a step.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

# the copies of a source with parts changed: (source, {text: replacement})
N_STAMPS = 16
STAMP = "if (tid == 0 && blockIdx.x == 0 && t < N_STAMPED) a2f_stamps[t * 16 + {k}] = clock64();\n"


def stamped(text: str, k: int) -> str:
    return STAMP.format(k=k) + text


VARIANTS = {
    # the walk bounded to row 0 (each CTA then attends to it alone)
    "no_walk": ("decode_loop.cu", {
        "const int n_local = t >= rank ? (t - rank) / cl + 1 : 0;": "const int n_local = rank == 0 ? 1 : 0;",
    }),
    # the SM clock of CTA 0's thread 0 at 16 points of each of the first steps
    "stamps": ("decode_loop.cu", {
        "namespace cg = cooperative_groups;":
            "namespace cg = cooperative_groups;\nconstexpr int N_STAMPED = 512;\n"
            "__device__ long long a2f_stamps[N_STAMPED * 16];",
        "  for (int t = 0; t < n_steps; ++t) {\n": "  for (int t = 0; t < n_steps; ++t) {\n" + stamped("", 0),
        "    put_row<V>(pv, x, lane);\n": "    put_row<V>(pv, x, lane);\n" + stamped("", 1),
        "      });\n      __syncthreads();\n      qs = sc + L::S_Q;\n":
            "      });\n" + stamped("      __syncthreads();\n", 2) + stamped("      qs = sc + L::S_Q;\n", 3),
        "      // the warp's partial: rescale to the warp's max, then plain sums,":
            stamped("      // the warp's partial: rescale to the warp's max, then plain sums,", 4),
        "      __syncwarp();  // the warp's reads of its row (q | k | v) are done":
            stamped("      __syncwarp();  // the warp's reads of its row (q | k | v) are done", 5),
        "    mbar_wait_cluster(xbar + 8 * par, phase);  // every CTA's partials are here\n":
            stamped("    mbar_wait_cluster(xbar + 8 * par, phase);\n", 6) + stamped("", 7),
        "      if (qq == 0) sc[L::S_ATTN + e] = asum / lsum;\n    }\n    __syncthreads();\n":
            "      if (qq == 0) sc[L::S_ATTN + e] = asum / lsum;\n    }\n"
            + stamped("    __syncthreads();\n", 8) + stamped("", 9),
        "      __syncthreads();\n      y = sc + L::S_Y0;\n    } else {\n      y = split_matvec(KD{}, w_o,":
            stamped("      __syncthreads();\n", 10) + stamped("      y = sc + L::S_Y0;\n", 11)
            + "    } else {\n      y = split_matvec(KD{}, w_o,",
        "    // h = LN3(h + W_2 relu(W_1 h))\n    put_row<V>(pv, h, lane);\n":
            "    // h = LN3(h + W_2 relu(W_1 h))\n    put_row<V>(pv, h, lane);\n" + stamped("", 12),
        "fmaxf(v, 0.f); });\n      __syncthreads();\n":
            "fmaxf(v, 0.f); });\n" + stamped("      __syncthreads();\n", 13) + stamped("", 14),
        "    warp_layer_norm<V>(h, ln + L::LN3S, ln + L::LN3B, lane);":
            stamped("    warp_layer_norm<V>(h, ln + L::LN3S, ln + L::LN3B, lane);", 15),
        "// layout[0] = packed weights":
            "extern \"C\" int a2f_read_stamps(long long* host) {\n"
            "  return cudaMemcpyFromSymbol(host, a2f_stamps, sizeof(a2f_stamps));\n}\n\n"
            "// layout[0] = packed weights",
    }),
    # K2's GEMM: no GELU in the epilogue; no tile copies past the ring's
    # first fill (stale tiles); no products
    "no_gelu": ("conv_encoder.cuh", {
        "pack_bf16(gelu(acc[4 * j + 2 * hh]), gelu(acc[4 * j + 2 * hh + 1]))":
            "pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1])",
    }),
    "no_loads": ("conv_encoder.cuh", {
        "    if (tid == 0 && kt < nk) {": "    if (tid == 0 && kt < nk && kt < STAGES) {",
        "    mbar_wait(full + 8 * (kt % STAGES), (kt / STAGES) & 1);":
            "    if (kt < STAGES) mbar_wait(full + 8 * (kt % STAGES), (kt / STAGES) & 1);",
    }),
    "no_mma": ("conv_encoder.cuh", {
        "      wgmma_ss_n256(acc, desc_sw128(stage + 64 * wg * BK * 2 + 32 * kk),\n"
        "                    desc_sw128(stage + A_BYTES + 32 * kk), 1);": "      ;",
    }),
}
STAGES = ("x, prefetch, own row", "q|k|v matvec", "its barrier", "walk", "warp merge",
          "partial pushed", "wait for the partials", "combine", "its barrier", "W_o matvec",
          "its barrier", "LN1, cross, LN2, own row", "W_1 matvec", "its barrier", "W_2 matvec + barrier",
          "LN3, out, W_fb + barrier, emb")
WIDTHS = (64, 128)


def build_variants(out_dir: Path) -> dict[str, Path]:
    """Each of VARIANTS built into ``out_dir`` (in parallel): the sources
    copied into a directory of its own with its one file changed, and the
    library of that file's stem built (a header's: its ``.cu`` of the same
    name)."""
    from audio2face_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    procs, libs = {}, {}
    for name, (source, hooks) in VARIANTS.items():
        src_dir = out_dir / "src" / name
        src_dir.mkdir(parents=True, exist_ok=True)
        for f in (*_build.CSRC.glob("*.cuh"), *_build.CSRC.glob("*.cu")):
            (src_dir / f.name).write_text(f.read_text())
        text = (_build.CSRC / source).read_text()
        for old, new in hooks.items():
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in csrc/{source} any more")
            text = text.replace(old, new)
        (src_dir / source).write_text(text)
        libs[name] = out_dir / f"lib{name}.so"
        procs[name] = subprocess.Popen([_build._nvcc(), *flags, "-o", str(libs[name]),
                                        str(src_dir / (source.rsplit(".", 1)[0] + ".cu"))])
    failed = [name for name, proc in procs.items() if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return libs


@contextlib.contextmanager
def library(lib_name: str, path: Path):
    """Route the wrapper's entry points of ``lib_name`` to the library at ``path``."""
    from audio2face_tpu_torch.ops import _build

    lib, orig = ctypes.CDLL(str(path)), _build.function

    def function(name, symbol, argtypes):
        if name != lib_name:
            return orig(name, symbol, argtypes)
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    _build.function = function
    try:
        yield
    finally:
        _build.function = orig


@contextlib.contextmanager
def forced_cluster(dk, key, planned: dict, cluster):
    """Launch the decode kernel with ``cluster`` CTAs an item (None: the plan's)."""
    if cluster is None:
        yield
        return
    dk._plans[key] = dict(planned, **dk.cluster_plan(key[1], cluster, key[2], key[3],
                                                     planned["smem_limit"], key[5]))
    try:
        yield
    finally:
        dk._plans[key] = planned


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_conv_check: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.models.faceformer import periodic_positional_encoding
    from audio2face_tpu_torch.ops import _build
    from audio2face_tpu_torch.ops import conv_encoder as ce
    from audio2face_tpu_torch.ops import decode_kernel as dk

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    tic = time.perf_counter()
    _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - tic}), flush=True)
    for lib in ("decode_loop", "conv_encoder", "conv_encoder_ln"):
        log = (_build.BUILD_DIR / f"{lib}.log").read_text()
        warnings = [line for line in log.splitlines() if "warning" in line.lower()]
        print(json.dumps({lib: cs.ptxas_report(log), "warnings": warnings[-10:]}), flush=True)

    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(device=dev, dtype=dtype)

    def weights_for(d):
        w32 = {}
        for name, shape in [("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)),
                            ("cq", (d, d)), ("co", (d, d)), ("f1", (d, 2 * d)), ("f2", (2 * d, d)),
                            ("fb", (d, d))]:
            # a weak feedback: the autoregression does not amplify rounding differences
            w32[f"{name}_kernel"] = randn(*shape, scale=0.4 / d ** 0.5 if name == "fb" else d ** -0.5)
            w32[f"{name}_bias"] = randn(shape[1], scale=0.1)
        for i in (1, 2, 3):
            w32[f"ln{i}_scale"], w32[f"ln{i}_bias"] = 1 + randn(d, scale=0.1), randn(d, scale=0.1)
        w16 = {k: (v if k.startswith("ln") else v.to(torch.bfloat16)) for k, v in w32.items()}
        return {torch.float32: w32, torch.bfloat16: w16}

    weights = {d: weights_for(d) for d in WIDTHS}

    def decode_inputs(b, t, biwi, dtype, d=64):
        kw = dict(period=25 if biwi else 60)
        pe = torch.as_tensor(periodic_positional_encoding(kw["period"], d), device=dev).to(dtype)
        if biwi:
            kw.update(mem_k=randn(b, 4, 2 * t, d // 4, scale=0.5, dtype=dtype),
                      mem_v=randn(b, 4, 2 * t, d // 4, scale=0.5, dtype=dtype))
            cross = None
        else:
            cross = randn(b, t, d, scale=0.5, dtype=dtype)
        return cross, randn(b, d, scale=0.5, dtype=dtype), pe, kw

    # ---- K3: plans and agreement with the plain version (width 128: its
    # cluster sizes forced too, the exchanges at 16, 8, 4 and 2 CTAs)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(False, 2, 150, f32, 64, None), (False, 8, 3600, bf16, 64, None),
             (False, 1, 7200, bf16, 64, None), (False, 2, 3600, f32, 64, None),
             (False, 20, 200, bf16, 64, None), (True, 2, 150, f32, 64, None),
             (True, 8, 750, bf16, 64, None), (True, 1, 6300, bf16, 64, None),
             (True, 2, 150, f32, 128, None), (False, 2, 150, f32, 128, None),
             (True, 8, 1500, bf16, 128, None), (True, 8, 1500, f32, 128, None),
             (False, 8, 1500, bf16, 128, None), (True, 1, 6000, bf16, 128, None),
             (True, 20, 200, bf16, 128, None), (True, 3, 400, bf16, 128, 16),
             (True, 3, 400, f32, 128, 4), (True, 3, 400, bf16, 128, 2)]
    for biwi, b, t, dtype, d, cl in cases:
        w = weights[d][dtype]
        cross, style, pe, kw = decode_inputs(b, t, biwi, dtype, d)
        plan = dk.kernel_cluster_plan(b, t, dev, biwi, dtype == bf16, d)
        with forced_cluster(dk, (b, t, biwi, dtype == bf16, style.device, d), plan, cl):
            out = dk.faceformer_decode_loop(cross, style, pe, w, **kw)
            torch.cuda.synchronize()
            used = dk._plans[(b, t, biwi, dtype == bf16, style.device, d)]
        ref = dk.decode_loop_reference(cross, style, pe, w, **kw)
        diff = (out.float() - ref.float()).abs()
        over = (diff - (cs.K3_BF16_STEP if dtype == bf16 else 0.0) * ref.float().abs()).max().item()
        print(json.dumps({"K3": "biwi" if biwi else "vocaset", "width": d, "shape": [b, t],
                          "dtype": str(dtype)[6:], "plan": used, "max_abs_err": diff.max().item(),
                          "err_beyond_one_bf16_step" if dtype == bf16 else "err": over,
                          "tol": cs.K3_F32_TOL, "finite": bool(torch.isfinite(out.float()).all())}),
              flush=True)

    # ---- K3 with and without the cache walk, at the serving shapes; the
    # walk-free kernel also at forced cluster sizes (cl: the plan's, 4, 1),
    # whose difference is the cluster barrier's and the partials' exchange;
    # at width 128 the plain loop
    libs = build_variants(REPO / "build" / "decode_conv_variants")
    times = {}
    shapes = ((False, 8, 3600, 64, (("full", None), ("no_walk", None), ("no_walk", 4), ("no_walk", 1))),
              (True, 8, 750, 64, (("full", None), ("no_walk", None), ("no_walk", 4), ("no_walk", 1))),
              (True, 8, 1500, 128, (("full", None), ("no_walk", None))))
    for biwi, b, t, d, variants in shapes:
        cross, style, pe, kw = decode_inputs(b, t, biwi, bf16, d)
        w16 = weights[d][bf16]
        key = f"{'biwi' if biwi else 'vocaset'} ({b}, {t}, {d})"
        pkey = (b, t, biwi, True, style.device, d)
        planned = dk.kernel_cluster_plan(b, t, dev, biwi, True, d)
        for rnd in range(2):
            for label, cl in variants:
                ctx = library("decode_loop", libs[label]) if label != "full" else contextlib.nullcontext()
                with ctx, forced_cluster(dk, pkey, planned, cl):
                    ms = cs.cuda_ms(torch, lambda: dk.faceformer_decode_loop(cross, style, pe, w16, **kw), 3)
                times.setdefault(f"{key} {label} cl={cl or planned['cluster']}", []).append(
                    {"ms": ms, "us_per_step": 1e3 * ms / t})
        if d == 128:
            ref_ms = cs.cuda_ms(torch, lambda: dk.decode_loop_reference(cross, style, pe, w16, **kw), 1)
            times[f"{key} plain loop"] = [{"ms": ref_ms}]
    print(json.dumps({"K3_ms": times, "card": card}), flush=True)
    # the SM clocks between the stages of a step, CTA 0 of item 0, steps 64-511
    cross, style, pe, kw = decode_inputs(8, 3600, False, bf16)
    with library("decode_loop", libs["stamps"]):
        dk.faceformer_decode_loop(cross, style, pe, weights[64][bf16], **kw)
    torch.cuda.synchronize()
    stamps = (ctypes.c_longlong * (512 * N_STAMPS))()
    fn = ctypes.CDLL(str(libs["stamps"])).a2f_read_stamps
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    cs.require(fn(ctypes.addressof(stamps)) == 0, "reading the stamps failed")
    # each stage ends at the next stamp; the last at the next step's first
    st = [list(stamps[N_STAMPS * i: N_STAMPS * (i + 1)]) for i in range(64, 512)]
    ends = [row[1:] + [nxt[0]] for row, nxt in zip(st, st[1:])]
    cycles = {name: sum(e[k] - row[k] for row, e in zip(st, ends)) / len(ends)
              for k, name in enumerate(STAGES)}
    print(json.dumps({"K3_stage_cycles (8, 3600) bf16": cycles,
                      "step_cycles": sum(st[i + 1][0] - st[i][0] for i in range(len(st) - 1)) / (len(st) - 1)}),
          flush=True)

    # ---- K2: agreement, time, and its launches split by the profiler
    from audio2face_tpu_torch.models.wav2vec2 import FeatureEncoder, Wav2Vec2Config

    torch.manual_seed(0)  # the convs' default initialization
    fe = FeatureEncoder(Wav2Vec2Config()).to(dev)
    kernels = [conv.weight.permute(2, 1, 0) for conv in fe.conv_layers]
    gscale, gbias = fe.group_norm.weight, fe.group_norm.bias
    for b, n, lens in ((2, 2503, [2503, 0]),
                       (8, 960000, [960000, 960000, 720000, 480000, 960000, 240000, 960000, 48000])):
        x = randn(b, n)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = ce.fused_conv_encoder(x, kernels, gscale, gbias, lens)
        ref = ce.conv_encoder_reference(x, kernels, gscale, gbias, lens)
        errs = [(out[i, :ce.stack_output_length(int(m))].float()
                 - ref[i, :ce.stack_output_length(int(m))].float()).abs().max().item()
                for i, m in enumerate(lens.tolist()) if ce.stack_output_length(int(m)) > 0]
        print(json.dumps({"K2": [b, n], "max_abs_err": max(errs),
                          "tol": 0.05 * ref.float().abs().max().item(),
                          "finite": bool(torch.isfinite(out.float()).all())}), flush=True)
    ms = cs.cuda_ms(torch, lambda: ce.fused_conv_encoder(x, kernels, gscale, gbias, lens), 5)
    launches = cs.k2_launch_ms(torch, lambda: ce.fused_conv_encoder(x, kernels, gscale, gbias, lens))
    print(json.dumps({"K2_ms": ms, "K2_launches_ms": launches,
                      "K2_launches_sum_ms": sum(t for _, t in launches), "card": card}), flush=True)
    ablation = {}
    for rnd in range(2):
        for name in ("full", "no_gelu", "no_loads", "no_mma"):
            ctx = library("conv_encoder", libs[name]) if name != "full" else contextlib.nullcontext()
            with ctx:
                ablation.setdefault(name, []).append(
                    cs.cuda_ms(torch, lambda: ce.fused_conv_encoder(x, kernels, gscale, gbias, lens), 3))
                if rnd == 0:
                    ablation[f"{name} launches"] = cs.k2_launch_ms(
                        torch, lambda: ce.fused_conv_encoder(x, kernels, gscale, gbias, lens))
    print(json.dumps({"K2_ablation_ms": ablation, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
