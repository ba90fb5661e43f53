#!/usr/bin/env python3
"""What holds the f32 attention forward back, by ablation, on one GPU.

Builds copies of ``csrc/flash_attention.cu`` into
``build/attention_f32_ablation/`` with one part of a kernel taken out or
changed, and times each twice in turn with CUDA events:

- the short-key kernel at the frame window (1024, 12, 25, 64): ``full``;
  ``no_scores`` (each lane's partial dot products replaced by a q value:
  no K loads, no FMAs); ``no_pv`` (no V loads or value FMAs);
  ``no_scores_no_pv``; ``r4`` (four query rows a group instead of two, so
  that each K/V row a group loads serves four rows, at more registers and
  fewer resident blocks); beside ``torch.addcmul(q, k, v)``, one pass that
  reads and writes the same bytes (the memory yardstick);
- the tiled kernel at the f32 training shape (8, 12, 600, 64), kv_lengths
  30-600: ``full``; ``no_scores`` (no S = Q K^T product); ``no_acc`` (no O
  += P V product); ``no_scores_no_acc``; ``no_loads`` (the K/V ring filled
  for the first two tiles only).

The ablated kernels compute wrong results on purpose; ``full`` and ``r4``
are checked against the plain version. Prints one JSON line per variant
group, with each variant's plan (shared memory a block, blocks per SM) and
registers.

``python3 tools/torch_attention_f32_ablation.py`` from the repository root.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

SHORT_HOOKS = {  # text in the source: text with the hook
    "          if (SK_G * ch + u < t_k) {\n            float kr[NV];":
        "          if (SK_G * ch + u < t_k && X_SCORES) {\n            float kr[NV];",
    "          for (int r = 0; r < R; ++r) part[r][u] = 0.f;  // keys past t_k: masked below":
        "          for (int r = 0; r < R; ++r) part[r][u] = X_SCORES ? 0.f : qv[r][u % NV];",
    "          if (SK_G * ch + u < t_k) {\n            float vr[NV];":
        "          if (SK_G * ch + u < t_k && X_PV) {\n            float vr[NV];",
    "constexpr int SK_R = 2; ": "constexpr int SK_R = X_R; ",
}
TILED_HOOKS = {
    "    ft_scores<D>(Qs, Ks, mp, s);":
        "    if (X_SCORES) ft_scores<D>(Qs, Ks, mp, s);\n"
        "    else for (int i = 0; i < 4; ++i) for (int j = 0; j < 4; ++j) s[i][j] = Ks[mp.col(j)] * (i + 1);",
    "    ft_accumulate<D>(Xs, Vs, mp, acc);":
        "    if (X_ACC) ft_accumulate<D>(Xs, Vs, mp, acc);\n    else acc[0][0] += Xs[mp.row(0) * FT_XP] + Vs[tid];",
    "    load_kv(kt + 1);\n    const float* Ks":
        "    if (X_LOADS || kt == 0) load_kv(kt + 1); else cp_async_commit();\n    const float* Ks",
}
DEFAULTS = {"X_SCORES": 1, "X_PV": 1, "X_R": 2, "X_ACC": 1, "X_LOADS": 1}
SHORT = {"full": {}, "no_scores": {"X_SCORES": 0}, "no_pv": {"X_PV": 0},
         "no_scores_no_pv": {"X_SCORES": 0, "X_PV": 0}, "r4": {"X_R": 4}}
TILED = {"full": {}, "no_scores": {"X_SCORES": 0}, "no_acc": {"X_ACC": 0},
         "no_scores_no_acc": {"X_SCORES": 0, "X_ACC": 0}, "no_loads": {"X_LOADS": 0}}


def build(out: Path) -> dict[str, Path]:
    from audio2face_tpu_torch.ops import _build

    text = (_build.CSRC / "flash_attention.cu").read_text()
    for hooks in (SHORT_HOOKS, TILED_HOOKS):
        for a, b in hooks.items():
            if a not in text:
                raise RuntimeError(f"hook not found in flash_attention.cu: {a!r}")
            text = text.replace(a, b)
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_attention_ablation.cu"
    src.write_text(text)
    variants = {f"short_{n}": d for n, d in SHORT.items()} | {f"tiled_{n}": d for n, d in TILED.items()}
    libs, procs = {}, {}
    for name, defs in variants.items():
        flags = [f"-D{k}={defs.get(k, v)}" for k, v in DEFAULTS.items()]
        libs[name] = out / f"{name}.so"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-o", str(libs[name]), str(src)],
            stdout=open(out / f"{name}.log", "w"), stderr=subprocess.STDOUT)
    failed = [n for n, p in procs.items() if p.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}: " + (out / f"{failed[0]}.log").read_text()[-3000:])
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_f32_ablation: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.ops import attention as attn

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out_dir = REPO / "build" / "attention_f32_ablation"
    libs = build(out_dir)
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        fn, plan = lib.a2f_flash_attention_fwd, lib.a2f_flash_attention_fwd_f32_plan
        fn.argtypes, fn.restype = attn._FWD_ARGTYPES, ctypes.c_int
        plan.argtypes, plan.restype = attn._F32_PLAN_ARGTYPES, ctypes.c_int
        fns[name] = (fn, plan)

    g = torch.Generator().manual_seed(0)
    card = torch.cuda.get_device_name(0)
    for group, shape, kvl in (
        ("short", (1024, 12, 25, 64), None),
        ("tiled", (8, 12, 600, 64), [600, 600, 450, 300, 600, 150, 600, 30]),
    ):
        b, h, t, d = shape
        q, k, v = (torch.randn(b, h, t, d, generator=g).to(dev) for _ in range(3))
        kv = None if kvl is None else torch.tensor(kvl, dtype=torch.int32, device=dev)
        kvlen, slopes, seed, thr, keep, hix = attn._kernel_side_inputs(q, t, kv, 0.0, None)
        o, lse = torch.empty_like(q), torch.empty(b, h, t, device=dev)
        ref = attn.mha_reference(q, k, v, kv_lengths=kv)

        def call(fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), kvlen.data_ptr(),
                    slopes.data_ptr(), b, h, t, t, d, 0, 0, 0, d ** -0.5, seed.data_ptr(), thr, keep,
                    *hix, torch.cuda.current_stream().cuda_stream)
            cs.require(rc == 0, f"launch failed with {rc}")

        res = {}
        names = [n for n in fns if n.startswith(group)]
        for _ in range(2):
            for name in names:
                fn, _plan = fns[name]
                call(fn)
                torch.cuda.synchronize()
                if name.endswith(("full", "r4")):
                    err = cs.row_scaled_err(o, ref)
                    cs.require(err <= cs.K1_F32_ROW_TOL, f"{name}: {err}")
                res.setdefault(name, {"ms": []})["ms"].append(cs.cuda_ms(torch, lambda: call(fn), 30))
        for name in names:
            info = (ctypes.c_int * 5)()
            fns[name][1](d, b * h, t, t, info)
            reps = cs.ptxas_report((out_dir / f"{name}.log").read_text())
            kernel = "flash_fwd_f32_short_kernel<64, 32>" if group == "short" else "flash_fwd_f32_tiled_kernel<64>"
            res[name].update(smem_bytes=info[1], blocks_per_sm=info[2], registers=reps[kernel]["registers"])
        if group == "short":
            res["addcmul_ms"] = [cs.cuda_ms(torch, lambda: torch.addcmul(q, k, v), 30) for _ in range(2)]
        print(json.dumps({f"{group} {list(shape)}": res, "card": card}), flush=True)
        del q, k, v, o, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
