#!/usr/bin/env python3
"""A short check of the f32 attention kernels on one GPU: K1's f32 forward
(the short-key path for t_k <= 64 and the tiled path) and K4's f32 backward.

It builds the sources, prints the f32 kernels' registers and spills
(``-Xptxas -v``) and their launch plans (shared memory a block, resident
blocks per SM, blocks launched) at the frame-window, training and predictor
shapes, runs ``chip_smoke.attention_variant_checks`` (every head dim and
option, f32 on both sides of the short-key bound), and then the readings of
``chip_smoke.f32_attention_readings`` and K1 f32 at the frame window by CUDA
events beside its plain version and SDPA. Raises on a miss.

``python3 tools/torch_attention_f32_check.py`` from the root of a checkout.
The kernels come from the package in the current directory and the checks
from the ``chip_smoke.py`` beside this file, so the same file reads another
checkout's kernels when run from that checkout's root:
``python3 /path/to/tools/torch_attention_f32_check.py --readings-only``
(only the readings, which need nothing the older wrapper lacks).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())  # the checkout whose kernels are read
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_f32_check: CUDA is not available", file=sys.stderr)
        return 1
    readings_only = "--readings-only" in sys.argv[1:]
    from audio2face_tpu_torch.ops import _build
    from audio2face_tpu_torch.ops import attention as attn_ops

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    tic = time.perf_counter()
    _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - tic, "package": attn_ops.__file__}), flush=True)
    for lib in ("flash_attention", "flash_attention_bwd"):
        log = (_build.BUILD_DIR / f"{lib}.log").read_text()
        warnings = [line for line in log.splitlines() if "warning" in line.lower()]
        if warnings:
            print("\n".join(warnings)[-3000:], flush=True)
        for name, rep in cs.ptxas_report(log).items():
            if "f32" in name:
                print(json.dumps({name: rep}), flush=True)

    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(device=dev, dtype=dtype)

    if not readings_only:
        for bh, t in ((1024 * 12, 25), (96, 600), (96, 3600)):
            print(json.dumps({"f32_plan": [64, bh, t, t], **attn_ops.f32_kernel_plan(64, bh, t, t)}),
                  flush=True)
        tic = time.perf_counter()
        checks = cs.attention_variant_checks(torch, attn_ops, randn)
        print(json.dumps({"variant_checks": checks, "s": time.perf_counter() - tic}), flush=True)

    # K1 f32 at the frame window by CUDA events, as chip_smoke.py 9c reads it
    q, k, v = (randn(1024, 12, 25, 64) for _ in range(3))
    out = attn_ops.flash_attention(q, k, v)
    ref = attn_ops.mha_reference(q, k, v)
    rel = cs.row_scaled_err(out, ref)
    cs.require(rel <= cs.K1_F32_ROW_TOL, f"K1 f32 frame window: {rel} > {cs.K1_F32_ROW_TOL}")
    print(json.dumps({"frame_window_events": {
        "err_over_row_max": rel, "tol": cs.K1_F32_ROW_TOL,
        "ms": cs.cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v), 20),
        "plain_ms": cs.cuda_ms(torch, lambda: attn_ops.mha_reference(q, k, v), 10),
        "sdpa_ms": cs.cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 20),
    }}), flush=True)
    del q, k, v, out, ref
    torch.cuda.empty_cache()
    print(json.dumps({"f32_readings": cs.f32_attention_readings(torch, attn_ops, randn, smi)}), flush=True)
    # K4 f32's two kernels apart, at the training shape without dropout
    b, h, t, d = 8, 12, 600, 64
    q, k, v, go = (randn(b, h, t, d) for _ in range(4))
    kvl = torch.tensor([600, 600, 450, 300, 600, 150, 600, 30], dtype=torch.int32, device=dev)
    out, lse = attn_ops.flash_attention(q, k, v, kv_lengths=kvl, return_lse=True)
    print(json.dumps({"k4_f32_split_ms": kernel_split_ms(
        torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, kv_lengths=kvl), 20)}), flush=True)
    return 0


def kernel_split_ms(torch, fn, calls: int) -> dict:
    """Device ms a call of ``fn`` spends in each kernel (by name, without
    its argument list), by the profiler over ``calls`` calls after a warm one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return split


if __name__ == "__main__":
    sys.exit(main())
