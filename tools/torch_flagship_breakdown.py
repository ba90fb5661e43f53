#!/usr/bin/env python3
"""Where the time of the port's flagship request goes, on one GPU.

Serves 8 clips x 60 s through the full-width bf16 FaceFormerPredictor of
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
then, last, one JSON line ``{"breakdown": {...}}``. Run from the
repository root: ``python3 tools/torch_flagship_breakdown.py``.
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
    ("K2 conv encoder", ("conv0_moments", "gn_fold", "conv0_gelu", "strided_conv_gemm")),
    ("K3 decode loop", ("decode_loop_kernel",)),
    ("library conv", ("convolve", "cudnn", "winograd", "fft")),
    ("library matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("copies", ("memcpy", "Memcpy", "memset", "Memset")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other elementwise/reduction"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flagship_breakdown: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
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
    copy_us = 1e3 * by_group.get("copies", 0.0)
    try:
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    except (KeyError, AttributeError, ValueError):  # older profilers name it cuda
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
    print(table)

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
        "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
    }
    print(json.dumps({"breakdown": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
