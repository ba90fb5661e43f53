#!/usr/bin/env python3
"""A short first check of the attention kernels (K1 forward, K4 backward)
on one GPU: build the sources, print each bf16 kernel's registers and spills
(``-Xptxas -v``), shared memory per block and resident blocks per SM, hold
K1 and K4 against their plain versions over every head dim, dtype and option
at small shapes and at the main path's shapes, and time them beside
``scaled_dot_product_attention``.

``python3 tools/torch_attention_check.py`` from the repository root. It
uses ``chip_smoke.py``'s checks and bars and raises on a miss; it is the
first, cheap run after an edit of ``csrc/flash_attention*.cu``,
``csrc/flash_common.cuh`` or ``csrc/wgmma.cuh``, before the whole smoke.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_check: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.ops import _build
    from audio2face_tpu_torch.ops import attention as attn_ops

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tic = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - tic:.1f} s", flush=True)
    for lib in ("flash_attention", "flash_attention_bwd"):
        log = (_build.BUILD_DIR / f"{lib}.log").read_text()
        print("\n".join(line for line in log.splitlines() if "warning" in line.lower())[-3000:])
        for name, rep in cs.ptxas_report(log).items():
            print(json.dumps({name: rep}))
    for d in (16, 32, 64, 128):
        print(json.dumps({"head_dim": d, **attn_ops.wgmma_occupancy(d)}), flush=True)

    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(device=dev, dtype=dtype)

    print(json.dumps(cs.attention_variant_checks(torch, attn_ops, randn)), flush=True)

    bf = torch.bfloat16
    # K1 at the serving shape
    b, h, t, d = 8, 12, 3600, 64
    q, k, v = (randn(b, h, t, d, dtype=bf) for _ in range(3))
    kvl = torch.tensor([3600, 3600, 2700, 1800, 3600, 900, 3600, 180], dtype=torch.int32, device=dev)
    for kw in (dict(kv_lengths=kvl), dict(causal=True, alibi_period=60)):
        out = attn_ops.flash_attention(q, k, v, **kw)
        ref = attn_ops.mha_reference(q, k, v, **kw)
        rel = cs.row_scaled_err(out, ref)
        print(json.dumps({"K1 serving": str(list(kw)), "err_over_row_max": rel, "tol": cs.K1_BF16_ROW_TOL}))
        cs.require(rel <= cs.K1_BF16_ROW_TOL, f"K1 serving {list(kw)}: {rel}")
    mask = (torch.arange(t, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    times = {
        "k1_serving_ms": cs.cuda_ms(torch, lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl), 10),
        "sdpa_serving_ms": cs.cuda_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask), 10),
    }
    del q, k, v, out, ref
    # K4 (and K1) at the training shape
    b, h, t, d = 8, 12, 600, 64
    q, k, v, go = (randn(b, h, t, d, dtype=bf) for _ in range(4))
    kvl = torch.tensor([600, 600, 450, 300, 600, 150, 600, 30], dtype=torch.int32, device=dev)
    drop = dict(dropout_rate=0.1, dropout_seed=torch.tensor([20240607], dtype=torch.int32, device=dev))
    for kw in (dict(kv_lengths=kvl, **drop), dict(causal=True, alibi_period=60, **drop)):
        out, lse = attn_ops.flash_attention(q, k, v, return_lse=True, **kw)
        got = attn_ops.flash_attention_bwd(q, k, v, out, lse, go, **kw)
        want = attn_ops.flash_attention_bwd_reference(q, k, v, out, lse, go, **kw)
        errs = [cs.row_scaled_err(a, w, cs.K4_ROW_FLOOR) for a, w in zip(got, want)]
        print(json.dumps({"K4 training": str([n for n in kw if n != "dropout_seed"]),
                          "dq_dk_dv_err_over_row_max": errs, "tol": cs.K4_BF16_ROW_TOL}))
        cs.require(max(errs) <= cs.K4_BF16_ROW_TOL, f"K4 training {list(kw)}: {errs}")
    out, lse = attn_ops.flash_attention(q, k, v, kv_lengths=kvl, return_lse=True, **drop)
    mask = (torch.arange(t, device=dev)[None, :] < kvl[:, None])[:, None, None, :]
    times["k1_train_dropout_ms"] = cs.cuda_ms(
        torch, lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl, **drop), 20)
    times["sdpa_train_ms"] = cs.cuda_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask), 20)
    times["k4_train_dropout_ms"] = cs.cuda_ms(
        torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, kv_lengths=kvl, **drop), 20)
    times["k4_train_ms"] = cs.cuda_ms(
        torch, lambda: attn_ops.flash_attention_bwd(q, k, v, out, lse, go, kv_lengths=kvl), 20)
    with torch.enable_grad():
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask)
        times["sdpa_bwd_train_ms"] = cs.cuda_ms(
            torch, lambda: torch.autograd.grad(lib_out, leaves, go, retain_graph=True), 20)
    print(json.dumps({"times": times, "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
