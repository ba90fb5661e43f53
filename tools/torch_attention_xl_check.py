#!/usr/bin/env python3
"""A short first check of K1 with Transformer-XL relative-position
attention (``csrc/flash_attention_xl.cu``, the wav2vec2-Conformer's
attention) on one GPU: build, print the kernel's registers, spills and
``wgmma`` serialization (``-Xptxas -v``), its shared memory and blocks per
SM, hold it to ``mha_reference`` with the dense term over shapes with
``t_q != t_k``, ragged KV lengths and one query, and time it beside the
unbiased and the WavLM-biased K1 at (8, 16, 3600, 64), KV lengths 180-3600
(profiler device time).

``python3 tools/torch_attention_xl_check.py`` from the repository root;
``--cuobjdump DIR`` also compares the SASS of ``flash_attention.cu`` built
here with the same source of another checkout at DIR (built with the same
flags), whitespace normalized. Prints one JSON line a check and exits
non-zero on a miss.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# max |kernel - plain| over the plain output's RMS, against the unbiased
# kernel's own on the same q, k, v: bf16 operands and probabilities give the
# unbiased kernel 0.003-0.032 (growing with the count of outputs), the f16
# staging of terms of ~40 adds up to ~1x that (H100, the first reading:
# 0.0065-0.057); dropping the position term reads 2.9-32
OUT_BAR_X = 3.0
LSE_BAR = 0.05  # absolute, in nats (first reading 1e-5 to 1.5e-3)


def sass(lib: Path) -> list:
    """The library's SASS, whitespace normalized, without what names the
    source file: the header lines ``identifier = <path>`` and the hash of
    the path in the anonymous namespace's mangled name
    (``_GLOBAL__N__<hash>_``)."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return [re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", " ".join(line.split()))
            for line in out.splitlines() if line.strip() and "identifier" not in line]


def build_other(src_root: Path, out_dir: Path) -> Path:
    """flash_attention.cu of another checkout, built with this one's flags."""
    from audio2face_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libflash_attention_other.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src_root / "audio2face_tpu_torch" / "csrc" / "flash_attention.cu")],
                   check=True, capture_output=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cuobjdump", type=Path, default=None)
    ap.add_argument("--no-timing", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_xl_check: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.ops import _build
    from audio2face_tpu_torch.ops import attention as attn_ops

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tic = time.perf_counter()
    _build.build_all()
    print(json.dumps({"build_s": round(time.perf_counter() - tic, 1)}), flush=True)
    log = (_build.BUILD_DIR / "flash_attention_xl.log").read_text()
    warn = [line for line in log.splitlines() if "warning" in line.lower()]
    print(json.dumps({"ptxas": cs.ptxas_report(log), "warnings": warn[-8:],
                      **attn_ops.xl_occupancy()}), flush=True)
    ok = True

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def case(b, h, t_q, t_k, kv, radius=None):
        radius = max(t_q, t_k) - 1 if radius is None else radius
        bf = torch.bfloat16
        q, k, v = (randn(b, h, t, 64).to(bf) for t in (t_q, t_k, t_k))
        rel = randn(h, 2 * radius + 1, 64).to(bf)
        bias = randn(h, 2 * radius + 1, scale=8.0)
        kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
        out, lse = attn_ops.flash_attention(q, k, v, kv_lengths=kvl, rel_pos=rel,
                                            rel_pos_bias=bias, return_lse=True)
        f = torch.float32
        ref, ref_lse = attn_ops.mha_reference(q.to(f), k.to(f), v.to(f), kv_lengths=kvl,
                                              rel_pos=rel.to(f), rel_pos_bias=bias,
                                              return_lse=True)
        plain = attn_ops.mha_reference(q.to(f), k.to(f), v.to(f), kv_lengths=kvl)
        base = attn_ops.flash_attention(q, k, v, kv_lengths=kvl).float()
        rms = ref.square().mean().sqrt()
        unbiased = ((base - plain).abs().amax() / plain.square().mean().sqrt()).item()
        err = ((out.float() - ref).abs().amax() / rms).item()
        lse_err = (lse - ref_lse).abs().amax().item()
        return {"shape": [b, h, t_q, t_k], "kv": kv, "radius": radius, "err": err,
                "lse_err": lse_err,
                "unbiased_err": unbiased,
                "no_position_term": ((plain - ref).abs().amax() / rms).item(),
                "ok": bool(err < OUT_BAR_X * max(unbiased, 0.01) and lse_err < LSE_BAR)}

    for args_ in ((1, 1, 1, 1, [1]), (1, 2, 64, 64, [64]), (2, 3, 70, 70, [70, 33]),
                  (1, 2, 130, 300, [257]), (1, 2, 300, 130, [130]), (2, 2, 100, 100, [100, 1]),
                  (2, 16, 200, 200, [200, 150]), (2, 16, 900, 900, [900, 477]),
                  (2, 16, 3600, 3600, [3600, 1800])):
        r = case(*args_)
        ok &= r["ok"]
        print(json.dumps(r), flush=True)
    r = case(1, 2, 200, 200, [200], radius=400)  # a wider table than the call needs
    ok &= r["ok"]
    print(json.dumps(r), flush=True)

    if not args.no_timing:
        bf = torch.bfloat16
        b, h, t = 8, 16, 3600
        q, k, v = (randn(b, h, t, 64).to(bf) for _ in range(3))
        kvl = torch.linspace(180, 3600, b, device=dev).to(torch.int32)
        rel = randn(h, 2 * t - 1, 64).to(bf)
        bias = randn(h, 2 * t - 1, scale=8.0)
        rows = attn_ops.xl_position_rows(rel, bias)
        table = randn(h, 2 * 778 + 1)
        gate = randn(b, h, t, scale=0.1) + 1.0
        kv = attn_ops._kernel_side_inputs(q, t, kvl, 0.0, None)[0]
        fn = _build.function("flash_attention_xl", "a2f_flash_attention_fwd_xl",
                             attn_ops._XL_ARGTYPES)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, t), device=dev)

        def xl_kernel_only():
            fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
               kv.data_ptr(), rows.data_ptr(), b, h, t, t, 64, t - 1, 0.125,
               torch.cuda.current_stream().cuda_stream)

        timings = {}
        for name, call in (
                ("xl", xl_kernel_only),
                ("xl_call", lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl, rel_pos=rel,
                                                             rel_pos_bias=bias)),
                ("unbiased", lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl)),
                ("wavlm", lambda: attn_ops.flash_attention(q, k, v, kv_lengths=kvl,
                                                           rel_table=table, rel_gate=gate))):
            times, names = cs.profiled_ms(torch, call, 10)
            timings[name] = {"dev_ms": sorted(times)[len(times) // 2], "kernels": names}
        print(json.dumps({"timing_8x16x3600": timings}), flush=True)

    if args.cuobjdump is not None:
        here = sorted(_build.BUILD_DIR.glob("libflash_attention_*.so"))
        here = [p for p in here if re.match(r"libflash_attention_[0-9a-f]{16}\.so", p.name)]
        other = build_other(args.cuobjdump, ROOT / "build" / "sass_other")
        a, b_ = sass(here[-1]), sass(other)
        same = a == b_
        ok &= same
        differ = [[x, y] for x, y in zip(a, b_) if x != y][:4]
        print(json.dumps({"sass_flash_attention_equal": same, "lines": [len(a), len(b_)],
                          "first_differences": differ}), flush=True)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
