#!/usr/bin/env python3
"""What holds the bf16 flash-attention forward (K1) back, by ablation, on one
GPU.

Builds copies of ``csrc/flash_attention.cu`` into ``build/attention_ablation/``
with one part of the kernel taken out or changed, and times each at the
serving shape (8, 12, 3600, 64) and the training shape (8, 12, 600, 64)
with the smoke's KV lengths, twice in turn, with CUDA events:

- ``full``: the kernel as it is (four warpgroups a block at D = 64);
- ``no_softmax``: scores go to the value product unscaled, no max, no exp;
- ``no_pv``: no O += P V product;
- ``no_loads``: the K/V ring is filled once and never again (stale tiles);
- ``nwg2``: two warpgroups a block and two blocks per SM (128 query rows
  share each K/V tile, not 256);

and the combinations ``no_loads_no_softmax`` and ``nwg2_no_loads``. The
ablated kernels compute wrong results on purpose; ``full`` and ``nwg2`` are
checked against the plain version.

``python3 tools/torch_attention_ablation.py`` from the repository root;
prints one JSON line per check and, last, ``{"ablation_ms": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

HOOKS = {  # macro: (text in the source, text with the hook)
    "NO_SOFTMAX": (
        "  const bool edge = k0 + BK > a.kvlen || (a.causal && k0 + BK - 1 > a.wg_row0);",
        "#ifdef ABL_NO_SOFTMAX\n  alpha[0] = alpha[1] = 1.f;\n  return;\n#endif\n"
        "  const bool edge = k0 + BK > a.kvlen || (a.causal && k0 + BK - 1 > a.wg_row0);",
    ),
    "NO_PV": (
        "    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mnmajor<D>(s_v_prev, kk), 1);\n"
        "    wgmma_commit();\n    wgmma_wait<1>();",
        "#ifndef ABL_NO_PV\n"
        "    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mnmajor<D>(s_v_prev, kk), 1);\n"
        "#endif\n    wgmma_commit();\n    wgmma_wait<1>();",
    ),
    "NO_LOADS": (  # the bf16 kernel's ring (the f32 tiled kernel has one too)
        "    if (kt <= last) {\n      const uint32_t stage = s_ring + (kt % C::STAGES)",
        "#ifdef ABL_NO_LOADS\n    if (kt <= last && kt < C::STAGES) {\n#else\n    if (kt <= last) {\n#endif\n"
        "      const uint32_t stage = s_ring + (kt % C::STAGES)",
    ),
    "NWG": (
        "  static constexpr int NWG = D == 64 ? 4 : 2;",
        "#ifndef ABL_NWG\n#define ABL_NWG (D == 64 ? 4 : 2)\n#endif\n  static constexpr int NWG = ABL_NWG;",
    ),
    "MIN_BLOCKS": (
        "__launch_bounds__(WgmmaFwd<D>::NT, 1)",
        "__launch_bounds__(WgmmaFwd<D>::NT, ABL_MIN_BLOCKS)",
    ),
}
ONE_BLOCK = ["-DABL_MIN_BLOCKS=1"]
TWO_BLOCKS_OF_TWO = ["-DABL_NWG=2", "-DABL_MIN_BLOCKS=2"]  # the design before four warpgroups
VARIANTS = {
    "full": ONE_BLOCK,
    "no_softmax": ONE_BLOCK + ["-DABL_NO_SOFTMAX"],
    "no_pv": ONE_BLOCK + ["-DABL_NO_PV"],
    "no_loads": ONE_BLOCK + ["-DABL_NO_LOADS"],
    "no_loads_no_softmax": ONE_BLOCK + ["-DABL_NO_LOADS", "-DABL_NO_SOFTMAX"],
    "nwg2": TWO_BLOCKS_OF_TWO,
    "nwg2_no_loads": TWO_BLOCKS_OF_TWO + ["-DABL_NO_LOADS"],
}
CHECKED = ("full", "nwg2")


def build(out_dir: Path) -> dict[str, Path]:
    from audio2face_tpu_torch.ops import _build

    src_dir = out_dir / "src"
    src_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (src_dir / header.name).write_text(header.read_text())
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for name, (old, new) in HOOKS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"hook {name} does not match csrc/flash_attention.cu any more")
        text = text.replace(old, new)
    (src_dir / "flash_attention.cu").write_text(text)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    libs = {name: out_dir / f"{name}.so" for name in VARIANTS}
    procs = {
        name: subprocess.Popen([_build._nvcc(), *flags, *defs, "-o", str(libs[name]),
                                str(src_dir / "flash_attention.cu")])
        for name, defs in VARIANTS.items()
    }
    failed = [name for name, p in procs.items() if p.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return libs


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_ablation: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from audio2face_tpu_torch.ops import attention as attn

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    fns = {}
    for name, path in build(REPO / "build" / "attention_ablation").items():
        fn = ctypes.CDLL(str(path)).a2f_flash_attention_fwd
        fn.argtypes, fn.restype = attn._FWD_ARGTYPES, ctypes.c_int
        fns[name] = fn
    g = torch.Generator().manual_seed(0)
    times: dict[str, list[float]] = {}
    for (b, h, t, d), kv in (((8, 12, 3600, 64), [3600, 3600, 2700, 1800, 3600, 900, 3600, 180]),
                             ((8, 12, 600, 64), [600, 600, 450, 300, 600, 150, 600, 30])):
        q, k, v = (torch.randn(b, h, t, d, generator=g).to(dev, torch.bfloat16) for _ in range(3))
        kvl = torch.tensor(kv, dtype=torch.int32, device=dev)
        ref = attn.mha_reference(q, k, v, kv_lengths=kvl)
        out, lse = torch.empty_like(q), torch.empty(b, h, t, device=dev)
        slopes = attn.device_alibi_slopes(h, dev)
        seed = torch.zeros(1, dtype=torch.int32, device=dev)
        for rnd in range(2):
            for name, fn in fns.items():
                def call(fn=fn):
                    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                            kvl.data_ptr(), slopes.data_ptr(), b, h, t, t, d, 1, 0, 0, d ** -0.5,
                            seed.data_ptr(), 0, 1.0, 0, 0, h, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: cudaError_t {rc}")
                if rnd == 0 and name in CHECKED:
                    call()
                    err = cs.row_scaled_err(out, ref)
                    print(json.dumps({"check": f"{name} T={t}", "err_over_row_max": err,
                                      "tol": cs.K1_BF16_ROW_TOL}), flush=True)
                    cs.require(err <= cs.K1_BF16_ROW_TOL, f"{name} T={t}: {err}")
                times.setdefault(f"{name} T={t}", []).append(cs.cuda_ms(torch, call, 20))
    print(json.dumps({"ablation_ms": times, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
