#!/usr/bin/env python3
"""What holds the tile rasterizer (K5) back, by ablation, on one GPU.

Builds copies of ``csrc/rasterizer.cu`` into ``build/k5_ablation/`` with one
part of the kernel taken out or changed, and times each on the smoke's
transfer batch (64 frames of the synthetic 5,023-vertex head at 800 x 800,
a NaN frame and an enlarged frame among them), twice in turn, with CUDA
events:

- ``full``: the kernel as it is;
- ``no_eval``: the cull runs, no survivor is evaluated (the chunk walk,
  copies, culls and key writes alone);
- ``no_div``: the shade is soz, not soz / iz (no IEEE division on an inside
  pixel);
- ``all_rows``: a survivor is tested on all 16 rows, not only on its row
  range;
- ``corner_only``: the cull's corner tests without its x/y range tests
  (more survivors, a cheaper cull, all rows);
- ``no_cull``: every triangle of an overlapping chunk is evaluated on every
  sub-tile and row (the work of the design before the cull);
- ``min_blocks_1``, ``min_blocks_16``: ``__launch_bounds__`` asks for 1
  (the compiler's own register count) or 16 resident blocks an SM instead
  of 10;
- ``count_pairs``: each warp writes the number of (triangle, sub-tile)
  pairs it evaluated in place of its keys; their sum must equal
  ``ops/rasterizer.py subtile_pairs``, the plain count of the same cull.

Every variant but ``no_eval`` and ``no_div`` must still equal the plain
version (they cull less, or compute the same keys otherwise), and is
checked; the compiler's register and spill report of each is printed.
``python3 tools/torch_k5_ablation.py`` from the repository root; prints one
JSON line per variant and check and, last, ``{"ablation_ms": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

HOOKS = {  # macro: (text in the source, text with the hook)
    "NO_EVAL": (
        "        for (int s = 0; s < n_surv; ++s) {",
        "#ifdef ABL_COUNT_PAIRS\n        n_pairs += n_surv;\n#endif\n"
        "#ifdef ABL_NO_EVAL\n        n_surv = 0;\n#endif\n        for (int s = 0; s < n_surv; ++s) {",
    ),
    "COUNT_PAIRS": (
        "  int g = 0;",
        "#ifdef ABL_COUNT_PAIRS\n  int n_pairs = 0;\n#endif\n  int g = 0;",
    ),
    "COUNT_PAIRS_OUT": (
        "  const int col = sx + lane;",
        "#ifdef ABL_COUNT_PAIRS\n#pragma unroll\n"
        "  for (int r = 0; r < STRIP_H; ++r) key[r] = r == 0 && lane == 0 ? n_pairs : 0;\n#endif\n"
        "  const int col = sx + lane;",
    ),
    "NO_DIV": (
        "              const float sh = __fdiv_rn(soz, fmaxf(iz, 1e-12f));",
        "#ifdef ABL_NO_DIV\n              const float sh = soz;\n#else\n"
        "              const float sh = __fdiv_rn(soz, fmaxf(iz, 1e-12f));\n#endif",
    ),
    "ALL_ROWS": (
        "            if (r > r_hi) break;",
        "#ifndef ABL_ALL_ROWS\n            if (r > r_hi) break;\n#endif",
    ),
    "ALL_ROWS_2": (
        "            if (r < r_lo) continue;",
        "#ifndef ABL_ALL_ROWS\n            if (r < r_lo) continue;\n#endif",
    ),
    "CORNER_ONLY": (
        "  const float p = __fmul_rn(b0, c1), q = __fmul_rn(b1, c0);",
        "#ifdef ABL_CORNER_ONLY\n  return ALL_ROWS;\n#endif\n  const float p = __fmul_rn(b0, c1), q = __fmul_rn(b1, c0);",
    ),
    "NO_CULL": (
        "  const float4 r0 = reinterpret_cast<const float4*>(tri)[0];",
        "#ifdef ABL_NO_CULL\n  return ALL_ROWS;\n#endif\n  const float4 r0 = reinterpret_cast<const float4*>(tri)[0];",
    ),
    "MIN_BLOCKS": (
        "constexpr int MIN_BLOCKS = 10;",
        "#ifdef ABL_MIN_BLOCKS\nconstexpr int MIN_BLOCKS = ABL_MIN_BLOCKS;\n#else\n"
        "constexpr int MIN_BLOCKS = 10;\n#endif",
    ),
}
VARIANTS = {
    "full": [],
    "no_eval": ["-DABL_NO_EVAL"],
    "no_div": ["-DABL_NO_DIV"],
    "all_rows": ["-DABL_ALL_ROWS"],
    "corner_only": ["-DABL_CORNER_ONLY"],
    "no_cull": ["-DABL_NO_CULL"],
    "min_blocks_1": ["-DABL_MIN_BLOCKS=1"],
    "min_blocks_16": ["-DABL_MIN_BLOCKS=16"],
    "count_pairs": ["-DABL_COUNT_PAIRS"],
}
CHECKED = ("full", "all_rows", "corner_only", "no_cull", "min_blocks_1", "min_blocks_16")


def build(out_dir: Path) -> dict[str, Path]:
    from audio2face_tpu_torch.ops import _build

    src_dir = out_dir / "src"
    src_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (src_dir / header.name).write_text(header.read_text())
    text = (_build.CSRC / "rasterizer.cu").read_text()
    for name, (old, new) in HOOKS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"hook {name} does not match csrc/rasterizer.cu any more")
        text = text.replace(old, new)
    (src_dir / "rasterizer.cu").write_text(text)
    libs = {name: out_dir / f"{name}.so" for name in VARIANTS}
    procs = {
        name: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-o", str(libs[name]),
                                str(src_dir / "rasterizer.cu")],
                               stdout=open(out_dir / f"{name}.log", "w"), stderr=subprocess.STDOUT)
        for name, defs in VARIANTS.items()
    }
    failed = [name for name, p in procs.items() if p.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k5_ablation: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from audio2face_tpu_torch.data.synthetic import generate_synthetic_face_obj
    from audio2face_tpu_torch.ops import rasterizer as rz
    from audio2face_tpu_torch.utils import renderer as rd
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    fns = {}
    out_dir = REPO / "build" / "k5_ablation"
    for name, path in build(out_dir).items():
        print(json.dumps({name: cs.ptxas_report((out_dir / f"{name}.log").read_text())}), flush=True)
        fn = ctypes.CDLL(str(path)).a2f_rasterize_keys
        fn.argtypes, fn.restype = rz._ARGTYPES, ctypes.c_int
        fns[name] = fn
    mesh = FaceMesh.load(generate_synthetic_face_obj(str(REPO / "build" / "k5_ablation" / "head.obj")))
    renderer = rd.Renderer(mesh)
    head = np.asarray(mesh.verts, np.float32)
    frames = head[None] * (1.0 + 0.01 * np.sin(np.arange(64) / 5.0))[:, None, None].astype(np.float32)
    frames[5], frames[9] = np.nan, head * 3.0
    faces, valid = renderer._faces_padded, renderer._face_valid
    proj = rd.project_and_shade(torch.as_tensor(frames, device=dev), faces, renderer.lights)
    h, w = rd.FRUSTUM["height"], rd.FRUSTUM["width"]
    coefs, bbox = rz.plane_coefficients(*proj, faces, valid, height=h, width=w)
    ref = rz.rasterize_keys_reference(coefs, bbox, height=h, width=w)
    out = torch.empty_like(ref)
    times: dict[str, list[float]] = {}
    for rnd in range(2):
        for name, fn in fns.items():
            def call(fn=fn):
                rc = fn(coefs.data_ptr(), bbox.data_ptr(), out.data_ptr(), coefs.shape[0],
                        bbox.shape[1], h, w, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError_t {rc}")
            if rnd == 0 and name == "count_pairs":
                call()
                counted, plain = int(out.long().sum()), int(rz.subtile_pairs(coefs, bbox, height=h, width=w).sum())
                print(json.dumps({"check": name, "kernel_subtile_pairs": counted, "plain_subtile_pairs": plain}),
                      flush=True)
                cs.require(counted == plain, f"the kernel evaluated {counted} pairs, subtile_pairs counts {plain}")
            if rnd == 0 and name in CHECKED:
                call()
                differing = int((out != ref).sum())
                print(json.dumps({"check": name, "differing_pixels": differing}), flush=True)
                cs.require(differing == 0, f"{name}: {differing} pixels differ from the plain version")
            times.setdefault(name, []).append(cs.cuda_ms(torch, call, 5 if name == "no_cull" else 20))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"ablation_ms": times, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
