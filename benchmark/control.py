#!/usr/bin/env python3
"""The output check's control: the plain reference put in the program's
place at the precision below the configuration's (bf16 -> fp8 operands in
every product), read by the cell's own comparison on the answers a window
would check.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--requests 45]

For each seed it rebuilds the cell's traffic, takes the sample of requests
that a window of ``--requests`` requests checks, computes their clips with
the fp8 reference, and prints the cell's compared numbers for them against
the f32 reference, one JSON line a seed. The benchmark's runs never run
it; it sets the upper reading of each limit (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def offline_sample(cell, reqs, n_requests: int) -> list:
    """The clips a window of ``n_requests`` requests would keep to check."""
    from benchmark.drivers.offline import check_sample, clips_of, offer_request

    sample = check_sample(cell.traffic, cell.seed)
    for r in range(n_requests):
        offer_request(sample, reqs.get(r), None)
    return clips_of(sample)


def control_reading(cell, n_requests: int) -> dict:
    import torch

    from benchmark.drivers.offline import Requests, compare_clips, reference_inputs
    from benchmark.reference.common import f32_exact, fp8_e4m3

    f32_exact()
    reqs = Requests(cell.cfg, cell.traffic, cell.seed)
    sample = offline_sample(cell, reqs, n_requests)
    w = cell.cfgmod.weights(cell.cfg, cell.seed, cell.device)
    audios, one_hot, templates = reference_inputs(reqs, sample, cell.cfg["n_styles"])
    for lo in range(0, len(sample), 8):
        outs = cell.cfgmod.reference(cell.cfg, w, audios[lo : lo + 8], one_hot[lo : lo + 8],
                                     templates[lo : lo + 8], cell.device, fp8_e4m3)
        for s, o in zip(sample[lo : lo + 8], outs):
            s["out"] = o.cpu().numpy()
    del w
    torch.cuda.empty_cache()
    return compare_clips(cell, reqs, sample)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=45)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    run.cache_dirs()
    for seed in args.seeds:
        cell = run.load_cell(args.workload, seed)
        t = time.perf_counter()
        reading = control_reading(cell, args.requests)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "fp8 reference",
                          **reading, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
