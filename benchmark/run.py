#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds everything by name: the cell ``benchmark/workloads/<cell>.json``
names its configuration (``benchmark/configs/<config>.json``, built by
``<config>.py`` beside it), its traffic mix (``benchmark/traffic/<mix>.json``,
whose ``driver`` names the general driver in ``benchmark/drivers/``) and the
limits of its output check. ``BENCHMARK.json`` at the root says which
metrics the cell reports; each per-layer metric is read by
``benchmark/metrics/<metric>.py``.

A run builds the configuration's weights on the card from the seed, builds
the program (the ``audio2face_tpu_torch`` port) on them and warms the
cell's own shapes (set-up, ``setup_s``), drives the traffic for
``--seconds`` (with ``--trace 1`` under the profiler, with harness spans
around the program's layers), reads the peak memory, frees the program,
and recomputes a seeded sample of the window's answers with the plain f32
reference (``benchmark/reference/``). It prints each compared number
beside its limit on standard error, and last on standard output one JSON
line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end
metrics, or with ``--trace 1`` the per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last.

Exits non-zero with no result when no CUDA device is there (or fewer than
the cell asks for), or when JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio2face_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into ``build/torch_kernels/`` itself)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    # libraries that would load JAX on their own
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell as the drivers see it."""

    name: str
    cfg: dict
    cfgmod: object
    traffic: dict
    driver: object
    seed: int
    device: str
    limits: dict
    chips: int = 1
    span: Callable = field(default=None)

    def sync(self) -> None:
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()


def load_cell(name: str, seed: int, device: str = "cuda", bench: Path = BENCH) -> Cell:
    """The cell ``name`` from its files under ``bench``."""
    import importlib

    wl = read_json(bench / "workloads" / f"{name}.json")
    cfg = read_json(bench / "configs" / f"{wl['config']}.json")
    traffic = read_json(bench / "traffic" / f"{wl['traffic']}.json")
    cfgmod = load_module(bench / "configs" / f"{wl['config']}.py", f"bench_config_{wl['config']}")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return Cell(name=name, cfg=cfg, cfgmod=cfgmod, traffic=traffic, driver=driver, seed=seed,
                device=device, limits=wl["limits"], chips=wl["chips"])


def cell_metrics(bench_json: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` prints: with ``trace`` the per-layer
    ones listed for it (or, unlisted, those moving an end-to-end metric the
    cell reports), else its end-to-end ones."""
    e2e = [m for m in bench_json["end_to_end"]
           if m["name"] == "setup_s" or cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench_json["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def run_cell(cell: Cell, seconds: float, trace: bool, bench_json: dict, t0: float = T0) -> dict:
    """Set up, drive the window, check; the result line as a dict."""
    import torch

    from benchmark import trace as tracing
    from benchmark.reference.common import f32_exact

    cuda = str(cell.device).startswith("cuda")
    spans = tracing.Spans()
    cell.span = spans.wrap if trace else tracing.no_span
    state = cell.driver.setup(cell)
    setup_s = time.perf_counter() - t0
    with tracing.profiled(trace) as prof:
        with spans.window() if trace else contextlib.nullcontext():
            win = cell.driver.window(cell, state, seconds)
            cell.sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.driver.teardown(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    wanted = cell_metrics(bench_json, cell.name, trace)
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        tr = tracing.Trace(prof, spans.spans) if prof is not None else None
        del prof
        ctx = SimpleNamespace(trace=tr, window=win, cfg=cell.cfg, cfgmod=cell.cfgmod, cell=cell)
        for m in wanted:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py", "bench_metric")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            breakdown = tr.breakdown()
            dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
            print(f"trace: {len(tr.device)} device events, {tr.matched} matched to launches, "
                  f"{len(tr.spans)} harness spans", file=sys.stderr)
    else:
        values = {**win.metrics, "setup_s": setup_s}
        for m in wanted:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    f32_exact()
    checks = cell.driver.check(cell, state, win)
    correct = win.failed == 0 and all(
        checks[k] <= lim for k, lim in cell.limits.items())
    result = {
        "correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak, **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": checks[k], "limit": lim} for k, lim in cell.limits.items()}
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    bench_json = read_json(ROOT / "BENCHMARK.json")
    cell = load_cell(args.workload, args.seed)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seconds, bool(args.trace), bench_json)
    found = forbidden_modules()
    if found:
        print(f"run.py: the process imported {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"result: {result['attempted']} attempted, {result['failed']} failed", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r}, limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
