#!/usr/bin/env python3
"""The program's own spans and counters against a traced window.

The port records spans and counters on its serving path while a recording
is open (``audio2face_tpu_torch/utils/spans.py``), on the clock the
profiler stamps its events with. This module reads such a recording beside
the harness's ``Trace``: the device's idle time by the innermost program
span open, the idle gaps named ``"<harness span>/<program span>"``, and the
walls and CPU time of the program's spans. The per-layer readers that use
it take the recording as ``ctx.program`` and read nothing without one.

``run.py`` does not open the recording yet, so the seven readers are not
listed in ``BENCHMARK.json``. Until it does, ``traced()`` runs one cell's
traced window with the recording open, as ``run.py --trace 1`` does, and
``PROGRAM_METRICS`` names the readers it calls::

    python3 benchmark/program_trace.py --workload <cell> --seed <n> --seconds <s>

It prints one JSON line: the cell's per-layer metrics and those read from
the recording, the breakdown with the gaps so named, and the idle seconds
and the wall time a request by program span.
"""

from __future__ import annotations

import bisect
import heapq
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

OUTSIDE = "outside"  # idle time with no program span open
# the per-layer metrics read from the program's recording: {name: unit}
PROGRAM_METRICS = {
    "request.d2h_wait_ms": "ms",
    "request.unpack_ms": "ms",
    "request.copy_useful_pct": "%",
    "model.pad_useful_pct": "%",
    "request.host_cpu_pct": "%",
    "device.idle_in_output_pct": "%",
}


def program_of(ctx):
    """The recording a reader's ``ctx`` carries, or None."""
    return getattr(ctx, "program", None)


def closed(rec, name: Optional[str] = None) -> list:
    """The recording's spans that ended (named ``name``)."""
    return [s for s in rec.spans if s.end_ns is not None and (name is None or s.name == name)]


def wall_s(rec, name: str) -> float:
    """Seconds of host wall time in the spans named ``name``."""
    return sum(s.end_ns - s.start_ns for s in closed(rec, name)) / 1e9


def roots(rec) -> list:
    """The outermost spans that ended: one per predictor call."""
    return [s for s in closed(rec) if s.parent is None and s.cpu_ns is not None]


def innermost(spans: list, t0: int, t1: int) -> list:
    """``[t0, t1)`` cut into (start, end, name) pieces, each named by the
    innermost of ``spans`` ((start, end, name) each) open in it, the latest
    started, or None."""
    spans = sorted((max(a, t0), min(b, t1), name) for a, b, name in spans if b > t0 and a < t1)
    cuts = sorted({t0, t1, *(s[0] for s in spans), *(s[1] for s in spans)})
    out, open_, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(spans) and spans[k][0] <= a:
            heapq.heappush(open_, (-spans[k][0], spans[k][1], spans[k][2]))
            k += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        out.append((a, b, open_[0][2] if open_ else None))
    return out


def program_pieces(trace, rec) -> list:
    """The window cut by the innermost program span open."""
    return innermost([(s.start_ns, s.end_ns, s.name) for s in closed(rec)], trace.t0, trace.t1)


def idle_intervals(trace) -> list:
    """The window's (start, end) stretches with no device event."""
    out, edge = [], trace.t0
    for s, e, _, _ in trace.device:  # sorted by start
        s, e = max(s, trace.t0), min(e, trace.t1)
        if s > edge:
            out.append((edge, s))
        edge = max(edge, e)
    if trace.t1 > edge:
        out.append((edge, trace.t1))
    return out


def idle_by_span(trace, rec) -> dict:
    """Idle seconds of the window by the innermost program span open; an
    idle stretch is split over the spans that cover it."""
    pieces = program_pieces(trace, rec)
    out: dict = {}
    i = 0
    for a, b in idle_intervals(trace):
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            s, e, name = pieces[j]
            key = name or OUTSIDE
            out[key] = out.get(key, 0) + min(b, e) - max(a, s)
            j += 1
    return {k: v / 1e9 for k, v in out.items()}


def breakdown(trace, rec, n: int = 10) -> dict:
    """``trace.breakdown(n)`` with each of the longest idle gaps named
    ``"<harness span>/<program span>"`` when a program span was open where
    it began, else by the harness span alone as there."""
    out = trace.breakdown(n)
    gaps = sorted(((b - a, a) for a, b in idle_intervals(trace)), reverse=True)[:n]
    names = []
    for cut in (innermost(trace.spans, trace.t0, trace.t1), program_pieces(trace, rec)):
        starts = [p[0] for p in cut]
        names.append([cut[k][2] if k >= 0 else None
                      for k in (bisect.bisect_right(starts, a) - 1 for _, a in gaps)])
    out["idle_gaps"] = [[f"{h or 'window'}/{p}" if p else h or "window", g / 1e9]
                        for (g, _), h, p in zip(gaps, *names)]
    return out


# ---- running a cell with the recording open ---------------------------------


def traced(cell, seconds: float, bench_json: dict) -> dict:
    """One traced window of ``cell`` as ``run.py --trace 1`` runs it, with
    the program's recording open inside the profiler."""
    import torch

    from audio2face_tpu_torch.utils import spans as program
    from benchmark import run
    from benchmark import trace as tracing

    spans = tracing.Spans()
    cell.span = spans.wrap
    state = cell.driver.setup(cell)
    with tracing.profiled(True) as prof, spans.window(), program.recording() as rec:
        win = cell.driver.window(cell, state, seconds)
        cell.sync()
    peak = torch.cuda.max_memory_allocated() if str(cell.device).startswith("cuda") else 0
    cell.driver.teardown(state)
    tr = tracing.Trace(prof, spans.spans)
    del prof
    ctx = SimpleNamespace(trace=tr, window=win, cfg=cell.cfg, cfgmod=cell.cfgmod, cell=cell,
                          program=rec)
    wanted = {m["name"]: m["unit"] for m in run.cell_metrics(bench_json, cell.name, trace=True)}
    metrics = {}
    for name, unit in {**wanted, **PROGRAM_METRICS}.items():
        reader = run.load_module(run.BENCH / "metrics" / f"{name}.py", "bench_metric")
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    out = {"attempted": win.attempted, "failed": win.failed, "metrics": metrics,
           "device": {"memory_peak_bytes": peak, "busy_s": tr.busy_s, "window_s": tr.window_s}}
    out["breakdown"] = breakdown(tr, rec)
    out["idle_s_by_program_span"] = idle_by_span(tr, rec)
    walls: dict = {}
    for s in closed(rec):
        walls[s.name] = walls.get(s.name, 0) + s.end_ns - s.start_ns
    out["wall_ms_a_request_by_program_span"] = {
        k: v / 1e6 / max(1, len(win.records)) for k, v in walls.items()}
    out["counters"] = dict(rec.counters)
    return out


def main(argv: Optional[list] = None) -> int:
    import argparse
    import json

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.cache_dirs()
    import torch

    cell = run.load_cell(args.workload, args.seed)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"program_trace.py: the cell needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    out = traced(cell, args.seconds, run.read_json(run.ROOT / "BENCHMARK.json"))
    out = {"workload": args.workload, "seed": args.seed, "card": run.card_line(), **out}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
