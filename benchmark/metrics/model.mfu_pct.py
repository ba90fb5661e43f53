"""The model's operations on the valid clips of the traced window's
requests (the configuration's count in ``benchmark/counts/work.py``),
over those requests' wall time times the bf16 peak. Layer: the model."""

from benchmark.counts.work import PEAK_BF16_FLOPS


def read(ctx):
    recs = [r for r in ctx.window.records if r.get("frames")]
    wall = sum(r["wall"] for r in recs)
    if wall <= 0:
        return None
    flops = sum(ctx.cfgmod.flops(ctx.cfg, n) for r in recs for n in r["lengths"])
    return 100.0 * flops / (wall * PEAK_BF16_FLOPS)
