"""A kernel's share of its roofline over the traced window: the bound of
the valid work of the window's answered clips (the configuration's
``kernel_work``, from ``benchmark/counts/work.py``) over the kernel's
device time."""

from benchmark.counts.work import bound_s


def share(ctx, kernel: str, name_part: str):
    if ctx.trace is None:
        return None
    lengths = [n for r in ctx.window.records if r.get("frames") for n in r["lengths"]]
    work = ctx.cfgmod.kernel_work(ctx.cfg, lengths).get(kernel)
    t = ctx.trace.device_seconds(lambda name: name_part in name)
    if work is None or t <= 0:
        return None
    flops, nbytes, peak = work
    return 100.0 * bound_s(nbytes, flops, peak) / t
