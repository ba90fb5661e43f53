"""The process's CPU time over the host wall time of the program's
``predict`` spans (one per predictor call): 100 is one core busy all
through the calls; the library's own threads may lift it above. Layer: the
host. Read from the program's recording (``ctx.program``)."""

from benchmark.program_trace import program_of, roots


def read(ctx):
    rec = program_of(ctx)
    calls = roots(rec) if rec is not None else []
    wall = sum(s.end_ns - s.start_ns for s in calls)
    if wall <= 0:
        return None
    return 100.0 * sum(s.cpu_ns for s in calls) / wall
