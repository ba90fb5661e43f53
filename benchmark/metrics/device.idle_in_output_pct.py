"""Share of the traced window's device idle time during which the innermost
program span open was the output path's: ``predict.head``,
``predict.copy`` or ``predict.unpack``. Layer: the device. Read from the
profiler's trace and the program's recording (``ctx.program``)."""

from benchmark.program_trace import idle_by_span, program_of

OUTPUT = ("predict.head", "predict.copy", "predict.unpack")


def read(ctx):
    rec = program_of(ctx)
    if rec is None or ctx.trace is None:
        return None
    idle = idle_by_span(ctx.trace, rec)
    total = sum(idle.values())
    if total <= 0:
        return None
    return 100.0 * sum(idle.get(name, 0.0) for name in OUTPUT) / total
