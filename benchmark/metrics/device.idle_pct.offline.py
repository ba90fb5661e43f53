"""Share of the traced window in which no kernel, copy or set ran on the
device. Layer: device."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct()
