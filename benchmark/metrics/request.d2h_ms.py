"""Device time of the device-to-host copies per request (profiler's
``Memcpy DtoH`` events in the traced window, over the window's requests).
Layer: the request output path (``serving.py``)."""


def read(ctx):
    if ctx.trace is None or not ctx.window.records:
        return None
    s = ctx.trace.device_seconds(lambda name: "DtoH" in name)
    return 1e3 * s / len(ctx.window.records) if s > 0 else None
