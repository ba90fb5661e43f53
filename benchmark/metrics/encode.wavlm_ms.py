"""Device time of the work launched inside the harness's span around the
model's audio encoder (WavLM Large: the conv stack and its layer norms, the
fps adapter, the projection, the positional conv, the 24 layers with K1's
gated bias), per request. Layer: encoder."""


def read(ctx):
    if ctx.trace is None or not ctx.window.records:
        return None
    s = ctx.trace.device_seconds(lambda name: True, span_name="encode")
    return 1e3 * s / len(ctx.window.records) if s > 0 else None
