"""Device time of the work launched inside the harness's span around the
model's decoder (``FaceFormer.decode``: the latents' cross key and value
projections and the decode loop, K3), per request. Layer: decoder."""


def read(ctx):
    if ctx.trace is None or not ctx.window.records:
        return None
    s = ctx.trace.device_seconds(lambda name: True, span_name="decode")
    return 1e3 * s / len(ctx.window.records) if s > 0 else None
