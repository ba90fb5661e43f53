"""Device time of the work launched inside the harness's spans around the
Conformer blocks' convolution modules (LayerNorm, pointwise product, GLU,
the zeroing of padded frames, depthwise conv, BatchNorm, SiLU, pointwise
product; 24 a model call), per request. Layer: encoder."""


def read(ctx):
    if ctx.trace is None or not ctx.window.records:
        return None
    s = ctx.trace.device_seconds(lambda name: True, span_name="conv_module")
    return 1e3 * s / len(ctx.window.records) if s > 0 else None
