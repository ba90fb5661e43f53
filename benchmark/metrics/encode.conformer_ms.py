"""Device time of the work launched inside the harness's span around the
model's audio encoder (the wav2vec2-Conformer: the conv stack in K2's
layer-norm mode with the conv biases, the fps adapter, the projection, the
24 blocks with K1's Transformer-XL term, the LayerNorm after them), its
``conv_module`` spans included, per request. Layer: encoder."""


def read(ctx):
    if ctx.trace is None or not ctx.window.records:
        return None
    s = sum(ctx.trace.device_seconds(lambda name: True, span_name=span)
            for span in ("encode", "conv_module"))
    return 1e3 * s / len(ctx.window.records) if s > 0 else None
