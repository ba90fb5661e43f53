"""Device time of the work launched inside the harness's span around the
frame predictor's feature extractor, per request. Layer: features
(``models/extractor.py``, ``ops/dsp.py``)."""


def read(ctx):
    if ctx.trace is None or not ctx.window.records:
        return None
    s = ctx.trace.device_seconds(lambda name: True, span_name="features")
    return 1e3 * s / len(ctx.window.records) if s > 0 else None
