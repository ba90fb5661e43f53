"""Host wall time of the program's ``predict.copy`` spans per request: each
chunk's ``.cpu().numpy()``, in which the host waits for the chunk's device
work still in flight and for its pageable copy (``request.d2h_ms`` gives
the copy's own device time). Layer: the request output path
(``serving.py``). Read from the program's recording (``ctx.program``)."""

from benchmark.program_trace import program_of, wall_s


def read(ctx):
    rec = program_of(ctx)
    if rec is None or not ctx.window.records:
        return None
    return 1e3 * wall_s(rec, "predict.copy") / len(ctx.window.records)
