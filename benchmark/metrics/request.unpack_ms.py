"""Host wall time of the program's ``predict.unpack`` spans per request:
the ``np.empty`` of every clip's result and the scatter of each copied
chunk's valid rows into them. Layer: the request output path
(``serving.py``). Read from the program's recording (``ctx.program``)."""

from benchmark.program_trace import program_of, wall_s


def read(ctx):
    rec = program_of(ctx)
    if rec is None or not ctx.window.records:
        return None
    return 1e3 * wall_s(rec, "predict.unpack") / len(ctx.window.records)
