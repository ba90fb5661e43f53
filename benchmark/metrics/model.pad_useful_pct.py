"""Share of the frames the model computes that are valid: the program's
counters ``frames_valid`` over ``frames_computed`` (FaceFormer: every row
of the batch grid at the padded bucket's frames, per model call; the frame
models: every row's whole chunk). For the frame models this equals
``request.copy_useful_pct`` by construction, since the copy takes what was
computed; FaceFormer's copy of overlapping head chunks reads below it. The
two part once the copy sends only valid rows. Layer: the model."""

from benchmark.program_trace import program_of


def read(ctx):
    rec = program_of(ctx)
    computed = rec.counters.get("frames_computed", 0) if rec is not None else 0
    if computed <= 0:
        return None
    return 100.0 * rec.counters.get("frames_valid", 0) / computed
