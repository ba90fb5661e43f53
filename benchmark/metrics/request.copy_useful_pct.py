"""Share of the vertex bytes copied to the host that the requests return:
the program's counters ``vertex_bytes_returned`` over
``vertex_bytes_copied``. The copy takes whole padded chunks: every row of
the batch grid, over the frame models' whole 128-frame chunks, where this
equals ``model.pad_useful_pct`` by construction, and over FaceFormer's
vertex-head chunks (at most 512 MB: 1,113 frames at a batch of 8, the last
realigned to the bucket's end, so frames of long buckets are copied twice),
where it reads below it. It parts further from it once the copy sends only
valid rows. Layer: the request output path (``serving.py``)."""

from benchmark.program_trace import program_of


def read(ctx):
    rec = program_of(ctx)
    copied = rec.counters.get("vertex_bytes_copied", 0) if rec is not None else 0
    if copied <= 0:
        return None
    return 100.0 * rec.counters.get("vertex_bytes_returned", 0) / copied
