"""K3 (``ops/decode_kernel.py``, ``decode_cluster_kernel``): bound (its
f32 arithmetic against the f32 peak) over device time, one decode step a
valid frame. Layer: kernels."""

from benchmark.metrics.kernel_roofline import share


def read(ctx):
    return share(ctx, "k3", "decode_cluster_kernel")
