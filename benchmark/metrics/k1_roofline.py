"""K1 (``ops/attention.py``, the bf16 flash-attention forward
``flash_fwd_wgmma_kernel``): bound over device time, from the clips' valid
frames in every encoder layer. Layer: kernels."""

from benchmark.metrics.kernel_roofline import share


def read(ctx):
    return share(ctx, "k1", "flash_fwd_wgmma_kernel")
