"""K1 with Transformer-XL relative-position attention
(``flash_fwd_xl_kernel``): bound over device time, from the clips' valid
frames in each of the 24 Conformer blocks, the position term's operations
and the rows of R and the table counted
(``counts/faceformer_conformer.py k1_xl_work``). Layer: kernels."""

from benchmark.metrics.kernel_roofline import share


def read(ctx):
    return share(ctx, "k1_xl", "flash_fwd_xl_kernel")
