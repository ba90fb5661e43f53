"""K1 with WavLM's gated relative-position bias (``flash_fwd_wgmma_kernel``
in its biased instantiation): bound over device time, from the clips'
valid frames in each of the 24 encoder layers, the table and gate bytes
counted (``counts/faceformer_wavlm.py k1_relpos_work``). Layer: kernels."""

from benchmark.metrics.kernel_roofline import share


def read(ctx):
    return share(ctx, "k1", "flash_fwd_wgmma_kernel")
