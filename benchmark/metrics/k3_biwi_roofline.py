"""K3 at the BIWI configuration's width (``decode_cluster_kernel`` at
D = 128): ``k3_roofline``'s reader, whose valid work is the configuration's
``kernel_work`` (``counts/faceformer_biwi.py k3_work`` in this cell).
Layer: kernels."""

from benchmark.metrics.k3_roofline import read  # noqa: F401
