"""What the plain references share: f32 products with TF32 off, and the
lower-precision control that puts fp8 operands into every product.

The references import torch alone: nothing of the program, of its tests or
of JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def f32_exact() -> None:
    """Products in true f32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448), returned in f32: the operand an fp8 product
    would read."""
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], quant: Quant = None):
    return F.linear(q(x, quant), q(w, quant), b)


def conv1d(x, w, b=None, quant: Quant = None, **kw):
    return F.conv1d(q(x, quant), q(w, quant), b, **kw)


def conv2d(x, w, b=None, quant: Quant = None, **kw):
    return F.conv2d(q(x, quant), q(w, quant), b, **kw)
