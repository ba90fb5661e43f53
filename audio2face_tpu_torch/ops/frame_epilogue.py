"""The frame models' conv-block epilogue: conv bias, BatchNorm with running
statistics and ReLU in one pass, a hand-written CUDA kernel + its plain
version.

``frame_epilogue(x, bias, bn, relu)`` computes ``relu?(bn?(x + bias?))`` over
an NCHW tensor, each stage optional: ``bias`` is a (C,) vector in ``x``'s
dtype (the conv's bias, cast as ``models/layers.py TorchConv`` casts it),
``bn`` a ``(mean, mul, beta)`` triple of (C,) f32 vectors with ``mul =
rsqrt(var + eps) * weight`` (``TorchBatchNorm.eval_affine``). CUDA tensors
launch ``csrc/frame_epilogue.cu``; CPU tensors run
``frame_epilogue_reference``, which is the per-op composition the frame
models run in training and on the CPU:

    v = x + bias                                    in x's dtype
    v = ((v.float() - mean) * mul + beta).to(x.dtype)
    v = relu(v)

The kernel takes the same steps with the same roundings, so on the card its
output equals that composition bit for bit. It has no backward: the models
take it only where autograd would record nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from audio2face_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, y, dtype, rows, channels, hw, bias, mean, mul, beta, relu, vector, stream
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])

BatchNormAffine = tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # mean, mul, beta


def frame_epilogue_reference(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                             bn: Optional[BatchNormAffine] = None, relu: bool = False,
                             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernel (module doc); ``out``, when given, receives
    the result."""
    y = x
    if bias is not None:
        y = y + bias[:, None, None]
    if bn is not None:
        mean, mul, beta = bn
        y = ((y.float() - mean[:, None, None]) * mul[:, None, None] + beta[:, None, None]).to(x.dtype)
    if relu:
        y = F.relu(y)
    return y if out is None else out.copy_(y)


def _check(x, bias, bn, out):
    if x.dim() != 4:
        raise ValueError(f"frame_epilogue takes NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"frame_epilogue runs in f32 or bf16, not {x.dtype}")
    c = x.shape[1]
    if bias is not None and (bias.shape != (c,) or bias.dtype != x.dtype or bias.device != x.device):
        raise ValueError(f"bias must be ({c},) {x.dtype} on {x.device}")
    for t in bn or ():
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"mean, mul and beta must be ({c},) f32 on {x.device}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device):
        raise ValueError("out must match x in shape, dtype and device")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _frame_epilogue_cuda(x, bias, bn, relu, out):
    for t in (x, out, bias, *(bn or ())):
        if t is not None and not t.is_contiguous():
            raise ValueError("frame_epilogue takes contiguous tensors")
    n, c, h, w = x.shape
    if x.numel() == 0:
        return out
    if c * h * w >= 2**31:
        raise ValueError(f"a row of {c * h * w} elements is over the kernel's 32-bit row index")
    vec = 16 // x.element_size()
    vector = (h * w) % vec == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    mean, mul, beta = bn if bn is not None else (None, None, None)
    fn = _build.function("frame_epilogue", "a2f_frame_epilogue", _ARGTYPES)
    rc = fn(x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], n, c, h * w, _ptr(bias), _ptr(mean),
            _ptr(mul), _ptr(beta), int(relu), int(vector),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "frame_epilogue")
    frame_epilogue.launches += 1
    return out


def frame_epilogue(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   bn: Optional[BatchNormAffine] = None, relu: bool = False,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu?(bn?(x + bias?))`` over an NCHW tensor (module doc), into
    ``out`` (``out=x`` for in place) or a new tensor.

    CUDA tensors launch the kernel, which has no backward: with gradients
    enabled and a tensor that requires one it raises. CPU tensors run the
    plain version."""
    _check(x, bias, bn, out)
    if x.device.type == "cpu":
        return frame_epilogue_reference(x, bias, bn, relu, out)
    if x.device.type != "cuda":
        raise ValueError(f"frame_epilogue runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, bias, *(bn or ()))
    ):
        raise RuntimeError("frame_epilogue has no backward: call it where autograd records nothing")
    return _frame_epilogue_cuda(x, bias, bn, relu, torch.empty_like(x) if out is None else out)


frame_epilogue.launches = 0
