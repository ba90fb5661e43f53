"""wav2vec2 conv feature encoder: a family of hand-written CUDA kernels + its
plain version.

Port of ``audio2face_tpu/ops/conv_encoder.py``. ``fused_conv_encoder`` runs
the 7-layer conv stack (k/s 10/5, 3/2 x4, 2/2 x2, 512 channels, no bias)
with the length-masked group norm after layer 0 and an exact GELU after
every layer: (B, L) f32 waveform -> (B, T_out, 512) bf16. CUDA tensors
launch ``csrc/conv_encoder.cu`` (``csrc/conv_encoder_ln.cu`` in the layer-norm mode);
CPU tensors run ``conv_encoder_reference``.

Numerics of both: the group-norm statistics come in f32 from the waveform,
analytically (conv0 is linear):

    mean_c   = sum_j W0[j,c] mu_j,          mu_j = E_t[x_{5t+j}]
    E[y^2]_c = sum_jk W0[j,c] W0[k,c] C_jk, C_jk = E_t[x_{5t+j} x_{5t+k}]

over the valid layer-0 windows; every conv takes bf16 operands (layer 0:
the bf16-rounded samples and weights) with f32 sums, and each layer's
output is stored in bf16.

``norm="layer"`` is WavLM Large's stack: the same convs, each followed by a
LayerNorm over its 512 channels (f32 statistics of the f32 sums, eps 1e-5,
the layer's affine), then the GELU, then one bf16 rounding. A per-frame
norm needs no length mask. The kernel takes layer 0's statistics
analytically per frame (``conv0_layer_norm_stats``) and layers 1-6's from
the accumulators (two passes over a cluster of two blocks); the plain
version takes them from the f32 sums. A CUDA call counts
``conv_layer_norms_fused`` (``utils/spans.py``), 7 a call. ``conv_bias``
(7 of (512,), the wav2vec2-Conformer's stack) adds each conv's f32 bias to
its f32 sums before the LayerNorm; layer 0's statistics then gain the
bias's terms (``conv0_layer_norm_stats``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from audio2face_tpu_torch.ops import _build
from audio2face_tpu_torch.utils import spans

CONV_KERNEL = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDE = (5, 2, 2, 2, 2, 2, 2)
C = 512
K0, S0 = CONV_KERNEL[0], CONV_STRIDE[0]
EPS = 1e-5
_MOM_BLOCKS = 64  # partial-sum blocks per item in csrc/conv_encoder.cu
_NMOM = 65


def stack_output_length(input_length: int) -> int:
    length = input_length
    for k, s in zip(CONV_KERNEL, CONV_STRIDE):
        length = (length - k) // s + 1
    return length


def _im2col10(x: torch.Tensor) -> torch.Tensor:
    """(B, L) waveform -> (B, T0, 10) windows at stride 5 (layer-0 im2col)."""
    return x.unfold(1, K0, S0)


def conv0_groupnorm_stats(
    xi: torch.Tensor,  # (B, T0, 10) im2col
    w0: torch.Tensor,  # (10, C) layer-0 kernel
    feat_lengths: Optional[torch.Tensor] = None,  # (B,) valid T0 rows
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-(item, channel) mean and rstd of the conv0 output (the
    masked group norm's statistics), in f32."""
    b, t0, _ = xi.shape
    xi32 = xi.float()
    if feat_lengths is None:
        n = torch.full((b, 1), float(t0), device=xi.device)
        xm = xi32
    else:
        valid = torch.arange(t0, device=xi.device)[None, :] < feat_lengths.to(xi.device)[:, None]
        n = feat_lengths.to(xi.device).float().clamp(min=1.0)[:, None]
        xm = xi32 * valid[..., None].float()
    mu = xm.sum(dim=1) / n  # (B, 10)
    corr = torch.einsum("btj,btk->bjk", xm, xm) / n[..., None]
    w0 = w0.float()
    mean = mu @ w0  # (B, C)
    ey2 = torch.einsum("bjk,jc,kc->bc", corr, w0, w0)
    var = (ey2 - mean.square()).clamp(min=0.0)
    return mean, torch.rsqrt(var + EPS)


def conv0_layer_norm_stats(w0: torch.Tensor, b0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer 0's per-frame LayerNorm statistics as quadratic forms of the
    frame's 10 samples x (layer 0 is linear): the channel mean ``wbar . x``
    and the variance ``x^T S x``, with ``wbar`` the bf16-rounded (10, C)
    kernel's mean over channels and ``S = (W - wbar)(W - wbar)^T / C`` its
    centred second moment (no ``E[y^2] - mean^2`` to cancel). Computed in
    f64, returned in f32 as the kernel reads them: ``wbar`` (10), then S's
    upper triangle row by row with the off-diagonal entries doubled (55).
    With layer 0's bias ``b0`` (C,) the mean gains ``bbar`` and the variance
    ``e . x + |b - bbar|^2 / C``, ``e = 2 (W - wbar)(b - bbar) / C``: then
    ``e`` (10), ``bbar`` and ``|b - bbar|^2 / C`` follow (77 in all)."""
    w = w0.reshape(K0, C).to(torch.bfloat16).double()
    wbar = w.mean(dim=1)
    d = w - wbar[:, None]
    s = d @ d.T / C
    j, k = torch.triu_indices(K0, K0, device=w.device)
    tri = s[j, k] * torch.where(j == k, 1.0, 2.0).to(s)
    parts = [wbar, tri]
    if b0 is not None:
        b = b0.to(w)
        db = b - b.mean()
        parts += [2.0 * (d @ db) / C, b.mean()[None], db.square().mean()[None]]
    return torch.cat(parts).float()


def _feat_lengths(lengths: Optional[torch.Tensor], b: int, n: int, device) -> torch.Tensor:
    """Valid layer-0 windows per item, clamped to [0, T0] (a zero-length row
    would otherwise count negative windows)."""
    t0 = (n - K0) // S0 + 1
    if lengths is None:
        return torch.full((b,), t0, dtype=torch.int32, device=device)
    return torch.div(lengths.to(device) - K0, S0, rounding_mode="floor").add(1).clamp(0, t0).to(torch.int32)


def _norm_params(norm_scale, norm_bias, norm: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The norm's affine as the kernels take it: (C,) each for the group
    norm, (7, C) each (stacked from 7 of (C,)) for the layer norms."""
    if norm == "group":
        if any(getattr(p, "shape", None) != (C,) for p in (norm_scale, norm_bias)):
            raise ValueError("group-norm scale and bias must be (512,)")
        return norm_scale, norm_bias
    if norm != "layer":
        raise ValueError(f"norm {norm!r}: want 'group' or 'layer'")
    out = []
    for name, p in (("scales", norm_scale), ("biases", norm_bias)):
        if len(p) != len(CONV_KERNEL) or any(t.shape != (C,) for t in p):
            raise ValueError(f"layer-norm {name} must be {len(CONV_KERNEL)} of (512,)")
        out.append(torch.stack(list(p)))
    return out[0], out[1]


def _conv_biases(conv_bias, norm: str) -> Optional[torch.Tensor]:
    """The conv biases as the kernel takes them: None, or (7, C) stacked
    from 7 of (C,); the layer-norm mode only."""
    if conv_bias is None:
        return None
    if norm != "layer":
        raise ValueError("a conv bias runs in the layer-norm mode only")
    if len(conv_bias) != len(CONV_KERNEL) or any(t.shape != (C,) for t in conv_bias):
        raise ValueError(f"conv biases must be {len(CONV_KERNEL)} of (512,)")
    return torch.stack(list(conv_bias))


def _check(x, kernels, norm_scale, norm_bias, norm):
    if x.dim() != 2:
        raise ValueError(f"waveform must be (B, L), got {tuple(x.shape)}")
    if len(kernels) != len(CONV_KERNEL):
        raise ValueError(f"need {len(CONV_KERNEL)} conv kernels, got {len(kernels)}")
    for i, (k, w) in enumerate(zip(CONV_KERNEL, kernels)):
        want = (k, 1 if i == 0 else C, C)
        if tuple(w.shape) != want:
            raise ValueError(f"conv{i} kernel must be (k, c_in, c_out) = {want}, got {tuple(w.shape)}")
    scale, bias = _norm_params(norm_scale, norm_bias, norm)
    if stack_output_length(x.shape[1]) < 1:
        raise ValueError(f"{x.shape[1]} samples are too short for the conv stack")
    return scale, bias


def _layer_norm_gelu(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, T, C) f32 sums -> LayerNorm over channels, affine, GELU, bf16."""
    return F.gelu(F.layer_norm(y, (C,), scale.float(), bias.float(), EPS)).to(torch.bfloat16)


def conv_encoder_reference(
    x: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    norm_scale,
    norm_bias,
    lengths: Optional[torch.Tensor] = None,
    *,
    norm: str = "group",
    conv_bias=None,
) -> torch.Tensor:
    """Plain version of the kernel family, with its numerics (module doc)."""
    scale, bias = _check(x, kernels, norm_scale, norm_bias, norm)
    cb = _conv_biases(conv_bias, norm)
    b, n = x.shape
    x = x.float()
    w0 = kernels[0].reshape(K0, C).float()
    xi = _im2col10(x)
    y0 = xi.to(torch.bfloat16).float() @ w0.to(torch.bfloat16).float()
    if cb is not None:
        y0 = y0 + cb[0].float()
    if norm == "layer":
        h = _layer_norm_gelu(y0, scale[0], bias[0])
    else:
        feat = None if lengths is None else _feat_lengths(lengths, b, n, x.device)
        mean, rstd = conv0_groupnorm_stats(xi, w0, feat)
        gs = rstd * scale.float()[None, :]
        gb = bias.float()[None, :] - mean * gs
        h = F.gelu(y0 * gs[:, None] + gb[:, None]).to(torch.bfloat16)
    for i, (k, s, w) in enumerate(zip(CONV_KERNEL[1:], CONV_STRIDE[1:], kernels[1:]), start=1):
        wt = w.to(torch.bfloat16).float().permute(2, 1, 0)  # (c_out, c_in, k)
        y = F.conv1d(h.float().transpose(1, 2), wt, stride=s).transpose(1, 2)
        if cb is not None:
            y = y + cb[i].float()
        h = _layer_norm_gelu(y, scale[i], bias[i]) if norm == "layer" else F.gelu(y).to(torch.bfloat16)
    return h


_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_LN_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _conv_encoder_cuda(x, kernels, scale, bias, lengths, norm, conv_bias=None):
    b, n = x.shape
    dev = x.device
    t0 = (n - K0) // S0 + 1
    t1 = (t0 - CONV_KERNEL[1]) // CONV_STRIDE[1] + 1
    xf = x.float().contiguous()
    w0 = kernels[0].reshape(K0, C).to(device=dev, dtype=torch.float32).contiguous()
    # each kernel (k, c_in, c_out) transposed to K-major (c_out, k*c_in)
    w_stack = torch.cat([
        w.to(device=dev, dtype=torch.bfloat16).permute(2, 0, 1).reshape(-1) for w in kernels[1:]
    ]).contiguous()
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    buf0 = torch.empty((b, t0, C), dtype=torch.bfloat16, device=dev)
    buf1 = torch.empty((b, t1, C), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, stack_output_length(n), C), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if norm == "layer":
        cb = None
        if conv_bias is not None:
            cb = conv_bias.to(device=dev, dtype=torch.float32).contiguous()
        stats = conv0_layer_norm_stats(w0, None if cb is None else cb[0])
        fn = _build.function("conv_encoder_ln", "a2f_conv_encoder_ln", _LN_ARGTYPES)
        rc = fn(
            xf.data_ptr(), w0.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if cb is None else cb.data_ptr(), w_stack.data_ptr(), buf0.data_ptr(),
            buf1.data_ptr(), out.data_ptr(), b, n, stream,
        )
    else:
        feat = _feat_lengths(lengths, b, n, dev).contiguous()
        partials = torch.empty((b, _MOM_BLOCKS, _NMOM), dtype=torch.float32, device=dev)
        gs = torch.empty((b, C), dtype=torch.float32, device=dev)
        gb = torch.empty((b, C), dtype=torch.float32, device=dev)
        fn = _build.function("conv_encoder", "a2f_conv_encoder", _ARGTYPES)
        rc = fn(
            xf.data_ptr(), feat.data_ptr(), w0.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), w_stack.data_ptr(), partials.data_ptr(), gs.data_ptr(),
            gb.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), out.data_ptr(), b, n, stream,
        )
    _build.check(rc, "fused_conv_encoder")
    fused_conv_encoder.launches += 1
    if norm == "layer":
        fused_conv_encoder.layer_norm_launches += 1
        if cb is not None:
            fused_conv_encoder.conv_bias_launches += 1
        spans.count("conv_layer_norms_fused", len(CONV_KERNEL))
    return out


def fused_conv_encoder(
    x: torch.Tensor,  # (B, L) f32 waveform
    kernels: Sequence[torch.Tensor],  # per layer (k, c_in, c_out)
    norm_scale,  # group: (C,); layer: 7 of (C,), one a conv
    norm_bias,  # as norm_scale
    lengths: Optional[torch.Tensor] = None,  # (B,) valid samples
    *,
    norm: str = "group",  # "group" (wav2vec2-base) or "layer" (WavLM Large)
    conv_bias=None,  # layer mode: 7 of (C,), each conv's bias (the wav2vec2-Conformer's)
) -> torch.Tensor:
    """Waveform -> (B, T_out, 512) bf16 latents (conv stack + norm + GELU).

    CUDA tensors launch the kernel family, which is inference only: with
    gradients enabled and an input that requires one it raises. CPU tensors
    run the plain version."""
    if x.device.type == "cpu":
        return conv_encoder_reference(x, kernels, norm_scale, norm_bias, lengths, norm=norm,
                                      conv_bias=conv_bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_encoder runs on cuda or cpu, not {x.device}")
    scale, bias = _check(x, kernels, norm_scale, norm_bias, norm)
    cb = _conv_biases(conv_bias, norm)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *kernels, scale, bias, *([] if cb is None else [cb]))
    ):
        raise RuntimeError(
            "fused_conv_encoder has no backward: call it under torch.no_grad(), or ask "
            "for the differentiable conv path (FaceFormer(..., differentiable=True), "
            "FeatureEncoder(..., train=True))"
        )
    return _conv_encoder_cuda(x, kernels, scale, bias, lengths, norm, cb)


fused_conv_encoder.launches = 0
fused_conv_encoder.layer_norm_launches = 0  # calls in the layer-norm mode
fused_conv_encoder.conv_bias_launches = 0  # of those, calls with the conv biases
