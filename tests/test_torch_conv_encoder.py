"""Port conv feature encoder vs the JAX package.

- the port's plain version of the fused kernel family vs JAX
  ``fused_conv_encoder`` run in interpret mode (bf16 activations, so the
  bound is tests/test_conv_encoder.py's 0.05 x max|ref|);
- the port's f32 ``FeatureEncoder`` (per-layer conv1d path) vs the JAX f32
  ``FeatureEncoder`` on valid rows;
- the layer-norm mode (WavLM Large's stack, which the JAX package does not
  have): its plain version vs the port's f32 ``conv1d`` path at the same
  bound, layer 0's analytic per-frame statistics, the wrapper's checks of
  the LayerNorm parameters; and the group-norm mode's plain output equal,
  bit for bit, to the formula it had before the layer-norm mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models.wav2vec2 import FeatureEncoder as JaxFeatureEncoder
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.ops.conv_encoder import fused_conv_encoder as jax_fused
from audio2face_tpu_torch.models.wav2vec2 import FeatureEncoder, Wav2Vec2Config
from audio2face_tpu_torch.ops import conv_encoder as ce
from audio2face_tpu_torch.ops.conv_encoder import fused_conv_encoder, stack_output_length
from audio2face_tpu_torch.utils import spans

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

L = 2500  # samples -> 7 output frames


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, L)) * 0.1).astype(np.float32)
    fe = JaxFeatureEncoder(JaxConfig(), dtype=None)
    variables = jax.jit(fe.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    return x, fe, variables, params


def _valid_frames(lengths):
    return [stack_output_length(int(n)) for n in lengths]


@pytest.mark.parametrize(
    "n,lengths",
    [(L, None), (L, (L, L - 800)), (2503, (2503, 1999)), (L, (L, 0))],
    ids=["full", "padded", "not_multiple_of_5", "zero_length_row"],
)
def test_plain_stack_matches_jax_fused(setup, n, lengths):
    x, _, _, params = setup
    x = x[:, :n]
    kernels = [params[f"conv{i}"]["kernel"] for i in range(7)]
    gn = params["group_norm"]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = np.asarray(
        jax_fused(
            jnp.asarray(x), [jnp.asarray(k) for k in kernels], jnp.asarray(gn["scale"]),
            jnp.asarray(gn["bias"]), jl, interpret=True, tile_frames=8,
        ),
        np.float32,
    )
    out = fused_conv_encoder(
        torch.tensor(x), [torch.tensor(k) for k in kernels], torch.tensor(gn["scale"]),
        torch.tensor(gn["bias"]), None if lengths is None else torch.tensor(lengths),
    )
    assert out.dtype == torch.bfloat16
    assert tuple(out.shape) == (2, stack_output_length(n), 512)
    out = out.float().numpy()
    assert np.isfinite(out).all()
    bound = 0.05 * np.abs(ref).max()
    valid = _valid_frames(lengths if lengths is not None else (n, n))
    for b, nv in enumerate(valid):
        if nv > 0:
            err = np.abs(out[b, :nv] - ref[b, :nv]).max()
            assert err < bound, (b, err, bound)


def test_f32_feature_encoder_matches_jax(setup):
    x, fe, variables, params = setup
    lengths = np.asarray([L, L - 700], np.int32)
    ref = np.asarray(fe.apply(variables, jnp.asarray(x), jnp.asarray(lengths)))
    port = FeatureEncoder(Wav2Vec2Config())
    sd = {"group_norm.weight": torch.tensor(params["group_norm"]["scale"]),
          "group_norm.bias": torch.tensor(params["group_norm"]["bias"])}
    for i in range(7):
        sd[f"conv_layers.{i}.weight"] = torch.tensor(
            np.transpose(params[f"conv{i}"]["kernel"], (2, 1, 0)).copy()
        )
    port.load_state_dict(sd)
    with torch.no_grad():
        out = port(torch.tensor(x), torch.tensor(lengths)).numpy()
    assert out.shape == ref.shape
    for b, nv in enumerate(_valid_frames(lengths)):
        np.testing.assert_allclose(out[b, :nv], ref[b, :nv], rtol=1e-4, atol=1e-6)


# ---- layer-norm mode ---------------------------------------------------------


def _layer_norm_encoder(seed: int = 0) -> FeatureEncoder:
    """WavLM Large's conv stack with random LayerNorm affines."""
    g = torch.Generator().manual_seed(seed)
    fe = FeatureEncoder(Wav2Vec2Config(feat_extract_norm="layer")).eval()
    with torch.no_grad():
        for ln in fe.layer_norms:
            ln.weight.copy_(1.0 + 0.1 * torch.randn(512, generator=g))
            ln.bias.copy_(0.05 * torch.randn(512, generator=g))
    return fe


def _stack_args(fe: FeatureEncoder):
    kernels = [conv.weight.permute(2, 1, 0) for conv in fe.conv_layers]
    return (kernels, [ln.weight for ln in fe.layer_norms], [ln.bias for ln in fe.layer_norms])


@pytest.mark.parametrize(
    "n,lengths",
    [(L, None), (L, (L, L - 800)), (2503, (2503, 1999)), (L, (L, 0)), (41680, (41680, 30000))],
    ids=["full", "padded", "not_multiple_of_5", "zero_length_row", "t_out_130"],
)
def test_plain_layer_norm_stack_matches_f32_conv1d(setup, n, lengths):
    """The plain layer-norm mode (bf16 operands, f32 sums and statistics,
    one bf16 rounding a layer) against ``FeatureEncoder``'s f32 ``conv1d``
    path with its per-conv LayerNorms, on valid frames, at the bound the
    group-norm stack is held to (0.05 x max|ref|); ``t_out_130`` gives 130
    frames, past one 128-row tile."""
    x = torch.tensor(setup[0][:, :n]) if n <= L else 0.3 * torch.randn(
        2, n, generator=torch.Generator().manual_seed(n))
    fe = _layer_norm_encoder()
    lt = None if lengths is None else torch.tensor(lengths)
    with torch.no_grad():
        ref = fe(x, lt).numpy()
        out = fused_conv_encoder(x, *_stack_args(fe), lt, norm="layer")
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, stack_output_length(n), 512)
    assert ref.shape == tuple(out.shape)
    out = out.float().numpy()
    assert np.isfinite(out).all()
    bound = 0.05 * np.abs(ref).max()
    for b, nv in enumerate(_valid_frames(lengths if lengths is not None else (n, n))):
        if nv > 0:
            err = np.abs(out[b, :nv] - ref[b, :nv]).max()
            assert err < bound, (b, err, bound)


def _group_plain_as_before(x, kernels, gn_scale, gn_bias, lengths=None):
    """``conv_encoder_reference`` as it was before the layer-norm mode."""
    b, n = x.shape
    x = x.float()
    w0 = kernels[0].reshape(ce.K0, ce.C).float()
    xi = ce._im2col10(x)
    feat = None if lengths is None else ce._feat_lengths(lengths, b, n, x.device)
    mean, rstd = ce.conv0_groupnorm_stats(xi, w0, feat)
    gs = rstd * gn_scale.float()[None, :]
    gb = gn_bias.float()[None, :] - mean * gs
    y0 = xi.to(torch.bfloat16).float() @ w0.to(torch.bfloat16).float()
    h = torch.nn.functional.gelu(y0 * gs[:, None] + gb[:, None]).to(torch.bfloat16)
    for k, s, w in zip(ce.CONV_KERNEL[1:], ce.CONV_STRIDE[1:], kernels[1:]):
        wt = w.to(torch.bfloat16).float().permute(2, 1, 0)
        y = torch.nn.functional.conv1d(h.float().transpose(1, 2), wt, stride=s).transpose(1, 2)
        h = torch.nn.functional.gelu(y).to(torch.bfloat16)
    return h


@pytest.mark.parametrize("lengths", [None, (L, L - 800)], ids=["full", "padded"])
def test_group_norm_plain_output_unchanged(setup, lengths):
    """The group-norm mode (the default) gives, bit for bit, the plain
    output it gave before the layer-norm mode was added."""
    x, _, _, params = setup
    kernels = [torch.tensor(params[f"conv{i}"]["kernel"]) for i in range(7)]
    gn = params["group_norm"]
    scale, bias = torch.tensor(gn["scale"]), torch.tensor(gn["bias"])
    lt = None if lengths is None else torch.tensor(lengths)
    want = _group_plain_as_before(torch.tensor(x), kernels, scale, bias, lt)
    assert torch.equal(ce.conv_encoder_reference(torch.tensor(x), kernels, scale, bias, lt), want)
    assert torch.equal(
        fused_conv_encoder(torch.tensor(x), kernels, scale, bias, lt, norm="group"), want)


def test_conv0_layer_norm_stats_equal_the_direct_statistics():
    """Layer 0's per-frame mean ``wbar . x`` and variance ``x^T S x`` (the
    centred form the kernel reads) against the mean and variance over the
    512 channels of the bf16-rounded conv, in f64; a frame whose channels
    share a large mean (a kernel with a common offset) keeps its variance
    to f32's precision, where ``E[y^2] - mean^2`` in f32 would lose it."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4000, 10, generator=g).to(torch.bfloat16).double()
    for offset in (0.0, 30.0):
        w0 = 0.3 * torch.randn(10, 512, generator=g) + offset
        st = ce.conv0_layer_norm_stats(w0)
        assert st.dtype == torch.float32 and st.shape == (65,)
        st = st.double()
        y = x @ w0.to(torch.bfloat16).double()
        j, k = torch.triu_indices(10, 10)
        mean = x @ st[:10]
        var = (x[:, j] * x[:, k] * st[10:]).sum(dim=1)
        want = y.var(dim=1, unbiased=False)
        torch.testing.assert_close(mean, y.mean(dim=1), rtol=1e-6, atol=1e-6)
        assert ((var - want).abs() / want).max().item() < 1e-5


def test_layer_norm_parameters_are_checked():
    """The wrapper takes seven (512,) LayerNorm affines (a list, or one
    (7, 512) tensor's rows) in the layer-norm mode and raises on anything
    else, and on a norm it does not know."""
    fe = _layer_norm_encoder()
    kernels, scales, biases = _stack_args(fe)
    x = torch.zeros(1, L)
    with torch.no_grad():
        listed = fused_conv_encoder(x, kernels, scales, biases, norm="layer")
        stacked = fused_conv_encoder(x, kernels, torch.stack(scales), torch.stack(biases),
                                     norm="layer")
    assert torch.equal(listed, stacked)
    for bad in (scales[:6], scales[0], torch.ones(7, 256), [torch.ones(256)] * 7):
        with pytest.raises(ValueError, match="layer-norm scales"):
            fused_conv_encoder(x, kernels, bad, biases, norm="layer")
    with pytest.raises(ValueError, match="layer-norm biases"):
        fused_conv_encoder(x, kernels, scales, torch.ones(7, 511), norm="layer")
    with pytest.raises(ValueError, match="layer-norm biases"):
        fused_conv_encoder(x, kernels, scales, biases[:6] + [torch.ones(512, 1)], norm="layer")
    for bad in (torch.stack(scales), scales):
        with pytest.raises(ValueError, match="group-norm scale"):
            fused_conv_encoder(x, kernels, bad, biases[0])
    with pytest.raises(ValueError, match="norm 'batch'"):
        fused_conv_encoder(x, kernels, scales, biases, norm="batch")
    with spans.recording() as rec:
        ce.conv_encoder_reference(x, kernels, scales, biases, norm="layer")
    assert "conv_layer_norms_fused" not in rec.counters  # the plain version counts nothing
