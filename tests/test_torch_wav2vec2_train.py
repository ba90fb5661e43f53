"""Train-mode parts of the port's wav2vec2 encoder: gradients vs jax.grad
(regularizers off: the JAX dropouts are hard-coded at 0.1, so both sides run
in eval mode with gradients on), the SpecAugment mask, determinism of train
mode under a seeded generator, LayerDrop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from audio2face_tpu_torch.compat.jax_params import (
    wav2vec2_jax_tree_from_state_dict,
    wav2vec2_state_dict_from_jax,
)
from audio2face_tpu_torch.models import wav2vec2 as w2v
from audio2face_tpu_torch.ops import _build
from audio2face_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
from audio2face_tpu_torch.ops.conv_encoder import fused_conv_encoder

NARROW = dict(
    conv_dim=(32,) * 7, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96,
    pos_conv_kernel=16, pos_conv_groups=4,
)

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)
S, T_OUT = 4000, 15


def _tiny_encoder(seed=0, **overrides):
    enc = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**{**NARROW, **overrides}))
    enc.init_parameters(torch.Generator().manual_seed(seed))
    return enc


def test_config_carries_the_jax_defaults():
    """Every field of the JAX config at its value; the port's WavLM and
    Conformer fields (no JAX counterpart) at the wav2vec2-base defaults."""
    ours, ref = dataclasses.asdict(w2v.Wav2Vec2Config()), dataclasses.asdict(JaxConfig())
    assert {k: ours[k] for k in ref} == ref
    assert {k: v for k, v in ours.items() if k not in ref} == {
        "feat_extract_norm": "group", "do_stable_layer_norm": False,
        "relative_position_buckets": 0, "layer_kind": "transformer",
        "conv_depthwise_kernel_size": 31}
    ours, ref = w2v.Wav2Vec2Config(), JaxConfig()
    assert ours.feat_extract_output_length(16000) == ref.feat_extract_output_length(16000) == 49


@pytest.mark.parametrize("use_lengths", [False, True], ids=["unpadded", "padded_lengths"])
def test_encoder_gradients_match_jax(use_lengths):
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(2, S)) * 0.1).astype(np.float32)
    probe = rng.normal(size=(2, T_OUT, NARROW["hidden_size"])).astype(np.float32)
    lengths = np.asarray([S, 2700], np.int32) if use_lengths else None
    out_lengths = np.asarray([T_OUT, 10], np.int32) if use_lengths else None
    if use_lengths:  # padded frames carry no loss
        probe[1, 10:] = 0.0
    jl_ = None if lengths is None else jnp.asarray(lengths)
    jo = None if out_lengths is None else jnp.asarray(out_lengths)

    jenc = JaxEncoder(JaxConfig(**NARROW))
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(audio))["params"]

    def jax_loss(p):
        out = jenc.apply({"params": p}, jnp.asarray(audio), output_len=T_OUT, lengths=jl_,
                         output_lengths=jo)
        return jnp.sum(out * probe), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)

    enc = w2v.Wav2Vec2Encoder(w2v.Wav2Vec2Config(**NARROW))
    enc.load_state_dict(wav2vec2_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    flash_attention.launches = flash_attention_bwd.launches = 0
    out = enc(torch.tensor(audio), output_len=T_OUT,
              lengths=None if lengths is None else torch.tensor(lengths),
              output_lengths=None if out_lengths is None else torch.tensor(out_lengths))
    (out * torch.tensor(probe)).sum().backward()
    n_valid = out_lengths if use_lengths else [T_OUT] * 2
    for b, n in enumerate(n_valid):
        np.testing.assert_allclose(out[b, :n].detach().numpy(), np.asarray(ref_out)[b, :n], atol=1e-4)

    grads = wav2vec2_jax_tree_from_state_dict({k: p.grad for k, p in enc.named_parameters()})
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_grads)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert set(got_leaves) == {path for path, _ in ref_leaves}
    largest = max(float(np.abs(np.asarray(ref)).max()) for _, ref in ref_leaves)
    for path, ref in ref_leaves:
        ref, got = np.asarray(ref), got_leaves[path]
        name = jax.tree_util.keystr(path)
        if "masked_spec_embed" in name:  # unused in eval mode
            assert not ref.any() and not got.any()
            continue
        # 1e-3 of the leaf's largest value; a leaf whose gradient is zero
        # analytically (the key bias: softmax ignores a shift of every score
        # of a row) is rounding noise on both sides, held to the same share
        # of 1e-4 of the largest gradient of any leaf
        scale = max(float(np.abs(ref).max()), 1e-4 * largest)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * scale, err_msg=name)
    # CPU tensors: plain versions forward and backward, nothing built
    assert flash_attention.launches == 0 and flash_attention_bwd.launches == 0
    assert not _build._libs


def test_spec_augment_mask_shape_span_and_share():
    cfg = w2v.Wav2Vec2Config()
    g = torch.Generator().manual_seed(0)
    mask = w2v.compute_spec_augment_mask(
        g, 4, 500, cfg.mask_time_prob, cfg.mask_time_length, cfg.mask_time_min_masks)
    assert mask.shape == (4, 500) and mask.dtype == torch.bool
    assert 0.01 < float(mask.float().mean()) < 0.2
    # int(0.05 * 500 / 10 + 0.5) = 3 spans of 10: at most 30 per row, and every
    # run of masked positions is at least one full span long
    assert int(mask.sum(dim=1).max()) <= 30
    for row in mask.tolist():
        runs = [len(r) for r in "".join("x" if m else " " for m in row).split()]
        assert runs and min(runs) >= cfg.mask_time_length
    # min_masks wins over a small probability
    two = w2v.compute_spec_augment_mask(g, 3, 100, 0.001, 10, 2)
    assert 10 <= int(two.sum(dim=1).min()) and int(two.sum(dim=1).max()) <= 20
    fmask = w2v.compute_spec_augment_mask(g, 4, 48, 0.3, 4)
    assert fmask.shape == (4, 48) and 0.05 < float(fmask.float().mean()) < 0.6


def test_train_mode_is_deterministic_per_seed_and_differs_between_seeds():
    enc = _tiny_encoder(mask_feature_prob=0.3, mask_feature_length=4)
    audio = torch.tensor((np.random.default_rng(1).normal(size=(2, S)) * 0.1).astype(np.float32))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return enc(audio, output_len=T_OUT, train=True, apply_spec_augment=True, generator=g)

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    with torch.no_grad():
        assert not torch.allclose(a, enc(audio, output_len=T_OUT))
    with pytest.raises(ValueError, match="Generator"):
        enc(audio, output_len=T_OUT, train=True)


def test_training_never_takes_the_fused_conv_encoder():
    """bf16 inference goes through the fused conv encoder's wrapper; training
    takes the differentiable conv path, and conv weights get gradients."""
    enc = _tiny_encoder(conv_dim=(512,) * 7, num_layers=1)
    audio = torch.tensor((np.random.default_rng(2).normal(size=(1, 2000)) * 0.1).astype(np.float32))
    assert enc.feature_encoder._fused_ok(torch.bfloat16)
    fused_conv_encoder.launches = 0
    g = torch.Generator().manual_seed(0)
    out = enc(audio, output_len=7, dtype=torch.bfloat16, train=True, generator=g)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    for conv in enc.feature_encoder.conv_layers:
        assert conv.weight.grad is not None and torch.isfinite(conv.weight.grad).all()
    assert enc.feature_encoder.conv_layers[0].weight.grad.abs().sum() > 0
    assert fused_conv_encoder.launches == 0


def test_layerdrop_one_returns_the_layers_input():
    enc = _tiny_encoder(layerdrop=1.0)
    none = _tiny_encoder(num_layers=0)
    none.load_state_dict({k: v for k, v in enc.state_dict().items() if not k.startswith("layers.")})
    audio = torch.tensor((np.random.default_rng(3).normal(size=(2, S)) * 0.1).astype(np.float32))
    a = enc(audio, output_len=T_OUT, train=True, generator=torch.Generator().manual_seed(5))
    b = none(audio, output_len=T_OUT, train=True, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    # and with layerdrop 0 every layer runs
    full = _tiny_encoder(layerdrop=0.0)
    c = full(audio, output_len=T_OUT, train=True, generator=torch.Generator().manual_seed(5))
    assert not torch.allclose(a, c)
