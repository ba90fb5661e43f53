"""The port's FaceFormer in training: decoder gradients vs jax.grad of the
JAX model's scan decode, the chunk-checkpointed step loop, the choice of the
decode implementation, the dropout keep-masks and a whole train-mode pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models import faceformer as jff
from audio2face_tpu_torch.compat.jax_params import (
    faceformer_jax_tree_from_state_dict,
    faceformer_state_dict_from_jax,
)
from audio2face_tpu_torch.models import faceformer as ff
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from audio2face_tpu_torch.ops.conv_encoder import fused_conv_encoder
from audio2face_tpu_torch.ops.decode_kernel import (
    decode_loop_reference,
    decode_steps,
    faceformer_decode_loop,
)

N_VERTS = 300
NARROW = Wav2Vec2Config(
    conv_dim=(32,) * 7, hidden_size=768, num_layers=1, num_heads=4, intermediate_size=64,
    pos_conv_kernel=16, pos_conv_groups=4,
)

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)


def _narrow_model(**kw):
    model = ff.FaceFormer(N_VERTS, 12, encoder_config=NARROW, **kw)
    g = torch.Generator().manual_seed(0)
    model.init_parameters(g)
    with torch.no_grad():  # trained-like motion maps (the init zeroes them)
        for lin in (model.vertice_map, model.vertice_map_r):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.05)
    return model


def test_decoder_gradients_match_jax_scan():
    """Through encoder_hidden=, eval mode with differentiable=True; motion maps
    randomized (zero-initialized they block every gradient into the decoder
    at step 0). Leaf by leaf through the inverse name map, each leaf within
    1e-3 of its largest value."""
    rng = np.random.default_rng(0)
    b, s = 2, 8000  # 30 frames
    t = s * 60 // 16000
    audio = (rng.normal(size=(b, s)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[[1, 5]]
    template = rng.normal(size=(b, N_VERTS // 3, 3)).astype(np.float32)
    hidden = rng.normal(size=(b, t, 768)).astype(np.float32)
    probe = rng.normal(size=(b, t, N_VERTS // 3, 3)).astype(np.float32)

    model = jff.FaceFormer(n_verts=N_VERTS, n_onehot=12, decode_impl="scan")
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(audio[:, :800]), jnp.asarray(one_hot), jnp.asarray(template))
    params = dict(jax.tree.map(np.asarray, variables["params"]))
    for name, shape in [("vertice_map_kernel", (N_VERTS, 64)), ("vertice_map_bias", (64,)),
                        ("vertice_map_r_kernel", (64, N_VERTS)), ("vertice_map_r_bias", (N_VERTS,))]:
        params[name] = rng.normal(0, 0.05, shape).astype(np.float32)
    dec_params = {k: v for k, v in params.items() if k != "audio_encoder"}

    def jax_loss(dp):
        out = model.apply({"params": {**dp, "audio_encoder": params["audio_encoder"]}},
                          jnp.asarray(audio), jnp.asarray(one_hot), jnp.asarray(template),
                          encoder_hidden=jnp.asarray(hidden))
        return jnp.sum(out * probe), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(dec_params)

    port = ff.FaceFormer(N_VERTS, 12, encoder_config=NARROW)
    sd = faceformer_state_dict_from_jax(params)
    port.load_state_dict({k: v for k, v in sd.items() if not k.startswith("audio_encoder.")},
                         strict=False)
    port.eval()
    faceformer_decode_loop.launches = 0
    out = port(torch.tensor(audio), torch.tensor(one_hot), torch.tensor(template),
               encoder_hidden=torch.tensor(hidden), differentiable=True)
    (out * torch.tensor(probe)).sum().backward()
    l2 = np.linalg.norm(out.detach().numpy() - np.asarray(ref_out), axis=-1).max()
    assert l2 < 1e-4, l2

    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in port.named_parameters()}
    tree = faceformer_jax_tree_from_state_dict(grads)
    assert set(tree) - {"audio_encoder"} == set(ref_grads)
    assert not any(p.grad is not None for p in port.audio_encoder.parameters())
    largest = max(float(np.abs(np.asarray(ref)).max()) for ref in ref_grads.values())
    for name, ref in ref_grads.items():
        ref = np.asarray(ref)
        # the key bias has a zero gradient analytically (softmax ignores a
        # shift of a row's scores): rounding noise on both sides, held to
        # the same share of 1e-4 of the largest gradient of any leaf
        scale = max(float(np.abs(ref).max()), 1e-4 * largest)
        np.testing.assert_allclose(tree[name], ref, rtol=0, atol=1e-3 * scale, err_msg=name)
    assert faceformer_decode_loop.launches == 0


def _decode_inputs(rng, b, t, dtype=torch.float32):
    model = _narrow_model()
    weights = {k: (v.detach().clone().requires_grad_(True) if v.dtype == dtype else v)
               for k, v in model.decoder_weights(dtype).items()}
    cross = torch.tensor(rng.normal(size=(b, t, 64)).astype(np.float32) * 0.5).to(dtype).requires_grad_(True)
    style = torch.tensor(rng.normal(size=(b, 64)).astype(np.float32) * 0.5).to(dtype)
    pe = torch.tensor(ff.periodic_positional_encoding()).to(dtype)
    return model, weights, cross, style, pe


@pytest.mark.parametrize("with_masks", [False, True], ids=["eval", "dropout-masks"])
def test_chunk_checkpointed_loop_equals_unchunked(with_masks):
    rng = np.random.default_rng(1)
    b, t = 2, 24
    _, weights, cross, style, pe = _decode_inputs(rng, b, t)
    masks = None
    if with_masks:
        masks = ff.decoder_keep_masks(t, b, torch.float32, torch.Generator().manual_seed(2), "cpu")
    leaves = [cross] + [w for w in weights.values() if w.requires_grad]
    results = []
    for chunk in (None, ff.decode_chunk_size(t) // 3, 5):  # 5 does not divide 24: ragged tail
        hs = decode_steps(cross, style, pe, weights, masks=masks, chunk=chunk)
        grads = torch.autograd.grad(hs.square().sum(), leaves)
        results.append((hs.detach(), grads))
    (hs0, g0) = results[0]
    for hs, grads in results[1:]:
        np.testing.assert_allclose(hs.numpy(), hs0.numpy(), rtol=0, atol=1e-6)
        for a, ref in zip(grads, g0):
            np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6 * float(ref.abs().max()))
    if with_masks:  # the masks really enter the loop
        plain = decode_steps(cross, style, pe, weights)
        assert not torch.allclose(plain, hs0)


def test_step_loop_equals_the_inference_loop_in_eval():
    """The decode kernel's plain version is the step loop in f32, whatever
    its inputs' type: bf16 inputs are upcast, computed in f32 and rounded
    once at the end, while the step loop itself computes in bf16."""
    rng = np.random.default_rng(3)
    _, weights, cross, style, pe = _decode_inputs(rng, 2, 70, torch.bfloat16)
    with torch.no_grad():
        want = decode_steps(cross.float(), style.float(), pe.float(),
                            {k: v.float() for k, v in weights.items()})
        got = decode_loop_reference(cross, style, pe, weights)
        in_bf16 = decode_steps(cross, style, pe, weights)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert in_bf16.dtype == torch.bfloat16 and not torch.equal(in_bf16, got)
    # LayerNorm outputs of unit scale: bf16 products cost a few bf16 steps
    assert float((in_bf16.float() - want).abs().max()) < 0.25


def test_bf16_step_loop_keeps_the_compute_dtype():
    rng = np.random.default_rng(4)
    _, weights, cross, style, pe = _decode_inputs(rng, 2, 12, torch.bfloat16)
    hs = decode_steps(cross, style, pe, weights, chunk=4)
    assert hs.dtype == torch.bfloat16
    hs.float().sum().backward()
    assert cross.grad.dtype == torch.bfloat16 and torch.isfinite(cross.grad.float()).all()


@pytest.mark.parametrize("n,chunk", [(600, 60), (30, 30), (61, 61), (130, 26), (97, 1), (3600, 60)])
def test_decode_chunk_size(n, chunk):
    assert ff.decode_chunk_size(n) == chunk


def test_training_never_selects_the_fused_decode_kernel(monkeypatch):
    monkeypatch.setattr(ff.decode_kernel, "smem_fits", lambda device, biwi=False, width=64: True)
    assert ff.select_decode_impl(torch.device("cuda")) == "fused"
    assert ff.select_decode_impl(torch.device("cuda"), train=True) == "steps"
    assert ff.select_decode_impl(torch.device("cpu"), train=True) == "steps"


def test_eval_takes_the_fused_kernel_whatever_the_autograd_state(monkeypatch):
    """With gradients enabled and weights that require them (a module's
    default state), train=False on a CUDA-typed selection still goes to the
    decode kernel's wrapper; only differentiable=True takes the step loop."""
    model = _narrow_model()
    model.eval()
    calls = []

    def fake_kernel(cross, style, pe, weights, *, period):
        calls.append(torch.is_grad_enabled() and any(w.requires_grad for w in weights.values()))
        return decode_loop_reference(cross, style, pe, weights, period=period)

    monkeypatch.setattr(ff, "select_decode_impl",
                        lambda device, dataset="vocaset", *, train=False, feature_dim=64:
                        "steps" if train else "fused")
    monkeypatch.setattr(ff.decode_kernel, "faceformer_decode_loop", fake_kernel)
    rng = np.random.default_rng(6)
    audio = torch.tensor((rng.normal(size=(1, 3200)) * 0.1).astype(np.float32))
    args = (audio, torch.eye(12)[:1], torch.zeros(1, N_VERTS // 3, 3))
    out = model(*args)
    assert calls == [True]
    with torch.no_grad():
        assert torch.equal(model(*args), out)
    assert calls == [True, False]
    soft = model(*args, differentiable=True)
    assert len(calls) == 2 and soft.requires_grad
    np.testing.assert_allclose(soft.detach().numpy(), out.detach().numpy(), rtol=0, atol=1e-5)
    soft.sum().backward()
    assert model.audio_encoder.feature_encoder.conv_layers[0].weight.grad.abs().sum() > 0


def test_keep_mask_statistics():
    masks = ff.decoder_keep_masks(200, 4, torch.float32, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in masks.items()} == {
        "m_pe": (200, 4, 64), "m_sa": (200, 4, 64), "m_ca": (200, 4, 64),
        "m_ff1": (200, 4, 128), "m_ff2": (200, 4, 64)}
    for m in masks.values():
        assert 0.88 < float((m > 0).float().mean()) < 0.92
        np.testing.assert_allclose(m[m > 0].numpy(), np.float32(1.0 / 0.9), rtol=1e-6)
        np.testing.assert_allclose(float(m.mean()), 1.0, atol=0.02)
    assert not torch.equal(masks["m_pe"], masks["m_sa"])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_train_mode_forward_and_backward(dtype):
    """A whole padded train-mode pass: hidden states out, a gradient into
    every parameter but the masked embedding's unused rows, the same result
    for the same generator seed, no inference-only kernel wrapper touched."""
    model = _narrow_model(dtype=dtype)
    model.train()
    rng = np.random.default_rng(5)
    audio = torch.tensor((rng.normal(size=(2, 8000)) * 0.1).astype(np.float32))
    one_hot, template = torch.eye(12)[:2], torch.zeros(2, N_VERTS // 3, 3)
    lengths = torch.tensor([8000, 5000])
    fused_conv_encoder.launches = faceformer_decode_loop.launches = 0

    def run(seed):
        return model(audio, one_hot, template, lengths, train=True, return_hidden=True,
                     generator=torch.Generator().manual_seed(seed))

    hs, mask = run(0)
    assert hs.shape == (2, 30, 64) and mask.sum(dim=1).tolist() == [30.0, 18.0]
    (hs.float() * mask[..., None]).square().sum().backward()
    for name, p in model.named_parameters():
        if name.startswith(("vertice_map_r.bias", "audio_encoder.layers")):
            continue  # the head's bias sits after the hidden states; LayerDrop may skip the layer
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert model.dec_q.weight.grad.abs().sum() > 0
    assert model.audio_encoder.feature_encoder.conv_layers[0].weight.grad.abs().sum() > 0
    hs2, _ = run(0)
    hs3, _ = run(1)
    assert torch.equal(hs, hs2) and not torch.allclose(hs.float(), hs3.float())
    verts, _ = model(audio, one_hot, template, lengths, train=True,
                     generator=torch.Generator().manual_seed(0))
    assert verts.shape == (2, 30, N_VERTS // 3, 3) and verts.dtype == torch.float32
    with pytest.raises(ValueError, match="Generator"):
        model(audio, one_hot, template, train=True)
    assert fused_conv_encoder.launches == 0 and faceformer_decode_loop.launches == 0
