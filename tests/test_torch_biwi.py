"""The port's FaceFormer BIWI mode vs the JAX package, on the CPU in f32:
the decode loop's 2-way cross softmax against the Pallas kernel's BIWI
variant in interpret mode, the wav2vec2 trim branch, the whole model and the
predictor with carried weights (max per-vertex L2 < 1e-4), the
dataset/weights mismatch errors, gradients leaf by leaf against ``jax.grad``
and the weight map there and back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models import faceformer as jff
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from audio2face_tpu.ops.decode_kernel import faceformer_decode_loop as jax_decode
from audio2face_tpu.serving import FaceFormerPredictor as JaxPredictor
from audio2face_tpu_torch.compat.jax_params import (
    faceformer_jax_tree_from_state_dict,
    faceformer_state_dict_from_jax,
    wav2vec2_state_dict_from_jax,
)
from audio2face_tpu_torch.models import faceformer as ff
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from audio2face_tpu_torch.ops.decode_kernel import (
    decode_loop_reference,
    decode_steps,
    faceformer_decode_loop,
)
from audio2face_tpu_torch.serving import FaceFormerPredictor

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

N_VERTS = 300
PERIOD = 25
MOTION_MAPS = [("vertice_map_kernel", (N_VERTS, 64)), ("vertice_map_bias", (64,)),
               ("vertice_map_r_kernel", (64, N_VERTS)), ("vertice_map_r_bias", (N_VERTS,))]


def _rand_weights(rng):
    d, f = 64, 128
    w = {}
    for name, shape in [
        ("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)), ("cq", (d, d)),
        ("co", (d, d)), ("f1", (d, f)), ("f2", (f, d)), ("fb", (d, d)),
    ]:
        # a weak feedback keeps the autoregression from amplifying the two
        # sides' rounding differences over the steps
        scale = 0.05 if name == "fb" else 0.2
        w[f"{name}_kernel"] = rng.normal(0, scale, shape).astype(np.float32)
        w[f"{name}_bias"] = rng.normal(0, 0.1, shape[1]).astype(np.float32)
    for i in (1, 2, 3):
        w[f"ln{i}_scale"] = (1.0 + rng.normal(0, 0.1, d)).astype(np.float32)
        w[f"ln{i}_bias"] = rng.normal(0, 0.1, d).astype(np.float32)
    return w


# (3, 60) crosses the period-25 ALiBi buckets twice; rtol/atol 1e-4 is the
# JAX package's own bar for its BIWI kernel against its scan
@pytest.mark.parametrize("b,t", [(1, 30), (3, 60)])
def test_biwi_decode_loop_matches_jax_kernel(b, t):
    rng = np.random.default_rng(0)
    w = _rand_weights(rng)
    mem_k = rng.normal(0, 0.5, (b, 4, 2 * t, 16)).astype(np.float32)
    mem_v = rng.normal(0, 0.5, (b, 4, 2 * t, 16)).astype(np.float32)
    style = rng.normal(0, 0.5, (b, 64)).astype(np.float32)
    pe = ff.periodic_positional_encoding(PERIOD)
    ref = jax_decode(
        None, jnp.asarray(style), jnp.asarray(pe), {k: jnp.asarray(v) for k, v in w.items()},
        period=PERIOD, interpret=True, fast_math=False,
        mem_k=jnp.asarray(mem_k), mem_v=jnp.asarray(mem_v),
    )
    tw = {k: torch.tensor(v) for k, v in w.items()}
    faceformer_decode_loop.biwi_launches = 0
    out = faceformer_decode_loop(
        None, torch.tensor(style), torch.tensor(pe), tw, period=PERIOD,
        mem_k=torch.tensor(mem_k), mem_v=torch.tensor(mem_v),
    )
    assert tuple(out.shape) == (b, t, 64) and faceformer_decode_loop.biwi_launches == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # bf16 inputs: computed in f32, rounded once at the end
    bf = torch.bfloat16
    args = (torch.tensor(style).to(bf), torch.tensor(pe).to(bf),
            {k: v.to(bf) if "ln" not in k else v for k, v in tw.items()})
    mem = dict(mem_k=torch.tensor(mem_k).to(bf), mem_v=torch.tensor(mem_v).to(bf))
    got = decode_loop_reference(None, *args, period=PERIOD, **mem)
    want = decode_steps(None, args[0].float(), args[1].float(),
                        {k: v.float() for k, v in args[2].items()}, period=PERIOD,
                        **{k: v.float() for k, v in mem.items()})
    assert got.dtype == bf and torch.equal(got, want.to(bf))


def test_biwi_decode_loop_checks_its_inputs():
    rng = np.random.default_rng(1)
    w = {k: torch.tensor(v) for k, v in _rand_weights(rng).items()}
    style, pe = torch.zeros(2, 64), torch.tensor(ff.periodic_positional_encoding(PERIOD))
    mem = torch.zeros(2, 4, 20, 16)
    with pytest.raises(ValueError, match="cross=None"):
        faceformer_decode_loop(torch.zeros(2, 10, 64), style, pe, w, period=PERIOD, mem_k=mem, mem_v=mem)
    with pytest.raises(ValueError, match="2T"):
        faceformer_decode_loop(None, style, pe, w, period=PERIOD, mem_k=mem[:, :, :19], mem_v=mem[:, :, :19])
    with pytest.raises(ValueError, match="cq_kernel"):
        faceformer_decode_loop(
            None, style, pe, {k: v for k, v in w.items() if not k.startswith("cq")},
            period=PERIOD, mem_k=mem, mem_v=mem)
    with pytest.raises(ValueError, match="vocaset variant"):
        faceformer_decode_loop(None, style, pe, w, period=PERIOD)


def test_biwi_trim_branch_matches_jax():
    """Even-length trim, the 2x-frame cap and the clamp of the valid latent
    counts, on the cases of the JAX package's own trim test."""
    rng = np.random.default_rng(5)
    audio = (rng.normal(size=(2, 16000)) * 0.1).astype(np.float32)
    jenc = JaxEncoder(JaxConfig(num_layers=1))
    variables = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(audio))
    enc = Wav2Vec2Encoder(Wav2Vec2Config(num_layers=1))
    enc.load_state_dict(wav2vec2_state_dict_from_jax(jax.tree.map(np.asarray, variables["params"])))
    enc.eval()
    lengths = np.asarray([16000, 11000], np.int32)
    for output_len, n_out in ((None, 48), (10, 20), (25, 48)):
        for lens in (None, lengths):
            ref = np.asarray(jenc.apply(
                variables, jnp.asarray(audio), output_len=output_len, dataset="biwi",
                lengths=None if lens is None else jnp.asarray(lens)))
            with torch.no_grad():
                out = enc(torch.tensor(audio), output_len=output_len, dataset="biwi",
                          lengths=None if lens is None else torch.tensor(lens)).numpy()
            assert out.shape == ref.shape == (2, n_out, 768)
            # 11000 samples give 34 valid latents; rows past them are padding
            for i, n in enumerate((n_out, min(n_out, 34)) if lens is not None else (n_out, n_out)):
                np.testing.assert_allclose(out[i, :n], ref[i, :n], atol=1e-4, rtol=0)


def _jax_biwi_params(rng, audio, one_hot, template):
    model = jff.FaceFormer(
        n_verts=N_VERTS, n_onehot=12, decode_impl="scan", dataset="biwi", period=PERIOD)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), audio, one_hot, template)
    params = dict(jax.tree.map(np.asarray, variables["params"]))
    for name, shape in MOTION_MAPS:  # the init zeroes them: output == template
        params[name] = rng.normal(0, 0.05, shape).astype(np.float32)
    # non-zero cross biases, so that the zero-padded latents (bias-only keys
    # and values) weigh in the 2-way softmax
    for name in ("cross_k_bias", "cross_v_bias", "cross_q_bias"):
        params[name] = rng.normal(0, 0.3, (64,)).astype(np.float32)
    return model, params


def test_whole_biwi_faceformer_matches_jax():
    """1 s of audio: 25 frames against 49 latents, trimmed to 48 and
    zero-padded to 50 (the short encode), padded batch with lengths."""
    rng = np.random.default_rng(4)
    b, s = 2, 16000
    audio = (rng.normal(size=(b, s)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[[1, 5]]
    template = rng.normal(size=(b, N_VERTS // 3, 3)).astype(np.float32)
    lengths = np.asarray([s, 11000], np.int32)
    model, params = _jax_biwi_params(rng, audio, one_hot, template)
    ref, ref_mask = jax.jit(lambda p, a, o, t, l: model.apply({"params": p}, a, o, t, l))(
        params, audio, one_hot, template, lengths)
    ref, ref_mask = np.asarray(ref), np.asarray(ref_mask)

    port = ff.FaceFormer(N_VERTS, 12, dataset="biwi", period=PERIOD)
    assert tuple(port.ppe.shape) == (PERIOD, 64)
    port.load_state_dict(faceformer_state_dict_from_jax(params))
    port.eval()
    with torch.no_grad():
        out, mask = port(torch.tensor(audio), torch.tensor(one_hot), torch.tensor(template),
                         torch.tensor(lengths))
    out, mask = out.numpy(), mask.numpy()
    assert out.shape == ref.shape == (b, 25, N_VERTS // 3, 3)
    np.testing.assert_array_equal(mask, ref_mask)
    for i in range(b):
        n = int(mask[i].sum())
        assert n == lengths[i] * 25 // 16000
        l2 = np.linalg.norm(out[i, :n] - ref[i, :n], axis=-1).max()
        assert l2 < 1e-4, (i, l2)


def test_biwi_predictor_matches_jax_and_refuses_mismatched_weights():
    kw = dict(n_verts=N_VERTS, bf16=False, max_batch=4, bucket_seconds=0.5)
    rng = np.random.default_rng(0)
    init = JaxPredictor(decode_impl="scan", dataset="biwi", **kw)
    params = dict(jax.tree.map(np.asarray, init.variables["params"]))
    for name, shape in MOTION_MAPS:
        params[name] = rng.normal(0, 0.05, shape).astype(np.float32)
    ref = JaxPredictor(variables={"params": jax.tree.map(jnp.asarray, params)},
                       decode_impl="scan", dataset="biwi", **kw)
    port = FaceFormerPredictor(variables={"params": params}, dataset="biwi", device="cpu", **kw)
    assert port.fps == ref.fps == 25 and port.model.period == 25
    audios = [(rng.normal(size=int(s * 16000)) * 0.1).astype(np.float32) for s in (0.3, 0.7, 0.45)]
    one_hot = np.eye(12, dtype=np.float32)[[0, 4, 9]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    want = ref(audios, one_hot, template)
    got = port(audios, one_hot, template)
    for a, w, g in zip(audios, want, got):
        assert g.shape == w.shape == (len(a) * 25 // 16000, N_VERTS // 3, 3)
        assert float(np.linalg.norm(g - w, axis=-1).max()) < 1e-4
    # the mismatch is an error in both directions, as in the JAX predictor
    with pytest.raises(ValueError, match="dataset='biwi'"):
        FaceFormerPredictor(variables={"params": params}, device="cpu", **kw)
    vocaset = {k: v for k, v in params.items() if not k.startswith(("cross_q", "cross_k"))}
    with pytest.raises(ValueError, match="dataset='vocaset'"):
        FaceFormerPredictor(variables={"params": vocaset}, dataset="biwi", device="cpu", **kw)
    with pytest.raises(ValueError, match="dataset='vocaset'"):
        FaceFormerPredictor(state_dict=faceformer_state_dict_from_jax(vocaset), dataset="biwi",
                            device="cpu", **kw)


def test_biwi_weight_map_there_and_back():
    rng = np.random.default_rng(2)
    audio = np.zeros((1, 800), np.float32)
    _, params = _jax_biwi_params(rng, audio, np.eye(12, dtype=np.float32)[:1],
                                 np.zeros((1, N_VERTS // 3, 3), np.float32))
    sd = faceformer_state_dict_from_jax(params)
    assert "cross_q.weight" in sd and "cross_k.bias" in sd
    back = faceformer_jax_tree_from_state_dict(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=str(path))
    # a vocaset state dict has no cross_q/cross_k and maps to a tree without them
    port = ff.FaceFormer(N_VERTS, 12, encoder_config=Wav2Vec2Config(num_layers=1))
    assert "cross_q_kernel" not in faceformer_jax_tree_from_state_dict(port.state_dict())
    assert not hasattr(port, "cross_q")


def test_biwi_decoder_gradients_match_jax_scan():
    """Through encoder_hidden= (2T latents), eval mode with
    differentiable=True; leaf by leaf through the inverse name map, each leaf
    within 1e-3 of its largest value."""
    rng = np.random.default_rng(0)
    b, s = 2, 16000  # 25 frames
    t = s * 25 // 16000
    audio = (rng.normal(size=(b, s)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[[1, 5]]
    template = rng.normal(size=(b, N_VERTS // 3, 3)).astype(np.float32)
    hidden = rng.normal(size=(b, 2 * t, 768)).astype(np.float32)
    probe = rng.normal(size=(b, t, N_VERTS // 3, 3)).astype(np.float32)
    model, params = _jax_biwi_params(
        rng, jnp.asarray(audio[:, :800]), jnp.asarray(one_hot), jnp.asarray(template))
    dec_params = {k: v for k, v in params.items() if k != "audio_encoder"}

    def jax_loss(dp):
        out = model.apply({"params": {**dp, "audio_encoder": params["audio_encoder"]}},
                          jnp.asarray(audio), jnp.asarray(one_hot), jnp.asarray(template),
                          encoder_hidden=jnp.asarray(hidden))
        return jnp.sum(out * probe), out

    (_, ref_out), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(dec_params)

    narrow = Wav2Vec2Config(conv_dim=(32,) * 7, hidden_size=768, num_layers=1, num_heads=4,
                            intermediate_size=64, pos_conv_kernel=16, pos_conv_groups=4)
    port = ff.FaceFormer(N_VERTS, 12, dataset="biwi", period=PERIOD, encoder_config=narrow)
    sd = faceformer_state_dict_from_jax(params)
    port.load_state_dict({k: v for k, v in sd.items() if not k.startswith("audio_encoder.")},
                         strict=False)
    port.eval()
    faceformer_decode_loop.launches = faceformer_decode_loop.biwi_launches = 0
    out = port(torch.tensor(audio), torch.tensor(one_hot), torch.tensor(template),
               encoder_hidden=torch.tensor(hidden), differentiable=True)
    (out * torch.tensor(probe)).sum().backward()
    l2 = np.linalg.norm(out.detach().numpy() - np.asarray(ref_out), axis=-1).max()
    assert l2 < 1e-4, l2

    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in port.named_parameters()}
    tree = faceformer_jax_tree_from_state_dict(grads)
    assert set(tree) - {"audio_encoder"} == set(ref_grads)
    assert port.cross_q.weight.grad.abs().sum() > 0 and port.cross_k.weight.grad.abs().sum() > 0
    largest = max(float(np.abs(np.asarray(ref)).max()) for ref in ref_grads.values())
    for name, ref in ref_grads.items():
        ref = np.asarray(ref)
        # biases whose gradient vanishes analytically (a softmax ignores a
        # shift of a row's scores) are rounding noise on both sides, held to
        # the same share of 1e-4 of the largest gradient of any leaf
        scale = max(float(np.abs(ref).max()), 1e-4 * largest)
        np.testing.assert_allclose(tree[name], ref, rtol=0, atol=1e-3 * scale, err_msg=name)
    assert faceformer_decode_loop.launches == faceformer_decode_loop.biwi_launches == 0


def test_biwi_train_mode_masks_and_chunks():
    """The BIWI step loop with dropout masks under chunk checkpointing equals
    the unchunked loop, values and gradients, and the cross mask enters it."""
    rng = np.random.default_rng(3)
    b, t = 2, 20
    w = {k: torch.tensor(v).requires_grad_(True) for k, v in _rand_weights(rng).items()}
    mem_k = torch.tensor(rng.normal(0, 0.5, (b, 4, 2 * t, 16)).astype(np.float32)).requires_grad_(True)
    mem_v = torch.tensor(rng.normal(0, 0.5, (b, 4, 2 * t, 16)).astype(np.float32)).requires_grad_(True)
    style = torch.tensor(rng.normal(0, 0.5, (b, 64)).astype(np.float32))
    pe = torch.tensor(ff.periodic_positional_encoding(PERIOD))
    masks = ff.decoder_keep_masks(t, b, torch.float32, torch.Generator().manual_seed(2), "cpu")
    leaves = [mem_k, mem_v, *w.values()]
    results = []
    for chunk in (None, 5, 6):  # 6 does not divide 20: ragged tail
        hs = decode_steps(None, style, pe, w, period=PERIOD, masks=masks, chunk=chunk,
                          mem_k=mem_k, mem_v=mem_v)
        results.append((hs.detach(), torch.autograd.grad(hs.square().sum(), leaves)))
    hs0, g0 = results[0]
    for hs, grads in results[1:]:
        np.testing.assert_allclose(hs.numpy(), hs0.numpy(), rtol=0, atol=1e-6)
        for a, ref in zip(grads, g0):
            np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6 * float(ref.abs().max()))
    no_ca = dict(masks, m_ca=torch.ones_like(masks["m_ca"]))
    other = decode_steps(None, style, pe, w, period=PERIOD, masks=no_ca, mem_k=mem_k, mem_v=mem_v)
    assert not torch.allclose(other, hs0)


def test_biwi_trainer_steps_at_25_fps():
    """``dataset: biwi`` builds the BIWI model (period 25) and trains through
    the step loop: frames and loss masks run at 25 fps, ``cross_q``/``cross_k``
    get gradients, the loss on a repeated batch falls."""
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    narrow = Wav2Vec2Config(conv_dim=(32,) * 7, hidden_size=48, num_layers=1, num_heads=4,
                            intermediate_size=64, pos_conv_kernel=16, pos_conv_groups=4)
    cfg = ExpConfig(
        batch_size=2, modelname="faceformer", one_hot_size=12, feature_extractor=None,
        sample_rate=16000, vertex_count=90, split_frame=False, n_feature=32, out_dim=52,
        win_length=440, percision="32", lr=1e-3, seed=3, dataset="biwi",
    )
    exp = Audio2FaceExperiment(cfg, device="cpu", model_kwargs={"encoder_config": narrow})
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():  # trained-like motion maps: the zero init blocks the decoder's gradients
        for lin in (exp.model.vertice_map, exp.model.vertice_map_r):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    rng = np.random.default_rng(0)
    samples = 8000
    t = samples * 25 // 16000  # 12 frames
    batch = {
        "audio": (rng.normal(size=(2, samples)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[[2, 7]],
        "verts": (rng.normal(size=(2, t, 90)) * 0.01).astype(np.float32),
        "template_vert": (rng.normal(size=(2, 30, 3)) * 0.01).astype(np.float32),
        "audio_lengths": np.asarray([samples, 5000], np.int32),
    }
    faceformer_decode_loop.launches = faceformer_decode_loop.biwi_launches = 0
    before = exp.eval_step(batch)
    exp.accumulate_gradients(batch)
    for name in ("cross_q", "cross_k"):
        grad = getattr(exp.model, name).weight.grad
        assert grad is not None and torch.isfinite(grad).all() and grad.abs().sum() > 0, name
    for _ in range(6):
        metrics = exp.train_step(batch)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert float(exp.eval_step(batch)["loss"]) < float(before["loss"])
    pred, _ = exp.predict(batch)
    assert pred.shape == (2, t, 30, 3)
    assert faceformer_decode_loop.launches == faceformer_decode_loop.biwi_launches == 0
