"""The port's mesh, data and Megatron tensor parallelism (``parallel/mesh.py``,
``parallel/comm.py``) on four spawned gloo ranks on the CPU, mirroring
tests/test_parallel.py: mesh shapes and errors, batch sharding, a DP
gradient step against one device, the TP spec rules against JAX's, the TP
encoder forward against JAX's unsharded encoder (atol 2e-5), and the
trainer's DP and DP x TP steps (FaceFormer, and Audio2Mesh with BatchNorm)
against the port's solo step with dropout on, at JAX's bars (loss and err
rtol 1e-5, parameters atol 3e-5 / rtol 1e-4). Also, with no spawn: the
attention hash with offsets and the row-sliced dropout draws against the
whole call's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_cases as cases
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from audio2face_tpu.parallel.mesh import make_mesh as jax_make_mesh
from audio2face_tpu.parallel.mesh import wav2vec2_param_spec as jax_param_spec
from audio2face_tpu_torch.compat.jax_params import wav2vec2_state_dict_from_jax
from audio2face_tpu_torch.models.faceformer import decoder_keep_masks
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder, dropout
from audio2face_tpu_torch.ops import attention as attn
from audio2face_tpu_torch.parallel.mesh import wav2vec2_param_spec
from torch_gloo import run_ranks

torch.set_num_threads(1)

TP_CONFIG = dict(
    conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=48, num_layers=2,
    num_heads=4, intermediate_size=96, pos_conv_kernel=16, pos_conv_groups=4,
)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 2000)).astype(np.float32)
    jenc = JaxEncoder(JaxConfig(**TP_CONFIG))
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    data = {
        "w": np.random.default_rng(0).normal(size=(12, 4)).astype(np.float32),
        "x": np.random.default_rng(1).normal(size=(16, 12)).astype(np.float32),
        "y": np.random.default_rng(2).normal(size=(16, 4)).astype(np.float32),
        "tp": {"config": TP_CONFIG, "audio": x,
               "state": {k: v.numpy() for k, v in wav2vec2_state_dict_from_jax(params).items()}},
    }
    ranks = run_ranks(4, cases.parallel_cases, (data,), tmp_path_factory.mktemp("gloo"))
    return ranks, data, np.asarray(jenc.apply(variables, jnp.asarray(x))), jenc


def test_mesh_shapes(results):
    ranks, *_ = results
    shapes = ranks[0]["mesh_shapes"]
    assert shapes[(4, 1)] == (4, 1) and shapes[(2, 2)] == (2, 2)
    assert shapes[(-1, 1)] == (4, 1) and shapes[(-1, 2)] == (2, 2) and shapes[(1, -1)] == (1, 4)
    # the errors are the JAX package's, word for word
    for shape, msg in ranks[0]["mesh_errors"].items():
        with pytest.raises(ValueError) as err:
            jax_make_mesh(shape, devices=jax.devices()[:4])
        assert str(err.value) == msg
    assert set(ranks[0]["mesh_errors"]) == {(3, 2), (-1, -1)}


def test_shard_batch_places_on_data_axis(results):
    ranks, *_ = results
    whole = np.arange(16 * 3).reshape(16, 3)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["shard_batch"]["audio"], whole[4 * r : 4 * r + 4])
        np.testing.assert_array_equal(got["shard_batch"]["odd"], np.arange(5))  # whole
        assert got["shard_batch"]["scalar"] == np.float32(2.0)
        np.testing.assert_array_equal(got["replicated"], [0.0, 0.0])  # rank 0's


def test_dp_training_step_matches_single_device(results):
    ranks, data, *_ = results
    w, x, y = (torch.tensor(data[k]) for k in ("w", "x", "y"))
    w.requires_grad_(True)
    ((x @ w - y) ** 2).mean().backward()
    for got in ranks:
        np.testing.assert_allclose(got["dp_grad"], w.grad.numpy(), rtol=1e-5)


def test_wav2vec2_tp_spec_rules():
    class FakeKey:
        def __init__(self, key):
            self.key = key

    paths = [("layer0", "q_proj", "kernel"), ("layer0", "q_proj", "bias"),
             ("layer0", "out_proj", "kernel"), ("layer0", "out_proj", "bias"),
             ("layer3", "intermediate_dense", "kernel"), ("layer3", "output_dense", "kernel"),
             ("layer2", "v_proj", "bias"), ("feature_projection", "projection", "kernel"),
             ("layer1", "layer_norm", "scale")]
    for names in paths:
        keys = tuple(FakeKey(n) for n in names)
        assert wav2vec2_param_spec(keys) == tuple(jax_param_spec(keys, None)) == jax_param_spec(
            keys, None), names
    # torch's (out, in) weights take the transposed spec of JAX's (in, out)
    assert wav2vec2_param_spec("layers.0.q_proj.weight") == ("model", None)
    assert wav2vec2_param_spec("layers.0.out_proj.weight") == (None, "model")
    assert wav2vec2_param_spec("layers.0.output_dense.bias") == () == P()
    assert wav2vec2_param_spec("feature_projection.projection.weight") == ()


def test_tensor_parallel_forward_matches_jax_unsharded(results):
    ranks, _, want, _ = results
    for got in ranks:
        assert got["tp_forward"].shape == want.shape
        np.testing.assert_allclose(got["tp_forward"], want, atol=2e-5)


def test_megatron_layer_holds_its_half_of_each_split_weight(results):
    ranks, data, *_ = results
    shapes = ranks[0]["tp_local_shapes"]
    assert shapes["q_proj.weight"] == (24, 48) and shapes["q_proj.bias"] == (24,)
    assert shapes["intermediate_dense.weight"] == (48, 48)  # 96 / 2 columns
    assert shapes["out_proj.weight"] == (48, 24) and shapes["out_proj.bias"] == (48,)
    assert shapes["output_dense.weight"] == (48, 48) and shapes["layer_norm.weight"] == (48,)
    np.testing.assert_array_equal(ranks[0]["tp_q_gathered"],
                                  data["tp"]["state"]["layers.0.q_proj.weight"])


def _assert_step_matches_solo(step, solo):
    for k, v in solo["metrics"].items():
        np.testing.assert_allclose(step["metrics"][k], v, rtol=1e-5, err_msg=k)
    assert step["step"] == solo["step"] == 1
    assert set(step["params"]) == set(solo["params"])
    for k, v in solo["params"].items():
        np.testing.assert_allclose(step["params"][k], v, atol=3e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", ["dp_step", "dp_tp_step"], ids=["dp", "dp-tp"])
def test_trainer_sharded_faceformer_step_matches_solo(results, case):
    ranks, *_ = results
    solo = ranks[0][case]["solo"]
    for got in ranks:
        _assert_step_matches_solo(got[case]["sharded"], solo)
    assert ranks[0][case]["tensor_parallel"] == (case == "dp_tp_step")
    assert ranks[0][case]["collectives"]["all_reduce"] > 0


def test_trainer_dp_batchnorm_gradient_matches_solo(results):
    """Audio2Mesh under DP: the BatchNorm moments are the whole batch's
    (forward and backward), so loss, err, every gradient and the running
    statistics equal the solo step's."""
    ranks, *_ = results
    solo = ranks[0]["bn_gradient"]["solo"]
    assert any("running_var" in k for k in solo["buffers"])
    for got in ranks:
        got = got["bn_gradient"]["sharded"]
        for k, v in solo["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
        for part in ("grads", "buffers"):
            for k, v in solo[part].items():
                np.testing.assert_allclose(got[part][k], v, atol=3e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hash_offsets_slice_the_whole_call(dtype):
    """A call on a slice of the batch and heads, told its place by
    ``hash_index``, drops what the whole call drops there: forward and the
    backward's plain version."""
    g = torch.Generator().manual_seed(0)
    b, h, t, d = 4, 6, 9, 16
    q, k, v, dout = (torch.randn(b, h, t, d, generator=g, dtype=dtype) for _ in range(4))
    kv = torch.tensor([9, 5, 7, 2])
    kw = dict(dropout_rate=0.3, dropout_seed=1234, kv_lengths=kv)
    out, lse = attn.mha_reference(q, k, v, return_lse=True, **kw)
    grads = attn.flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw)
    mask = attn.attention_keep_mask(b, h, t, t, 1234, 0.3, None)
    for b0, nb, h0, nh in ((2, 2, 3, 3), (1, 1, 0, 2), (0, 4, 4, 2)):
        rows, heads = slice(b0, b0 + nb), slice(h0, h0 + nh)
        part = [x[rows, heads] for x in (q, k, v, dout)]
        skw = dict(kw, kv_lengths=kv[rows], hash_index=(b0, h0, h))
        np.testing.assert_array_equal(
            attn.attention_keep_mask(nb, nh, t, t, 1234, 0.3, None, (b0, h0, h)), mask[rows, heads])
        o, l_ = attn.mha_reference(*part[:3], return_lse=True, **skw)
        torch.testing.assert_close(o, out[rows, heads], rtol=0, atol=0)
        for got, want in zip(attn.flash_attention_bwd_reference(*part[:3], o, l_, part[3], **skw),
                             grads):
            torch.testing.assert_close(got, want[rows, heads])
        if dtype == torch.float32:  # the wrapper on CPU tensors, with autograd
            o2 = attn.flash_attention(*part[:3], **skw)
            torch.testing.assert_close(o2, out[rows, heads], rtol=0, atol=0)


def test_row_sliced_random_draws_are_the_whole_draw_sliced():
    """Dropout, the decoder's keep masks and SpecAugment on a data-parallel
    rank's rows (and a tensor-parallel rank's columns) are that slice of
    the solo step's draws, and every rank's generator advances alike."""
    x = torch.randn(8, 5, 12)

    def gen():
        return torch.Generator().manual_seed(7)

    g_whole, g_part = gen(), gen()
    whole = dropout(x, 0.1, g_whole)
    part = dropout(x[2:6, :, 4:8], 0.1, g_part, rows=(2, 8), cols=(4, 12))
    torch.testing.assert_close(part, whole[2:6, :, 4:8], rtol=0, atol=0)
    assert torch.equal(torch.rand(3, generator=g_whole), torch.rand(3, generator=g_part))
    masks = decoder_keep_masks(10, 8, torch.float32, gen(), "cpu")
    part = decoder_keep_masks(10, 4, torch.float32, gen(), "cpu", batch_rows=(4, 8))
    for name, m in masks.items():
        torch.testing.assert_close(part[name], m[:, 4:8], rtol=0, atol=0)
    # the whole wav2vec2 encoder in train mode (dropouts, SpecAugment,
    # LayerDrop, attention dropout through the hash) on rows 2-3 of 4
    cfg = Wav2Vec2Config(**cases.ENC, mask_time_prob=0.2)
    enc = Wav2Vec2Encoder(cfg)
    enc.init_parameters(gen())
    audio = torch.randn(4, 4000, generator=gen()) * 0.1
    lengths = torch.tensor([4000, 3000, 2500, 3900])
    kw = dict(output_len=15, lengths=lengths, train=True, apply_spec_augment=True)
    with torch.no_grad():
        whole = enc(audio, generator=gen(), **kw)
        kw["lengths"] = lengths[2:]
        part = enc(audio[2:], generator=gen(), batch_rows=(2, 4), **kw)
    torch.testing.assert_close(part, whole[2:])
