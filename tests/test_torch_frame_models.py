"""The port's frame models (Audio2Mesh, VOCA, Song2Face) and their layers
against the JAX package with carried variables (``compat/jax_params.py``):
f32, eval and train mode, max per-vertex L2 < 1e-4 (BASELINE.md's bar), and
the BatchNorm running statistics after one train-mode forward at batch 2,
where the biased (flax) and unbiased (torch) variance updates part."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models import Audio2Mesh as JaxAudio2Mesh
from audio2face_tpu.models import Song2Face as JaxSong2Face
from audio2face_tpu.models import Voca as JaxVoca
from audio2face_tpu.models.layers import ScanLSTM as JaxScanLSTM
from audio2face_tpu.models.layers import tile_onehot_rows as jax_tile_onehot_rows
from audio2face_tpu_torch.compat.jax_params import (
    frame_model_jax_variables_from_state_dict,
    frame_model_state_dict_from_jax,
)
from audio2face_tpu_torch.models import layers
from audio2face_tpu_torch.registry import get_model

torch.set_num_threads(1)

N_VERTS = 300
VERTEX_L2_BAR = 1e-4
STATS_TOL = 1e-5  # running statistics, relative to their largest |value|
MODELS = [("audio2mesh", JaxAudio2Mesh, (52, 32)), ("voca", JaxVoca, (29, 16)),
          ("song2face", JaxSong2Face, (52, 32))]
FEATURES = {name: feat for name, _, feat in MODELS}


def _inputs(seed, bs, feat):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, *feat)).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[rng.integers(0, 12, bs)]
    template = rng.normal(size=(bs, N_VERTS // 3, 3)).astype(np.float32)
    return x, one_hot, template


@pytest.fixture(scope="module", params=MODELS, ids=[m[0] for m in MODELS])
def pair(request):
    """(name, JAX model, its variables with random BN statistics, port model)."""
    name, jax_cls, feat = request.param
    x, one_hot, template = _inputs(0, 2, feat)
    jm = jax_cls(N_VERTS, 12)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x, one_hot, template))
    rng = np.random.default_rng(1)
    if "batch_stats" in variables:
        variables = dict(variables, batch_stats=jax.tree.map(
            lambda a: (np.abs(rng.normal(size=a.shape)) + 0.5).astype(np.float32),
            variables["batch_stats"]))
    port = get_model(name)(N_VERTS, 12)
    port.load_state_dict(frame_model_state_dict_from_jax(name, variables))
    return name, jm, variables, port, feat


def _max_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1).max())


def test_eval_matches_jax(pair):
    name, jm, variables, port, feat = pair
    x, one_hot, template = _inputs(2, 3, feat)
    want = jm.apply(variables, x, one_hot, template)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(one_hot), torch.tensor(template))
    assert got.shape == (3, N_VERTS // 3, 3) and got.dtype == torch.float32
    assert _max_l2(got.numpy(), want) < VERTEX_L2_BAR


def test_train_mode_and_running_stats_match_jax(pair):
    """One train-mode forward at batch 2: the output (batch statistics) and
    the updated running statistics. Against the reference's torch update
    (unbiased variance) the running variance parts by n / (n - 1)."""
    name, jm, variables, port, feat = pair
    x, one_hot, template = _inputs(3, 2, feat)
    port = get_model(name)(N_VERTS, 12)
    port.load_state_dict(frame_model_state_dict_from_jax(name, variables))
    if "batch_stats" in variables:
        want, upd = jm.apply(variables, x, one_hot, template, train=True, mutable=["batch_stats"])
    else:
        want, upd = jm.apply(variables, x, one_hot, template, train=True), {}
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(one_hot), torch.tensor(template), train=True)
    assert _max_l2(got.numpy(), want) < VERTEX_L2_BAR
    if not upd:
        return  # VOCA has no BatchNorm
    back = frame_model_jax_variables_from_state_dict(name, port.state_dict())["batch_stats"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=0,
                                   atol=STATS_TOL * np.abs(np.asarray(leaf)).max())
    # a BN whose batch holds n = 2 items x 4 values per channel (Song2Face's
    # last regression BN, Audio2Mesh's artic4_pre_bn): torch's unbiased
    # update would differ from the biased one by n / (n - 1)
    bn_name = "reg2_bn" if name == "song2face" else "artic4_pre_bn"
    old = variables["batch_stats"][bn_name]["bn"]["var"]
    new = np.asarray(upd["batch_stats"][bn_name]["bn"]["var"])
    n = 2 * 4
    unbiased = 0.9 * old + (new - 0.9 * old) * n / (n - 1)
    assert np.abs(unbiased - new).max() > 100 * STATS_TOL * np.abs(new).max()


def test_state_dict_names_and_round_trip(pair):
    name, _, variables, port, _ = pair
    sd = port.state_dict()
    assert set(sd) == set(frame_model_state_dict_from_jax(name, variables))
    back = frame_model_jax_variables_from_state_dict(name, sd)
    for tree in ("params", "batch_stats"):
        leaves = jax.tree.leaves(jax.tree.map(
            lambda a, b: float(np.abs(np.asarray(a) - b).max()), variables.get(tree, {}), back[tree]))
        assert all(e == 0.0 for e in leaves)


@pytest.mark.parametrize("name", ["audio2mesh", "voca", "song2face"])
def test_bf16_forward_keeps_f32_vertices_and_init_scheme(name):
    """bf16 compute with f32 parameters (the "16-mixed" serving path): f32
    vertices, finite, close to the f32 forward; the init follows the JAX
    scheme (zero biases, unit BN scales, zero/one running statistics)."""
    feat = FEATURES[name]
    model = get_model(name)(N_VERTS, 12)
    model.init_parameters(torch.Generator().manual_seed(0))
    for key, value in model.state_dict().items():
        if key.endswith("running_var") or (".bn.weight" in key):
            assert torch.all(value == 1.0), key
        elif key.endswith("running_mean") or (key.endswith(".bias") and ".b_" not in key):
            assert torch.all(value == 0.0), key
    bf = get_model(name)(N_VERTS, 12, dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    x, one_hot, template = (torch.tensor(a) for a in _inputs(4, 2, feat))
    with torch.no_grad():
        f32, b16_eval = model(x, one_hot, template), bf(x, one_hot, template)
        b16 = bf(x, one_hot, template, train=True)
    assert b16.dtype == torch.float32 and torch.isfinite(b16).all()
    disp = (f32 - template).abs().max()
    assert (b16_eval - f32).abs().max() < 0.1 * disp


def test_onehot_tiling_matches_jax_and_torch_view():
    """The rotated-row tiling of the reference (32 columns, 12 entries)."""
    one_hot = np.zeros((2, 12), np.float32)
    one_hot[0, 3] = one_hot[1, 11] = 1.0
    got = layers.tile_onehot_rows(torch.tensor(one_hot), 12, 32).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_tile_onehot_rows(jnp.asarray(one_hot), 12, 32)))
    np.testing.assert_array_equal(got, torch.tensor(one_hot).repeat(1, 32).view(2, 12, 32).numpy())
    assert not (got[0] == got[0, 0]).all()  # rows are rotated, not equal
    np.testing.assert_array_equal(  # VOCA's 8 entries over 16 columns: whole rows
        layers.tile_onehot_rows(torch.tensor(one_hot[:, :8]), 8, 16).numpy(),
        np.asarray(jax_tile_onehot_rows(jnp.asarray(one_hot[:, :8]), 8, 16)))


def test_scan_lstm_matches_jax_and_torch_lstm():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 17, 64)).astype(np.float32)
    port = layers.ScanLSTM(64, 32)
    layers.init_frame_model(port, torch.Generator().manual_seed(5))
    params = {k: v.detach().numpy() for k, v in port.named_parameters()}
    jparams = {k: (v.T if v.ndim == 2 else v) for k, v in params.items()}
    want = np.asarray(JaxScanLSTM(32).apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.tensor(x), torch.float32).numpy()
        ref = torch.nn.LSTM(64, 32, batch_first=True)
        for leaf, name in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                           ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
            getattr(ref, name).copy_(getattr(port, leaf))
        torch_out = ref(torch.tensor(x))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, torch_out, atol=1e-5)
    # bf16: the recurrence in bf16 with an f32 hoisted projection, as JAX
    with torch.no_grad():
        b16 = port(torch.tensor(x), torch.bfloat16)
    want16 = np.asarray(JaxScanLSTM(32, dtype=jnp.bfloat16).apply({"params": jparams}, jnp.asarray(x)))
    assert b16.dtype == torch.bfloat16
    assert np.abs(b16.float().numpy() - want16.astype(np.float32)).max() < 0.05


def test_conv_stack_registers_jax_names():
    blocks = (dict(features=4, kernel=(1, 3), stride=(1, 2), pad=(0, 1), name="a0"),
              dict(features=5, kernel=(3, 1), stride=(2, 1), pad=(1, 0), bn=False, relu=False,
                   name="a1"))
    m = torch.nn.Module()
    assert layers.add_conv_blocks(m, 1, blocks) == 5
    assert sorted(n for n, _ in m.named_children()) == ["a0", "a0_bn", "a1"]
    out = layers.conv_stack(m, torch.randn(2, 1, 8, 8), blocks, False, torch.float32)
    assert out.shape == (2, 5, 4, 4)
