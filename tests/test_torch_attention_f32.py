"""f32 attention at the f32 forward's short-key boundary: the port (CPU -> its
plain versions, forward and backward through the autograd Function) against
the JAX package's Pallas kernels run in interpret mode, at t_k = 1, 25, 64
and 65 (t_k <= 64 takes the short-key kernel on the card, 65 the tiled
one), t_q != t_k, every option, and at the wav2vec2 frame window."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.ops.attention import flash_attention_bwd_pallas, flash_attention_pallas
from audio2face_tpu_torch.ops import attention as attn
from audio2face_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

# tests/test_attention.py's tolerance for the flash kernel vs the reference
RTOL, ATOL = 1e-4, 1e-5
# the JAX package's bar for its backward kernels (tests/test_attention.py)
BWD_RTOL, BWD_ATOL = 2e-3, 2e-4
SEED = 77

CASES = [
    # b, h, t_q, t_k, d, causal, period, kv_lengths, rate
    pytest.param(2, 2, 25, 25, 64, False, None, None, 0.0, id="tk25"),
    pytest.param(2, 2, 25, 25, 64, True, 25, [25, 0], 0.1, id="tk25-causal-period-kvlen0-dropout"),
    pytest.param(3, 2, 40, 1, 32, False, None, [1, 0, 1], 0.1, id="tk1-tq40-kvlen0-dropout"),
    pytest.param(2, 3, 1, 1, 16, False, 25, None, 0.0, id="tk1-tq1-period"),
    pytest.param(2, 2, 7, 64, 32, False, 25, [64, 40], 0.1, id="tk64-tq7-negative-offsets"),
    pytest.param(2, 2, 64, 64, 16, True, 25, None, 0.1, id="tk64-causal-period-dropout"),
    pytest.param(2, 2, 100, 65, 64, True, None, [65, 1], 0.1, id="tk65-tq100-causal-kvlen"),
    pytest.param(2, 2, 30, 65, 16, False, 25, [65, 0], 0.0, id="tk65-tq30-period-kvlen0"),
    pytest.param(1, 2, 65, 65, 128, False, 25, None, 0.1, id="tk65-d128-period-dropout"),
]


def _inputs(b, h, t_q, t_k, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t_q, d)).astype(np.float32)
    k = rng.normal(size=(b, h, t_k, d)).astype(np.float32)
    v = rng.normal(size=(b, h, t_k, d)).astype(np.float32)
    g = rng.normal(size=(b, h, t_q, d)).astype(np.float32)
    return q, k, v, g


def _jax_kw(causal, period, kvl, rate):
    return dict(causal=causal, alibi_period=period, interpret=True,
                kv_lengths=None if kvl is None else jnp.asarray(kvl, jnp.int32),
                dropout_rate=rate, dropout_seed=jnp.asarray([SEED], jnp.int32))


def _torch_kw(causal, period, kvl, rate):
    return dict(causal=causal, alibi_period=period, dropout_rate=rate, dropout_seed=SEED,
                kv_lengths=None if kvl is None else torch.tensor(kvl, dtype=torch.int32))


def _live(b, kvl):
    """Items whose rows attend to at least one key: a zero-length item's
    forward rows are padding (finite, not compared)."""
    return np.ones(b, bool) if kvl is None else np.asarray(kvl) > 0


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,period,kvl,rate", CASES)
def test_forward_matches_jax_kernel(b, h, t_q, t_k, d, causal, period, kvl, rate):
    q, k, v, _ = _inputs(b, h, t_q, t_k, d, seed=t_k + t_q)
    ref, ref_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True,
        **_jax_kw(causal, period, kvl, rate))
    out, lse = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), return_lse=True,
                               **_torch_kw(causal, period, kvl, rate))
    live = _live(b, kvl)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(ref_lse)[live], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,period,kvl,rate", CASES)
def test_backward_matches_jax_kernels(b, h, t_q, t_k, d, causal, period, kvl, rate):
    """dq, dk, dv through the autograd Function against
    flash_attention_bwd_pallas, at the JAX tests' bar for its backward."""
    q, k, v, g = _inputs(b, h, t_q, t_k, d, seed=t_k + t_q)
    jkw = _jax_kw(causal, period, kvl, rate)
    out_j, lse_j = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True, **jkw)
    ref = flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out_j, lse_j, jnp.asarray(g), **jkw)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, **_torch_kw(causal, period, kvl, rate))
    out.backward(torch.tensor(g))
    for name, r, a in zip(("dq", "dk", "dv"), ref, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=BWD_RTOL, atol=BWD_ATOL,
                                   err_msg=name)
    if kvl is not None:  # keys past the KV length (all keys of a zero-length item) get no gradient
        for i, n in enumerate(kvl):
            assert not kt.grad[i, :, n:].any() and not vt.grad[i, :, n:].any()


@pytest.mark.parametrize("kvl,rate", [
    pytest.param(None, 0.0, id="plain"),
    pytest.param([25, 20, 25, 3], 0.0, id="kvlen"),
    pytest.param([25, 20, 25, 3], 0.1, id="kvlen-dropout"),
])
def test_frame_window_matches_jax_kernel(kvl, rate):
    """The wav2vec2 extractor's frame-window shape, (B x 128, 12, 25, 64) on
    the card, at B x 128 = 4: out, lse and, through the Function, the
    gradients."""
    b, h, t, d = 4, 12, 25, 64
    q, k, v, g = _inputs(b, h, t, t, d, seed=4)
    jkw = _jax_kw(False, None, kvl, rate)
    ref, ref_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True, **jkw)
    ref_grads = flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ref, ref_lse, jnp.asarray(g), **jkw)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = flash_attention(qt, kt, vt, return_lse=True, **_torch_kw(False, None, kvl, rate))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=RTOL, atol=ATOL)
    out.backward(torch.tensor(g))
    for name, r, a in zip(("dq", "dk", "dv"), ref_grads, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=BWD_RTOL, atol=BWD_ATOL,
                                   err_msg=name)


def test_fully_masked_rows_attend_uniformly():
    """A zero-length item's rows are finite padding: the plain version gives
    every key the same weight (the mean of v) and an lse of the mask value,
    as the short-key kernel computes over the row's t_k keys."""
    q, k, v, _ = _inputs(2, 2, 5, 25, 64, seed=9)
    out, lse = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), return_lse=True,
                               kv_lengths=torch.tensor([0, 25]))
    mean_v = torch.tensor(v[0]).mean(dim=1, keepdim=True).expand(2, 5, 64)
    np.testing.assert_allclose(out[0].numpy(), mean_v.numpy(), rtol=1e-5, atol=1e-6)
    assert np.all(lse[0].numpy() == np.float32(attn.DEFAULT_MASK_VALUE))


def _c_constant(source: str, name: str) -> int:
    text = (Path(attn.__file__).resolve().parent.parent / "csrc" / source).read_text()
    m = re.search(r"constexpr\s+int\s+" + name + r"\s*=\s*(\d+)\s*;", text)
    assert m is not None, f"{name} not in {source}"
    return int(m.group(1))


def test_short_key_bound_matches_the_kernel_source():
    assert attn.F32_SHORT_MAX_TK == _c_constant("flash_attention.cu", "SK_MAX_TK") == 64


@pytest.mark.parametrize("t_k,path", [(1, "short"), (25, "short"), (64, "short"), (65, "tiled"),
                                      (600, "tiled"), (3600, "tiled")])
def test_f32_forward_path_is_chosen_by_t_k(t_k, path):
    assert attn.f32_forward_path(t_k) == path


def test_cpu_calls_count_no_f32_launch():
    """The f32 launch counters count kernel launches only: CPU tensors run
    the plain versions and count nothing."""
    attn.flash_attention.f32_launches = attn.flash_attention_bwd.f32_launches = 0
    attn.flash_attention.launches = attn.flash_attention_bwd.launches = 0
    q, k, v, g = (torch.tensor(x, requires_grad=True) for x in _inputs(1, 2, 9, 25, 16, seed=1))
    flash_attention(q, k, v).backward(g.detach())
    assert attn.flash_attention.f32_launches == attn.flash_attention_bwd.f32_launches == 0
    assert attn.flash_attention.launches == attn.flash_attention_bwd.launches == 0
