"""Attention for training: the hash dropout mask, dropout in the forward,
and the backward (plain version and autograd Function on the CPU) vs the JAX
package's Pallas kernels run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.ops.attention import (
    _dropout_keep_tile,
    flash_attention_bwd_pallas,
    flash_attention_pallas,
)
from audio2face_tpu_torch.ops import _build
from audio2face_tpu_torch.ops.attention import (
    dropout_keep_mask,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    mha_reference,
)

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

INT32_MAX = 2**31 - 1


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 1234567, -5, -INT32_MAX - 1, INT32_MAX, INT32_MAX - 1])
def test_dropout_keep_mask_equals_jax_hash(seed, rate):
    """Bit for bit: wrapping int32 multiplies and logical shifts, global
    row/col indices, bh up to 96."""
    bh = np.arange(96, dtype=np.int32).reshape(96, 1, 1)
    row = np.arange(70, dtype=np.int32).reshape(1, 70, 1) + 531
    col = np.arange(66, dtype=np.int32).reshape(1, 1, 66) + 3590
    ref = np.asarray(_dropout_keep_tile(
        jnp.int32(seed), jnp.asarray(bh), jnp.asarray(row), jnp.asarray(col), rate))
    got = dropout_keep_mask(seed, torch.tensor(bh), torch.tensor(row), torch.tensor(col), rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # a one-element tensor seed gives the same mask
    got_t = dropout_keep_mask(
        torch.tensor([seed], dtype=torch.int32), torch.tensor(bh), torch.tensor(row),
        torch.tensor(col), rate)
    np.testing.assert_array_equal(got_t.numpy(), ref)
    dropped = float((got == 0).float().mean())
    if rate == 0.1:
        assert 0.05 < dropped < 0.16
    kept = got[got > 0]
    np.testing.assert_array_equal(kept.numpy(), np.float32(1.0 / (1.0 - rate)))


def _qkv(rng, b, h, t_q, t_k, d):
    return (rng.normal(size=(b, h, t_q, d)).astype(np.float32),
            rng.normal(size=(b, h, t_k, d)).astype(np.float32),
            rng.normal(size=(b, h, t_k, d)).astype(np.float32))


@pytest.mark.parametrize("causal,period", [(False, None), (True, 60)])
def test_dropout_forward_matches_jax_kernel(causal, period):
    """Same dropped positions as the Pallas kernel: tests/test_attention.py's
    bar for the kernel against a dense hash-mask oracle (2e-5)."""
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 3, 130, 130, 64)
    seed = 77
    ref, ref_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, alibi_period=period,
        interpret=True, return_lse=True, dropout_rate=0.1, dropout_seed=jnp.asarray([seed], jnp.int32))
    out, lse = mha_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal, alibi_period=period,
        return_lse=True, dropout_rate=0.1, dropout_seed=seed)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    # the logsumexp never sees the mask
    _, lse0 = mha_reference(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
                            alibi_period=period, return_lse=True)
    np.testing.assert_array_equal(lse.numpy(), lse0.numpy())
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-4, atol=1e-5)
    # the wrapper on CPU tensors is the plain version, and rate 0 is the
    # no-dropout result exactly
    via = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
                          alibi_period=period, dropout_rate=0.1, dropout_seed=seed)
    np.testing.assert_array_equal(via.numpy(), out.numpy())
    none = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
                           alibi_period=period, dropout_rate=0.0, dropout_seed=seed)
    plain = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
                            alibi_period=period)
    np.testing.assert_array_equal(none.numpy(), plain.numpy())


BWD_CASES = [
    # b, h, t_q, t_k, d, causal, period, kv_lengths, rate
    pytest.param(2, 3, 130, 130, 64, False, None, None, 0.0, id="plain"),
    pytest.param(2, 3, 130, 130, 64, False, None, None, 0.1, id="dropout"),
    pytest.param(2, 2, 64, 64, 32, True, None, [64, 40], 0.0, id="causal-kvlen"),
    pytest.param(2, 2, 64, 64, 32, True, 60, [64, 40], 0.1, id="causal-kvlen-period-dropout"),
    pytest.param(2, 4, 90, 150, 16, False, 60, None, 0.0, id="tq-ne-tk-period"),
    pytest.param(1, 2, 40, 100, 64, False, None, [57], 0.5, id="tq-ne-tk-kvlen-dropout"),
]


@pytest.mark.parametrize("b,h,t_q,t_k,d,causal,period,kvl,rate", BWD_CASES)
def test_backward_matches_jax_kernels(b, h, t_q, t_k, d, causal, period, kvl, rate):
    """flash_attention_bwd_reference and the autograd Function (CPU) against
    flash_attention_bwd_pallas in interpret mode: the JAX tests' bar for the
    Pallas backward (rtol 2e-3, atol 2e-4)."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, b, h, t_q, t_k, d)
    g = rng.normal(size=q.shape).astype(np.float32)
    seed = 2024
    kv_j = None if kvl is None else jnp.asarray(kvl, jnp.int32)
    kv_t = None if kvl is None else torch.tensor(kvl, dtype=torch.int32)
    jkw = dict(causal=causal, alibi_period=period, kv_lengths=kv_j, interpret=True,
               dropout_rate=rate, dropout_seed=jnp.asarray([seed], jnp.int32))
    out_j, lse_j = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True, **jkw)
    ref = flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out_j, lse_j, jnp.asarray(g), **jkw)
    ref = [np.asarray(x) for x in ref]

    tkw = dict(causal=causal, alibi_period=period, kv_lengths=kv_t,
               dropout_rate=rate, dropout_seed=seed)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = flash_attention(qt, kt, vt, return_lse=True, **tkw)
    assert out.grad_fn is not None and not lse.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=2e-5)
    out.backward(torch.tensor(g))
    got_fn = [x.grad.numpy() for x in (qt, kt, vt)]
    got_ref = flash_attention_bwd_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), out.detach(), lse, torch.tensor(g), **tkw)
    for name, r, a, c in zip(("dq", "dk", "dv"), ref, got_fn, got_ref):
        np.testing.assert_allclose(a, r, rtol=2e-3, atol=2e-4, err_msg=f"Function {name}")
        np.testing.assert_allclose(c.numpy(), r, rtol=2e-3, atol=2e-4, err_msg=f"reference {name}")
    if kvl is not None:  # keys past the KV length get no gradient
        for i, n in enumerate(kvl):
            assert not got_fn[1][i, :, n:].any() and not got_fn[2][i, :, n:].any()


def test_backward_equals_autograd_through_plain_version():
    """The closed form is the derivative of mha_reference with the same mask."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(rng, 2, 2, 33, 47, 16))
    kw = dict(causal=False, alibi_period=7, kv_lengths=torch.tensor([47, 20]),
              dropout_rate=0.2, dropout_seed=-3)
    g = torch.tensor(rng.normal(size=q.shape).astype(np.float32))
    out, lse = mha_reference(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = flash_attention_bwd(q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), g, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_zero_length_item_gives_zero_dk_dv_and_finite_dq():
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(rng, 2, 2, 20, 20, 16))
    out = flash_attention(q, k, v, kv_lengths=torch.tensor([0, 20]), dropout_rate=0.1, dropout_seed=5)
    out.square().sum().backward()
    assert not k.grad[0].any() and not v.grad[0].any()
    assert torch.isfinite(q.grad).all() and k.grad[1].any()


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_function_gradcheck_f64(rate):
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
               for x in _qkv(rng, 1, 2, 5, 7, 16))

    def fn(q, k, v):
        return flash_attention(q, k, v, alibi_period=3, kv_lengths=torch.tensor([6]),
                               dropout_rate=rate, dropout_seed=11)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6)


def test_cpu_backward_launches_and_builds_nothing():
    flash_attention.launches = flash_attention_bwd.launches = 0
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(x, requires_grad=True) for x in _qkv(rng, 1, 1, 9, 9, 16))
    flash_attention(q, k, v, causal=True, dropout_rate=0.1, dropout_seed=1).sum().backward()
    assert q.grad is not None
    assert flash_attention.launches == 0 and flash_attention_bwd.launches == 0
    assert not _build._libs


def test_invalid_dropout_rate_raises():
    x = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="dropout_rate"):
        flash_attention(x, x, x, dropout_rate=1.0, dropout_seed=0)
