"""Port flash_attention (CPU -> its plain version) vs the JAX Pallas flash
kernel run in interpret mode, output and logsumexp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.ops.attention import flash_attention_pallas
from audio2face_tpu_torch.ops.attention import flash_attention

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

# tests/test_attention.py's tolerance for the flash kernel vs the reference
RTOL, ATOL = 1e-4, 1e-5


def _run_both(b, h, t_q, t_k, d, *, causal, period, kv_lengths=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t_q, d)).astype(np.float32)
    k = rng.normal(size=(b, h, t_k, d)).astype(np.float32)
    v = rng.normal(size=(b, h, t_k, d)).astype(np.float32)
    kvl = None if kv_lengths is None else np.asarray(kv_lengths, np.int32)
    ref, ref_lse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        alibi_period=period, kv_lengths=None if kvl is None else jnp.asarray(kvl),
        interpret=True, return_lse=True,
    )
    out, lse = flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        alibi_period=period, kv_lengths=None if kvl is None else torch.tensor(kvl),
        return_lse=True,
    )
    return np.asarray(ref), np.asarray(ref_lse), out.numpy(), lse.numpy()


@pytest.mark.parametrize("period", [None, 60])
@pytest.mark.parametrize("t_q,t_k,d", [(37, 37, 16), (130, 130, 64), (8, 200, 64)])
def test_causal_matches_jax(t_q, t_k, d, period):
    ref, ref_lse, out, lse = _run_both(2, 3, t_q, t_k, d, causal=True, period=period)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse, ref_lse, rtol=RTOL, atol=ATOL)


def test_noncausal_period_negative_offsets():
    """t_q != t_k without causality gives negative i - j: the ALiBi bucket
    must floor toward -inf, not truncate toward zero."""
    ref, ref_lse, out, lse = _run_both(2, 4, 90, 150, 32, causal=False, period=60, seed=1)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse, ref_lse, rtol=RTOL, atol=ATOL)


def test_kv_lengths_mask():
    ref, ref_lse, out, lse = _run_both(
        3, 2, 100, 100, 64, causal=False, period=None, kv_lengths=[100, 57, 3], seed=2
    )
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse, ref_lse, rtol=RTOL, atol=ATOL)
