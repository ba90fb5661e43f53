"""Port losses vs the JAX package's, values and (for the chunked head loss)
gradients, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu import losses as jl
from audio2face_tpu_torch import losses as tl

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

RTOL = 1e-6
V = 40


def _close(got: dict, ref: dict):
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=1e-7)


def test_voca_loss():
    rng = np.random.default_rng(0)
    pred, gt = rng.normal(size=(2, 8, V, 3)).astype(np.float32)
    _close(tl.VocaLoss()(torch.tensor(pred), torch.tensor(gt)),
           jl.VocaLoss()(jnp.asarray(pred), jnp.asarray(gt)))
    _close(tl.VocaLoss(2.0, 3.0)(torch.tensor(pred), torch.tensor(gt)),
           jl.VocaLoss(2.0, 3.0)(jnp.asarray(pred), jnp.asarray(gt)))


@pytest.mark.parametrize("t", [6, 7])
def test_faceformer_loss_drops_odd_frame(t):
    rng = np.random.default_rng(1)
    pred, gt = rng.normal(size=(2, 1, t, V, 3)).astype(np.float32)
    _close(tl.FaceFormerLoss()(torch.tensor(pred), torch.tensor(gt)),
           jl.FaceFormerLoss()(jnp.asarray(pred), jnp.asarray(gt)))


@pytest.mark.parametrize("t", [8, 9])
def test_masked_faceformer_loss(t):
    rng = np.random.default_rng(2)
    pred, gt = rng.normal(size=(2, 3, t, V, 3)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray([t, 5, 0])[:, None]).astype(np.float32)
    _close(tl.masked_faceformer_loss(torch.tensor(pred), torch.tensor(gt), torch.tensor(mask)),
           jl.masked_faceformer_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)))
    if t % 2:  # FaceFormerLoss drops an odd trailing frame from every term
        return
    # B = 1 with every frame valid is FaceFormerLoss
    full = tl.masked_faceformer_loss(torch.tensor(pred[:1]), torch.tensor(gt[:1]), torch.ones(1, t))
    ff = tl.FaceFormerLoss()(torch.tensor(pred[:1]), torch.tensor(gt[:1]))
    np.testing.assert_allclose(full["loss"].numpy(), ff["loss"].numpy(), rtol=1e-6)


def test_mse_error():
    rng = np.random.default_rng(3)
    pred, gt = rng.normal(size=(2, 2, 5, V, 3)).astype(np.float32)
    mask = np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    for m in (None, mask):
        got = tl.mse_error(torch.tensor(pred), torch.tensor(gt), V,
                           None if m is None else torch.tensor(m))
        ref = jl.mse_error(jnp.asarray(pred), jnp.asarray(gt), V,
                           None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("t,chunk", [(7, 128), (16, 6), (130, 128), (130, 32)])
def test_chunked_head_loss_value_and_gradients(t, chunk):
    """Value equals the JAX chunked loss and the port's unchunked pair;
    gradients w.r.t. hs, kernel and bias equal jax.grad's."""
    rng = np.random.default_rng(t)
    b, d = 2, 64
    hs = rng.normal(size=(b, t, d)).astype(np.float32)
    kernel = (rng.normal(size=(d, 3 * V)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(3 * V,)) * 0.1).astype(np.float32)
    template = rng.normal(size=(b, V, 3)).astype(np.float32)
    gt = rng.normal(size=(b, t, V, 3)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray([t, max(t - 3, 1)])[:, None]).astype(np.float32)

    def jax_loss(hs, kernel, bias):
        loss, err = jl.chunked_faceformer_head_loss(
            hs, kernel, bias, jnp.asarray(template), jnp.asarray(gt), jnp.asarray(mask),
            n_verts=V, precision=jax.lax.Precision.HIGHEST, chunk=chunk)
        return loss["loss"], (loss, err)

    (_, (ref_loss, ref_err)), ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(hs), jnp.asarray(kernel), jnp.asarray(bias))

    ths, tk, tb = (torch.tensor(x, requires_grad=True) for x in (hs, kernel, bias))
    loss, err = tl.chunked_faceformer_head_loss(
        ths, tk, tb, torch.tensor(template), torch.tensor(gt), torch.tensor(mask),
        n_verts=V, chunk=chunk)
    loss["loss"].backward()
    for key in ref_loss:
        np.testing.assert_allclose(loss[key].detach().numpy(), np.asarray(ref_loss[key]), rtol=1e-5)
    np.testing.assert_allclose(err.detach().numpy(), np.asarray(ref_err), rtol=1e-5)
    for got, ref in zip((ths, tk, tb), ref_grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())

    # the unchunked pair on the materialized prediction
    with torch.no_grad():
        pred = (ths @ tk + tb).reshape(b, t, V, 3) + torch.tensor(template)[:, None]
        want = tl.masked_faceformer_loss(pred, torch.tensor(gt), torch.tensor(mask))
        want_err = tl.mse_error(pred, torch.tensor(gt), V, torch.tensor(mask))
    np.testing.assert_allclose(loss["loss"].detach().numpy(), want["loss"].numpy(), rtol=1e-5)
    np.testing.assert_allclose(err.detach().numpy(), want_err.numpy(), rtol=1e-5)
