"""Port decode loop (CPU -> its plain version) vs the JAX fused Pallas
decode kernel run in interpret mode with full-precision products."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models.faceformer import periodic_positional_encoding as jax_ppe
from audio2face_tpu.ops.decode_kernel import faceformer_decode_loop as jax_decode
from audio2face_tpu_torch.models.faceformer import periodic_positional_encoding
from audio2face_tpu_torch.ops.decode_kernel import faceformer_decode_loop

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)


def _rand_weights(rng):
    d, f = 64, 128
    w = {}
    for name, shape in [
        ("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)),
        ("f1", (d, f)), ("f2", (f, d)), ("fb", (d, d)),
    ]:
        w[f"{name}_kernel"] = rng.normal(0, 0.2, shape).astype(np.float32)
        w[f"{name}_bias"] = rng.normal(0, 0.1, shape[1]).astype(np.float32)
    for i in (1, 2, 3):
        w[f"ln{i}_scale"] = (1.0 + rng.normal(0, 0.1, d)).astype(np.float32)
        w[f"ln{i}_bias"] = rng.normal(0, 0.1, d).astype(np.float32)
    return w


def test_ppe_table_matches_jax():
    np.testing.assert_array_equal(periodic_positional_encoding(), jax_ppe())


# (2, 150) crosses the period-60 ALiBi buckets twice
@pytest.mark.parametrize("b,t", [(1, 30), (4, 64), (6, 37), (2, 150)])
def test_decode_loop_matches_jax_kernel(b, t):
    rng = np.random.default_rng(0)
    w = _rand_weights(rng)
    cross = rng.normal(0, 0.5, (b, t, 64)).astype(np.float32)
    style = rng.normal(0, 0.5, (b, 64)).astype(np.float32)
    pe = periodic_positional_encoding()

    ref = jax_decode(
        jnp.asarray(cross), jnp.asarray(style), jnp.asarray(pe),
        {k: jnp.asarray(v) for k, v in w.items()}, interpret=True, fast_math=False,
    )
    out = faceformer_decode_loop(
        torch.tensor(cross), torch.tensor(style), torch.tensor(pe),
        {k: torch.tensor(v) for k, v in w.items()},
    )
    assert tuple(out.shape) == (b, t, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
