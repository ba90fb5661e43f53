"""The attention kernels' C interface and what the wrappers hand it, on the
CPU: each ``extern "C"`` entry point in ``csrc/`` against the ctypes argument
types its wrapper binds, the device-cached ALiBi slopes, the 16-byte aligned
layout of the kernels' inputs, and the plain version of the backward's
``delta = rowsum(dO * O)`` against the JAX package's expression."""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu_torch.ops import attention as attn

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

CSRC = Path(attn.__file__).resolve().parent.parent / "csrc"


def c_parameters(source: str, symbol: str) -> list[str]:
    """The parameter declarations of ``extern "C" int symbol(...)`` in ``source``."""
    text = (CSRC / source).read_text()
    m = re.search(r'extern\s+"C"\s+int\s+' + symbol + r"\s*\(([^)]*)\)", text)
    assert m is not None, f"{symbol} not declared in {source}"
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def kind_of_c(param: str) -> str:
    if "*" in param:
        return "pointer"
    words = param.split()[:-1]  # drop the parameter's name
    if words == ["unsigned", "int"]:
        return "unsigned"
    if words == ["float"]:
        return "float"
    if words == ["int"]:
        return "int"
    raise AssertionError(f"unexpected C parameter {param!r}")


def kind_of_ctypes(t) -> str:
    return {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_uint: "unsigned",
            ctypes.c_float: "float"}[t]


@pytest.mark.parametrize("source, symbol, argtypes", [
    ("flash_attention.cu", "a2f_flash_attention_fwd", attn._FWD_ARGTYPES),
    ("flash_attention.cu", "a2f_flash_attention_fwd_relpos", attn._RELPOS_ARGTYPES),
    ("flash_attention_xl.cu", "a2f_flash_attention_fwd_xl", attn._XL_ARGTYPES),
    ("flash_attention_xl.cu", "a2f_flash_attention_fwd_xl_occupancy", [attn.ctypes.c_void_p]),
    ("flash_attention_bwd.cu", "a2f_flash_attention_bwd", attn._BWD_ARGTYPES),
    ("flash_attention.cu", "a2f_flash_attention_fwd_occupancy", attn._OCCUPANCY_ARGTYPES),
    ("flash_attention_bwd.cu", "a2f_flash_attention_bwd_occupancy", attn._OCCUPANCY_ARGTYPES),
    ("flash_attention.cu", "a2f_flash_attention_fwd_f32_plan", attn._F32_PLAN_ARGTYPES),
    ("flash_attention_bwd.cu", "a2f_flash_attention_bwd_f32_occupancy", attn._OCCUPANCY_ARGTYPES),
])
def test_entry_point_matches_ctypes_binding(source, symbol, argtypes):
    params = c_parameters(source, symbol)
    assert [kind_of_c(p) for p in params] == [kind_of_ctypes(t) for t in argtypes], params


def test_backward_entry_point_takes_out_and_writes_delta():
    """The dq kernel computes delta from O and dO: the entry point takes the
    forward's output and a writable delta, and no longer a computed one."""
    names = [p.split()[-1].lstrip("*") for p in c_parameters("flash_attention_bwd.cu",
                                                             "a2f_flash_attention_bwd")]
    assert names[:10] == ["q", "k", "v", "out", "dout", "lse", "delta", "dq", "dk", "dv"]
    params = c_parameters("flash_attention_bwd.cu", "a2f_flash_attention_bwd")
    assert params[6].startswith("float*") and "const" not in params[6]


@pytest.mark.parametrize("heads", [12, 4, 6])
def test_device_slopes_are_cached_and_equal_alibi_slopes(heads):
    first = attn.device_alibi_slopes(heads, torch.device("cpu"))
    second = attn.device_alibi_slopes(heads, "cpu")
    assert first is second
    assert first.dtype == torch.float32
    np.testing.assert_array_equal(first.numpy(), attn.alibi_slopes(heads))


def test_kernel_side_inputs_reuse_the_cached_slopes():
    q = torch.zeros(2, 12, 8, 16)
    first = attn._kernel_side_inputs(q, 8, None, 0.0, None)[1]
    second = attn._kernel_side_inputs(q, 8, torch.tensor([3, 8]), 0.1, 7)[1]
    assert first is second is attn.device_alibi_slopes(12, q.device)


def test_kernel_layout_aligns_a_contiguous_view():
    base = torch.arange(2 * 1 * 5 * 16 + 3, dtype=torch.bfloat16)
    view = base[3:].reshape(2, 1, 5, 16)  # contiguous, 6 bytes past an aligned start
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    fixed = attn._kernel_layout(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    aligned = torch.zeros(2, 1, 5, 16, dtype=torch.bfloat16)
    assert attn._kernel_layout(aligned) is aligned


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_reference_equals_jax_expression(dtype):
    """audio2face_tpu/ops/attention.py: delta = jnp.sum(g.astype(f32) * out.astype(f32), -1)."""
    rng = np.random.default_rng(3)
    out = torch.tensor(rng.normal(size=(2, 3, 37, 64)), dtype=torch.float32).to(dtype)
    g = torch.tensor(rng.normal(size=(2, 3, 37, 64)), dtype=torch.float32).to(dtype)
    ref = jnp.sum(jnp.asarray(g.float().numpy()).astype(jnp.float32)
                  * jnp.asarray(out.float().numpy()).astype(jnp.float32), axis=-1)
    got = attn.attention_delta_reference(out, g)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
