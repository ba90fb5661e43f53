"""The decode loop's and the conv encoder's C interface and what their
wrappers hand it, on the CPU: each ``extern "C"`` entry point of
``csrc/decode_loop.cu``, ``csrc/conv_encoder.cu``, ``csrc/conv_encoder_ln.cu``
and ``csrc/frame_epilogue.cu`` against the ctypes argument types its wrapper
binds; the decode weights' packing (bf16 storage is the f32 packing of the
same bf16 weights, in the order of the C layout constants); the Python mirror of K3's shared-memory plan (cache rows a CTA,
the capacity boundary, bytes a CTA) against the C constants; and the decode
loops' use of the device-cached ALiBi slopes."""

import re

import numpy as np
import pytest
import torch

from audio2face_tpu_torch.ops import attention as attn
from audio2face_tpu_torch.ops import conv_encoder as ce
from audio2face_tpu_torch.ops import decode_kernel as dk
from audio2face_tpu_torch.ops import frame_epilogue as fe
from tests.test_torch_attention_abi import CSRC, c_parameters, kind_of_c, kind_of_ctypes

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)


def _evaluate(bodies, values: dict) -> dict:
    for body in bodies:
        for item in body.split(","):
            name, expr = (s.strip() for s in item.split("=", 1))
            values[name] = int(eval(expr, {}, dict(values)))  # noqa: S307 (C integer arithmetic)
    return values


def c_constants(source: str, width: int = 64) -> dict:
    """The namespace-level ``constexpr int`` constants of ``source`` (lines
    that start with them), evaluated in order, then the ``static constexpr
    int`` members of its ``struct Layout`` at ``D = width``."""
    text = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
    values = _evaluate(re.findall(r"^constexpr int (\w+\s*=[^;]+);", text, flags=re.M), {})
    struct = re.search(r"^struct Layout \{(.*?)^\};", text, flags=re.M | re.S)
    if struct:
        values = _evaluate(re.findall(r"^\s*static constexpr int (\w+\s*=[^;]+);",
                                      struct.group(1), flags=re.M), dict(values, D=width))
    return values


C = c_constants("decode_loop.cu")
C128 = c_constants("decode_loop.cu", 128)


@pytest.mark.parametrize("source, symbol, argtypes", [
    ("decode_loop.cu", "a2f_decode_loop", dk._ARGTYPES),
    ("decode_loop.cu", "a2f_decode_loop_biwi", dk._ARGTYPES_BIWI),
    ("decode_loop.cu", "a2f_decode_plan", dk._PLAN_ARGTYPES),
    ("decode_loop.cu", "a2f_decode_layout", dk._LAYOUT_ARGTYPES),
    ("conv_encoder.cu", "a2f_conv_encoder", ce._ARGTYPES),
    ("conv_encoder_ln.cu", "a2f_conv_encoder_ln", ce._LN_ARGTYPES),
    ("frame_epilogue.cu", "a2f_frame_epilogue", fe._ARGTYPES),
])
def test_entry_point_matches_ctypes_binding(source, symbol, argtypes):
    params = c_parameters(source, symbol)
    assert [kind_of_c(p) for p in params] == [kind_of_ctypes(t) for t in argtypes], params


@pytest.mark.parametrize("symbol, first", [
    ("a2f_decode_loop", ["cross"]), ("a2f_decode_loop_biwi", ["mem_k", "mem_v"])])
def test_decode_entry_points_take_the_wrappers_argument_order(symbol, first):
    names = [p.split()[-1].lstrip("*") for p in c_parameters("decode_loop.cu", symbol)]
    assert names == first + ["style", "pe", "weights", "ln", "slopes", "kv", "out", "batch",
                             "n_steps", "period", "width", "bf16", "cluster", "rows_cta",
                             "stream"]


@pytest.mark.parametrize("width", dk.WIDTHS)
def test_python_layout_equals_the_c_constants(width):
    c, lay = (C, dk.layout(64)) if width == 64 else (C128, dk.layout(128))
    if width == 64:
        assert (dk.N_WEIGHTS, dk.N_WEIGHTS_BIWI) == (C["N_WEIGHTS_VOCASET"], C["N_WEIGHTS_BIWI"])
        assert (dk.SCRATCH_FLOATS, dk.SCRATCH_FLOATS_BIWI) == (C["SCRATCH_VOCASET"],
                                                               C["SCRATCH_BIWI"])
        assert (dk.N_LN, dk.ROW_BYTES, dk.GATHER_FLOATS) == (C["N_LN"], C["ROW_BYTES"],
                                                             C["GATHER_FLOATS"])
    assert (lay.n_weights, lay.n_weights_biwi) == (c["N_WEIGHTS_VOCASET"], c["N_WEIGHTS_BIWI"])
    assert (lay.n_matrix, lay.n_matrix_biwi) == (c["N_MATRIX_VOCASET"], c["N_MATRIX_BIWI"])
    assert (lay.n_bias, lay.n_bias_biwi) == (c["N_BIAS_VOCASET"], c["N_BIAS_BIWI"])
    assert lay.n_matrix + lay.n_bias == lay.n_weights
    assert (lay.scratch, lay.scratch_biwi) == (c["SCRATCH_VOCASET"], c["SCRATCH_BIWI"])
    assert lay.gather == c["GATHER_FLOATS"] == 2 * c["NWARPS"] * c["PART"]
    assert (lay.n_ln, lay.row_bytes, lay.exchange) == (c["N_LN"], c["ROW_BYTES"],
                                                       c["EXCHANGE_FLOATS"])
    assert dk.MAX_CLUSTER == c["MAX_CLUSTER"]
    assert dk.N_WARPS == c["NWARPS"] == c["NTHREADS"] // 32
    # every packed matrix starts 16-byte aligned in bf16 and in f32
    for name in ("WQKV", "WO", "W1", "W2", "WFB", "WCQ", "WCO"):
        assert c[name] % 8 == 0
    # the scratch rows read as float4 and the latent rows filled by cp.async
    for name in ("S_ATTN", "S_Y0", "S_Y1", "S_PV", "S_STEP", "SCRATCH_VOCASET", "SCRATCH_BIWI"):
        assert c[name] % 4 == 0
    assert c["S_XBAR"] % 2 == 0  # the mbarriers: 8-byte aligned
    # the exchanges' 14 mbarriers, then their float4-read results
    assert c["EX_BARS"] >= 2 * 7 * 2 and c["EX_BARS"] % 4 == 0
    for name in ("X_QKV", "X_O", "X_CQ", "X_CO", "X_F1", "X_F2", "X_FB", "X_FLOATS"):
        assert c[name] % 4 == 0


def _weights(rng, biwi, dtype):
    w = {}
    names = [("q", (64, 64)), ("k", (64, 64)), ("v", (64, 64)), ("o", (64, 64)),
             ("f1", (64, 128)), ("f2", (128, 64)), ("fb", (64, 64))]
    if biwi:
        names += [("cq", (64, 64)), ("co", (64, 64))]
    for name, shape in names:
        w[f"{name}_kernel"] = torch.tensor(rng.normal(0, 0.2, shape), dtype=torch.float32).to(dtype)
        w[f"{name}_bias"] = torch.tensor(rng.normal(0, 0.1, shape[1]), dtype=torch.float32).to(dtype)
    for i in (1, 2, 3):  # layer-norm parameters stay f32, as FaceFormer.decoder_weights keeps them
        w[f"ln{i}_scale"] = torch.tensor(1 + rng.normal(0, 0.1, 64), dtype=torch.float32)
        w[f"ln{i}_bias"] = torch.tensor(rng.normal(0, 0.1, 64), dtype=torch.float32)
    return w


@pytest.mark.parametrize("biwi", [False, True])
def test_bf16_packing_upcast_equals_the_f32_packing(biwi):
    w16 = _weights(np.random.default_rng(1), biwi, torch.bfloat16)
    packed16, ln16 = dk._pack_weights(w16, "cpu", biwi)
    packed32, ln32 = dk._pack_weights({k: v.float() for k, v in w16.items()}, "cpu", biwi)
    assert packed16.dtype == torch.bfloat16 and packed32.dtype == torch.float32
    assert packed16.numel() == (C["N_WEIGHTS_BIWI"] if biwi else C["N_WEIGHTS_VOCASET"])
    assert torch.equal(packed16.float(), packed32)
    assert ln16.dtype == ln32.dtype == torch.float32 and torch.equal(ln16, ln32)


def test_mixed_dtypes_store_f32():
    w = _weights(np.random.default_rng(2), False, torch.bfloat16)
    w["o_bias"] = w["o_bias"].float()  # bf16 storage would no longer be exact
    assert dk._pack_weights(w, "cpu")[0].dtype == torch.float32


@pytest.mark.parametrize("biwi", [False, True])
def test_packing_order_matches_the_c_layout(biwi):
    w = _weights(np.random.default_rng(3), biwi, torch.float32)
    packed, ln = dk._pack_weights(w, "cpu", biwi)
    qkv = torch.cat([w["q_kernel"], w["k_kernel"], w["v_kernel"]], dim=1)
    blocks = {"WQKV": qkv.T, "BQKV": torch.cat([w["q_bias"], w["k_bias"], w["v_bias"]]),
              "WO": w["o_kernel"].T, "BO": w["o_bias"], "W1": w["f1_kernel"].T, "B1": w["f1_bias"],
              "W2": w["f2_kernel"].T, "B2": w["f2_bias"], "WFB": w["fb_kernel"].T, "BFB": w["fb_bias"]}
    if biwi:
        blocks.update({"WCQ": w["cq_kernel"].T, "BCQ": w["cq_bias"], "WCO": w["co_kernel"].T,
                       "BCO": w["co_bias"]})
    for name, want in blocks.items():
        # matrices (out, in) row-major: output n's weights are contiguous
        got = packed[C[name]: C[name] + want.numel()].reshape(want.shape)
        assert torch.equal(got, want), name
    for name in ("LN1S", "LN1B", "LN2S", "LN2B", "LN3S", "LN3B"):
        key = f"ln{name[2]}_{'scale' if name[3] == 'S' else 'bias'}"
        assert torch.equal(ln[C[name]: C[name] + 64], w[key]), name


@pytest.mark.parametrize("biwi", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_fixed_bytes_mirror_the_c_formula(biwi, bf16, cluster):
    n_w = C["N_WEIGHTS_BIWI"] if biwi else C["N_WEIGHTS_VOCASET"]
    scratch = C["SCRATCH_BIWI"] if biwi else C["SCRATCH_VOCASET"]
    want = n_w * (2 if bf16 else 4) + 4 * C["N_LN"] + 4 * (scratch + cluster * C["GATHER_FLOATS"])
    assert dk.fixed_smem_bytes(biwi, bf16, cluster) == want
    assert want % 16 == 0  # the gathered partials and the cache rows start 16-byte aligned
    assert dk.smem_bytes(biwi) == dk.fixed_smem_bytes(biwi, False, 1)
    # width 128: a CTA holds its rows' share of each matrix and every bias,
    # and the exchanges after the scratch
    c = C128
    n_w = ((c["N_MATRIX_BIWI"] if biwi else c["N_MATRIX_VOCASET"]) // cluster
           + (c["N_BIAS_BIWI"] if biwi else c["N_BIAS_VOCASET"]))
    scratch = (c["SCRATCH_BIWI"] if biwi else c["SCRATCH_VOCASET"]) + c["EXCHANGE_FLOATS"]
    want = n_w * (2 if bf16 else 4) + 4 * c["N_LN"] + 4 * (scratch + cluster * c["GATHER_FLOATS"])
    assert dk.fixed_smem_bytes(biwi, bf16, cluster, 128) == want
    assert want % 16 == 0


# rows a CTA holds at the H100's 232,448 bytes a block (cluster 16, 8, 1):
# bf16 weights leave room for 259 / 277 / 293 (vocaset) and 223 / 241 / 257
# (BIWI) rows, f32 weights for 113 / 131 / 147 and 45 / 63 / 79
@pytest.mark.parametrize("biwi, bf16, capacities", [
    (False, True, (259, 277, 293)), (True, True, (223, 241, 257)),
    (False, False, (113, 131, 147)), (True, False, (45, 63, 79))])
@pytest.mark.parametrize("cluster", [16, 8, 1])
def test_cluster_plan_capacity_boundary(biwi, bf16, capacities, cluster):
    capacity = capacities[(16, 8, 1).index(cluster)]
    at_capacity = cluster * capacity
    for n_steps in (1, 37, at_capacity - 1, at_capacity, at_capacity + 1, 3 * at_capacity // 2):
        plan = dk.cluster_plan(n_steps, cluster, biwi, bf16)
        share = -(-n_steps // cluster)
        assert plan["rows_per_cta"] == min(capacity, share)
        assert plan["rows_resident"] == min(n_steps, at_capacity)
        assert plan["capacity_rows"] == at_capacity
        assert plan["smem_bytes"] == dk.fixed_smem_bytes(biwi, bf16, cluster) + plan["rows_per_cta"] * 512
        assert plan["smem_bytes"] <= dk.SM90_SMEM_PER_BLOCK
    # one row more than a CTA holds no longer fits the block
    assert dk.fixed_smem_bytes(biwi, bf16, cluster) + (capacity + 1) * 512 > dk.SM90_SMEM_PER_BLOCK


def test_flagship_cache_is_resident_with_bf16_weights():
    """(8, 3600) bf16: every row in the cluster's shared memory at CL = 16;
    at CL = 8 a tail stays in device memory; f32 weights leave a tail."""
    assert dk.cluster_plan(3600, 16, False, True)["rows_resident"] == 3600
    assert dk.cluster_plan(3600, 8, False, True)["rows_resident"] == 8 * 277
    assert dk.cluster_plan(3600, 16, False, False)["rows_resident"] == 16 * 113
    assert dk.cluster_plan(750, 8, True, True)["rows_resident"] == 750


def test_cluster_plan_raises_where_the_weights_do_not_fit():
    with pytest.raises(RuntimeError, match=str(dk.fixed_smem_bytes(True, False, 16))):
        dk.cluster_plan(100, 16, True, False, smem_limit=100_000)


def test_decode_steps_take_the_cached_slopes(monkeypatch):
    """The plain loop (and the kernel wrapper) take the device-cached slopes:
    no host-to-device copy of the slopes per call."""
    cached = attn.device_alibi_slopes(dk.N_HEADS, torch.device("cpu"))

    def refuse(n_heads):
        raise AssertionError("alibi_slopes recomputed on the host")

    monkeypatch.setattr(attn, "alibi_slopes", refuse)
    rng = np.random.default_rng(4)
    w = _weights(rng, False, torch.float32)
    cross = torch.tensor(rng.normal(0, 0.5, (2, 5, 64)), dtype=torch.float32)
    style = torch.tensor(rng.normal(0, 0.5, (2, 64)), dtype=torch.float32)
    pe = torch.zeros(60, 64)
    out = dk.decode_steps(cross, style, pe, w)
    assert out.shape == (2, 5, 64) and bool(torch.isfinite(out).all())
    assert attn.device_alibi_slopes(dk.N_HEADS, "cpu") is cached
    assert "alibi_slopes(" not in (CSRC.parent / "ops" / "decode_kernel.py").read_text().replace(
        "device_alibi_slopes(", "")


def test_width_128_splits_its_weights_over_the_cluster():
    """Where the weights live (C ``home_of``): all of them in every CTA at
    width 64, each CTA's rows' share of every matrix at width 128, whose
    bf16 weights (363 KB) a block's 227 KB cannot hold whole."""
    text = (CSRC / "decode_loop.cu").read_text()
    assert "return d == 64 ? HOME_SMEM : HOME_SPLIT;" in text
    assert not dk.layout(64).split and dk.layout(128).split
    assert 2 * C128["N_WEIGHTS_BIWI"] > dk.SM90_SMEM_PER_BLOCK
    for cluster in (1, 2, 4, 8, 16):  # every matrix's outputs split evenly, 4 rows a warp round
        for n_out in (3 * 128, 128, 256):
            assert n_out % cluster == 0 and (n_out // cluster) % 4 == 0


# width-128 BIWI rows a CTA holds at the H100's 232,448 bytes a block, as
# the C plan gave them on the card
@pytest.mark.parametrize("bf16, cluster, capacity", [
    (True, 16, 142), (True, 8, 137), (True, 2, 18), (False, 8, 91), (False, 4, 11)])
def test_cluster_plan_capacity_at_width_128(bf16, cluster, capacity):
    at_capacity = cluster * capacity
    row = dk.layout(128).row_bytes
    assert row == 1024
    for n_steps in (1, at_capacity - 1, at_capacity, at_capacity + 1, 1500):
        plan = dk.cluster_plan(n_steps, cluster, True, bf16, width=128)
        assert plan["rows_per_cta"] == min(capacity, -(-n_steps // cluster))
        assert plan["rows_resident"] == min(n_steps, at_capacity)
        assert plan["smem_bytes"] <= dk.SM90_SMEM_PER_BLOCK
    fixed = dk.fixed_smem_bytes(True, bf16, cluster, 128)
    assert fixed + capacity * row <= dk.SM90_SMEM_PER_BLOCK < fixed + (capacity + 1) * row


def test_width_128_f32_weights_need_four_ctas():
    with pytest.raises(RuntimeError, match="shared memory"):
        dk.cluster_plan(100, 2, True, False, width=128)
    with pytest.raises(ValueError, match="widths"):
        dk.layout(96)
