"""FaceFormer at its published BIWI widths (decoder 128 wide, 4 heads of 32,
FFN 256, 25 fps, period 25) in the port, against the benchmark's plain f32
reference (``benchmark/reference/faceformer_biwi.py``) on the CPU at small
vertex counts, with the full wav2vec2-base encoder:

- the predictor's plain decode loop and the differentiable step loop, BIWI
  at width 128, and BIWI and vocaset at width 64;
- ``convert_faceformer`` on an upstream-named BIWI checkpoint 128 wide;
- the decoder's span and counters;
- the live paths' refusal of another width than 64;
- the CLI config's ``feature_dim`` reaching the trainer's model.

The last test needs the card (skipped without CUDA): K3 at width 128
against its plain loop, launched, and the predictor's counters there
(``python3 -m pytest --noconftest tests/test_torch_biwi_widths.py -q`` on
the card: this file imports no JAX).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer
from audio2face_tpu_torch.compat.torch_export import export_faceformer
from audio2face_tpu_torch.models import faceformer as ff
from audio2face_tpu_torch.models.decoder_step import decoder_step_params
from audio2face_tpu_torch.ops import decode_kernel as dk
from audio2face_tpu_torch.streaming import load_live_faceformer
from audio2face_tpu_torch.utils import spans
from benchmark.drivers.common import audio_bank
from benchmark.run import load_module

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
N_VERTS = 90
# f32 against f32: rounding only, relative to the clip's motion (the port
# reads 1.5e-6 here; bf16 products or a bf16 sum in the decode read 1e-3
# and more)
TOL = 1e-4
# clips of the predictor's request, 1 s buckets: 0.44 s; 1.003 s (latents
# one short of 2T: a padded row is read); 1.031 s (one latent past 2T);
# 1.513 s; and 2 s, alone in its group and filling its bucket (the batch's
# own even trim)
LENGTHS = [7000, 16050, 16500, 24200, 32000]


def config(name: str, **changes) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(vertice_dim=N_VERTS, compute_dtype="float32",
               predictor={"max_batch": 4, "bucket_seconds": 1.0}, **changes)
    return cfg


def config_module(name: str):
    return load_module(BENCH / "configs" / f"{name}.py", f"test_widths_{name}")


def inputs(cfg: dict, lengths: list, seed: int = 3):
    bank = audio_bank(seed, 8.0, cfg["sample_rate"])
    audios = [bank[1000 * i: 1000 * i + n] for i, n in enumerate(lengths)]
    one_hot = np.eye(cfg["n_styles"], dtype=np.float32)[
        [(5 * i + 3) % cfg["n_styles"] for i in range(len(lengths))]]
    template = (0.05 * np.random.default_rng(seed).standard_normal((N_VERTS // 3, 3))
                ).astype(np.float32)
    return audios, one_hot, template


def rel_gap(got: np.ndarray, want: torch.Tensor, template: np.ndarray) -> float:
    want = want.numpy()
    motion = np.sqrt(np.square(np.linalg.norm(want - template[None], axis=-1)).mean())
    return float(np.linalg.norm(got - want, axis=-1).max() / motion)


def biwi_config(width: int) -> dict:
    return config("faceformer_biwi", feature_dim=width, dim_feedforward=2 * width)


@pytest.mark.parametrize("name, width, impl", [
    ("faceformer_biwi", 128, "loop"), ("faceformer_biwi", 128, "steps"),
    ("faceformer_biwi", 64, "loop"), ("faceformer_vocaset", 64, "loop")])
def test_port_matches_the_plain_reference(name, width, impl):
    """The predictor (sort, 1 s buckets, groups of 4) against the reference,
    every clip; ``steps`` decodes with the differentiable step loop."""
    cfg = biwi_config(width) if name == "faceformer_biwi" else config(name)
    mod = config_module(name)
    w = mod.weights(cfg, 2**31 + 11, "cpu")
    lengths = LENGTHS if name == "faceformer_biwi" else LENGTHS[:3]
    audios, one_hot, template = inputs(cfg, lengths)
    pred = mod.predictor(cfg, w, "cpu")
    assert pred.model.feature_dim == width
    if impl == "steps":
        decode = pred.model.decode
        pred.model.decode = lambda memory, oh, **kw: decode(memory, oh, impl="steps")
    got = pred(audios, one_hot, template)
    want = mod.reference(cfg, w, audios, one_hot, [template] * len(audios), "cpu")
    for n, g, r in zip(lengths, got, want):
        assert g.shape == tuple(r.shape) == (n * cfg["fps"] // 16000, N_VERTS // 3, 3)
        assert rel_gap(g, r, template) < TOL, n


def test_step_loop_gradients_at_width_128():
    """The differentiable step loop at width 128 (train mode: masks and
    checkpointed chunks) gives finite gradients to every decoder weight, and
    in eval mode decodes what the plain loop does."""
    model = ff.FaceFormer(N_VERTS, 6, dataset="biwi", period=25, feature_dim=128)
    g = torch.Generator().manual_seed(1)
    model.init_parameters(g)
    with torch.no_grad():
        for lin in (model.vertice_map, model.vertice_map_r):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    b, t = 2, 30
    hidden = torch.randn(b, 2 * t, 768, generator=g)
    audio = torch.zeros(b, t * 640)
    one_hot = torch.eye(6)[[1, 4]]
    template = torch.randn(b, N_VERTS // 3, 3, generator=g)
    model.eval()
    with torch.no_grad():
        plain = model(audio, one_hot, template, encoder_hidden=hidden, use_kernels=False)
    steps = model(audio, one_hot, template, encoder_hidden=hidden, differentiable=True)
    torch.testing.assert_close(steps, plain, rtol=0, atol=1e-5)
    model.train()
    out = model(audio, one_hot, template, encoder_hidden=hidden, train=True,
                generator=torch.Generator().manual_seed(2))
    out.square().mean().backward()
    for name in ("dec_q", "dec_out", "cross_q", "cross_k", "linear1", "linear2", "vertice_map"):
        grad = getattr(model, name).weight.grad
        assert grad is not None and bool(torch.isfinite(grad).all()) and grad.abs().sum() > 0, name


def test_converter_takes_the_checkpoints_width():
    """An upstream-named BIWI checkpoint 128 wide (q | k | v packed in one
    (384, 128) ``in_proj``) converts to the port's weights, split at 128,
    and serves what the reference computes."""
    cfg = biwi_config(128)
    mod = config_module("faceformer_biwi")
    w = mod.weights(cfg, 5, "cpu")
    upstream = export_faceformer(w)
    layer = "transformer_decoder.layers.0"
    assert upstream[f"{layer}.self_attn.in_proj_weight"].shape == (384, 128)
    assert upstream[f"{layer}.multihead_attn.in_proj_weight"].shape == (384, 128)
    port = convert_faceformer(upstream, dataset="biwi")
    assert set(port) == set(w)
    for name, want in w.items():
        if name.startswith("audio_encoder."):  # the positional conv goes through weight norm
            torch.testing.assert_close(port[name], want, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(port[name], want), name
    packed = torch.as_tensor(upstream[f"{layer}.self_attn.in_proj_weight"])
    assert torch.equal(port["dec_k.weight"], packed[128:256])
    audios, one_hot, template = inputs(cfg, [12345])
    got = mod.predictor(cfg, port, "cpu")(audios, one_hot, template)
    want = mod.reference(cfg, w, audios, one_hot, [template], "cpu")
    assert rel_gap(got[0], want[0], template) < TOL


def test_decode_span_and_counters_at_width_128():
    """``predict.decode`` opens inside ``predict.model`` once a group, and
    ``decode_steps`` counts every row of the batch grid at the bucket's
    frames; the plain loop spills no cache row."""
    cfg = biwi_config(128)
    mod = config_module("faceformer_biwi")
    pred = mod.predictor(cfg, mod.weights(cfg, 9, "cpu"), "cpu")
    audios, one_hot, template = inputs(cfg, [7000, 16050, 24200])
    with spans.recording() as rec:
        pred(audios, one_hot, template)
    decodes = [s for s in rec.spans if s.name == "predict.decode"]
    assert len(decodes) == 1  # one group of 3 clips, padded to a batch of 4
    assert rec.spans[decodes[0].parent].name == "predict.model"
    # the bucket: 24,200 samples round up to 2 s, 50 frames at 25 fps
    assert rec.counters["decode_steps"] == 4 * 50 == rec.counters["frames_computed"]
    assert rec.counters["decode_rows_spilled"] == 0


def test_select_decode_impl_runs_the_kernel_at_width_128(monkeypatch):
    assert dk.smem_bytes(True, 128) <= dk.SM90_SMEM_PER_BLOCK
    monkeypatch.setattr(dk, "smem_fits", lambda device, biwi=False, width=64: True)
    cuda = torch.device("cuda")
    assert ff.select_decode_impl(cuda, "biwi", feature_dim=128) == "fused"
    assert ff.select_decode_impl(cuda, "vocaset", feature_dim=128) == "fused"
    with pytest.raises(ValueError, match="96"):
        ff.select_decode_impl(cuda, "biwi", feature_dim=96)
    assert ff.select_decode_impl(torch.device("cpu"), "biwi", feature_dim=96) == "loop"


def test_live_paths_refuse_another_width():
    from audio2face_tpu_torch.multistream import MultiStreamFaceFormerPredictor
    from audio2face_tpu_torch.streaming import StreamingFaceFormerPredictor

    model = ff.FaceFormer(N_VERTS, 12, feature_dim=128)
    model.init_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    with pytest.raises(ValueError, match="128 wide"):
        decoder_step_params(model)
    with pytest.raises(ValueError, match="128 wide"):
        load_live_faceformer(None, sd, N_VERTS, 12, None, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="128 wide"):
        StreamingFaceFormerPredictor(n_verts=N_VERTS, state_dict=sd, device="cpu")
    with pytest.raises(ValueError, match="128 wide"):
        MultiStreamFaceFormerPredictor(n_verts=N_VERTS, state_dict=sd, device="cpu")


def test_config_feature_dim_reaches_the_trainers_model(tmp_path):
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    cfg = ExpConfig.from_dict(dict(
        batch_size=1, modelname="faceformer", one_hot_size=6, feature_extractor=None,
        sample_rate=16000, vertex_count=N_VERTS, split_frame=False, n_feature=32, out_dim=52,
        win_length=440, percision="32", dataset="biwi", feature_dim=128))
    assert cfg.feature_dim == 128
    exp = Audio2FaceExperiment(cfg, log_dir=str(tmp_path / "run"), device="cpu")
    assert exp.model.feature_dim == 128 and tuple(exp.model.ppe.shape) == (25, 128)
    assert exp.model.linear1.out_features == 256
    assert ExpConfig.from_dict(dict(cfg.__dict__, feature_dim=64)).feature_dim == 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("biwi", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_width_128_matches_its_plain_loop(cuda, biwi, dtype):
    """K3 launched at width 128 against the plain loop in f32 on the same
    inputs: f32 outputs to 2e-4 (a bf16 sum in the kernel misses it), bf16
    outputs within one bf16 step more; a shape past the cluster's shared
    memory (rows spilled to device memory) and a batch past 8."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device=cuda, dtype=dtype)

    d = 128
    w = {}
    for name, shape in [("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)),
                        ("cq", (d, d)), ("co", (d, d)), ("f1", (d, 2 * d)), ("f2", (2 * d, d)),
                        ("fb", (d, d))]:
        w[f"{name}_kernel"] = randn(*shape, scale=(0.4 if name == "fb" else 1.0) / d ** 0.5)
        w[f"{name}_bias"] = randn(shape[1], scale=0.1)
    for i in (1, 2, 3):
        w[f"ln{i}_scale"] = 1 + randn(d, scale=0.1).float()
        w[f"ln{i}_bias"] = randn(d, scale=0.1).float()
    period = 25 if biwi else 60
    for b, t in ((3, 300), (8, 1500), (10, 90)):
        pe = torch.as_tensor(ff.periodic_positional_encoding(period, d), device=cuda).to(dtype)
        style = randn(b, d, scale=0.5)
        kw = {}
        cross = None
        if biwi:
            kw = dict(mem_k=randn(b, 4, 2 * t, d // 4, scale=0.5),
                      mem_v=randn(b, 4, 2 * t, d // 4, scale=0.5))
        else:
            cross = randn(b, t, d, scale=0.5)
        before = dk.faceformer_decode_loop.biwi_launches + dk.faceformer_decode_loop.launches
        with torch.no_grad(), spans.recording() as rec:
            out = dk.faceformer_decode_loop(cross, style, pe, w, period=period, **kw)
            ref = dk.decode_loop_reference(cross, style, pe, w, period=period, **kw)
        assert dk.faceformer_decode_loop.biwi_launches + dk.faceformer_decode_loop.launches == before + 1
        plan = dk.kernel_cluster_plan(b, t, cuda, biwi, dtype == torch.bfloat16, d)
        assert rec.counters["decode_rows_spilled"] == b * (t - plan["rows_resident"])
        step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
        over = ((out.float() - ref.float()).abs() - step * ref.float().abs()).max().item()
        assert out.shape == (b, t, d) and bool(torch.isfinite(out.float()).all())
        assert over <= 2e-4, (b, t, over)
