"""FaceFormer with the wav2vec2-Conformer speech encoder (relative
positions) in the port, against HF's ``Wav2Vec2ConformerModel`` and the
benchmark's plain f32 reference
(``benchmark/reference/faceformer_conformer.py``), on the CPU at small
widths (the configuration's own file at its published widths is for the
card):

- the reference's encoder and the port's (through ``convert_faceformer``)
  against a tiny ``Wav2Vec2ConformerModel`` (relative positions, a
  LayerNorm after each conv with its bias, swish, depthwise kernel 31) on
  one unpadded clip of 300 latents;
- ``mha_reference`` (and ``flash_attention`` on CPU tensors) with
  Transformer-XL's term against HF's ``_apply_relative_embeddings``
  attention, u and v folded as the port folds them;
- the predictor on a padded batch of unequal clips against the reference,
  each clip its answer alone; without the zeroing before the depthwise
  conv it misses; the reference with ``W_pos`` or the depthwise kernels
  zeroed misses by far;
- K2's layer-norm mode with the conv bias (plain version and statistics),
  the spans and counters, and what refuses the encoder.

The last tests need the card (skipped without CUDA): K1's Transformer-XL
forward against ``mha_reference``, K2's layer-norm mode with the bias
against its plain version, an 8 x 60 s group's peak memory and the counters
there (``python3 -m pytest --noconftest tests/test_torch_conformer.py -q``
on the card: this file imports no JAX).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer
from audio2face_tpu_torch.compat.torch_export import export_faceformer
from audio2face_tpu_torch.compat.wav2vec2_convert import export_wav2vec2, strip_prefix
from audio2face_tpu_torch.models import conformer as cf
from audio2face_tpu_torch.models import wav2vec2 as w2v
from audio2face_tpu_torch.ops import attention as attn
from audio2face_tpu_torch.ops import conv_encoder as ce
from audio2face_tpu_torch.utils import spans
from benchmark.drivers.common import audio_bank
from benchmark.reference import faceformer as ff
from benchmark.reference import faceformer_conformer as ref
from benchmark.run import load_module

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
N_VERTS = 90
# f32 against f32: rounding only, relative to the clip's motion (bf16
# products read 1e-3 and more)
TOL = 1e-4
# the predictor's request, 1 s buckets, groups of 4: 0.44 s, 1.003 s, 1.51 s
LENGTHS = [7000, 16050, 24200]
# a Conformer at small widths: 2 blocks of 2 heads of 64 (K1's head size),
# the published conv kernels and strides, depthwise kernel 31
TINY = dict(conv_dim=[32] * 7, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256)
CONFIG = load_module(BENCH / "configs" / "faceformer_conformer_relpos_large.py",
                     "test_conformer_config")
VOCASET = load_module(BENCH / "configs" / "faceformer_vocaset.py", "test_conformer_vocaset")


def config(**changes) -> dict:
    cfg = json.loads((BENCH / "configs" / "faceformer_conformer_relpos_large.json").read_text())
    cfg.update(vertice_dim=N_VERTS, compute_dtype="float32",
               predictor={"max_batch": 4, "bucket_seconds": 1.0}, **changes)
    cfg["conformer"] = {**cfg["conformer"], **TINY}
    return cfg


def inputs(cfg: dict, lengths: list, seed: int = 3):
    bank = audio_bank(seed, 8.0, cfg["sample_rate"])
    audios = [bank[1000 * i: 1000 * i + n] for i, n in enumerate(lengths)]
    one_hot = np.eye(cfg["n_styles"], dtype=np.float32)[
        [(5 * i + 3) % cfg["n_styles"] for i in range(len(lengths))]]
    template = (0.05 * np.random.default_rng(seed).standard_normal((N_VERTS // 3, 3))
                ).astype(np.float32)
    return audios, one_hot, template


def rel_gap(got, want: torch.Tensor, template: np.ndarray) -> float:
    want = want.numpy()
    motion = np.sqrt(np.square(np.linalg.norm(want - template[None], axis=-1)).mean())
    return float(np.linalg.norm(np.asarray(got) - want, axis=-1).max() / motion)


@pytest.fixture(scope="module")
def hf_conformer():
    """A tiny HF ``Wav2Vec2ConformerModel`` whose every tensor moves its
    outputs: LeCun-scale kernels (``linear_pos`` at the benchmark's gain),
    non-zero position biases and BatchNorm statistics."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.wav2vec2_conformer.modeling_wav2vec2_conformer import (
        Wav2Vec2ConformerModel)

    hf_cfg = transformers.Wav2Vec2ConformerConfig(
        **TINY, feat_extract_norm="layer", conv_bias=True, hidden_act="swish",
        position_embeddings_type="relative", conv_depthwise_kernel_size=31,
        max_source_positions=5000)
    torch.manual_seed(0)
    model = Wav2Vec2ConformerModel(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "pos_bias" in name:
                p.normal_(0.0, 0.5)
            elif p.dim() >= 2 and "pos_conv_embed" not in name:
                gain = CONFIG.POS_GAIN if "linear_pos" in name else 1.0
                p.normal_(0.0, gain / math.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.normal_(0.0, 0.05)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.exp(0.1 * torch.randn_like(b)))
    return model


# 300 latents of 50 fps; at fps 50 the adapter keeps them as they are
SAMPLES = 320 * 300 + 80


def hf_upstream(hf) -> dict:
    """FaceFormer's upstream state dict with ``hf`` as its audio encoder
    (the decoder's tensors from the vocaset configuration's weights)."""
    vcfg = json.loads((BENCH / "configs" / "faceformer_vocaset.json").read_text())
    vcfg.update(vertice_dim=N_VERTS)
    vcfg["wav2vec2"] = {**vcfg["wav2vec2"], "conv_dim": [32] * 7, "hidden_size": 128,
                        "num_hidden_layers": 1, "num_attention_heads": 2, "intermediate_size": 256,
                        "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4}
    w = VOCASET.weights(vcfg, 7, "cpu")
    upstream = {k: v for k, v in export_faceformer(w).items() if not k.startswith("audio_encoder.")}
    upstream.update({f"audio_encoder.{k}": v for k, v in hf.state_dict().items()})
    return upstream


@pytest.mark.parametrize("side", ["reference", "port"])
def test_encoder_equals_hf_conformer(hf_conformer, side):
    """The reference's encoder (on the HF weights under the port's names)
    and the port's ``Wav2Vec2Encoder`` (its config read from the weights)
    against ``Wav2Vec2ConformerModel`` on one unpadded clip of 300 latents
    (T >= 100: offsets to +-299). f32 against f32 in other orders of
    summation: 2e-5 of outputs of size ~4 (the port reads ~1e-6)."""
    hf = hf_conformer
    torch.manual_seed(1)
    x = ff.zero_mean_unit_var(0.3 * torch.randn(1, SAMPLES))
    port = convert_faceformer(hf_upstream(hf))
    with torch.no_grad():
        want = hf(x).last_hidden_state
        if side == "reference":
            got = ref.encode(port, x[0], config(fps=50))[None]
        else:
            sd = strip_prefix(port, "audio_encoder.")
            enc = w2v.Wav2Vec2Encoder(w2v.config_from_state_dict(sd)).eval()
            enc.load_state_dict(sd)
            got = enc(x)
    assert got.shape == want.shape == (1, 300, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_converter_maps_every_conformer_tensor(hf_conformer):
    """Every HF tensor but the positional conv and the BatchNorms' counters
    has its port name, and the port's encoder takes exactly those; the
    config read back is the Conformer's; export refuses it."""
    sd = hf_conformer.state_dict()
    port = convert_faceformer(hf_upstream(hf_conformer))
    enc_sd = strip_prefix(port, "audio_encoder.")
    cfg = w2v.config_from_state_dict(enc_sd)
    assert (cfg.layer_kind, cfg.num_layers, cfg.num_heads, cfg.intermediate_size,
            cfg.conv_depthwise_kernel_size, cfg.conv_bias,
            cfg.feat_extract_norm) == ("conformer", 2, 2, 256, 31, True, "layer")
    enc = w2v.Wav2Vec2Encoder(cfg)
    assert set(enc.state_dict()) == set(enc_sd)
    skipped = {k for k in sd if "pos_conv_embed" in k or k.endswith("num_batches_tracked")}
    assert len(enc_sd) == len(sd) - len(skipped)
    with pytest.raises(ValueError, match="Conformer"):
        export_wav2vec2(enc_sd)


def test_relative_attention_equals_hf():
    """``mha_reference`` and ``flash_attention`` (CPU tensors) with ``u``
    folded into q, ``r`` = linear_pos of the sinusoid and the table
    ``(v - u) . r`` against HF ``Wav2Vec2ConformerSelfAttention`` over 150
    frames (f32: 1e-5); the plain attention misses by far."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.wav2vec2_conformer.modeling_wav2vec2_conformer import (
        Wav2Vec2ConformerRelPositionalEmbedding, Wav2Vec2ConformerSelfAttention)

    hf_cfg = transformers.Wav2Vec2ConformerConfig(
        hidden_size=128, num_attention_heads=2, position_embeddings_type="relative")
    torch.manual_seed(2)
    hf = Wav2Vec2ConformerSelfAttention(hf_cfg).eval()
    port = cf.RelPositionAttention(128, 2)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            p.normal_(0.0, 0.5 if "pos_bias" in name else 128 ** -0.5)
        port.load_state_dict(hf.state_dict())
    t = 150
    x = torch.randn(1, t, 128)
    with torch.no_grad():
        want, _ = hf(x, relative_position_embeddings=Wav2Vec2ConformerRelPositionalEmbedding(
            hf_cfg)(x))
        pe = cf.relative_sinusoid(t, 128, "cpu")
        for use_kernels in (False, True):
            got = port(x, pe, None, torch.float32, use_kernels)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        r, table = port.position_terms(pe, torch.float32)
        assert r.shape == (2, 2 * t - 1, 64) and table.shape == (2, 2 * t - 1)
        q = torch.randn(1, 2, t, 64)
        plain = attn.mha_reference(q, q, q)
        full = attn.mha_reference(q, q, q, rel_pos=r, rel_pos_bias=table)
    assert (plain - full).abs().max() > 100 * 1e-5


def test_dense_term_masks_keys_and_takes_unequal_lengths():
    """The dense term at ``t_q != t_k`` with KV lengths against softmax over
    scores built entry by entry (f32: 1e-5)."""
    g = torch.Generator().manual_seed(5)
    b, h, t_q, t_k, d = 2, 2, 9, 13, 64
    q = torch.randn(b, h, t_q, d, generator=g)
    k, v = (torch.randn(b, h, t_k, d, generator=g) for _ in range(2))
    r = 12
    rel = torch.randn(h, 2 * r + 1, d, generator=g)
    table = torch.randn(h, 2 * r + 1, generator=g)
    kv = torch.tensor([13, 5])
    got = attn.mha_reference(q, k, v, kv_lengths=kv, rel_pos=rel, rel_pos_bias=table)
    s = torch.empty(b, h, t_q, t_k)
    for i in range(t_q):
        for j in range(t_k):
            m = i - j + r
            s[:, :, i, j] = ((q[:, :, i] * k[:, :, j]).sum(-1) + (q[:, :, i] * rel[:, m]).sum(-1)
                             + table[:, m])
    s = (s / 8).masked_fill(torch.arange(t_k)[None, None, None, :] >= kv[:, None, None, None],
                            -1e30)
    torch.testing.assert_close(got, s.softmax(-1) @ v, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="offsets"):
        attn.mha_reference(q, k, v, rel_pos=rel[:, 2:-2], rel_pos_bias=table[:, 2:-2])


def test_predictor_matches_the_plain_reference_clip_by_clip(monkeypatch):
    """The predictor (sort, 1 s buckets, groups of 4, padded rows) against
    the reference, every clip alone, f32; without the zeroing of padded
    frames before the depthwise conv the padded clips miss."""
    cfg = config()
    w = CONFIG.weights(cfg, 2**31 + 11, "cpu")
    audios, one_hot, template = inputs(cfg, LENGTHS)
    pred = CONFIG.predictor(cfg, w, "cpu")
    enc = pred.model.audio_encoder.config
    assert (enc.hidden_size, enc.num_layers, enc.num_heads, enc.layer_kind, enc.conv_bias,
            enc.feat_extract_norm) == (128, 2, 2, "conformer", True, "layer")
    got = pred(audios, one_hot, template)
    want = CONFIG.reference(cfg, w, audios, one_hot, [template] * len(audios), "cpu")
    for n, g_, r in zip(LENGTHS, got, want):
        assert g_.shape == tuple(r.shape) == (n * 60 // 16000, N_VERTS // 3, 3)
        assert rel_gap(g_, r, template) < TOL, n

    forward = cf.ConvModule.forward
    monkeypatch.setattr(cf.ConvModule, "forward",
                        lambda self, x, valid, dtype: forward(self, x, None, dtype))
    unmasked = pred(audios, one_hot, template)
    assert max(rel_gap(u, r, template) for u, r in zip(unmasked, want)) > 5 * TOL


@pytest.mark.parametrize("zeroed", ["self_attn.linear_pos.weight",
                                    "conv_module.depthwise_conv.weight"])
def test_reference_needs_the_position_term_and_the_conv_module(zeroed):
    """The reference with every block's ``W_pos`` (or depthwise kernel)
    zeroed misses its own answer by more than five times the predictor
    test's tolerance."""
    cfg = config()
    w = CONFIG.weights(cfg, 13, "cpu")
    audios, one_hot, template = inputs(cfg, LENGTHS[:2])
    want = CONFIG.reference(cfg, w, audios, one_hot, [template] * 2, "cpu")
    w0 = {k: (torch.zeros_like(v) if k.endswith(zeroed) else v) for k, v in w.items()}
    got = CONFIG.reference(cfg, w0, audios, one_hot, [template] * 2, "cpu")
    assert max(rel_gap(g_.numpy(), r, template) for g_, r in zip(got, want)) > 5 * TOL


def test_from_checkpoint_builds_the_conformer(tmp_path):
    """``FaceFormerPredictor.from_checkpoint`` on a checkpoint of Conformer
    FaceFormer weights builds the Conformer encoder and answers as the
    predictor built from the state dict does."""
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    cfg = config()
    w = CONFIG.weights(cfg, 21, "cpu")
    path = tmp_path / "model.ckpt"
    torch.save({"model": w}, path)
    p = cfg["predictor"]
    kw = dict(n_verts=N_VERTS, n_onehot=cfg["n_styles"], bf16=False, max_batch=p["max_batch"],
              bucket_seconds=p["bucket_seconds"], unit_scale=cfg["unit_scale"], device="cpu")
    loaded = FaceFormerPredictor.from_checkpoint(str(path), **kw)
    assert loaded.model.audio_encoder.config.conformer
    audios, one_hot, template = inputs(cfg, LENGTHS[:2])
    for a, b in zip(loaded(audios, one_hot, template),
                    FaceFormerPredictor(state_dict=w, **kw)(audios, one_hot, template)):
        np.testing.assert_array_equal(a, b)


def test_spans_and_counters():
    """``predict.encode`` opens inside ``predict.model`` once a group, and
    every block of every model call counts one ``relpos_attention_layers``
    and one ``conformer_conv_modules``."""
    cfg = config()
    pred = CONFIG.predictor(cfg, CONFIG.weights(cfg, 9, "cpu"), "cpu")
    audios, one_hot, template = inputs(cfg, [7000, 16050, 24200, 30000, 9000])
    with spans.recording() as rec:
        pred(audios, one_hot, template)
    encodes = [s for s in rec.spans if s.name == "predict.encode"]
    assert len(encodes) == 2  # groups of 4 and 1
    assert all(rec.spans[s.parent].name == "predict.model" for s in encodes)
    n = 2 * cfg["conformer"]["num_hidden_layers"]
    assert rec.counters["relpos_attention_layers"] == n
    assert rec.counters["conformer_conv_modules"] == n
    assert "gated_bias_layers" not in rec.counters


def test_harness_spans_wrap_each_conv_module():
    """The configuration's ``install_spans`` wraps the encoder in
    ``encode`` and each block's conv module in ``conv_module``."""
    cfg = config()
    pred = CONFIG.predictor(cfg, CONFIG.weights(cfg, 9, "cpu"), "cpu")
    opened = []

    def span(name, fn):
        def wrapper(*a, **k):
            opened.append(name)
            return fn(*a, **k)
        return wrapper

    CONFIG.install_spans(pred, span)
    audios, one_hot, template = inputs(cfg, [16000])
    pred(audios, one_hot, template)
    assert opened.count("encode") == 1 and opened.count("conv_module") == 2
    assert opened.count("model") == 1


def test_conv_bias_layer_norm_stack():
    """K2's plain layer-norm mode with the conv biases against the f32
    ``conv1d`` path of the same stack (bf16 products: 0.05), the statistics
    with the bias against the biased conv 0's exact channel mean and
    variance (f64), and the bias refused in the group-norm mode."""
    cfg = w2v.Wav2Vec2Config(feat_extract_norm="layer", conv_bias=True)
    fe = w2v.FeatureEncoder(cfg).eval()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for conv in fe.conv_layers:
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                              / conv.weight[0].numel() ** 0.5)
            conv.bias.copy_(0.3 * torch.randn(512, generator=g))
    assert fe._fused_ok(torch.bfloat16) and not fe._fused_ok(torch.float32)
    assert not w2v.FeatureEncoder(w2v.Wav2Vec2Config(conv_bias=True))._fused_ok(torch.bfloat16)
    x = torch.randn(2, 4000, generator=g)
    with torch.no_grad():
        got = fe(x, dtype=torch.bfloat16)
        want = fe(x)
        unbiased = ce.conv_encoder_reference(
            x, [c.weight.permute(2, 1, 0) for c in fe.conv_layers],
            [ln.weight for ln in fe.layer_norms], [ln.bias for ln in fe.layer_norms], norm="layer")
    torch.testing.assert_close(got.float(), want, rtol=0.05, atol=0.05)
    assert (unbiased.float() - want).abs().max() > 0.2

    w0 = fe.conv_layers[0].weight.reshape(512, 10).t()
    b0 = fe.conv_layers[0].bias
    st = ce.conv0_layer_norm_stats(w0, b0).double()
    assert st.shape == (77,)
    xs = torch.randn(5, 10, generator=g).double()
    y = xs @ w0.to(torch.bfloat16).double() + b0.double()
    wbar, tri, e = st[:10], st[10:65], st[65:75]
    j, k = torch.triu_indices(10, 10)
    mean = xs @ wbar + st[75]
    var = (xs[:, j] * xs[:, k] * tri).sum(-1) + xs @ e + st[76]
    torch.testing.assert_close(mean, y.mean(-1), rtol=0, atol=1e-5)
    torch.testing.assert_close(var, y.var(-1, unbiased=False), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="layer-norm mode"):
        ce.conv_encoder_reference(x, [c.weight.permute(2, 1, 0) for c in fe.conv_layers],
                                  torch.ones(512), torch.zeros(512), norm="group",
                                  conv_bias=[c.bias for c in fe.conv_layers])


def test_work_counts():
    """K1's Transformer-XL term adds one 64-wide multiply-add and one add a
    (query, key, head): (4 d + 2 d + 1) / 4 d of plain K1's operations,
    whatever the lengths; the blocks' dense products are ~48.3 M a frame
    (FFNs 33.6 M, q/k/v/out 8.4 M, pointwise 6.3 M), so a 60 s clip of the
    published model is ~6.9 TFLOP with attention and the conv stack."""
    from benchmark.counts import faceformer_conformer as counts
    from benchmark.counts import work

    frames, kv = [3600, 1200, 45], [3600, 1100, 45]
    plain, plain_bytes = work.k1_work(frames, kv, 16, 64)
    xl, xl_bytes = counts.k1_xl_work(frames, kv, 16, 64)
    assert xl / plain == pytest.approx((6 * 64 + 1) / (4 * 64))
    assert xl_bytes - plain_bytes == 16 * sum(q + k - 1 for q, k in zip(frames, kv)) * (64 * 2 + 4)
    cfg = json.loads((BENCH / "configs" / "faceformer_conformer_relpos_large.json").read_text())
    enc = cfg["conformer"]
    h, f = enc["hidden_size"], enc["intermediate_size"]
    assert 8 * h * f + 8 * h * h + 6 * h * h == pytest.approx(48.3e6, rel=2e-3)
    assert 6.5e12 < CONFIG.flops(cfg, 60 * 16000) < 7.5e12
    got = CONFIG.kernel_work(cfg, [60 * 16000, 16000 * 3 + 17])["k1_xl"]
    want = counts.k1_xl_work([3600, 180], [3600, 180], 16, 64)
    assert got[:2] == (24 * want[0], 24 * want[1])


def test_conformer_is_refused_where_it_does_not_serve():
    """Training, the sequence-parallel split, the live paths, autograd, the
    backward, dropout, an f32 kernel launch and a gated bias beside the term
    refuse it; the base and WavLM configs are as before."""
    from audio2face_tpu_torch.streaming import load_live_faceformer

    assert not w2v.Wav2Vec2Config().conformer
    with pytest.raises(ValueError, match="layer_kind"):
        w2v.Wav2Vec2Config(layer_kind="rnn")
    with pytest.raises(ValueError, match="own norms"):
        w2v.Wav2Vec2Config(layer_kind="conformer", do_stable_layer_norm=True)
    cfg = config()
    w = CONFIG.weights(cfg, 5, "cpu")
    with pytest.raises(ValueError, match="wav2vec2-base"):
        load_live_faceformer(None, w, N_VERTS, cfg["n_styles"], None, 0, torch.device("cpu"))
    sd = strip_prefix(w, "audio_encoder.")
    enc = w2v.Wav2Vec2Encoder(w2v.config_from_state_dict(sd))
    enc.load_state_dict(sd)
    x = torch.zeros(1, 16000)
    with pytest.raises(ValueError, match="serves only"):
        enc(x, pre_layers_only=True)
    with pytest.raises(ValueError, match="serves only"):
        enc(x, train=True, generator=torch.Generator())
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 64, generator=g, requires_grad=True) for _ in range(3))
    rel, table = torch.zeros(2, 15, 64), torch.zeros(2, 15)
    with pytest.raises(ValueError, match="no backward"):
        attn.flash_attention(q, k, v, rel_pos=rel, rel_pos_bias=table)
    with pytest.raises(ValueError, match="no backward"):
        attn.flash_attention_bwd(q, k, v, q, table, q, rel_pos=rel, rel_pos_bias=table)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    with pytest.raises(ValueError, match="dropout"):
        attn.flash_attention(qd, kd, vd, rel_pos=rel, rel_pos_bias=table, dropout_rate=0.1,
                             dropout_seed=3)
    with pytest.raises(ValueError, match="gated bias"):
        attn.flash_attention(qd, kd, vd, rel_pos=rel, rel_pos_bias=table,
                             rel_table=torch.zeros(2, 11), rel_gate=torch.ones(1, 2, 8))
    with pytest.raises(ValueError, match="go together"):
        attn.flash_attention(qd, kd, vd, rel_pos=rel)
    with pytest.raises(ValueError, match="bf16"):  # an f32 launch
        attn._flash_attention_xl_cuda(qd, kd, vd, None, 0.125, rel, table)


# ---------------------------------------------------------------- card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("t", [200, 900, 3600])
def test_xl_kernel_matches_the_plain_version(cuda, t):
    """K1's bf16 forward with Transformer-XL's term against
    ``mha_reference`` on the same bf16 inputs, at (2, 16, T, 64) with key
    lengths below T. Both round P and the outputs to bf16; the kernel also
    stages ``q' . r + c`` in f16 (2^-11 of terms of ~40 before the 1/8
    scale), so an output may miss by 2^-7 of sum_j p_j |v_j| and of its
    value; the log-sum-exps by 1e-2; the launch without the term misses."""
    g = torch.Generator(device=cuda).manual_seed(t)
    b, h, d = 2, 16, 64
    q, k, v = (torch.randn(b, h, t, d, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    rel = torch.randn(h, 2 * t - 1, d, generator=g, device=cuda).to(torch.bfloat16)
    table = 8.0 * torch.randn(h, 2 * t - 1, generator=g, device=cuda)
    kv = torch.tensor([t - 7, t // 2 + 3], device=cuda)
    before = attn.flash_attention.xl_launches
    with torch.no_grad():
        out, lse = attn.flash_attention(q, k, v, kv_lengths=kv, rel_pos=rel, rel_pos_bias=table,
                                        return_lse=True)
        f = torch.float32
        want, want_lse = attn.mha_reference(q.to(f), k.to(f), v.to(f), kv_lengths=kv,
                                            rel_pos=rel.to(f), rel_pos_bias=table,
                                            return_lse=True)
        plain = attn.flash_attention(q, k, v, kv_lengths=kv)
        mass = attn.mha_reference(q.to(f), k.to(f), v.abs().to(f), kv_lengths=kv,
                                  rel_pos=rel.to(f), rel_pos_bias=table)
    torch.cuda.synchronize()
    assert attn.flash_attention.xl_launches == before + 1
    allowed = 2.0 ** -7 * (want.abs() + mass)
    over = ((out.float() - want).abs() - allowed).max().item()
    assert over <= 1e-4, over
    assert (lse - want_lse).abs().max().item() <= 1e-2
    assert (plain.float() - want).abs().max().item() > 0.1


@pytest.mark.parametrize("batch,seconds", [(1, 60.0), (8, 10.0)])
def test_biased_layer_norm_conv_stack_matches_the_plain_version(cuda, batch, seconds):
    """K2 in its layer-norm mode with the conv biases against
    ``conv_encoder_reference`` in the same mode (mixed lengths at batch 8),
    at K2's bar, 0.05 x max|ref|; without the biases it misses."""
    fe = w2v.FeatureEncoder(w2v.Wav2Vec2Config(feat_extract_norm="layer", conv_bias=True))
    fe = fe.to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(batch)
    with torch.no_grad():
        for conv in fe.conv_layers:
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, device=cuda)
                              / conv.weight[0].numel() ** 0.5)
            conv.bias.copy_(0.3 * torch.randn(512, generator=g, device=cuda))
        for ln in fe.layer_norms:
            ln.weight.copy_(1.0 + 0.1 * torch.randn(512, generator=g, device=cuda))
            ln.bias.copy_(0.05 * torch.randn(512, generator=g, device=cuda))
    n = int(seconds * 16000)
    x = 0.1 * torch.randn(batch, n, generator=g, device=cuda)
    lengths = torch.tensor([n - 16000 * (i % 4) for i in range(batch)], device=cuda)
    kernels = [conv.weight.permute(2, 1, 0) for conv in fe.conv_layers]
    scale = [ln.weight for ln in fe.layer_norms]
    bias = [ln.bias for ln in fe.layer_norms]
    cb = [conv.bias for conv in fe.conv_layers]
    before = ce.fused_conv_encoder.layer_norm_launches
    with torch.no_grad():
        out = ce.fused_conv_encoder(x, kernels, scale, bias, lengths, norm="layer", conv_bias=cb)
        want = ce.conv_encoder_reference(x, kernels, scale, bias, lengths, norm="layer",
                                         conv_bias=cb)
        unbiased = ce.fused_conv_encoder(x, kernels, scale, bias, lengths, norm="layer")
    torch.cuda.synchronize()
    assert ce.fused_conv_encoder.layer_norm_launches == before + 2
    assert out.shape == want.shape == (batch, ce.stack_output_length(n), 512)
    assert bool(torch.isfinite(out.float()).all())
    bar = 0.05 * want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() < bar
    assert (unbiased.float() - want.float()).abs().max().item() > bar


def test_long_group_holds_no_dense_term(cuda):
    """An 8 x 60 s group through the Conformer encoder at its published
    widths (bf16): its peak memory above the weights stays below what one
    materialised (8, 16, 3600, 7199) bf16 term would add (6.6 GB);
    ``predict.encode``, ``relpos_attention_layers`` (24),
    ``conformer_conv_modules`` (24) and ``conv_layer_norms_fused`` (7) are
    recorded."""
    from audio2face_tpu_torch.models.faceformer import FaceFormer

    cfg = json.loads((BENCH / "configs" / "faceformer_conformer_relpos_large.json").read_text())
    w = CONFIG.weights(cfg, 1, cuda)
    model = FaceFormer(cfg["vertice_dim"], cfg["n_styles"], dtype=torch.bfloat16,
                       encoder_config=w2v.config_from_state_dict(w, "audio_encoder."))
    model.load_state_dict(w)
    model = model.eval().to(cuda)
    del w
    audio = 0.1 * torch.randn(8, 60 * 16000, device=cuda)
    lengths = torch.full((8,), 60 * 16000, device=cuda)
    one_hot = torch.eye(cfg["n_styles"], device=cuda)[:8]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode(), spans.recording() as rec:
        model(audio, one_hot, None, lengths, return_hidden=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert rec.counters["relpos_attention_layers"] == 24
    assert rec.counters["conformer_conv_modules"] == 24
    assert rec.counters["conv_layer_norms_fused"] == 7
    assert [s.name for s in rec.spans] == ["predict.encode", "predict.decode"]
    assert peak < 8 * 16 * 3600 * 7199 * 2, peak
