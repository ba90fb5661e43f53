"""FaceFormer with the WavLM speech encoder in the port, against HF's
``WavLMModel`` and the benchmark's plain f32 reference
(``benchmark/reference/faceformer_wavlm.py``), on the CPU at small widths
(the configuration's own file at its published widths is for the card):

- the reference's encoder and the port's (through ``convert_faceformer``)
  against a tiny ``WavLMModel`` with 320 buckets and distance 800, past the
  bucket's saturation (T >= 900 latents);
- the port's Toeplitz table against HF's bucket for every offset in
  [-1000, 1000], and ``mha_reference``'s table bias against attention over
  the dense bias;
- the predictor on a padded batch of unequal clips against the reference,
  and the reference without its table, which must miss by far;
- the conv stack's path (K2's layer-norm mode in bf16, ``conv1d`` in f32
  and in training), the encoder's span and counter, and what refuses the
  encoder (training, the backward, f32 kernels, the live paths, the
  sequence-parallel split, a bias without pre-LN layers).

The last tests need the card (skipped without CUDA): K1's biased bf16
forward against ``mha_reference``, K2's layer-norm mode against its plain
version at batch 1 and 8 and its counter (7 a model call), an 8 x 60 s
group's peak memory, and the spans and counters there (``python3 -m pytest
--noconftest tests/test_torch_wavlm.py -q`` on the card: this file imports
no JAX).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer
from audio2face_tpu_torch.compat.torch_export import export_faceformer
from audio2face_tpu_torch.compat.wav2vec2_convert import export_wav2vec2, strip_prefix
from audio2face_tpu_torch.models import wav2vec2 as w2v
from audio2face_tpu_torch.ops import attention as attn
from audio2face_tpu_torch.ops import conv_encoder as ce
from audio2face_tpu_torch.utils import spans
from benchmark.drivers.common import audio_bank
from benchmark.reference import faceformer_wavlm as ref
from benchmark.run import load_module

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
N_VERTS = 90
# f32 against f32: rounding only, relative to the clip's motion (bf16
# products read 1e-3 and more)
TOL = 1e-4
# the predictor's request, 1 s buckets, groups of 4: 0.44 s, 1.003 s, 1.51 s
LENGTHS = [7000, 16050, 24200]
# a WavLM at small widths: 2 pre-LN layers of 2 heads of 64 (K1's head
# size), the published conv kernels, strides and buckets
TINY = dict(conv_dim=[32] * 7, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def config(**changes) -> dict:
    cfg = json.loads((BENCH / "configs" / "faceformer_wavlm_large.json").read_text())
    cfg.update(vertice_dim=N_VERTS, compute_dtype="float32",
               predictor={"max_batch": 4, "bucket_seconds": 1.0}, **changes)
    cfg["wavlm"] = {**cfg["wavlm"], **TINY}
    return cfg


CONFIG = load_module(BENCH / "configs" / "faceformer_wavlm_large.py", "test_wavlm_config")


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


def make_hf_wavlm(large: bool = True):
    """A tiny HF ``WavLMModel`` with a table and gate constants that move its
    outputs: Large's layout (layer-norm convs, pre-LN layers), or with
    ``large=False`` Base's (a group norm after conv 0, post-LN layers),
    which the port refuses."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.wavlm.modeling_wavlm import WavLMModel

    hf_cfg = transformers.WavLMConfig(
        **TINY, feat_extract_norm="layer" if large else "group", do_stable_layer_norm=large,
        conv_bias=False, num_buckets=320, max_bucket_distance=800)
    torch.manual_seed(0)
    model = WavLMModel(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "rel_attn_embed" in name:
                p.normal_(0.0, 1.0)
            elif "gru_rel_pos_const" in name:
                p.normal_(1.0, 0.1)
    return model


@pytest.fixture(scope="module")
def hf_wavlm():
    return make_hf_wavlm()


def hf_bucket(rel: torch.Tensor) -> torch.Tensor:
    from transformers.models.wavlm.modeling_wavlm import WavLMAttention

    return WavLMAttention(64, 1, num_buckets=320, max_distance=800)._relative_positions_bucket(rel)


# latents past the bucket's saturation (778): 950 frames of 50 fps
SAMPLES = 320 * 950 + 80


def hf_upstream(hf) -> dict:
    """FaceFormer's upstream state dict with ``hf`` as its audio encoder."""
    w = CONFIG.weights(config(), 7, "cpu")
    upstream = {k: v for k, v in export_faceformer(w).items() if not k.startswith("audio_encoder.")}
    upstream.update({f"audio_encoder.{k}": v for k, v in hf.state_dict().items()})
    return upstream


@pytest.mark.parametrize("side", ["reference", "port"])
def test_encoder_equals_hf_wavlm(hf_wavlm, side):
    """The reference's encoder (on the HF weights under the port's names)
    and the port's ``Wav2Vec2Encoder`` (its config read from the weights)
    against ``WavLMModel`` on one unpadded clip of 950 latents. f32 against
    f32 in other orders of summation: 2e-5 of outputs of size ~4 (the
    port reads 1e-6)."""
    hf = hf_wavlm
    torch.manual_seed(1)
    x = 0.3 * torch.randn(1, SAMPLES)
    cfg = config()
    # the HF encoder under FaceFormer's upstream names, then the converter
    port = convert_faceformer(hf_upstream(hf))
    with torch.no_grad():
        want = hf(x).last_hidden_state
        if side == "reference":
            h = ref.project(port, ref.conv_features(port, x, cfg["wavlm"]), cfg["wavlm"])
            got = ref.transformer(port, h, cfg["wavlm"])
        else:
            sd = strip_prefix(port, "audio_encoder.")
            enc = w2v.Wav2Vec2Encoder(w2v.config_from_state_dict(sd)).eval()
            enc.load_state_dict(sd)
            got = enc(x)
    assert got.shape == want.shape == (1, 950, 128)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_bias_without_pre_ln_is_refused():
    """The gated bias runs in pre-LN layers only: a config with buckets and
    post-LN layers, and WavLM Base's weights (post-LN, a group norm after
    conv 0), are refused."""
    with pytest.raises(ValueError, match="pre-LN"):
        w2v.Wav2Vec2Config(relative_position_buckets=320)
    sd = strip_prefix(convert_faceformer(hf_upstream(make_hf_wavlm(large=False))),
                      "audio_encoder.")
    with pytest.raises(ValueError, match="pre-LN"):
        w2v.config_from_state_dict(sd)


def test_converter_round_trip_keeps_hf_wavlm_names(hf_wavlm):
    """``export_wav2vec2`` gives the HF WavLM names back (the positional
    conv in torch's weight-norm form), the gate constant (1, heads, 1, 1)."""
    from audio2face_tpu_torch.compat.wav2vec2_convert import convert_wav2vec2

    sd = hf_wavlm.state_dict()
    back = export_wav2vec2(convert_wav2vec2(sd))
    assert set(back) == set(sd)
    for name, value in sd.items():
        if "pos_conv_embed.conv.parametrizations" not in name:
            np.testing.assert_array_equal(back[name], value.numpy(), err_msg=name)


def test_table_equals_hf_buckets():
    """The port's (heads, 2R + 1) table at offset clamp(r, -R, R) holds the
    table row of HF's bucket, for every r in [-1000, 1000]."""
    assert w2v.relative_position_radius(320) == 778
    g = torch.Generator().manual_seed(0)
    embed = torch.randn(320, 3, generator=g)
    table = w2v.relative_position_table(embed)
    assert table.shape == (3, 2 * 778 + 1)
    rel = torch.arange(-1000, 1001)
    want = embed[hf_bucket(rel)].t()  # (heads, offsets)
    got = table[:, rel.clamp(-778, 778) + 778]
    assert torch.equal(got, want)
    buckets = hf_bucket(torch.tensor([0, 79, -79, 80, -80, 777, -777, 778, -778]))
    assert buckets.tolist() == [0, 239, 79, 240, 80, 318, 158, 319, 159]
    assert torch.equal(w2v.relative_position_bucket(rel, 320), hf_bucket(rel))


@pytest.mark.parametrize("fn", ["mha_reference", "flash_attention"])
def test_table_bias_equals_attention_over_the_dense_bias(fn):
    """``mha_reference`` (and ``flash_attention`` on CPU tensors) with the
    table bias and key lengths against softmax(q k^T / 8 + bias) v over the
    dense bias built from HF's buckets; the bias moves the output far past
    the tolerance (f32, 1e-5)."""
    g = torch.Generator().manual_seed(4)
    b, h, t, d = 2, 3, 900, 64
    q, k, v = (torch.randn(b, h, t, d, generator=g) for _ in range(3))
    embed = torch.randn(320, h, generator=g)
    gate = 1.0 + torch.rand(b, h, t, generator=g)
    kv = torch.tensor([900, 610])
    out = getattr(attn, fn)(q, k, v, kv_lengths=kv, rel_table=w2v.relative_position_table(embed),
                            rel_gate=gate)
    pos = torch.arange(t)
    dense = embed[hf_bucket(pos[None, :] - pos[:, None])].permute(2, 0, 1)  # (h, t, t)
    s = q @ k.transpose(-1, -2) / 8 + gate[..., None] * dense[None]
    s = s.masked_fill(pos[None, None, None, :] >= kv[:, None, None, None], -1e30)
    want = s.softmax(dim=-1) @ v
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    plain = attn.mha_reference(q, k, v, kv_lengths=kv)
    assert (plain - want).abs().max() > 100 * 1e-5


def test_predictor_matches_the_plain_reference():
    """The predictor (sort, 1 s buckets, groups of 4, padded rows) against
    the reference, every clip, f32; and the reference without its table
    misses by more than five times the tolerance."""
    cfg = config()
    w = CONFIG.weights(cfg, 2**31 + 11, "cpu")
    audios, one_hot, template = inputs(cfg, LENGTHS)
    pred = CONFIG.predictor(cfg, w, "cpu")
    enc = pred.model.audio_encoder.config
    assert (enc.hidden_size, enc.num_layers, enc.num_heads, enc.relative_position_buckets,
            enc.feat_extract_norm, enc.do_stable_layer_norm) == (128, 2, 2, 320, "layer", True)
    got = pred(audios, one_hot, template)
    want = CONFIG.reference(cfg, w, audios, one_hot, [template] * len(audios), "cpu")
    for n, g_, r in zip(LENGTHS, got, want):
        assert g_.shape == tuple(r.shape) == (n * 60 // 16000, N_VERTS // 3, 3)
        assert rel_gap(g_, r, template) < TOL, n
    w0 = dict(w, **{"audio_encoder.rel_attn_embed.weight": torch.zeros_like(
        w["audio_encoder.rel_attn_embed.weight"])})
    unbiased = CONFIG.reference(cfg, w0, audios, one_hot, [template] * len(audios), "cpu")
    assert max(rel_gap(u.numpy(), r, template) for u, r in zip(unbiased, want)) > 5 * TOL


def test_encode_span_and_gated_bias_counter():
    """``predict.encode`` opens inside ``predict.model`` once a group, and
    every layer of every model call counts one ``gated_bias_layers``."""
    cfg = config()
    pred = CONFIG.predictor(cfg, CONFIG.weights(cfg, 9, "cpu"), "cpu")
    audios, one_hot, template = inputs(cfg, [7000, 16050, 24200, 30000, 9000])
    with spans.recording() as rec:
        pred(audios, one_hot, template)
    encodes = [s for s in rec.spans if s.name == "predict.encode"]
    assert len(encodes) == 2  # groups of 4 and 1
    assert all(rec.spans[s.parent].name == "predict.model" for s in encodes)
    assert rec.counters["gated_bias_layers"] == 2 * cfg["wavlm"]["num_hidden_layers"]


def test_layer_norm_stack_takes_the_fused_entry(monkeypatch):
    """A bf16 layer-norm stack of K2's shape goes to ``fused_conv_encoder``
    in its layer-norm mode, with the seven LayerNorms' affines, and
    wav2vec2-base's in the group-norm mode; f32 and ``train`` keep
    ``conv1d``; on the CPU the entry runs the plain version and counts no
    ``conv_layer_norms_fused``."""
    base = w2v.FeatureEncoder(w2v.Wav2Vec2Config()).eval()
    layer = w2v.FeatureEncoder(w2v.Wav2Vec2Config(feat_extract_norm="layer")).eval()
    assert base._fused_ok(torch.bfloat16) and layer._fused_ok(torch.bfloat16)
    assert not layer._fused_ok(torch.float32)
    calls = []
    fused = ce.fused_conv_encoder

    def record(x, kernels, scale, bias, lengths=None, *, norm="group"):
        calls.append((norm, scale, bias))
        return fused(x, kernels, scale, bias, lengths, norm=norm)

    monkeypatch.setattr(ce, "fused_conv_encoder", record)
    x = torch.randn(2, 4000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), spans.recording() as rec:
        got = layer(x, dtype=torch.bfloat16)
        assert len(calls) == 1
        norm, scale, bias = calls[0]
        assert norm == "layer" and len(scale) == len(bias) == 7
        assert all(s is ln.weight and b is ln.bias
                   for s, b, ln in zip(scale, bias, layer.layer_norms))
        want = layer(x)
        trained = layer(x, dtype=torch.bfloat16, train=True)
        assert len(calls) == 1  # f32 and train ran conv1d
        base(x, dtype=torch.bfloat16)
    assert [c[0] for c in calls] == ["layer", "group"] and calls[1][1] is base.group_norm.weight
    assert rec.counters.get("conv_layer_norms_fused", 0) == 0
    assert got.dtype == trained.dtype == torch.bfloat16
    assert got.shape == trained.shape == want.shape == (2, 12, 512)
    torch.testing.assert_close(got.float(), want, rtol=0.05, atol=0.05)  # bf16 products
    torch.testing.assert_close(trained.float(), want, rtol=0.05, atol=0.05)


def test_base_weights_give_the_default_config():
    """wav2vec2-base weights read back as ``Wav2Vec2Config()``: the flagship
    builds the model it built before."""
    with torch.device("meta"):
        sd = w2v.Wav2Vec2Encoder().state_dict()
    assert w2v.config_from_state_dict(sd) == w2v.Wav2Vec2Config()
    assert not w2v.Wav2Vec2Config().wavlm


def test_wavlm_encoder_is_refused_where_it_does_not_serve():
    from audio2face_tpu_torch.streaming import load_live_faceformer

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
    table, gate = torch.zeros(2, 11), torch.ones(1, 2, 8)
    with pytest.raises(ValueError, match="no backward"):
        attn.flash_attention(q, k, v, rel_table=table, rel_gate=gate)
    with pytest.raises(ValueError, match="no backward"):
        attn.flash_attention_bwd(q, k, v, q, gate, q, rel_table=table, rel_gate=gate)
    with pytest.raises(ValueError, match="dropout"):
        attn.flash_attention(q.detach(), k.detach(), v.detach(), rel_table=table, rel_gate=gate,
                             dropout_rate=0.1, dropout_seed=3)
    with pytest.raises(ValueError, match="bf16"):  # an f32 launch
        attn._flash_attention_relpos_cuda(q.detach(), k.detach(), v.detach(), None, 0.125, table,
                                          gate)


# ---------------------------------------------------------------- card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("t", [200, 900, 3600])
def test_biased_kernel_matches_the_plain_version(cuda, t):
    """K1's bf16 forward with the gated bias against ``mha_reference`` on
    the same bf16 inputs, at (2, 16, T, 64) with key lengths below T. Both
    round P to bf16 (the kernel before the row's last rescale, the plain
    version after the division) and their outputs to bf16, so an output
    may miss by 2^-8 of sum_j p_j |v_j| and of its value; the log-sum-exps
    within the SFU's exp2 (2e-3); the same launch without the bias misses."""
    g = torch.Generator(device=cuda).manual_seed(t)
    b, h, d = 2, 16, 64
    q, k, v = (torch.randn(b, h, t, d, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    embed = torch.randn(320, h, generator=g, device=cuda)
    table = w2v.relative_position_table(embed)
    gate = 1.0 + torch.rand(b, h, t, generator=g, device=cuda)
    kv = torch.tensor([t - 7, t // 2 + 3], device=cuda)
    before = attn.flash_attention.relpos_launches
    with torch.no_grad():
        out, lse = attn.flash_attention(q, k, v, kv_lengths=kv, rel_table=table, rel_gate=gate,
                                        return_lse=True)
        want, want_lse = attn.mha_reference(q, k, v, kv_lengths=kv, rel_table=table,
                                            rel_gate=gate, return_lse=True)
        plain = attn.flash_attention(q, k, v, kv_lengths=kv)
        mass = attn.mha_reference(q, k, v.abs(), kv_lengths=kv, rel_table=table, rel_gate=gate)
    torch.cuda.synchronize()
    assert attn.flash_attention.relpos_launches == before + 1
    allowed = 2.0 ** -8 * (want.float().abs() + mass.float())
    over = ((out.float() - want.float()).abs() - allowed).max().item()
    assert over <= 1e-4, over
    assert (lse - want_lse).abs().max().item() <= 2e-3
    assert (plain.float() - want.float()).abs().max().item() > 0.1


def _layer_norm_stack(device, seed: int):
    """WavLM Large's conv stack with random kernels and LayerNorm affines."""
    fe = w2v.FeatureEncoder(w2v.Wav2Vec2Config(feat_extract_norm="layer")).to(device).eval()
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for conv in fe.conv_layers:
            fan_in = conv.weight.shape[1] * conv.weight.shape[2]
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, device=device)
                              / fan_in ** 0.5)
        for ln in fe.layer_norms:
            ln.weight.copy_(1.0 + 0.1 * torch.randn(512, generator=g, device=device))
            ln.bias.copy_(0.05 * torch.randn(512, generator=g, device=device))
    return fe


@pytest.mark.parametrize("batch,seconds", [(1, 60.0), (8, 10.0)])
def test_layer_norm_conv_stack_matches_the_plain_version(cuda, batch, seconds):
    """K2 in its layer-norm mode against ``conv_encoder_reference`` in the
    same mode on the same inputs (mixed lengths at batch 8), at K2's bar,
    0.05 x max|ref|: both multiply bf16 operands with f32 sums and round
    each layer's output once to bf16, in other orders of summation and with
    layer 0's statistics taken analytically by the kernel."""
    fe = _layer_norm_stack(cuda, batch)
    n = int(seconds * 16000)
    x = 0.1 * torch.randn(batch, n, generator=torch.Generator(device=cuda).manual_seed(7),
                          device=cuda)
    lengths = torch.tensor([n - 16000 * (i % 4) for i in range(batch)], device=cuda)
    kernels = [conv.weight.permute(2, 1, 0) for conv in fe.conv_layers]
    scale = [ln.weight for ln in fe.layer_norms]
    bias = [ln.bias for ln in fe.layer_norms]
    before = ce.fused_conv_encoder.layer_norm_launches
    with torch.no_grad():
        out = ce.fused_conv_encoder(x, kernels, scale, bias, lengths, norm="layer")
        ref = ce.conv_encoder_reference(x, kernels, scale, bias, lengths, norm="layer")
    torch.cuda.synchronize()
    assert ce.fused_conv_encoder.layer_norm_launches == before + 1
    assert out.shape == ref.shape == (batch, ce.stack_output_length(n), 512)
    assert bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err < 0.05 * ref.float().abs().max().item(), err


def test_model_call_counts_seven_fused_layer_norms(cuda):
    """A bf16 call of a WavLM-shaped encoder (K2's conv stack with its
    LayerNorms, two small pre-LN layers) counts 7 ``conv_layer_norms_fused``;
    wav2vec2-base's stack counts none."""
    small = dict(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                 pos_conv_kernel=16, pos_conv_groups=4)
    counts = []
    for cfg in (w2v.Wav2Vec2Config(feat_extract_norm="layer", do_stable_layer_norm=True,
                                   relative_position_buckets=320, **small),
                w2v.Wav2Vec2Config(**small)):
        enc = w2v.Wav2Vec2Encoder(cfg).to(cuda).eval()
        x = 0.1 * torch.randn(2, 32000, device=cuda)
        with torch.no_grad(), spans.recording() as rec:
            enc(x, lengths=torch.tensor([32000, 20000], device=cuda), dtype=torch.bfloat16)
        torch.cuda.synchronize()
        counts.append(rec.counters.get("conv_layer_norms_fused", 0))
    assert counts == [7, 0]


def test_long_group_holds_no_dense_bias(cuda):
    """An 8 x 60 s group through the WavLM Large encoder at its published
    widths (bf16): its peak memory above the weights stays within what a
    materialised (8, 16, 3600, 3600) bf16 bias would add (3.3 GB) of the
    same call without the bias; ``predict.encode``,
    ``gated_bias_layers`` (24) and ``conv_layer_norms_fused`` (7) are
    recorded."""
    from audio2face_tpu_torch.models.faceformer import FaceFormer

    cfg = json.loads((BENCH / "configs" / "faceformer_wavlm_large.json").read_text())
    w = CONFIG.weights(cfg, 1, cuda)
    model = FaceFormer(cfg["vertice_dim"], cfg["n_styles"], dtype=torch.bfloat16,
                       encoder_config=w2v.config_from_state_dict(w, "audio_encoder."))
    model.load_state_dict(w)
    model = model.eval().to(cuda)
    del w
    audio = 0.1 * torch.randn(8, 60 * 16000, device=cuda)
    lengths = torch.full((8,), 60 * 16000, device=cuda)
    one_hot = torch.eye(cfg["n_styles"], device=cuda)[:8]

    def peak(bias: bool) -> int:
        enc = model.audio_encoder
        embed = enc.rel_attn_embed
        if not bias:
            object.__setattr__(enc, "config", dataclasses.replace(
                enc.config, relative_position_buckets=0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        try:
            with torch.inference_mode(), spans.recording() as rec:
                model(audio, one_hot, None, lengths, return_hidden=True)
            torch.cuda.synchronize()
        finally:
            object.__setattr__(enc, "config", dataclasses.replace(
                enc.config, relative_position_buckets=embed.num_embeddings))
        if bias:
            assert rec.counters["gated_bias_layers"] == 24
            assert rec.counters["conv_layer_norms_fused"] == 7
            assert [s.name for s in rec.spans] == ["predict.encode", "predict.decode"]
        return torch.cuda.max_memory_allocated() - base

    biased, unbiased = peak(True), peak(False)
    assert biased - unbiased < 8 * 16 * 3600 * 3600 * 2, (biased, unbiased)
