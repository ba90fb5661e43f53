"""The seeded weights, and the work counts with worked numbers."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark.counts import work
from benchmark.tests.conftest import SMALL_VERTS, config, config_module


@pytest.mark.parametrize("name", ["faceformer_vocaset", "audio2mesh_mfcc"])
def test_weights_repeat_by_seed_and_differ_across_seeds(name):
    cfg = config(name, vertice_dim=SMALL_VERTS)
    mod = config_module(name)
    a, b, c = mod.weights(cfg, 11, "cpu"), mod.weights(cfg, 11, "cpu"), mod.weights(cfg, 12, "cpu")
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k], c[k]), k
        # no tensor zero: every path, the decoder's feedback included, shows
        assert float(a[k].abs().max()) > 0, k


@pytest.mark.parametrize("name", ["faceformer_vocaset", "audio2mesh_mfcc"])
def test_weights_fill_the_model_exactly(name):
    """The weight maker's names and shapes are the port's, every one."""
    from audio2face_tpu_torch.models.audio2mesh import Audio2Mesh
    from audio2face_tpu_torch.models.faceformer import FaceFormer

    cfg = config(name, vertice_dim=SMALL_VERTS)
    model = (FaceFormer if name == "faceformer_vocaset" else Audio2Mesh)(SMALL_VERTS, 12)
    model.load_state_dict(config_module(name).weights(cfg, 3, "cpu"), strict=True)


def test_huge_seeds_are_accepted():
    cfg = config("audio2mesh_mfcc", vertice_dim=SMALL_VERTS)
    w = config_module("audio2mesh_mfcc").weights(cfg, 2**31 + 12345, "cpu")
    assert all(bool(torch.isfinite(t).all()) for t in w.values())


def test_k1_bound_reproduces_the_kernel_table():
    """chip_smoke.py's K1 row: (8, 12, 3600, 64) bf16, every query row
    against kv_lengths 180-3600: 0.2234 ms, by operations."""
    kv = [3600, 3600, 2700, 1800, 3600, 900, 3600, 180]
    flops, nbytes = work.k1_work([3600] * 8, kv)
    ms = 1e3 * work.bound_s(nbytes, flops, work.PEAK_BF16_FLOPS)
    assert round(ms, 4) == 0.2234
    assert flops / work.PEAK_BF16_FLOPS > nbytes / work.PEAK_HBM_BYTES


def test_k3_bound_reproduces_the_kernel_table():
    """chip_smoke.py's K3 row: 8 items x 3600 frames, f32 arithmetic:
    0.2298 ms, by operations."""
    flops, nbytes = work.k3_work([3600] * 8)
    assert round(1e3 * work.bound_s(nbytes, flops, work.PEAK_F32_FLOPS), 4) == 0.2298


def test_counts_take_valid_lengths_only():
    """A request counts the work of its clips whatever the program pads
    them to: the counts are sums over clips of their own valid frames, so
    any grouping or order of the same clips counts the same."""
    cfg = config("faceformer_vocaset")
    mod = config_module("faceformer_vocaset")
    lengths = [16000 * 3 + 17, 16000 * 11 + 5, 16000 * 35]
    together = mod.kernel_work(cfg, lengths)
    apart = [mod.kernel_work(cfg, [n]) for n in lengths]
    assert together["k1"][0] == pytest.approx(sum(a["k1"][0] for a in apart), rel=1e-12)
    assert together["k3"][0] == pytest.approx(sum(a["k3"][0] for a in apart), rel=1e-12)
    assert mod.kernel_work(cfg, lengths[::-1]) == together
    frames = [n * 60 // 16000 for n in lengths]
    # K1: 12 layers, 12 heads of 64: 4 h d T^2 a layer for a clip of T frames
    assert together["k1"][0] == pytest.approx(12 * 4 * 12 * 64 * sum(t * t for t in frames))
    # what the 40 s bucket's padded queries would add is not counted
    padded = work.k1_work([2400] * 3, frames, 12, 64)[0] * 12
    assert padded > together["k1"][0]
    total = sum(mod.flops(cfg, n) for n in lengths)
    assert total == pytest.approx(sum(mod.flops(cfg, n) for n in sorted(lengths)))


def test_faceformer_flops_of_a_minute():
    """~1.4 TFLOP a 60 s clip (the flagship's ~11 TFLOP for 8)."""
    cfg = config("faceformer_vocaset")
    f = config_module("faceformer_vocaset").flops(cfg, 60 * 16000)
    assert 1.3e12 < f < 1.5e12


def test_audio2mesh_flops_a_frame():
    cfg = config("audio2mesh_mfcc")
    per_frame = work.mfcc_flops(cfg) + work.audio2mesh_frame_flops(cfg)
    assert 1.0e8 < per_frame < 2.0e8
    assert math.isclose(config_module("audio2mesh_mfcc").flops(cfg, 22000), 60 * per_frame)
