"""The plain references against the port's plain versions, at the
published widths with short clips and few vertices, in f32 on the CPU: the
same weights give the same vertices (offline FaceFormer through the
predictor's sort, buckets and padding; the frame predictor's windows, MFCC
and Audio2Mesh)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.drivers.common import audio_bank
from benchmark.tests.conftest import SMALL_VERTS, config, config_module

TOL = 1e-4  # f32 against f32: rounding only, relative to the motion


def rel_gap(got: np.ndarray, want: torch.Tensor, template: np.ndarray) -> float:
    want = want.numpy()
    motion = np.sqrt(np.square(np.linalg.norm(want - template[None], axis=-1)).mean())
    return float(np.linalg.norm(got - want, axis=-1).max() / motion)


def inputs(sr: int, lengths: list, seed: int = 3):
    bank = audio_bank(seed, 8.0, sr)
    audios = [bank[1000 * i : 1000 * i + n] for i, n in enumerate(lengths)]
    one_hot = np.eye(12, dtype=np.float32)[[(5 * i + 3) % 12 for i in range(len(lengths))]]
    template = (0.05 * np.random.default_rng(seed).standard_normal((SMALL_VERTS // 3, 3))
                ).astype(np.float32)
    return audios, one_hot, template


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def test_faceformer_reference_matches_the_predictor():
    cfg = config("faceformer_vocaset", vertice_dim=SMALL_VERTS, compute_dtype="float32")
    mod = config_module("faceformer_vocaset")
    w = mod.weights(cfg, 7, "cpu")
    audios, one_hot, template = inputs(16000, [16000 + 123, 36000 + 7, 8000 + 400])
    got = mod.predictor(cfg, w, "cpu")(audios, one_hot, template)
    want = mod.reference(cfg, w, audios, one_hot, [template] * 3, "cpu")
    for g, r in zip(got, want):
        assert g.shape == tuple(r.shape)
        assert rel_gap(g, r, template) < TOL


def test_audio2mesh_reference_matches_the_frame_predictor():
    cfg = config("audio2mesh_mfcc", vertice_dim=SMALL_VERTS, percision="32")
    mod = config_module("audio2mesh_mfcc")
    w = mod.weights(cfg, 9, "cpu")
    audios, one_hot, template = inputs(22000, [22000 + 321, 11000 + 17])
    got = mod.predictor(cfg, w, "cpu")(audios, one_hot, template)
    want = mod.reference(cfg, w, audios, one_hot, [template] * 2, "cpu")
    for g, r in zip(got, want):
        assert g.shape == tuple(r.shape)
        assert rel_gap(g, r, template) < TOL
