"""The offline request loop both predictors share (``serving.py
_BucketedPredictor``) on the CPU: a group's host padding to its audio
bucket and the batch grid, and a call at the predictor's own sample rate
equal to a call without one."""

import numpy as np
import pytest
import torch

from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor

torch.set_num_threads(1)

N_VERTS = 300
# three clips of mixed lengths at max_batch 4: one group, padded to 4 rows
SECONDS = (0.3, 0.7, 0.45)


def build(kind: str):
    """(predictor with 0.5 s buckets and max_batch 4, its sample rate)."""
    if kind == "faceformer":
        return FaceFormerPredictor(n_verts=N_VERTS, bf16=False, max_batch=4, bucket_seconds=0.5,
                                   device="cpu"), 16000
    cfg = ExpConfig(batch_size=8, modelname="audio2mesh", vertex_count=N_VERTS, one_hot_size=12,
                    feature_extractor="mfcc", sample_rate=22000, split_frame=True, n_feature=32,
                    out_dim=52, win_length=440, percision="32", lr=1e-3)
    return FramePredictor(cfg, max_batch=4, frame_batch=16, bucket_seconds=0.5, seed=3,
                          device="cpu"), 22000


@pytest.mark.parametrize("kind", ["faceformer", "frame"])
def test_pad_group_and_the_predictors_own_rate(kind):
    pred, sr = build(kind)
    rng = np.random.default_rng(0)
    group = [(rng.normal(size=int(s * sr)) * 0.1).astype(np.float32) for s in SECONDS]
    one_hot = np.eye(12, dtype=np.float32)[[0, 4, 9]]
    template = rng.normal(size=(3, N_VERTS // 3, 3)).astype(np.float32)

    audio, lengths, oh, tmpl = pred._pad_group(group, one_hot, template)
    samples = 2 * int(0.5 * sr)  # the longest clip, 0.7 s, up to the 0.5 s grid
    assert audio.shape == (4, samples) and audio.dtype == np.float32
    for j, a in enumerate(group):
        assert np.array_equal(audio[j, : len(a)], a) and not audio[j, len(a) :].any()
    assert not audio[3].any()
    # the dummy row decodes a few frames of silence (FaceFormer), discarded
    assert lengths.dtype == np.int64
    assert lengths.tolist() == [len(a) for a in group] + [min(800, samples)]
    assert oh.shape == (4, 12) and np.array_equal(oh[:3], one_hot) and not oh[3].any()
    assert tmpl.shape == (4, N_VERTS // 3, 3) and tmpl.dtype == np.float32
    assert np.array_equal(tmpl[:3], template) and not tmpl[3].any()

    assert pred.sample_rate == sr
    want = pred(group, one_hot, template[0])
    got = pred(group, one_hot, template[0], sample_rate=sr)
    assert [g.shape[0] for g in got] == [len(a) * pred.fps // sr for a in group]
    for w, g in zip(want, got):
        assert w.tobytes() == g.tobytes()
