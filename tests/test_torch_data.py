"""The port's data pipeline against the JAX package's: the subject lists and
splits, the fragmenter, the synthetic VOCASET and BIWI generators (the same
files), VOCASET frame and clip batches and BIWI clip batches (equal arrays
for the same ``np_rng``), and the mel helpers at the tolerance of the JAX
package's checks against torchaudio (tests/torchaudio_mirror.py)."""

import filecmp
import os

import numpy as np
import pytest
import torch

from audio2face_tpu.data import biwi as jax_biwi
from audio2face_tpu.data import utils as jax_utils
from audio2face_tpu.data import vocaset as jax_vocaset
from audio2face_tpu.data.synthetic import generate_synthetic_vocaset as jax_generate_vocaset
from audio2face_tpu_torch.data import biwi, utils, vocaset
from audio2face_tpu_torch.data.synthetic import generate_synthetic_vocaset

torch.set_num_threads(1)

VOCASET_FILES = ("templates.pkl", "raw_audio_fixed.pkl", "data_verts.npy", "subj_seq_to_idx.pkl")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The same miniature VOCASET written by each package's generator."""
    kw = dict(n_verts=50, sentences_per_subject=1, seconds_per_sentence=0.6)
    jax_dir = jax_generate_vocaset(str(tmp_path_factory.mktemp("jax")), **kw)
    port_dir = generate_synthetic_vocaset(str(tmp_path_factory.mktemp("port")), **kw)
    return jax_dir, port_dir


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_subject_lists_and_one_hot_match_jax():
    for name in ("TRAINING_SUBJECTS", "TRAINING_SENTENCES", "VALIDATION_SUBJECTS",
                 "VALIDATION_SENTENCES", "TEST_SUBJECTS", "ALL_SUBJECTS", "FPS",
                 "FRAGMENT_SECONDS", "MAX_RANDOM_SHIFT"):
        assert getattr(vocaset, name) == getattr(jax_vocaset, name), name
    for h in vocaset.ALL_SUBJECTS:
        np.testing.assert_array_equal(vocaset.get_human_id_one_hot(h),
                                      jax_vocaset.get_human_id_one_hot(h))
    audio = np.asarray([-32768, 0, 16384], np.int16)
    np.testing.assert_array_equal(vocaset.normalize_audio(audio), jax_vocaset.normalize_audio(audio))


def test_fragmenter_matches_jax():
    rng = np.random.default_rng(0)
    audio = rng.integers(-1000, 1000, 44000).astype(np.int16)
    for idx, shift in [(0, 0), (5, 0), (30, -200), (60, 500), (119, 17)]:
        got = vocaset.get_audio_fragment(audio, idx, sample_rate=22000, shift=shift)
        np.testing.assert_array_equal(
            got, jax_vocaset.get_audio_fragment(audio, idx, sample_rate=22000, shift=shift))
        vec = vocaset.batch_audio_fragments(audio, np.asarray([idx]), sample_rate=22000,
                                            shifts=np.asarray([shift]))[0]
        np.testing.assert_array_equal(vec, got)
        assert len(got) == 11440  # 0.52 s at 22 kHz
    idxs = np.arange(0, 120, 7)
    shifts = rng.integers(-500, 501, len(idxs))
    np.testing.assert_array_equal(
        vocaset.batch_audio_fragments(audio, idxs, sample_rate=22000, shifts=shifts),
        jax_vocaset.batch_audio_fragments(audio, idxs, sample_rate=22000, shifts=shifts))


def test_synthetic_vocaset_files_and_splits_match_jax(dirs):
    jax_dir, port_dir = dirs
    for name in VOCASET_FILES:
        assert filecmp.cmp(os.path.join(jax_dir, name), os.path.join(port_dir, name), shallow=False), name
    for phase in ("train", "val", "test"):
        jax_vocaset.ClipVocaSet(jax_dir, phase=phase)
        vocaset.ClipVocaSet(port_dir, phase=phase)
    for name in ("train_list", "val_list", "test_list"):
        assert filecmp.cmp(os.path.join(jax_dir, "split", f"{name}.csv"),
                           os.path.join(port_dir, "split", f"{name}.csv"), shallow=False), name
    rec = vocaset.DataSplitRecorder.load(port_dir)
    assert {h for h, *_ in rec.train_list} <= set(vocaset.TRAINING_SUBJECTS)
    for h, s, _, _ in rec.val_list:
        assert h in vocaset.VALIDATION_SUBJECTS and int(s[-2:]) >= 21
    assert set(vocaset.TEST_SUBJECTS) <= {h for h, *_ in rec.test_list}


@pytest.mark.parametrize("split_frame", [True, False])
def test_vocaset_batches_match_jax(dirs, split_frame):
    """Train batches (shuffled, with the random shift in frame mode), val
    batches and a predict batch equal JAX's, array for array."""
    jax_dir, port_dir = dirs
    kw = dict(batch_size=16 if split_frame else 3, random_shift=split_frame, split_frame=split_frame)
    jdm = jax_vocaset.VocaDataModule(jax_dir, **kw)
    pdm = vocaset.VocaDataModule(port_dir, **kw)
    jdm.setup()
    pdm.setup()
    _assert_batches_equal(pdm.train_batches(np.random.default_rng(3)),
                          jdm.train_batches(np.random.default_rng(3)))
    _assert_batches_equal(pdm.val_batches(), jdm.val_batches())
    h, s = pdm.test_dataset.datalist[0][:2]
    _assert_batches_equal([pdm.predict_batch(h, s)], [jdm.predict_batch(h, s)])
    if split_frame:
        with pytest.raises(ValueError, match="no frames"):
            pdm.train_dataset.gather_frames([])
    else:
        batch = pdm.predict_batch(h, s)
        # the vertex bucket equals the model's frame count of the audio bucket
        assert batch["verts"].shape[1] == batch["audio"].shape[1] * 60 // 16000


def test_biwi_generator_and_batches_match_jax(tmp_path):
    kw = dict(n_verts=40, sentences=(1, 2, 3, 33, 37), seconds_per_sentence=0.5)
    jax_dir = jax_biwi.generate_synthetic_biwi(str(tmp_path / "jax"), **kw)
    port_dir = biwi.generate_synthetic_biwi(str(tmp_path / "port"), **kw)
    for root, _, files in os.walk(jax_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), jax_dir)
            assert filecmp.cmp(os.path.join(jax_dir, rel), os.path.join(port_dir, rel), shallow=False), rel
    jdm = jax_biwi.BiwiDataModule(jax_dir, batch_size=2, train_subjects=("F2", "M3"))
    pdm = biwi.BiwiDataModule(port_dir, batch_size=2, train_subjects=("F2", "M3"))
    jdm.setup()
    pdm.setup()
    for phase in ("train", "val", "test"):
        assert pdm._datasets[phase].datalist == jdm._datasets[phase].datalist
    _assert_batches_equal(pdm.train_batches(np.random.default_rng(1)),
                          jdm.train_batches(np.random.default_rng(1)))
    _assert_batches_equal(pdm.val_batches(), jdm.val_batches())
    batch = pdm.predict_batch("F1", "37")
    # 25 fps alignment: the frame bucket is the audio bucket's 25 fps count
    assert batch["audio"].shape[1] % biwi.AUDIO_GRAIN == 0
    assert batch["verts"].shape[1] == batch["audio"].shape[1] * 25 // 16000
    assert batch["one_hot"].sum() == 0  # F1 is not a training subject


def test_mel_helpers_match_jax():
    x = np.random.default_rng(3).normal(size=(11440,)).astype(np.float32) * 0.1
    for name, rtol in (("melspec_htk_slaney", 1e-4), ("melspec_htk", 1e-3)):
        got, want = getattr(utils, name)(x), getattr(jax_utils, name)(x)
        assert got.shape == want.shape == (32, 11440 // 176 + 1)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())
    m = utils.melspec_htk(x)
    np.testing.assert_allclose(utils.power_to_db(m), jax_utils.power_to_db(m), atol=1e-3)
    db = utils.power_to_db(m)
    assert db.max() <= 0.0 and db.min() >= -80.0
