"""BIWI-format dataset pipeline for the FaceFormer BIWI mode.

Port of ``audio2face_tpu/data/biwi.py`` (numpy on the host; wavs at other
rates are resampled by the port's ``ops/dsp.py resample`` on the CPU). The
reference repo has no BIWI loader — only the model-side branches it
vendored (the wav2vec trim arm, src/model/wav2vec.py:119-124, and the
enc_dec_mask BIWI arm, src/model/faceformer.py:60-62) — so this module
makes ``FaceFormer(dataset="biwi")`` trainable end to end. It consumes the
public on-disk layout of the BIWI 3D audiovisual corpus as prepared for the
vendored model family:

    <datapath>/
      wav/<subject>_<sentence>.wav          speech clips (any sample rate;
                                            resampled to 16 kHz on load)
      vertices_npy/<subject>_<sentence>.npy (T, V*3) float32 vertex tracks
                                            at 25 fps (V = 23,370 for real
                                            BIWI); (T, V, 3) also accepted
      templates.pkl                         dict subject -> (V, 3) neutral

Sentence-number split routing (the corpus convention: each subject records
40 sentences): 1-32 train, 33-36 val, 37-40 test. One-hot identity is over
``train_subjects`` (style conditioning is only learnable for subjects seen
in training — unseen-subject clips get a zero one-hot, the standard
"unseen condition" evaluation setup).

Batches use the same padded-bucket ``ClipBatch`` schema as the VOCASET
whole-clip path (``data/vocaset.py``), with the 25 fps alignment: the audio
grain is 3,200 samples = 0.2 s = exactly 5 frames, so every bucket keeps
``frame_count(audio_len, 25)`` consistent with the model's mask.

The BIWI corpus itself is licensed (ETH release) and cannot ship here;
:func:`generate_synthetic_biwi` materializes a format-identical stand-in
for tests and smoke runs, exactly like ``data/synthetic.py`` does for
VOCASET.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Sequence

import numpy as np

from audio2face_tpu_torch.data.vocaset import ClipBatch, resample_16k
from audio2face_tpu_torch.utils.shapes import round_up as _round_up

BIWI_FPS = 25
SR = 16000
AUDIO_GRAIN = 3200  # 0.2 s = exactly 5 frames at 25 fps
FRAME_GRAIN = AUDIO_GRAIN * BIWI_FPS // SR  # 5

# corpus convention: 40 sentences per subject
TRAIN_SENTENCES = range(1, 33)
VAL_SENTENCES = range(33, 37)
TEST_SENTENCES = range(37, 41)

DEFAULT_TRAIN_SUBJECTS = ("F2", "F3", "F4", "M3", "M4", "M5")


def _phase_of(sentence: int) -> str:
    if sentence in TRAIN_SENTENCES:
        return "train"
    if sentence in VAL_SENTENCES:
        return "val"
    return "test"


def _load_wav_16k(path: str) -> np.ndarray:
    from audio2face_tpu_torch.utils.audio_io import read_wav

    wav, sr = read_wav(path)
    return resample_16k(wav, int(sr))


class BiwiSet:
    """One split of a BIWI-layout directory; lazy per-clip loading."""

    def __init__(self, datapath: str, phase: str, train_subjects: Sequence[str]):
        self.datapath = datapath
        self.phase = phase
        self.train_subjects = list(train_subjects)
        with open(os.path.join(datapath, "templates.pkl"), "rb") as f:
            self.templates = {k: np.asarray(v, np.float32) for k, v in pickle.load(f).items()}

        self.datalist: list[tuple[str, str]] = []
        wav_dir = os.path.join(datapath, "wav")
        for fname in sorted(os.listdir(wav_dir)):
            if not fname.endswith(".wav"):
                continue
            stem = fname[: -len(".wav")]
            subject, _, sent = stem.rpartition("_")
            if not subject or not sent.isdigit():
                continue
            if phase != "all" and _phase_of(int(sent)) != phase:
                continue
            vpath = os.path.join(datapath, "vertices_npy", stem + ".npy")
            if os.path.exists(vpath):
                self.datalist.append((subject, sent))

    def __len__(self) -> int:
        return len(self.datalist)

    def one_hot(self, subject: str) -> np.ndarray:
        oh = np.zeros(len(self.train_subjects), np.float32)
        if subject in self.train_subjects:
            oh[self.train_subjects.index(subject)] = 1.0
        return oh

    def _load(self, subject: str, sentence: str):
        stem = f"{subject}_{sentence}"
        wav = _load_wav_16k(os.path.join(self.datapath, "wav", stem + ".wav"))
        v = np.load(os.path.join(self.datapath, "vertices_npy", stem + ".npy"))
        v = np.asarray(v, np.float32).reshape(v.shape[0], -1, 3)
        return wav, v

    def gather_clips(
        self,
        keys: Sequence[tuple[str, str]],
        audio_bucket: Optional[int] = None,
        frame_bucket: Optional[int] = None,
    ) -> ClipBatch:
        clips = [(s, *self._load(s, sent)) for s, sent in keys]
        max_s = max(len(c[1]) for c in clips)
        s_bucket = audio_bucket or _round_up(max_s, AUDIO_GRAIN)
        # must equal the model's static frame count frame_count(s_bucket, 25)
        # — see the same derivation in vocaset.gather_clips
        f_bucket = frame_bucket or s_bucket * BIWI_FPS // SR

        n = len(clips)
        nv = clips[0][2].shape[1]
        audio = np.zeros((n, s_bucket), np.float32)
        audio_lengths = np.zeros(n, np.int32)
        verts = np.zeros((n, f_bucket, nv, 3), np.float32)
        frame_lengths = np.zeros(n, np.int32)
        template = np.zeros((n, nv, 3), np.float32)
        one_hot = np.zeros((n, len(self.train_subjects)), np.float32)
        for i, (subject, wav, v) in enumerate(clips):
            s = min(len(wav), s_bucket)
            f = min(len(v), f_bucket, s * BIWI_FPS // SR)
            # keep the model's frame mask (audio_len * 25 // 16000) == f when
            # the vertex track is shorter than the audio
            if s * BIWI_FPS // SR > f:
                s = min(s, (f + 1) * SR // BIWI_FPS - 1)
            audio[i, :s] = wav[:s]
            audio_lengths[i] = s
            verts[i, :f] = v[:f]
            frame_lengths[i] = f
            template[i] = self.templates[subject]
            one_hot[i] = self.one_hot(subject)
        return ClipBatch(audio, audio_lengths, verts, frame_lengths, template, one_hot)

    def get_framedatas(self, subject: str, sentence: str):
        return self.gather_clips([(subject, sentence)])


class BiwiDataModule:
    """Drop-in datamodule for ``Audio2FaceExperiment.fit`` — same batch
    surface as ``VocaDataModule`` in whole-clip mode (``train_batches`` /
    ``val_batches`` / ``predict_batch`` / ``test_dataset``)."""

    def __init__(
        self,
        datapath: str,
        batch_size: int = 1,
        train_subjects: Sequence[str] = DEFAULT_TRAIN_SUBJECTS,
        num_workers: int = 0,  # surface parity; loading is vectorized
    ):
        self.datapath = datapath
        self.batch_size = batch_size
        self.train_subjects = list(train_subjects)
        self._datasets: dict[str, BiwiSet] = {}

    def setup(self, stage: Optional[str] = None) -> None:
        for phase in ("train", "val", "test"):
            self._datasets[phase] = BiwiSet(self.datapath, phase, self.train_subjects)

    @property
    def train_dataset(self) -> BiwiSet:
        return self._datasets["train"]

    @property
    def val_dataset(self) -> BiwiSet:
        return self._datasets["val"]

    @property
    def test_dataset(self) -> BiwiSet:
        return self._datasets["test"]

    def _clip_batches(self, ds: BiwiSet, shuffle: bool, rng) -> Iterator[dict]:
        order = np.arange(len(ds))
        if shuffle and rng is not None:
            rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order), bs):
            keys = [ds.datalist[j] for j in order[i : i + bs]]
            yield ds.gather_clips(keys).asdict()

    def train_batches(self, rng: np.random.Generator) -> Iterator[dict]:
        return self._clip_batches(self.train_dataset, shuffle=True, rng=rng)

    def val_batches(self) -> Iterator[dict]:
        return self._clip_batches(self.val_dataset, shuffle=False, rng=None)

    def predict_batch(self, subject: str, sentence: str) -> dict:
        return self.test_dataset.get_framedatas(subject, sentence).asdict()


def generate_synthetic_biwi(
    out_dir: str,
    n_verts: int = 120,
    subjects: Sequence[str] = ("F2", "M3", "F1"),
    sentences: Sequence[int] = (1, 2, 33, 37),
    seconds_per_sentence: float = 0.8,
    seed: int = 0,
) -> str:
    """Format-identical BIWI stand-in (the corpus is licensed): 16 kHz wavs,
    (T, V*3) 25 fps vertex tracks correlated with the audio envelope, and a
    per-subject template pickle. Defaults cover every split phase."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "wav"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "vertices_npy"), exist_ok=True)
    import scipy.io.wavfile as wavfile

    templates = {}
    for si, subject in enumerate(subjects):
        tmpl = rng.normal(0, 0.05, size=(n_verts, 3)).astype(np.float32)
        templates[subject] = tmpl
        for sent in sentences:
            n = int(seconds_per_sentence * SR)
            t = np.arange(n) / SR
            f0 = 100.0 + 20.0 * si + 5.0 * sent
            env = 0.4 + 0.3 * np.sin(2 * np.pi * (2.0 + 0.3 * sent) * t)
            wav = (env * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
            wavfile.write(
                os.path.join(out_dir, "wav", f"{subject}_{sent:02d}.wav"),
                SR,
                (wav * 16384).astype(np.int16),
            )
            n_frames = n * BIWI_FPS // SR
            fenv = env[:: SR // BIWI_FPS][:n_frames].astype(np.float32)
            motion = rng.normal(0, 0.01, size=(1, n_verts, 3)).astype(np.float32)
            v = tmpl[None] + fenv[:, None, None] * motion
            np.save(
                os.path.join(out_dir, "vertices_npy", f"{subject}_{sent:02d}.npy"),
                v.reshape(n_frames, -1).astype(np.float32),
            )
    with open(os.path.join(out_dir, "templates.pkl"), "wb") as f:
        pickle.dump(templates, f)
    return out_dir
