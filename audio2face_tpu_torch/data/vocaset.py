"""VOCASET data pipeline: host-side loading, split bookkeeping, batches.

Port of ``audio2face_tpu/data/vocaset.py``. The reference's dataset stack
(src/dataset/vocaset.py) reads four artifacts: ``templates.pkl``,
``raw_audio_fixed.pkl``, ``data_verts.npy`` (memory-mapped) and
``subj_seq_to_idx.pkl``. The 12-subject split is the reference's (8 train
subjects x sentences 01-40, 2 val subjects x sentences 21-40, everything
else test), materialized as ``{datapath}/split/{train,val,test}_list.csv``.

- Per-frame mode (``split_frame=True``): one 0.52 s window around each
  frame, zero-padded, with an optional +-500-sample random shift in the
  train phase; int16 clips are gathered and normalized by the native
  fragmenter (``runtime/hostloader.py``), vertex rows by its row gather.
- Whole-clip mode: clips resampled 22 kHz -> 16 kHz on the host, padded to
  shape buckets with per-item valid lengths.

Batches are dicts of numpy arrays; the trainer's ``fit`` uploads them
through ``runtime.Prefetcher`` (pinned host buffers, copies on a side CUDA
stream) while the previous step runs.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Iterator, Literal, Mapping, Optional, Sequence

import numpy as np
import torch

from audio2face_tpu_torch.utils.shapes import round_up as _round_up

TRAINING_SUBJECTS = [
    "FaceTalk_170728_03272_TA",
    "FaceTalk_170904_00128_TA",
    "FaceTalk_170725_00137_TA",
    "FaceTalk_170915_00223_TA",
    "FaceTalk_170811_03274_TA",
    "FaceTalk_170913_03279_TA",
    "FaceTalk_170904_03276_TA",
    "FaceTalk_170912_03278_TA",
]
TRAINING_SENTENCES = [f"sentence{i:02d}" for i in range(1, 41)]
VALIDATION_SUBJECTS = [
    "FaceTalk_170811_03275_TA",
    "FaceTalk_170908_03277_TA",
]
VALIDATION_SENTENCES = [f"sentence{i:02d}" for i in range(21, 41)]
TEST_SUBJECTS = ["FaceTalk_170809_00138_TA", "FaceTalk_170731_00024_TA"]
ALL_SUBJECTS = [*TRAINING_SUBJECTS, *VALIDATION_SUBJECTS, *TEST_SUBJECTS]

FPS = 60
FRAGMENT_SECONDS = 0.52
MAX_RANDOM_SHIFT = 500


def get_human_id_one_hot(human_id: str) -> np.ndarray:
    """12-dim identity one-hot over the fixed subject order."""
    one_hot = np.zeros(len(ALL_SUBJECTS), dtype=np.float32)
    one_hot[ALL_SUBJECTS.index(human_id)] = 1.0
    return one_hot


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def normalize_audio(audio: np.ndarray) -> np.ndarray:
    """int16 PCM -> float32 in [-1, 1); float input passes through as f32."""
    if audio.dtype == np.int16:
        return (audio / 32768.0).astype(np.float32)
    return audio.astype(np.float32)


def get_audio_fragment(
    audio: np.ndarray,
    idx: int,
    *,
    fps: int = FPS,
    sample_rate: int,
    length: float = FRAGMENT_SECONDS,
    shift: int = 0,
) -> Optional[np.ndarray]:
    """The reference host fragmenter: a ``length``-second window around frame
    ``idx``'s timestamp from a clip padded with half a window on the left
    (plus ``shift``) and a full window on the right; None past the end."""
    dtype = audio.dtype
    n_pad = int(sample_rate * length / 2)
    l_pad = n_pad + shift
    padded = np.concatenate(
        [np.zeros(l_pad, dtype), audio, np.zeros(2 * n_pad, dtype)]
    )
    start = idx * sample_rate // fps
    end = start + 2 * n_pad
    if end > len(padded):
        return None
    return padded[start:end]


def batch_audio_fragments(
    audio: np.ndarray,
    idxs: np.ndarray,
    *,
    sample_rate: int,
    shifts: Optional[np.ndarray] = None,
    fps: int = FPS,
    length: float = FRAGMENT_SECONDS,
) -> np.ndarray:
    """Vectorized fragmenter: (N,) frame indices -> (N, window) in one
    gather, row for row equal to :func:`get_audio_fragment`."""
    n_pad = int(sample_rate * length / 2)
    window = 2 * n_pad
    if shifts is None:
        shifts = np.zeros(len(idxs), np.int64)
    padded = np.concatenate(
        [
            np.zeros(n_pad + MAX_RANDOM_SHIFT, audio.dtype),
            audio,
            np.zeros(window + MAX_RANDOM_SHIFT, audio.dtype),
        ]
    )
    starts = (
        np.asarray(idxs, np.int64) * sample_rate // fps + MAX_RANDOM_SHIFT - shifts
    )
    gather = starts[:, None] + np.arange(window)[None, :]
    return padded[gather]


# ---------------------------------------------------------------------------
# Split bookkeeping (CSV-compatible with the reference)
# ---------------------------------------------------------------------------


class DataSplitRecorder:
    """Writes and reads the train/val/test lists as CSVs under
    ``{datapath}/split/``: train = training subject x sentences 01-40, val =
    validation subject x sentences 21-40, everything else test."""

    COLUMNS = ["human_id", "sentence_id", "clip_index", "data_verts_index"]

    def __init__(self) -> None:
        self.train_list: list[tuple] = []
        self.val_list: list[tuple] = []
        self.test_list: list[tuple] = []

    def add(self, human_id: str, sentence_id: str, clip_index: int, data_verts_index: int):
        row = (human_id, sentence_id, int(clip_index), int(data_verts_index))
        if human_id in TRAINING_SUBJECTS and sentence_id in TRAINING_SENTENCES:
            self.train_list.append(row)
        elif human_id in VALIDATION_SUBJECTS and sentence_id in VALIDATION_SENTENCES:
            self.val_list.append(row)
        else:
            self.test_list.append(row)

    def save(self, datapath: str) -> None:
        split_dir = os.path.join(datapath, "split")
        os.makedirs(split_dir, exist_ok=True)
        for name, rows in (
            ("train_list", self.train_list),
            ("val_list", self.val_list),
            ("test_list", self.test_list),
        ):
            with open(os.path.join(split_dir, f"{name}.csv"), "w") as f:
                f.write(",".join(self.COLUMNS) + "\n")
                for r in rows:
                    f.write(f"{r[0]},{r[1]},{r[2]},{r[3]}\n")

    @staticmethod
    def exists(datapath: str) -> bool:
        split_dir = os.path.join(datapath, "split")
        return all(
            os.path.exists(os.path.join(split_dir, f"{n}_list.csv"))
            for n in ("train", "val", "test")
        )

    @classmethod
    def build(cls, raw_audio, subj_seq_to_idx, datapath: str) -> "DataSplitRecorder":
        rec = cls()
        for clip_name, clip_data in raw_audio.items():
            if clip_name not in subj_seq_to_idx:
                continue
            for sentence_id in clip_data:
                if sentence_id not in subj_seq_to_idx[clip_name]:
                    continue
                for clip_index, seq_num in subj_seq_to_idx[clip_name][sentence_id].items():
                    rec.add(clip_name, sentence_id, clip_index, seq_num)
        rec.save(datapath)
        return rec

    @classmethod
    def load(cls, datapath: str) -> "DataSplitRecorder":
        rec = cls()
        split_dir = os.path.join(datapath, "split")
        for name, target in (
            ("train_list", rec.train_list),
            ("val_list", rec.val_list),
            ("test_list", rec.test_list),
        ):
            with open(os.path.join(split_dir, f"{name}.csv")) as f:
                next(f)  # header
                for line in f:
                    h, s, ci, vi = line.strip().split(",")
                    target.append((h, s, int(ci), int(vi)))
        return rec

    def get_list(self, phase: Literal["train", "val", "test", "all"] = "all"):
        if phase == "train":
            return self.train_list
        if phase == "val":
            return self.val_list
        if phase == "test":
            return self.test_list
        return self.train_list + self.val_list + self.test_list


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


@dataclass
class FrameBatch:
    """Per-frame batch (split_frame=True)."""

    audio: np.ndarray  # (B, window) float32
    verts: np.ndarray  # (B, V, 3) float32
    template_vert: np.ndarray  # (B, V, 3) float32
    one_hot: np.ndarray  # (B, 12) float32

    def asdict(self) -> dict[str, np.ndarray]:
        return {
            "audio": self.audio,
            "verts": self.verts,
            "template_vert": self.template_vert,
            "one_hot": self.one_hot,
        }


@dataclass
class ClipBatch:
    """Whole-clip batch (split_frame=False), padded to shape buckets with
    per-item valid lengths."""

    audio: np.ndarray  # (B, S16k) float32 @ 16 kHz
    audio_lengths: np.ndarray  # (B,) int32 valid samples
    verts: np.ndarray  # (B, T, V, 3) float32
    frame_lengths: np.ndarray  # (B,) int32 valid frames
    template_vert: np.ndarray  # (B, V, 3)
    one_hot: np.ndarray  # (B, 12)

    def asdict(self) -> dict[str, np.ndarray]:
        return {
            "audio": self.audio,
            "audio_lengths": self.audio_lengths,
            "verts": self.verts,
            "frame_lengths": self.frame_lengths,
            "template_vert": self.template_vert,
            "one_hot": self.one_hot,
        }


def resample_16k(wav: np.ndarray, sample_rate: int) -> np.ndarray:
    """A float32 clip resampled to 16 kHz on the host (the port's polyphase
    resampler, ``ops/dsp.py resample``)."""
    from audio2face_tpu_torch.ops.dsp import resample

    if int(sample_rate) == 16000:
        return np.asarray(wav, np.float32)
    return resample(torch.from_numpy(np.ascontiguousarray(wav, np.float32)),
                    int(sample_rate), 16000).numpy()


class ClipVocaSet:
    """Loads the four VOCASET artifacts and serves batches.

    ``datapath`` layout and split semantics mirror the reference;
    ``sample_rate`` is read from the audio records."""

    def __init__(
        self,
        datapath: str,
        phase: Literal["train", "val", "test", "all"] = "all",
        random_shift: bool = False,
        split_frame: bool = True,
        normalize: bool = True,
    ):
        if not split_frame and random_shift:
            raise ValueError("random_shift is not supported when split_frame is False")
        self.phase = phase
        self.datapath = os.path.abspath(datapath)
        self.random_shift = random_shift
        self.split_frame = split_frame
        self.normalize = normalize

        self.template_verts: Mapping[str, np.ndarray] = load_pickle(
            os.path.join(self.datapath, "templates.pkl")
        )
        self.raw_audio = load_pickle(os.path.join(self.datapath, "raw_audio_fixed.pkl"))
        self.data_verts = np.load(
            os.path.join(self.datapath, "data_verts.npy"), mmap_mode="r"
        )
        self.wav_seq_to_idx = load_pickle(
            os.path.join(self.datapath, "subj_seq_to_idx.pkl")
        )

        if not DataSplitRecorder.exists(self.datapath):
            self.split_recorder = DataSplitRecorder.build(
                self.raw_audio, self.wav_seq_to_idx, self.datapath
            )
        else:
            self.split_recorder = DataSplitRecorder.load(self.datapath)

        self.datalist_raw = self.split_recorder.get_list(phase)
        if split_frame:
            self.datalist = self.datalist_raw
        else:
            seen = {}
            for human_id, sentence_id, _, _ in self.datalist_raw:
                seen[(human_id, sentence_id)] = None
            self.datalist = list(seen.keys())

    def __len__(self) -> int:
        return len(self.datalist)

    # -- per-frame mode ----------------------------------------------------

    def gather_frames(
        self, indices: Sequence[int], rng: Optional[np.random.Generator] = None
    ) -> FrameBatch:
        """A FrameBatch of dataset rows ``indices``, gathered per clip; the
        +-500-sample shift applies when ``rng`` is given in the train phase."""
        from audio2face_tpu_torch.runtime import fragment_batch_i16, gather_rows_f32

        rows = [self.datalist[i] for i in indices]
        if not rows:
            raise ValueError(
                f"no frames selected from phase {self.phase!r}: check that the "
                "(subject, sentence) pair routes to this split"
            )
        n = len(rows)
        first_audio = self.raw_audio[rows[0][0]][rows[0][1]]
        sr = int(first_audio["sample_rate"])
        # one fragment window for the whole batch, from the first row's rate:
        # a batch that mixed rates would get misaligned fragments
        mixed = {
            int(self.raw_audio[h][s]["sample_rate"]) for h, s, _, _ in rows
        }
        if mixed != {sr}:
            raise ValueError(
                f"gather_frames requires one sample rate per batch, got {sorted(mixed)}"
            )
        n_pad = int(sr * FRAGMENT_SECONDS / 2)
        window = 2 * n_pad

        audio = np.empty((n, window), np.float32)
        template = np.empty((n,) + self.data_verts.shape[1:], np.float32)
        one_hot = np.empty((n, len(ALL_SUBJECTS)), np.float32)

        shifts = (
            rng.integers(-MAX_RANDOM_SHIFT, MAX_RANDOM_SHIFT + 1, n)
            if (rng is not None and self.random_shift and self.phase == "train")
            else np.zeros(n, np.int64)
        )

        # one native gather per clip: fragment = audio[idx*sr//fps - n_pad -
        # shift ...], zero past either end (the reference's padding)
        by_clip: dict[tuple[str, str], list[int]] = {}
        for i, (human_id, sentence_id, _, _) in enumerate(rows):
            by_clip.setdefault((human_id, sentence_id), []).append(i)
        for (human_id, sentence_id), positions in by_clip.items():
            rec = self.raw_audio[human_id][sentence_id]
            clip_sr = int(rec["sample_rate"])
            wav = rec["audio"]
            starts = np.asarray(
                [rows[i][2] * clip_sr // FPS - n_pad - shifts[i] for i in positions],
                np.int64,
            )
            if self.normalize and wav.dtype == np.int16:
                frags = fragment_batch_i16(wav, starts, window)
            else:
                frags = batch_audio_fragments(
                    wav, np.asarray([rows[i][2] for i in positions]),
                    sample_rate=clip_sr,
                    shifts=np.asarray([shifts[i] for i in positions]),
                )
                if self.normalize:
                    frags = normalize_audio(frags)
            audio[positions] = frags

        verts_idx = np.asarray([r[3] for r in rows], np.int64)
        verts = gather_rows_f32(self.data_verts, verts_idx)
        for i, (human_id, _, _, _) in enumerate(rows):
            template[i] = self.template_verts[human_id]
            one_hot[i] = get_human_id_one_hot(human_id)
        return FrameBatch(audio, verts, template, one_hot)

    # -- whole-clip mode ----------------------------------------------------

    def gather_clips(
        self,
        keys: Sequence[tuple[str, str]],
        audio_bucket: Optional[int] = None,
        frame_bucket: Optional[int] = None,
    ) -> ClipBatch:
        """A padded ClipBatch of (human_id, sentence_id) keys.

        Audio is resampled to 16 kHz on the host. Buckets default to the
        batch maximum rounded up (1600 samples / 6 frames = 0.1 s grain)."""
        clips = []
        for human_id, sentence_id in keys:
            rec = self.raw_audio[human_id][sentence_id]
            wav = normalize_audio(rec["audio"]) if self.normalize else rec["audio"].astype(np.float32)
            wav16 = resample_16k(wav, int(rec["sample_rate"]))
            idx_map = self.wav_seq_to_idx[human_id][sentence_id]
            v = np.stack([self.data_verts[i] for i in idx_map.values()]).astype(np.float32)
            clips.append((human_id, wav16, v))

        max_s = max(len(c[1]) for c in clips)
        s_bucket = audio_bucket or _round_up(max_s, 1600)
        # the model's frame axis is frame_count(s_bucket), so the vertex
        # bucket must equal it exactly (a clip a few samples past a 1600
        # grain would otherwise get fewer vertex rows than model frames);
        # vertex rows beyond the audio's frame clock are truncated
        f_bucket = frame_bucket or s_bucket * FPS // 16000

        n = len(clips)
        nv = clips[0][2].shape[1]
        audio = np.zeros((n, s_bucket), np.float32)
        audio_lengths = np.zeros(n, np.int32)
        verts = np.zeros((n, f_bucket, nv, 3), np.float32)
        frame_lengths = np.zeros(n, np.int32)
        template = np.zeros((n, nv, 3), np.float32)
        one_hot = np.zeros((n, len(ALL_SUBJECTS)), np.float32)
        for i, (human_id, wav16, v) in enumerate(clips):
            s = min(len(wav16), s_bucket)
            f = min(len(v), f_bucket, s * FPS // 16000)
            # keep the model's frame mask (audio_len * 60 // 16000) == f even
            # when the vertex track is shorter than the audio
            if s * FPS // 16000 > f:
                s = min(s, (f + 1) * 16000 // FPS - 1)
            audio[i, :s] = wav16[:s]
            audio_lengths[i] = s
            verts[i, :f] = v[:f]
            frame_lengths[i] = f
            template[i] = self.template_verts[human_id]
            one_hot[i] = get_human_id_one_hot(human_id)
        return ClipBatch(audio, audio_lengths, verts, frame_lengths, template, one_hot)

    def get_framedatas(self, human_id: str, sentence_id: str):
        """All rows of one (subject, sentence) in frame order: the predict
        path."""
        if self.split_frame:
            rows = [
                (i, row)
                for i, row in enumerate(self.datalist)
                if row[0] == human_id and row[1] == sentence_id
            ]
            rows.sort(key=lambda x: x[1][2])
            return self.gather_frames([i for i, _ in rows])
        return self.gather_clips([(human_id, sentence_id)])


# ---------------------------------------------------------------------------
# Data module (batch iterators)
# ---------------------------------------------------------------------------


class VocaDataModule:
    """Train/val/test ClipVocaSets and their batch iterators."""

    def __init__(
        self,
        datapath: str,
        batch_size: int = 32,
        num_workers: int = 0,  # accepted for the reference's surface; loading is vectorized
        random_shift: bool = False,
        split_frame: bool = True,
    ):
        self.datapath = datapath
        self.batch_size = batch_size
        self.random_shift = random_shift
        self.split_frame = split_frame
        self._datasets: dict[str, ClipVocaSet] = {}

    def setup(self, stage: Optional[str] = None) -> None:
        for phase in ("train", "val", "test"):
            self._datasets[phase] = ClipVocaSet(
                self.datapath,
                phase=phase,
                random_shift=self.random_shift and phase == "train",
                split_frame=self.split_frame,
            )

    @property
    def train_dataset(self) -> ClipVocaSet:
        return self._datasets["train"]

    @property
    def val_dataset(self) -> ClipVocaSet:
        return self._datasets["val"]

    @property
    def test_dataset(self) -> ClipVocaSet:
        return self._datasets["test"]

    def _frame_batches(
        self, ds: ClipVocaSet, shuffle: bool, drop_last: bool, rng: Optional[np.random.Generator]
    ) -> Iterator[dict[str, np.ndarray]]:
        order = np.arange(len(ds))
        if shuffle and rng is not None:
            rng.shuffle(order)
        bs = self.batch_size
        end = len(order) - (len(order) % bs) if drop_last else len(order)
        for i in range(0, end, bs):
            yield ds.gather_frames(order[i : i + bs], rng).asdict()

    def _clip_batches(self, ds: ClipVocaSet, shuffle: bool, rng) -> Iterator[dict[str, np.ndarray]]:
        order = np.arange(len(ds))
        if shuffle and rng is not None:
            rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order), bs):
            keys = [ds.datalist[j] for j in order[i : i + bs]]
            yield ds.gather_clips(keys).asdict()

    def train_batches(self, rng: np.random.Generator) -> Iterator[dict]:
        ds = self.train_dataset
        if self.split_frame:
            # drop_last + shuffle, like the reference's train loader
            return self._frame_batches(ds, shuffle=True, drop_last=True, rng=rng)
        return self._clip_batches(ds, shuffle=True, rng=rng)

    def val_batches(self) -> Iterator[dict]:
        ds = self.val_dataset
        if self.split_frame:
            return self._frame_batches(ds, shuffle=False, drop_last=False, rng=None)
        return self._clip_batches(ds, shuffle=False, rng=None)

    def predict_batch(self, human_id: str, sentence_id: str) -> dict:
        return self.test_dataset.get_framedatas(human_id, sentence_id).asdict()
