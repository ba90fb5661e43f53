"""The port's own copies of the numpy/scipy helpers (mesh I/O, waveform
decoding, synthetic demo assets) against the JAX package's, and its CLIs on
the CPU at a tiny size."""

import io
import os

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from audio2face_tpu.data import synthetic as jsyn
from audio2face_tpu.utils import audio_io as jaudio
from audio2face_tpu.utils import facemesh as jmesh
from audio2face_tpu_torch.cli import infer, render_frames, render_offline
from audio2face_tpu_torch.data import synthetic as syn
from audio2face_tpu_torch.utils import audio_io, facemesh

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores
torch.set_num_threads(1)


def _write_ply(path, verts, faces, binary):
    header = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
              f"element vertex {len(verts)}", "property float x", "property float y",
              "property float z", f"element face {len(faces)}",
              "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(verts.astype("<f4").tobytes())
            for face in faces:
                f.write(np.uint8(len(face)).tobytes() + np.asarray(face, "<i4").tobytes())
        else:
            for v in verts:
                f.write((" ".join(f"{x:.6f}" for x in v) + "\n").encode())
            for face in faces:
                f.write((f"{len(face)} " + " ".join(str(i) for i in face) + "\n").encode())


def test_obj_round_trip_and_parser_cases(tmp_path):
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(7, 3))
    faces = np.asarray([[0, 1, 2], [2, 3, 4], [4, 5, 6]])
    mesh = facemesh.FaceMesh(verts, faces)
    path = str(tmp_path / "m.obj")
    mesh.save(path)
    back = facemesh.FaceMesh.load(path)
    np.testing.assert_allclose(back.verts, verts, atol=1e-8)
    np.testing.assert_array_equal(back.faces, faces)
    assert (back.n_verts, back.n_faces) == (7, 3) and repr(back) == "FaceMesh(n_verts=7, n_faces=3)"
    # /vt/vn suffixes, relative indices and a quad (fan-triangulated), as the JAX parser reads them
    with open(path, "a") as f:
        f.write("f 1/1/1 2/2/2 3/3/3\nf -1 -2 -3\nf 1 2 3 4\n")
    for got, want in zip(facemesh.load_obj(path), jmesh.load_obj(path)):
        np.testing.assert_array_equal(got, want)
    assert len(facemesh.load_obj(path)[1]) == 7
    copy = mesh.copy()
    copy.set_verts(verts * 2)
    np.testing.assert_array_equal(mesh.verts, verts)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        facemesh.FaceMesh(np.zeros((3, 2)), faces)
    with pytest.raises(ValueError, match="Unsupported"):
        facemesh.FaceMesh.load(__file__)
    with pytest.raises(FileNotFoundError):
        facemesh.FaceMesh.load(str(tmp_path / "missing.obj"))
    with pytest.raises(ValueError, match="obj"):
        mesh.save(str(tmp_path / "m.ply"))


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_ply_parser_matches_jax(tmp_path, binary):
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(6, 3)).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5]]  # a triangle and a quad
    path = str(tmp_path / "m.ply")
    _write_ply(path, verts, faces, binary)
    got_v, got_f = facemesh.load_ply(path)
    want_v, want_f = jmesh.load_ply(path)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_allclose(got_v, verts, atol=1e-6)
    assert got_f.tolist() == [[0, 1, 2], [2, 3, 4], [2, 4, 5]]
    facemesh.convert_ply_to_obj(path, str(tmp_path / "m.obj"))
    assert facemesh.FaceMesh.load(str(tmp_path / "m.obj")).n_faces == 3


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_pcm_to_float32_every_dtype(dtype):
    rng = np.random.default_rng(2)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        wav = rng.integers(info.min, info.max, size=(500, 2), dtype=dtype, endpoint=True)
    else:
        wav = rng.uniform(-1, 1, size=(500, 2)).astype(dtype)
    for w in (wav, wav[:, 0]):
        got = audio_io.pcm_to_float32(w)
        np.testing.assert_array_equal(got, jaudio.pcm_to_float32(w))
        assert got.dtype == np.float32 and got.ndim == 1 and np.abs(got).max() <= 1.0


def test_read_wav_path_and_bytes(tmp_path):
    pcm = (np.sin(np.arange(800) / 10) * 20000).astype(np.int16)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, 22050, pcm)
    a, sr = audio_io.read_wav(path)
    body = io.BytesIO()
    wavfile.write(body, 22050, pcm)
    b, sr_b = audio_io.read_wav(body.getvalue())
    assert sr == sr_b == 22050
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, jaudio.read_wav(path)[0])


def test_synthetic_assets_match_jax(tmp_path):
    for n in (5023, 60, 5):
        a = syn.generate_synthetic_face_obj(str(tmp_path / f"p{n}.obj"), n)
        b = jsyn.generate_synthetic_face_obj(str(tmp_path / f"j{n}.obj"), n)
        assert open(a).read() == open(b).read()
        assert facemesh.FaceMesh.load(a).n_verts == n
    with pytest.raises(ValueError, match="at least 5"):
        syn.generate_synthetic_face_obj(str(tmp_path / "x.obj"), 4)
    obj = str(tmp_path / "p60.obj")
    syn.generate_demo_animation(obj, str(tmp_path / "p.npy"), seconds=0.1)
    jsyn.generate_demo_animation(obj, str(tmp_path / "j.npy"), seconds=0.1)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy"))
    np.testing.assert_array_equal(syn.synthesize_speech_like(0.3, seed=3),
                                  jsyn.synthesize_speech_like(0.3, seed=3))
    paths = syn.generate_demo_assets(str(tmp_path / "assets"), n_verts=60, seconds=0.1)
    assert all(os.path.getsize(p) > 0 for p in paths.values())
    assert np.load(paths["verts"]).shape == (6, 60, 3)


def test_render_clis_on_the_cpu(tmp_path):
    """A 60-vertex head (coarse triangles: the banded path) through both
    render CLIs, from generated assets to a video and PNG frames."""
    assets = tmp_path / "assets"
    out = tmp_path / "out"
    paths = syn.generate_demo_assets(str(assets), n_verts=60, seconds=2 / 60)
    render_offline.main(["--template", paths["template"], "--verts", paths["verts"],
                         "--output", str(out), "--device", "cpu"])
    assert os.path.getsize(out / "tmp.mp4") > 0
    np.save(assets / "two.npy", np.load(paths["verts"])[:2])
    render_frames.main(["--template", paths["template"], "--verts", str(assets / "two.npy"),
                        "--output", str(out / "frames"), "--device", "cpu"])
    import cv2

    frame = cv2.imread(str(out / "frames" / "render_1.png"))
    assert frame.shape == (800, 800, 3) and (frame != 255).any()
    assert os.path.getsize(out / "frames" / "render.mp4") > 0


def test_infer_cli_on_the_cpu(tmp_path):
    """Random weights (smoke mode), BIWI and vocaset, f32 on the CPU."""
    template = syn.generate_synthetic_face_obj(str(tmp_path / "face.obj"), 60)
    wav = str(tmp_path / "clip.wav")
    wavfile.write(wav, 22000, (syn.synthesize_speech_like(0.4, seed=1) * 32767).astype(np.int16))
    base = ["--audio", wav, "--template", template, "--output", str(tmp_path / "out"),
            "--device", "cpu", "--f32", "--batch", "1"]
    infer.main(base + ["--dataset", "biwi"])
    verts = np.load(tmp_path / "out" / "clip_verts.npy")
    n16 = -(-8800 * 8 // 11)  # 0.4 s at 22 kHz, resampled to 16 kHz
    assert verts.shape == (n16 * 25 // 16000, 60, 3) and np.isfinite(verts).all()
    # --checkpoint, --torch-checkpoint and --config work
    # (test_infer_cli_frame_models_and_checkpoints), --streaming too
    # (test_infer_cli_streaming_on_the_cpu), for vocaset weights only
    with pytest.raises(SystemExit, match="only vocaset"):
        infer.main(base + ["--dataset", "biwi", "--streaming"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA is not available (skipped: a GPU is present)")
        infer.main([a for a in base if a not in ("--device", "cpu")])


def test_infer_cli_frame_models_and_checkpoints(tmp_path):
    """--config serves a frame model; --checkpoint takes the port trainer's
    checkpoint and --torch-checkpoint a reference Lightning one, whose
    vertices equal the predictor's own on the same weights."""
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.serving import FramePredictor
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment
    from tests.torch_mirrors import TorchVoca

    template = syn.generate_synthetic_face_obj(str(tmp_path / "face.obj"), 60)
    wav = str(tmp_path / "clip.wav")
    wavfile.write(wav, 22000, (syn.synthesize_speech_like(0.4, seed=2) * 32767).astype(np.int16))
    out = tmp_path / "out"
    base = ["--audio", wav, "--template", template, "--output", str(out), "--device", "cpu",
            "--batch", "1"]
    configs = {}
    for name, extra in (("audio2mesh", ""), ("voca", "n_feature: 16\nout_dim: 29\nwin_length: 790\n")):
        path = tmp_path / f"{name}.yaml"
        path.write_text(f'modelname: "{name}"\nbatch_size: 2\nvertex_count: 180\none_hot_size: 12\n'
                        f'split_frame: True\npercision: "32"\nlr: 1e-4\nfeature_extractor: "mfcc"\n'
                        f'sample_rate: 22000\nn_feature: 32\nout_dim: 52\nwin_length: 440\n{extra}')
        configs[name] = str(path)
    infer.main(base + ["--config", configs["audio2mesh"]])
    assert np.load(out / "clip_verts.npy").shape == (24, 60, 3)

    exp = Audio2FaceExperiment(ExpConfig.from_yaml(configs["audio2mesh"]), log_dir=str(tmp_path / "run"),
                               device="cpu")
    ckpt = exp.save_checkpoint(epoch=0)
    infer.main(base + ["--config", configs["audio2mesh"], "--checkpoint", ckpt])
    clip = audio_io.read_wav(wav)[0]
    mesh = facemesh.FaceMesh.load(template)
    want = FramePredictor.from_checkpoint(ckpt, exp.config, max_batch=1, device="cpu")(
        [clip], np.eye(12, dtype=np.float32)[[0]], np.asarray(mesh.verts, np.float32))[0]
    np.testing.assert_array_equal(np.load(out / "clip_verts.npy"), want)

    torch.manual_seed(0)
    sd = {f"model.{k}": v for k, v in TorchVoca(180, 12).state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "voca.ckpt")
    infer.main(base + ["--config", configs["voca"], "--torch-checkpoint", str(tmp_path / "voca.ckpt")])
    verts = np.load(out / "clip_verts.npy")
    assert verts.shape == (24, 60, 3) and np.isfinite(verts).all()
    with pytest.raises(SystemExit, match="frame models"):
        faceformer = tmp_path / "ff.yaml"
        faceformer.write_text(open(configs["voca"]).read().replace('"voca"', '"faceformer"'))
        infer.main(base + ["--config", str(faceformer)])


def test_infer_cli_streaming_on_the_cpu(tmp_path, capsys):
    """--streaming decodes FaceFormer through StreamingFaceFormerPredictor and
    a frame model (--config) through a FrameStreamPool slot, end to end on
    the CPU, and prints the per-chunk (per-packet) latency."""
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.serving import FramePredictor
    from audio2face_tpu_torch.streaming import StreamingFaceFormerPredictor

    template = syn.generate_synthetic_face_obj(str(tmp_path / "face.obj"), 60)
    wav = str(tmp_path / "clip.wav")
    wavfile.write(wav, 22000, (syn.synthesize_speech_like(0.5, seed=3) * 32767).astype(np.int16))
    out = tmp_path / "out"
    base = ["--audio", wav, "--template", template, "--output", str(out), "--device", "cpu",
            "--batch", "1", "--streaming"]
    infer.main(base + ["--f32", "--chunk-seconds", "0.2", "--left-seconds", "0.2",
                       "--lookahead-seconds", "0.1"])
    verts = np.load(out / "clip_verts.npy")
    clip, sr = audio_io.read_wav(wav)
    n16 = -(-len(clip) * 8 // 11)  # resampled to 16 kHz
    assert verts.shape == (n16 * 60 // 16000, 60, 3) and np.isfinite(verts).all()
    assert "ms compute/chunk" in capsys.readouterr().out
    # the same stream, run directly on the CLI's (seed 0) weights
    stream = StreamingFaceFormerPredictor(n_verts=180, chunk_seconds=0.2, left_seconds=0.2,
                                          lookahead_seconds=0.1, device="cpu")
    mesh = facemesh.FaceMesh.load(template)
    stream.start_stream(np.eye(12, dtype=np.float32)[0], np.asarray(mesh.verts, np.float32))
    from audio2face_tpu_torch.ops.dsp import resample

    audio16 = resample(torch.as_tensor(clip), sr, 16000).numpy()
    want = np.concatenate([stream.push(audio16[i : i + 1600]) for i in range(0, len(audio16), 1600)]
                          + [stream.flush()])
    np.testing.assert_array_equal(verts, want)

    cfg_path = tmp_path / "audio2mesh.yaml"
    cfg_path.write_text('modelname: "audio2mesh"\nbatch_size: 2\nvertex_count: 180\none_hot_size: 12\n'
                        'split_frame: True\npercision: "32"\nlr: 1e-4\nfeature_extractor: "mfcc"\n'
                        'sample_rate: 22000\nn_feature: 32\nout_dim: 52\nwin_length: 440\n')
    infer.main(base + ["--config", str(cfg_path)])
    got = np.load(out / "clip_verts.npy")
    assert "ms compute/100 ms packet" in capsys.readouterr().out
    want = FramePredictor(ExpConfig.from_yaml(str(cfg_path)), max_batch=1, device="cpu")(
        [clip], np.eye(12, dtype=np.float32)[[0]], np.asarray(mesh.verts, np.float32))[0]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
