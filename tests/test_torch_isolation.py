"""The port stands alone: it imports neither JAX, flax nor the JAX package
(nor, at module level, pydantic, optax, orbax, tensorboardX, yaml or cv2,
which the GPU machine lacks), its entry points refuse to fall back to the CPU, and
CPU tensors go through the plain versions, forward and backward, without
launching (or building) any kernel."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORTS = r'''
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "audio2face_tpu", "pydantic", "optax", "orbax",
           "tensorboardX", "yaml", "cv2")

def blocked(name):
    # exact package or its submodules: "audio2face_tpu_torch" is NOT blocked
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"the port must not import {name}")
        return None

assert not blocked("audio2face_tpu_torch") and blocked("audio2face_tpu.ops")
sys.meta_path.insert(0, Blocker())
import audio2face_tpu_torch
names = [m.name for m in pkgutil.walk_packages(audio2face_tpu_torch.__path__, "audio2face_tpu_torch.")]
for name in ("cli.train", "cli.serve", "cli.evaluate", "cli.export", "evaluation",
             "compat.torch_export", "parallel", "parallel.comm", "parallel.mesh",
             "parallel.fsdp", "parallel.sequence", "parallel.pipeline", "parallel.dryrun"):
    assert "audio2face_tpu_torch." + name in names, name
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
from audio2face_tpu_torch.ops import _build
assert not _build._libs, "importing the port loaded kernels"
# the package's top-level surface resolves without JAX or a kernel
for name in ("ExpConfig", "get_model", "get_extractor", "get_loss_fn", "VertexRegions",
             "evaluate_animation", "infer_regions", "FaceFormerPredictor", "ServingDaemon",
             "make_mesh", "dryrun_multichip"):
    getattr(audio2face_tpu_torch, name)
assert audio2face_tpu_torch.__version__ and not _build._libs
print(len(names))
'''


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 50  # every module of the port so far


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FaceFormerPredictor(n_verts=30)


def test_renderer_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from audio2face_tpu_torch.utils.facemesh import FaceMesh
    from audio2face_tpu_torch.utils.renderer import Renderer

    mesh = FaceMesh(np.zeros((3, 3), np.float32), np.asarray([[0, 1, 2]]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(mesh)


def test_cpu_tensors_take_plain_versions():
    from audio2face_tpu_torch.models.faceformer import FaceFormer
    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from audio2face_tpu_torch.ops import _build
    from audio2face_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from audio2face_tpu_torch.ops.conv_encoder import fused_conv_encoder
    from audio2face_tpu_torch.ops.decode_kernel import faceformer_decode_loop
    from audio2face_tpu_torch.ops.rasterizer import rasterize_keys
    from audio2face_tpu_torch.utils.facemesh import FaceMesh
    from audio2face_tpu_torch.utils.renderer import Renderer

    wrappers = (flash_attention, flash_attention_bwd, fused_conv_encoder, faceformer_decode_loop,
                rasterize_keys)
    for w in wrappers:
        w.launches = 0
    faceformer_decode_loop.biwi_launches = 0
    # bf16 takes the fused conv-encoder wrapper; every wrapper sees CPU tensors
    model = FaceFormer(30, 12, dtype=torch.bfloat16, encoder_config=Wav2Vec2Config(num_layers=1))
    model.init_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    audio = torch.tensor((rng.normal(size=(2, 4000)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        out, mask = model(audio, torch.eye(12)[:2], torch.zeros(2, 10, 3),
                          torch.tensor([4000, 2500]))
    assert out.shape == (2, 15, 10, 3) and torch.isfinite(out).all()
    assert mask.sum(dim=1).tolist() == [15.0, 9.0]
    # a training pass: attention with dropout forward and backward
    hs, _ = model(audio, torch.eye(12)[:2], torch.zeros(2, 10, 3), torch.tensor([4000, 2500]),
                  train=True, return_hidden=True, generator=torch.Generator().manual_seed(0))
    hs.float().sum().backward()
    assert model.audio_encoder.feature_projection.projection.weight.grad is not None
    # the BIWI model: the decode wrapper's 2-way cross-softmax variant
    biwi = FaceFormer(30, 12, dataset="biwi", period=25, dtype=torch.bfloat16,
                      encoder_config=Wav2Vec2Config(num_layers=1))
    biwi.init_parameters(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out, mask = biwi(audio, torch.eye(12)[:2], torch.zeros(2, 10, 3), torch.tensor([4000, 2500]))
    assert out.shape == (2, 6, 10, 3) and torch.isfinite(out).all()
    assert mask.sum(dim=1).tolist() == [6.0, 3.0]
    # the tile rasterizer through the renderer's tiled path
    tri = FaceMesh(np.asarray([[-0.05, -0.05, 0.5], [0.05, -0.05, 0.5], [0.0, 0.05, 0.5]], np.float32),
                   np.asarray([[0, 1, 2]]))
    frames = Renderer(tri, device="cpu")._render_frames_tiled(np.asarray(tri.verts)[None])
    assert frames[0].shape == (800, 800, 3) and (frames[0] != 255).any()
    assert [w.launches for w in wrappers] == [0, 0, 0, 0, 0]
    assert faceformer_decode_loop.biwi_launches == 0
    assert not _build._libs


def test_frame_entry_points_refuse_the_cpu_unless_asked():
    """FramePredictor and the trainer on a frame model run on the GPU by
    default and never fall back; asked for the CPU, the wav2vec2 extractor
    sends its attention through the kernel wrapper's plain version."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.models.extractor import Wav2VecExtractor
    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from audio2face_tpu_torch.ops import _build
    from audio2face_tpu_torch.ops.attention import flash_attention
    from audio2face_tpu_torch.serving import FramePredictor
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    cfg = ExpConfig(batch_size=2, modelname="audio2mesh", one_hot_size=12, feature_extractor="mfcc",
                    sample_rate=22000, vertex_count=30, split_frame=True, n_feature=32, out_dim=52,
                    win_length=440)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FramePredictor(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Audio2FaceExperiment(cfg.model_copy(update={"modelname": "song2face"}))
    assert FramePredictor(cfg, device="cpu").device.type == "cpu"
    flash_attention.launches = 0
    fe = Wav2VecExtractor(22000, 32, 52, config=Wav2Vec2Config(num_layers=1))
    out = fe(torch.zeros(2, 11440))
    assert out.shape == (2, 52, 32) and flash_attention.launches == 0 and not _build._libs
