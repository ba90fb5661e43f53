"""The frame models' conv-block epilogue (``ops/frame_epilogue.py``): conv
bias, eval BatchNorm and ReLU in one pass.

On the CPU: the wrapper's plain version against the per-op composition the
models ran before it (a bias ``add_`` in the conv's dtype, ``TorchBatchNorm``
in eval, ``F.relu``), bit for bit in f32 and bf16; CPU tensors never build or
launch the kernel, and the models' CPU and training paths count no fused
block. On the card (skipped without CUDA): the kernel against its plain
version bit for bit at every Audio2Mesh block shape at 1,024 rows, an
Audio2Mesh ``FramePredictor`` request and one eval forward of each frame
model equal to the per-op composition written here, no launch in training
or under autograd, and ``conv_epilogues_fused`` equal to the launches."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.models import audio2mesh, layers
from audio2face_tpu_torch.models.layers import TorchBatchNorm
from audio2face_tpu_torch.ops import _build
from audio2face_tpu_torch.ops.frame_epilogue import frame_epilogue, frame_epilogue_reference
from audio2face_tpu_torch.registry import get_model
from audio2face_tpu_torch.serving import FramePredictor
from audio2face_tpu_torch.utils import spans

torch.set_num_threads(1)

N_VERTS = 300
# (C, H, W, bias, bn, relu) of each one-pass epilogue of Audio2Mesh, in order
AUDIO2MESH_BLOCKS = [
    (72, 64, 16, True, True, True), (108, 64, 8, True, True, True),
    (162, 64, 4, True, True, True), (243, 64, 2, True, True, True),
    (256, 64, 1, True, True, True),  # analysis0-4
    (256, 32, 1, True, True, True), (256, 16, 1, True, True, True),
    (256, 8, 1, True, True, True),  # artic0-2
    (256, 8, 1, False, True, False), (256, 4, 1, True, False, True),  # artic3_pre_bn, artic3
    (256, 4, 1, False, True, False), (256, 1, 1, True, False, True),  # artic4_pre_bn, artic4
]
# one-pass epilogues a forward of each frame model
BLOCKS = {"audio2mesh": len(AUDIO2MESH_BLOCKS), "voca": 4, "song2face": 9}
FEATURES = {"audio2mesh": (52, 32), "voca": (29, 16), "song2face": (52, 32)}
DTYPES = [torch.float32, torch.bfloat16]


def stages(c: int, dtype, bias: bool, bn: bool, seed: int, device="cpu"):
    """A conv bias in ``dtype`` and a BatchNorm in eval mode with statistics
    and affine drawn from ``seed``, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    norm = TorchBatchNorm(c)
    with torch.no_grad():
        s = norm.bn
        s.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
        s.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.05)
        s.weight.copy_(torch.randn(c, generator=g) * 0.3 + 1)
        s.bias.copy_(torch.randn(c, generator=g) * 0.2)
    b = (torch.randn(c, generator=g) * 0.1).to(dtype).to(device) if bias else None
    return b, (norm.to(device) if bn else None)


def conv_output(n, c, h, w, dtype, seed, device="cpu"):
    """A stand-in for a conv's output: unit-scale values, some exactly 0."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=g) * 2
    x[x.abs() < 0.05] = 0.0
    return x.to(dtype).to(device)


def composition(x, bias, norm, relu):
    """The per-op path: the bias ``add_`` after a conv, ``TorchBatchNorm`` in
    eval, ``F.relu``."""
    y = x.clone()
    if bias is not None:
        y.add_(bias[:, None, None])
    if norm is not None:
        y = norm(y, train=False)
    return F.relu(y) if relu else y


def affine(norm):
    return None if norm is None else norm.eval_affine()


# ---- CPU ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("bias, bn, relu", [
    (True, True, True), (False, True, False), (True, False, True), (True, False, False),
    (False, True, True),
])
def test_plain_version_equals_the_per_op_composition(dtype, bias, bn, relu):
    x = conv_output(6, 27, 4, 3, dtype, seed=1)
    b, norm = stages(27, dtype, bias, bn, seed=2)
    with torch.no_grad():
        want = composition(x, b, norm, relu)
        got = frame_epilogue(x, b, affine(norm), relu)
        into = frame_epilogue(x.clone(), b, affine(norm), relu, out=torch.empty_like(x))
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(into, want)
    assert frame_epilogue.launches == 0 and not _build._libs  # CPU tensors: the plain version


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = conv_output(2, 4, 3, 3, torch.bfloat16, seed=0)
    b, norm = stages(4, torch.bfloat16, True, True, seed=0)
    with pytest.raises(ValueError, match="NCHW"):
        frame_epilogue(x[0], b)
    with pytest.raises(ValueError, match="bias"):
        frame_epilogue(x, b.float())
    with pytest.raises(ValueError, match="f32"):
        frame_epilogue(x, bn=tuple(t.to(torch.bfloat16) for t in norm.eval_affine()))
    with pytest.raises(ValueError, match="f32 or bf16"):
        frame_epilogue(x.half())
    with pytest.raises(ValueError, match="out"):
        frame_epilogue(x, b, out=torch.empty(2, 4, 3, 4, dtype=torch.bfloat16))


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cpu_and_training_paths_count_no_fused_block(name, train):
    model = get_model(name)(n_verts=N_VERTS, n_onehot=12, dtype=torch.bfloat16)
    model.init_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(4, *FEATURES[name])).astype(np.float32))
    one_hot = torch.eye(12)[[0, 3, 5, 7]]
    template = torch.zeros(4, N_VERTS // 3, 3)
    with spans.recording() as rec, torch.set_grad_enabled(train):
        model(x, one_hot, template, train=train)
    assert rec.counters.get("conv_epilogues_fused", 0) == 0 and frame_epilogue.launches == 0


# ---- the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("block", range(len(AUDIO2MESH_BLOCKS)))
def test_kernel_equals_plain_version_at_audio2mesh_shapes(block, dtype, cuda):
    c, h, w, bias, bn, relu = AUDIO2MESH_BLOCKS[block]
    x = conv_output(1024, c, h, w, dtype, seed=block, device=cuda)
    b, norm = stages(c, dtype, bias, bn, seed=100 + block, device=cuda)
    with torch.inference_mode():
        want = frame_epilogue_reference(x, b, affine(norm), relu)
        got = frame_epilogue(x, b, affine(norm), relu)
        inplace = x.clone()
        frame_epilogue(inplace, b, affine(norm), relu, out=inplace)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(inplace, want)
    assert torch.equal(want, composition(x, b, norm, relu))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel_scalar_path_and_rows_past_the_grid(dtype, cuda):
    """A view 2 elements into its storage (no 16-byte alignment, the scalar
    path) and 70,000 rows (past grid.y's 65,535)."""
    for shape, offset in (((64, 8, 4, 2), 2), ((70_000, 3, 1, 1), 0)):
        n = int(np.prod(shape))
        flat = conv_output(1, 1, 1, n + offset, dtype, seed=n, device=cuda).reshape(-1)
        x = flat[offset:].view(shape)
        b, norm = stages(shape[1], dtype, True, True, seed=5, device=cuda)
        with torch.inference_mode():
            got = frame_epilogue(x, b, affine(norm), True)
            want = frame_epilogue_reference(x, b, affine(norm), True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape


def per_op_block(conv, bn, x, train, dtype, relu=True):
    """The conv block as the models ran it before the one-pass epilogue:
    cuDNN's conv with its bias, the BatchNorm's f32 formula, ReLU."""
    c = conv.conv
    y = F.conv2d(x.to(dtype), c.weight.to(dtype), c.bias.to(dtype), stride=c.stride,
                 padding=c.padding)
    if bn is not None:
        y = per_op_batchnorm(bn, y, train)
    return F.relu(y) if relu else y


def per_op_batchnorm(self, x, train):
    s = self.bn
    mul = torch.rsqrt(s.running_var + layers.BN_EPS) * s.weight
    y = (x.float() - s.running_mean[:, None, None]) * mul[:, None, None] + s.bias[:, None, None]
    return y.to(x.dtype)


def use_per_op_path(monkeypatch):
    monkeypatch.setattr(layers, "conv_block", per_op_block)
    monkeypatch.setattr(audio2mesh, "conv_block", per_op_block)
    monkeypatch.setattr(TorchBatchNorm, "forward", per_op_batchnorm)


def randomize_biases_and_statistics(model, seed: int):
    """Non-zero conv biases and BatchNorm statistics and affines (the init
    leaves them 0 and 1, which would hide a stage)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.05)
            elif isinstance(m, TorchBatchNorm):
                c = m.bn.weight.shape[0]
                m.bn.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.bn.weight.copy_(torch.randn(c, generator=g) * 0.1 + 1)
                m.bn.bias.copy_(torch.randn(c, generator=g) * 0.1)


def test_audio2mesh_request_equals_the_per_op_path(cuda, monkeypatch):
    cfg = ExpConfig(batch_size=8, modelname="audio2mesh", vertex_count=N_VERTS, one_hot_size=12,
                    feature_extractor="mfcc", sample_rate=22000, split_frame=True, n_feature=32,
                    out_dim=52, win_length=440, percision="16-mixed", lr=1e-3)
    pred = FramePredictor(cfg, max_batch=4, frame_batch=64, bucket_seconds=1.0, seed=3, device=cuda)
    randomize_biases_and_statistics(pred.model, seed=4)
    rng = np.random.default_rng(0)
    audios = [(rng.normal(size=int(s * 22000)) * 0.1).astype(np.float32) for s in (0.7, 2.3, 1.4)]
    one_hot = np.eye(12, dtype=np.float32)[[1, 5, 11]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    frame_epilogue.launches = 0
    with spans.recording() as rec:
        got = pred(audios, one_hot, template)
    chunks = sum(1 for sp in rec.spans if sp.name == "predict.model")
    assert chunks == 3  # one group of 3 clips: 138 frames in chunks of 64
    assert rec.counters["conv_epilogues_fused"] == frame_epilogue.launches == BLOCKS["audio2mesh"] * chunks
    use_per_op_path(monkeypatch)
    frame_epilogue.launches = 0
    want = pred(audios, one_hot, template)
    assert frame_epilogue.launches == 0
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_eval_forward_equals_the_per_op_path(name, dtype, cuda, monkeypatch):
    model = get_model(name)(n_verts=N_VERTS, n_onehot=12, dtype=dtype)
    model.init_parameters(torch.Generator().manual_seed(1))
    randomize_biases_and_statistics(model, seed=2)
    model.eval().to(cuda)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(96, *FEATURES[name])).astype(np.float32), device=cuda)
    one_hot = torch.eye(12, device=cuda)[rng.integers(0, 12, 96)]
    template = torch.as_tensor(rng.normal(size=(96, N_VERTS // 3, 3)).astype(np.float32),
                               device=cuda)
    frame_epilogue.launches = 0
    with torch.inference_mode(), spans.recording() as rec:
        got = model(x, one_hot, template, train=False)
    assert rec.counters["conv_epilogues_fused"] == frame_epilogue.launches == BLOCKS[name]
    use_per_op_path(monkeypatch)
    with torch.inference_mode():
        want = model(x, one_hot, template, train=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_training_and_autograd_launch_no_kernel(name, cuda):
    model = get_model(name)(n_verts=N_VERTS, n_onehot=12, dtype=torch.bfloat16)
    model.init_parameters(torch.Generator().manual_seed(1))
    model.to(cuda)
    x = torch.randn(8, *FEATURES[name], device=cuda)
    one_hot = torch.eye(12, device=cuda)[:8]
    template = torch.zeros(8, N_VERTS // 3, 3, device=cuda)
    frame_epilogue.launches = 0
    with spans.recording() as rec:
        model.train()
        model(x, one_hot, template, train=True).square().mean().backward()
        model.eval()
        model(x, one_hot, template, train=False).square().mean().backward()  # eval under autograd
    torch.cuda.synchronize()
    assert frame_epilogue.launches == 0 and rec.counters.get("conv_epilogues_fused", 0) == 0
