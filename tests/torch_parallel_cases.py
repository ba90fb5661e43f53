"""Rank-side cases of the port's multi-rank tests (``tests/torch_gloo.py``
runs them on spawned gloo ranks). Torch and the port only: every rank
imports this module afresh, and JAX stays in the pytest process, which
compares what the ranks return with the JAX package and with the port's
solo runs. Each ``*_cases(rank, data)`` runs all cases of one test file and
returns a dict of numpy results; solo baselines are computed by rank 0."""

from __future__ import annotations

import numpy as np
import torch

# the trainer's tiny FaceFormer: FSDP shards intermediate_dense (64 x 512
# is MIN_FSDP_ELEMS) and the vertex head (V3 x 64)
V3 = 600
ENC = dict(conv_dim=(32,) * 7, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=512, pos_conv_kernel=16, pos_conv_groups=4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def ff_config(**kw):
    from audio2face_tpu_torch.config import ExpConfig

    base = dict(batch_size=4, modelname="faceformer", one_hot_size=12, feature_extractor=None,
                sample_rate=16000, vertex_count=V3, split_frame=False, n_feature=32,
                out_dim=52, win_length=440, percision="32", lr=1e-4, seed=3)
    return ExpConfig(**{**base, **kw})


def ff_batch(seed: int, b: int = 4, samples: int = 4000) -> dict:
    rng = np.random.default_rng(seed)
    t = samples * 60 // 16000
    return {
        "audio": (rng.normal(size=(b, samples)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[rng.integers(0, 12, b)],
        "verts": (rng.normal(size=(b, t, V3)) * 0.01).astype(np.float32),
        "template_vert": (rng.normal(size=(b, V3 // 3, 3)) * 0.01).astype(np.float32),
        "audio_lengths": np.asarray([samples, 3000, 2000, 3500, 4000, 2500, 3800, 1600][:b],
                                    np.int32),
    }


def frame_config(**kw):
    from audio2face_tpu_torch.config import ExpConfig

    base = dict(batch_size=8, modelname="audio2mesh", vertex_count=180, one_hot_size=12,
                feature_extractor="mfcc", sample_rate=22000, split_frame=True, n_feature=32,
                out_dim=52, win_length=440, percision="32", lr=1e-4)
    return ExpConfig(**{**base, **kw})


def frame_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "audio": (rng.normal(size=(8, 11440)) * 0.1).astype(np.float32),
        "verts": (rng.normal(size=(8, 60, 3)) * 0.01).astype(np.float32),
        "template_vert": (rng.normal(size=(8, 60, 3)) * 0.01).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[rng.integers(0, 12, 8)],
    }


def _experiment(config, **kw):
    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    model_kwargs = {"encoder_config": Wav2Vec2Config(**ENC)} if config.modelname == "faceformer" else {}
    return Audio2FaceExperiment(config, device="cpu", tensorboard=False,
                                model_kwargs=model_kwargs, **kw)


def _one_step(exp, batch) -> dict:
    """One training step's metrics and the whole state after it."""
    with torch.enable_grad():
        metrics = exp.train_step(batch)
    state = exp.state_dict()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": _np(state["model"]), "step": state["step"]}


def _one_gradient(exp, batch) -> dict:
    """One batch's metrics, gradients (whole on every rank: no FSDP or TP
    here) and the BatchNorm running statistics its forward left."""
    with torch.enable_grad():
        metrics = exp.accumulate_gradients(batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: _np(p.grad) for n, p in exp.model.named_parameters()},
            "buffers": {n: _np(b) for n, b in exp.model.named_buffers()}}


def gradient_case(rank: int, shape, config, batch) -> dict:
    """The sharded gradient on a ``shape`` mesh and, on rank 0, the solo one."""
    from audio2face_tpu_torch.parallel.mesh import make_mesh

    out = {"sharded": _one_gradient(_experiment(config, mesh=make_mesh(shape)), batch)}
    if rank == 0:
        out["solo"] = _one_gradient(_experiment(config), batch)
    return out


def trainer_step_case(rank: int, shape, fsdp: bool, config, batch) -> dict:
    """The sharded step on a ``shape`` mesh and, on rank 0, the solo step."""
    from audio2face_tpu_torch.parallel import comm
    from audio2face_tpu_torch.parallel.mesh import make_mesh

    comm.reset_counts()
    exp = _experiment(config, mesh=make_mesh(shape), fsdp=fsdp)
    out = {"sharded": _one_step(exp, batch), "tensor_parallel": exp.tensor_parallel,
           "fsdp": exp.fsdp, "collectives": dict(comm.COUNTS)}
    if rank == 0:
        out["solo"] = _one_step(_experiment(config), batch)
    return out


# ---- tests/test_torch_parallel.py -------------------------------------------


def parallel_cases(rank: int, data: dict) -> dict:
    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from audio2face_tpu_torch.parallel import comm
    from audio2face_tpu_torch.parallel.mesh import (
        MODEL_AXIS, make_mesh, replicate, shard_batch,
        shard_params_tensor_parallel)

    out: dict = {"mesh_shapes": {}, "mesh_errors": {}}
    for shape in ((4, 1), (2, 2), (-1, 1), (-1, 2), (1, -1)):
        out["mesh_shapes"][shape] = tuple(make_mesh(shape).mesh.shape)
    for shape in ((3, 2), (-1, -1)):
        try:
            make_mesh(shape)
        except ValueError as e:
            out["mesh_errors"][shape] = str(e)
    # shard_batch: each rank its rows along data; odd tails and scalars whole
    mesh = make_mesh((4, 1))
    placed = shard_batch(mesh, {"audio": np.arange(16 * 3).reshape(16, 3), "odd": np.arange(5),
                                "scalar": np.float32(2.0)})
    out["shard_batch"] = {k: v.numpy() for k, v in placed.items()}
    # replicate: rank 0's values on every rank
    out["replicated"] = replicate(mesh, {"w": np.full((2,), float(rank))})["w"].numpy()

    # a data-parallel gradient step == the single-device one
    w = torch.tensor(data["w"], requires_grad=True)
    xs = shard_batch(mesh, {"x": data["x"], "y": data["y"]})
    loss = ((xs["x"] @ w - xs["y"]) ** 2).sum() / (data["x"].shape[0] * data["y"].shape[1])
    loss.backward()
    out["dp_grad"] = comm.all_reduce(w.grad, None).numpy()

    # the Megatron forward against the JAX unsharded encoder (data["tp"])
    tp = data["tp"]
    mesh22 = make_mesh((2, 2))
    enc = Wav2Vec2Encoder(Wav2Vec2Config(**tp["config"]))
    enc.load_state_dict({k: torch.tensor(v) for k, v in tp["state"].items()})
    shard_params_tensor_parallel(mesh22, enc)
    layer = enc.layers[0]
    out["tp_local_shapes"] = {n: tuple(p.shape) for n, p in layer.named_parameters()}
    x = shard_batch(mesh22, {"x": tp["audio"]})["x"]
    with torch.no_grad():
        y = enc(x)
    out["tp_forward"] = comm.all_gather(y, 0, mesh22.get_group("data")).numpy()
    # the model group holds one layer's halves: gathered, the whole layer
    q = comm.all_gather(layer.q_proj.weight.detach(), 0, mesh22.get_group(MODEL_AXIS))
    out["tp_q_gathered"] = q.numpy()

    # trainer steps with dropout on: DP (4 x 1), DP x TP (2 x 2)
    out["dp_step"] = trainer_step_case(rank, (4, 1), False, ff_config(), ff_batch(0))
    out["dp_tp_step"] = trainer_step_case(rank, (2, 2), False, ff_config(), ff_batch(0))
    # a frame model with BatchNorm: the batch moments of the whole batch.
    # Its gradients, not Adam's step: the conv biases before a BatchNorm
    # have none analytically, so Adam scales their rounding noise to lr
    out["bn_gradient"] = gradient_case(rank, (4, 1), frame_config(), frame_batch(0))
    return out


# ---- tests/test_torch_fsdp.py ------------------------------------------------


def fsdp_cases(rank: int, data: dict) -> dict:
    from torch.distributed.tensor import DTensor

    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from audio2face_tpu_torch.parallel.dryrun import dryrun_multichip
    from audio2face_tpu_torch.parallel.fsdp import shard_state_fsdp, state_memory_bytes
    from audio2face_tpu_torch.parallel.mesh import make_mesh

    out: dict = {}

    def placements(module):
        return {n: (tuple(repr(p) for p in v.placements) if isinstance(v, DTensor) else "whole",
                    tuple(v.to_local().shape if isinstance(v, DTensor) else v.shape))
                for n, v in module.named_parameters()}

    # placement of a tree under TP x FSDP on a 2 x 2 mesh
    tree = torch.nn.Module()
    tree.audio_encoder = Wav2Vec2Encoder(Wav2Vec2Config(
        conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2), num_layers=1))
    tree.vertice_map = torch.nn.Linear(128, 15069)
    whole = state_memory_bytes(tree)
    shard_state_fsdp(make_mesh((2, 2)), tree, tensor_parallel=True)
    out["placements"] = placements(tree)
    out["memory"] = (whole, state_memory_bytes(tree))

    # the trainer: DP x TP x FSDP against the solo step, dropout on
    step = trainer_step_case(rank, (2, 2), True, ff_config(), ff_batch(0))
    out["fsdp_tp_step"] = step
    exp = _experiment(ff_config(), mesh=make_mesh((2, 2)), fsdp=True)
    out["fsdp_tp_placements"] = placements(exp.model.audio_encoder.layers[0])
    with torch.enable_grad():
        exp.train_step(ff_batch(0))
    # the Adam moments take their parameter's shards
    w = exp.model.audio_encoder.layers[0].intermediate_dense.weight
    moment = exp.optimizer.state[w]["exp_avg"]
    out["moment"] = (tuple(repr(p) for p in moment.placements), tuple(moment.to_local().shape))
    # the whole state, gathered, loads back into another sharded experiment
    state = exp.state_dict()
    again = _experiment(ff_config(), mesh=make_mesh((2, 2)), fsdp=True)
    again.load_state_dict(state)
    regathered = again.state_dict()
    out["roundtrip"] = max(
        float((state["model"][k] - regathered["model"][k]).abs().max()) for k in state["model"])
    moments = state["optimizer"]["state"]
    out["roundtrip_moments"] = max(
        float((moments[i]["exp_avg"] - regathered["optimizer"]["state"][i]["exp_avg"]).abs().max())
        for i in moments)
    out["state_keys"] = sorted(state["model"])

    # FSDP on a pure-DP mesh for a BatchNorm frame model: step, eval, a
    # checkpoint written by rank 0 that a solo trainer loads
    frame = _experiment(frame_config(fsdp=True), mesh=make_mesh((4, 1)),
                        log_dir=data["log_dir"])
    with torch.enable_grad():
        metrics = frame.train_step(frame_batch(0))
    ev = frame.eval_step(frame_batch(1))
    path = frame.save_checkpoint(0)
    out["frame"] = {"fsdp": frame.fsdp, "loss": float(metrics["loss"]), "err": float(ev["err"]),
                    "path": path, "state": _np(frame.state_dict()["model"])}
    if rank == 0:
        solo = _experiment(frame_config())
        solo.load_checkpoint(path)
        out["frame"]["solo_loaded"] = _np(solo.state_dict()["model"])

    # fit on the mesh: every rank runs the loop, rank 0 writes the metrics
    # and checkpoints; a fresh sharded experiment resumes from them
    fit_dir = data["log_dir"] + "/fit"
    fit_exp = _experiment(frame_config(fsdp=True), mesh=make_mesh((4, 1)), log_dir=fit_dir)
    _, result = fit_exp.fit(FrameData(), max_epochs=2, log_every=1)
    resumed = _experiment(frame_config(fsdp=True), mesh=make_mesh((4, 1)), log_dir=fit_dir)
    _, again = resumed.fit(FrameData(), max_epochs=3, resume=True)
    out["fit"] = {"result": (result.epochs_run, result.best_epoch, result.best_val_err),
                  "resumed": (again.epochs_run, resumed.step), "writer": fit_exp.writer,
                  "dir": fit_dir}

    out["cli"] = {"stdout": cli_train_case(data["cli"]), "root": data["cli"]["root"]}

    # the dry run of the whole matrix, in these ranks
    out["dryrun"] = dryrun_multichip(4, Wav2Vec2Config(**ENC))
    return out


def cli_train_case(cli: dict) -> str:
    """``cli.train`` as ``torchrun`` runs it on every rank (its environment
    names the world size; the group exists), in one shared working
    directory; returns the rank's standard output."""
    import contextlib
    import io
    import os

    import torch.distributed as dist

    from audio2face_tpu_torch.cli import train

    os.environ["WORLD_SIZE"] = str(dist.get_world_size())
    cwd, out = os.getcwd(), io.StringIO()
    os.chdir(cli["root"])
    try:
        with contextlib.redirect_stdout(out):
            train.main(["--config", cli["cfg"], "--dataset-path", cli["data"],
                        "--max-epochs", "1", "--predict-subject", cli["subject"],
                        "--predict-sentence", cli["sentence"], "--skip-render", "--device", "cpu"])
    finally:
        os.chdir(cwd)
        del os.environ["WORLD_SIZE"]
    return out.getvalue()


class FrameData:
    """A data module of two training batches and one validation batch of
    ``frame_batch``, the same on every rank."""

    def train_batches(self, np_rng):
        yield frame_batch(int(np_rng.integers(0, 100)))
        yield frame_batch(7)

    def val_batches(self):
        yield frame_batch(1)


# ---- tests/test_torch_sequence_parallel.py -----------------------------------


def sequence_cases(rank: int, data: dict) -> dict:
    from audio2face_tpu_torch.models import wav2vec2
    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from audio2face_tpu_torch.parallel import comm
    from audio2face_tpu_torch.parallel.mesh import make_mesh
    from audio2face_tpu_torch.parallel.sequence import (
        sequence_parallel_encode, sequence_parallel_layers)
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    cfg = Wav2Vec2Config(**data["config"])
    enc = Wav2Vec2Encoder(cfg)
    enc.load_state_dict({k: torch.tensor(v) for k, v in data["state"].items()})
    enc.eval()
    audio = torch.tensor(data["audio"])
    mesh4, mesh22 = make_mesh((4, 1)), make_mesh((2, 2))
    out: dict = {}
    shapes = []
    real = wav2vec2.mha_reference

    def spy(q, k, v, **kw):  # the attention calls' (t_q, t_k)
        shapes.append((q.shape[2], k.shape[2]))
        return real(q, k, v, **kw)

    wav2vec2.mha_reference = spy
    try:
        with torch.no_grad():
            out["share4"] = sequence_parallel_encode(enc, audio, mesh4, config=cfg,
                                                     use_kernels=False).numpy()
    finally:
        wav2vec2.mha_reference = real
    out["attention_shapes"] = shapes
    with torch.no_grad():
        out["gathered4"] = sequence_parallel_encode(enc, audio, mesh4, config=cfg,
                                                    gather_output=True).numpy()
        b2, lengths = torch.tensor(data["audio2"]), torch.tensor(data["lengths"])
        out["padded2"] = sequence_parallel_encode(enc, b2, mesh22, lengths=lengths, config=cfg,
                                                  gather_output=True).numpy()
        h, fl = enc(audio, pre_layers_only=True)
        out["split_point_lengths"] = fl
        out["layers2"] = sequence_parallel_layers(enc, h, mesh22, config=cfg,
                                                  gather_output=True).numpy()
        out["encode2"] = sequence_parallel_encode(enc, audio, mesh22, config=cfg,
                                                  gather_output=True).numpy()

    # the predictor: sp_mesh against the solo predictor, ragged clips
    comm.reset_counts()
    kw = dict(n_verts=150, bf16=False, bucket_seconds=0.5, device="cpu")
    sp = FaceFormerPredictor(seed=1, sp_mesh=mesh22, **kw)
    clips, one_hot, template = data["clips"], data["one_hot"], data["template"]
    out["sp_predictor"] = sp(clips, one_hot, template)
    out["sp_collectives"] = dict(comm.COUNTS)
    if rank == 0:
        out["solo_predictor"] = FaceFormerPredictor(seed=1, **kw)(clips, one_hot, template)
    return out


# ---- tests/test_torch_pipeline_parallel.py -----------------------------------


def pipeline_cases(rank: int, data: dict) -> dict:
    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from audio2face_tpu_torch.parallel import comm
    from audio2face_tpu_torch.parallel.mesh import make_mesh
    from audio2face_tpu_torch.parallel.pipeline import (
        pipeline_parallel_encode, pipeline_parallel_layers)

    cfg = Wav2Vec2Config(**data["config"])
    enc = Wav2Vec2Encoder(cfg)
    enc.load_state_dict({k: torch.tensor(v) for k, v in data["state"].items()})
    enc.eval()
    audio = torch.tensor(data["audio"])
    mesh22, mesh14 = make_mesh((2, 2)), make_mesh((1, 4))
    out: dict = {}
    with torch.no_grad():
        comm.reset_counts()
        out["stages2"] = pipeline_parallel_encode(enc, audio, mesh22, config=cfg).numpy()
        out["stages4"] = pipeline_parallel_encode(enc, audio, mesh14, config=cfg).numpy()
        out["collectives"] = dict(comm.COUNTS)
        lengths = torch.tensor(data["lengths"])
        out["micro2_padded"] = pipeline_parallel_encode(
            enc, audio, mesh22, n_micro=2, lengths=lengths, config=cfg).numpy()
        out["dp_pp"] = pipeline_parallel_encode(
            enc, audio, mesh22, n_micro=2, config=cfg, data_axis="data").numpy()
        h, _ = enc(audio, pre_layers_only=True)

    # gradients through the pipeline: each stage's layers, against the
    # plain layer stack's on rank 0
    stage = rank % 2  # the model coordinate on the 2 x 2 mesh
    per = cfg.num_layers // 2
    with torch.enable_grad():
        enc.zero_grad(set_to_none=True)
        y = pipeline_parallel_layers(enc, h, mesh22, config=cfg)
        (y ** 2).mean().backward()
    out["pp_grads"] = {n: p.grad.numpy().copy() for n, p in enc.layers.named_parameters()
                       if int(n.split(".")[0]) // per == stage}
    out["pp_untouched"] = [n for n, p in enc.layers.named_parameters()
                           if int(n.split(".")[0]) // per != stage and p.grad is not None]
    if rank == 0:
        enc.zero_grad(set_to_none=True)
        with torch.enable_grad():
            x = h
            for layer in enc.layers:
                x = layer(x)
            (x ** 2).mean().backward()
        out["solo_grads"] = {n: p.grad.numpy().copy() for n, p in enc.layers.named_parameters()}
    return out


# ---- tests/test_torch_parallel_serving.py ------------------------------------


def serving_cases(rank: int, data: dict) -> dict:
    from audio2face_tpu_torch.frame_stream import FrameStreamPool
    from audio2face_tpu_torch.multistream import MultiStreamFaceFormerPredictor
    from audio2face_tpu_torch.parallel import comm
    from audio2face_tpu_torch.parallel.mesh import make_mesh
    from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor

    mesh = make_mesh((4, 1))
    out: dict = {}
    clips, one_hot, template = data["clips"], data["one_hot"], data["template"]
    ftemplate, oh3 = data["frame_template"], data["one_hot"][:3]

    # FaceFormerPredictor: 3 clips padded to the mesh's 4 rows
    kw = dict(n_verts=150, bf16=False, bucket_seconds=0.5, device="cpu")
    comm.reset_counts()
    pred = FaceFormerPredictor(seed=1, mesh=mesh, max_batch=6, **kw)
    out["ff_max_batch"] = pred.max_batch
    out["ff_mesh"] = pred(clips, oh3, template)
    out["ff_collectives"] = dict(comm.COUNTS)

    # FramePredictor on the frame model
    fkw = dict(max_batch=4, frame_batch=16, bucket_seconds=0.5, seed=3, device="cpu")
    fcfg = frame_config(vertex_count=300)
    fclips = data["frame_clips"]
    out["frame_mesh"] = FramePredictor(fcfg, mesh=mesh, **fkw)(fclips, oh3, ftemplate)

    # the slot-sharded pools: 4 slots, one each, interleaved pushes
    pool = MultiStreamFaceFormerPredictor(state_dict=None, n_verts=300, n_streams=4, seed=0,
                                          mesh=mesh, device="cpu", **data["pool_kw"])
    out["pool_mesh"] = interleave(pool, data["pool_clips"], one_hot, data["pool_template"])
    fpool = FrameStreamPool(fcfg, n_streams=4, frame_batch=8, seed=3, mesh=mesh, device="cpu")
    out["frame_pool_mesh"] = interleave(fpool, fclips, one_hot, ftemplate)
    if rank == 0:
        out["ff_solo"] = FaceFormerPredictor(seed=1, **kw)(clips, oh3, template)
        out["frame_solo"] = FramePredictor(fcfg, **fkw)(fclips, oh3, ftemplate)
        solo_pool = MultiStreamFaceFormerPredictor(
            state_dict=None, n_verts=300, n_streams=4, seed=0, device="cpu", **data["pool_kw"])
        out["pool_solo"] = interleave(solo_pool, data["pool_clips"], one_hot,
                                      data["pool_template"])
        solo_fpool = FrameStreamPool(fcfg, n_streams=4, frame_batch=8, seed=3, device="cpu")
        out["frame_pool_solo"] = interleave(solo_fpool, fclips, one_hot, ftemplate)
    return out


def interleave(pool, clips, one_hot, template, piece: int = 3000) -> list:
    """Every clip through its own slot, pushed a piece at a time in turns."""
    slots = [pool.open_stream(one_hot[i], template) for i in range(len(clips))]
    got = [[] for _ in clips]
    offs = [0] * len(clips)
    while any(o < len(c) for o, c in zip(offs, clips)):
        for i, c in enumerate(clips):
            if offs[i] < len(c):
                j = min(offs[i] + piece, len(c))
                got[i].append(pool.push(slots[i], c[offs[i]:j], last=j == len(c)))
                offs[i] = j
    return [np.concatenate([o for o in g + [pool.poll(s)] if o.size]) for g, s in zip(got, slots)]

