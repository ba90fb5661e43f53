"""``dryrun_multichip(n)``: the whole parallelism matrix on an n-rank mesh.

Counterpart of ``__graft_entry__.py dryrun_multichip``: on a (data, model)
mesh of n ranks (a model axis of 2 when n is even), one FaceFormer training
step under DP x TP x FSDP (data parallelism, the wav2vec2 encoder in its
Megatron form over ``model``, parameters and Adam moments sharded over
``data``), a sequence-parallel encode (the transformer stack time-sharded
over ``data``) and, with a model axis, a DP x PP encode (GPipe stages over
``model``, microbatches over ``data``). The step checks that FSDP placed
the FFN's ``intermediate_dense`` weight where the JAX rule puts it.

With no process group it spawns n gloo ranks on the CPU (rendezvous by a
file in a temporary directory) and returns rank 0's summary; inside an
n-rank group (``torchrun``) every rank runs it and returns the summary.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

N_VERTS = 15069
N_ONEHOT = 12
SR = 16000


def _dryrun_local(n_devices: int, encoder_config=None) -> dict:
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
    from audio2face_tpu_torch.parallel import comm
    from audio2face_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, make_mesh
    from audio2face_tpu_torch.parallel.pipeline import pipeline_parallel_encode
    from audio2face_tpu_torch.parallel.sequence import sequence_parallel_encode
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment
    from torch.distributed.tensor import DTensor, Shard

    if dist.get_world_size() != n_devices:
        raise ValueError(
            f"dryrun_multichip({n_devices}) in a group of {dist.get_world_size()} ranks")
    encoder_config = encoder_config or Wav2Vec2Config()
    model_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh((n_devices // model_axis, model_axis))
    batch_size = n_devices // model_axis
    config = ExpConfig(
        batch_size=batch_size, modelname="faceformer", vertex_count=N_VERTS,
        one_hot_size=N_ONEHOT, feature_extractor=None, sample_rate=SR, split_frame=False,
        n_feature=32, out_dim=52, win_length=440, percision="32", lr=1e-4,
    )
    exp = Audio2FaceExperiment(
        config, mesh=mesh, fsdp=n_devices > model_axis, device=mesh.device_type,
        tensorboard=False, log_dir=os.path.join(tempfile.gettempdir(), "a2f_dryrun"),
        model_kwargs={"encoder_config": encoder_config})
    assert exp.tensor_parallel == (model_axis > 1)
    if exp.fsdp:
        # the JAX rule: (in, out) kernel P("data", "model") under TP, else
        # P(None, "data"); the torch weight is (out, in)
        w = exp.model.audio_encoder.layers[0].intermediate_dense.weight
        want = Shard(1) if exp.tensor_parallel else Shard(0)
        assert isinstance(w, DTensor) and w.placements == (want,), w

    seconds = 0.25
    n_samples, n_frames = int(seconds * SR), int(seconds * SR) * 60 // SR
    rng = np.random.default_rng(0)
    batch = {
        "audio": (rng.normal(size=(batch_size, n_samples)) * 0.1).astype(np.float32),
        "audio_lengths": np.full((batch_size,), n_samples, np.int32),
        "verts": rng.normal(size=(batch_size, n_frames, N_VERTS // 3, 3)).astype(np.float32),
        "template_vert": rng.normal(size=(batch_size, N_VERTS // 3, 3)).astype(np.float32),
        "one_hot": np.eye(N_ONEHOT, dtype=np.float32)[rng.integers(0, N_ONEHOT, batch_size)],
    }
    comm.reset_counts()
    with torch.enable_grad():
        metrics = exp.train_step(batch)
    step_collectives = sum(comm.COUNTS.values())

    # SP and PP take a plain encoder with the trained weights: the trainer's
    # is split over the model axis, which PP's stages use for themselves
    state = exp.state_dict()["model"]
    encoder = Wav2Vec2Encoder(encoder_config).to(exp.device)
    encoder.load_state_dict({k[len("audio_encoder."):]: v for k, v in state.items()
                             if k.startswith("audio_encoder.")})
    audio = torch.as_tensor(batch["audio"], device=exp.device)
    with torch.no_grad():
        sp_hidden = sequence_parallel_encode(
            encoder, audio, mesh, config=encoder_config, gather_output=True)
        pp_hidden = None
        if model_axis > 1:
            n_data = axis_size(mesh, DATA_AXIS)
            pp_audio = audio.repeat(n_data, 1)
            pp_hidden = pipeline_parallel_encode(
                encoder, pp_audio, mesh, n_micro=pp_audio.shape[0] // n_data,
                config=encoder_config, data_axis=DATA_AXIS if n_data > 1 else None)
    return {
        "mesh": {"data": batch_size, "model": model_axis}, "fsdp": exp.fsdp,
        "tensor_parallel": exp.tensor_parallel, "sp_hidden": tuple(sp_hidden.shape),
        "pp_hidden": None if pp_hidden is None else tuple(pp_hidden.shape),
        "loss": float(metrics["loss"]), "err": float(metrics["err"]),
        "step_collectives": step_collectives,
    }


def _rank_main(rank: int, n: int, init_file: str, out_file: str, encoder_config) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n)
    try:
        summary = _dryrun_local(n, encoder_config)
        if rank == 0:
            torch.save(summary, out_file)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, encoder_config=None) -> dict:
    """One DP x TP x FSDP FaceFormer training step, an SP encode and a
    DP x PP encode on an n-rank mesh; returns a summary (mesh, output
    shapes, loss, err) and prints it. ``encoder_config`` narrows the
    wav2vec2 encoder (default: wav2vec2-base)."""
    if dist.is_initialized():
        summary = _dryrun_local(n_devices, encoder_config)
    else:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory(prefix="a2f_dryrun_") as tmp:
            init_file, out_file = os.path.join(tmp, "rendezvous"), os.path.join(tmp, "summary.pt")
            mp.start_processes(_rank_main, args=(n_devices, init_file, out_file, encoder_config),
                               nprocs=n_devices, start_method="spawn")
            summary = torch.load(out_file, weights_only=True)
    print(f"dryrun_multichip OK: {summary}")
    return summary


def _main(argv: Optional[list] = None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    dryrun_multichip(int(argv[0]) if argv else 2)


if __name__ == "__main__":
    _main()
