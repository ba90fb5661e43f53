"""Inference entry point: wav file(s) -> vertex animation (+ optional video).

Port of ``audio2face_tpu/cli/infer.py``. Decodes any number of clips of
any length in padded batches on one GPU: FaceFormer by default (vocaset, or
``--dataset biwi``), a frame model (audio2mesh, voca, song2face) with
``--config configs/<model>.yaml``.

Example:
    python -m audio2face_tpu_torch.cli.infer --audio clip.wav --subject 3 \
        --template assets/FLAME_sample.obj \
        --checkpoint logs/.../checkpoints/epoch=7-step=123 --output out/ --video

``--checkpoint`` takes a checkpoint of the port's trainer,
``--torch-checkpoint`` a reference PyTorch/Lightning ``.ckpt``; without
either the weights are random (smoke mode). ``--streaming`` feeds each clip
in 100 ms packets through the live path and prints the compute latency:
FaceFormer (vocaset) through ``StreamingFaceFormerPredictor``, per emitted
chunk; a frame model (``--config``) through a ``FrameStreamPool`` slot, per
packet.
"""

import argparse
import os
import time

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--audio", nargs="+", required=True, help="input wav file(s)")
    parser.add_argument("--subject", type=int, nargs="+", default=None,
                        help="style one-hot index per clip (default 0)")
    parser.add_argument("--template", required=True, help="FLAME template .obj/.ply")
    parser.add_argument("--checkpoint", default=None, help="checkpoint of the port's trainer")
    parser.add_argument("--torch-checkpoint", default=None, help="reference .ckpt/.pt")
    parser.add_argument("--output", default="output")
    parser.add_argument("--video", action="store_true", help="render mp4 per clip")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--streaming", action="store_true",
                        help="decode incrementally with bounded lookahead "
                             "(simulated live input; prints per-chunk latency)")
    parser.add_argument("--chunk-seconds", type=float, default=1.0)
    parser.add_argument("--left-seconds", type=float, default=2.0)
    parser.add_argument("--lookahead-seconds", type=float, default=0.5)
    parser.add_argument("--config", default=None,
                        help="experiment YAML for a frame model "
                             "(audio2mesh/voca/song2face); omit for faceformer")
    parser.add_argument("--dataset", choices=["vocaset", "biwi"], default=None,
                        help="faceformer dataset family (trainer checkpoints are "
                             "detected; REQUIRED as 'biwi' for BIWI-trained torch "
                             "checkpoints: frames run at 25 fps)")
    parser.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor
    from audio2face_tpu_torch.utils.audio_io import read_wav
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    mesh = FaceMesh.load(args.template)
    if args.config:
        from audio2face_tpu_torch.config import ExpConfig

        cfg = ExpConfig.from_yaml(args.config)
        if cfg.modelname == "faceformer":
            raise SystemExit("--config is for the frame models; omit it for faceformer")
        cls, kwargs = FramePredictor, dict(config=cfg, max_batch=args.batch, device=args.device)
    else:
        cls, kwargs = FaceFormerPredictor, dict(
            n_verts=mesh.n_verts * 3, max_batch=args.batch, bf16=not args.f32, device=args.device)
        if args.dataset:
            kwargs["dataset"] = args.dataset
    if args.torch_checkpoint:
        predictor = cls.from_torch_checkpoint(args.torch_checkpoint, **kwargs)
    elif args.checkpoint:
        predictor = cls.from_checkpoint(args.checkpoint, **kwargs)
    else:
        print("WARNING: no checkpoint given: using random weights (smoke mode)")
        predictor = cls(**kwargs)

    audios, rates = [], set()
    for path in args.audio:
        wav, sr = read_wav(path)
        audios.append(wav)
        rates.add(sr)
    if len(rates) != 1:
        raise ValueError(f"all clips must share one sample rate, got {rates}")

    subjects = args.subject or [0] * len(audios)
    one_hot = np.eye(predictor.n_onehot, dtype=np.float32)[subjects]
    template = np.asarray(mesh.verts, np.float32)
    sr = rates.pop()
    if args.streaming and args.config:
        results = _stream_frames(predictor, audios, one_hot, template, sr)
    elif args.streaming:
        if predictor.dataset == "biwi":
            raise SystemExit(
                "--streaming supports only vocaset faceformer checkpoints "
                "(the streaming windows assume the 60 fps adapter)"
            )
        results = _stream(predictor, audios, one_hot, template, sr, args)
    else:
        results = predictor(audios, one_hot, template, sample_rate=sr)

    os.makedirs(args.output, exist_ok=True)
    for path, verts in zip(args.audio, results):
        stem = os.path.splitext(os.path.basename(path))[0]
        out_npy = os.path.join(args.output, f"{stem}_verts.npy")
        np.save(out_npy, verts)
        print(f"{path}: {verts.shape[0]} frames -> {out_npy}")
        if args.video:
            from audio2face_tpu_torch.utils.renderer import Renderer, images_to_video

            renderer = Renderer(mesh, device=args.device)
            images = renderer.render(verts)
            images_to_video(images, os.path.join(args.output, stem), fps=predictor.fps)


def _stream_frames(predictor, audios, one_hot, template, sr):
    """Live frame-model path: each clip in 100 ms packets through a
    FrameStreamPool slot, with the compute latency per packet."""
    from audio2face_tpu_torch.frame_stream import FrameStreamPool
    from audio2face_tpu_torch.serving import _resampled

    pool = FrameStreamPool(
        predictor.config, state_dict=predictor.model.state_dict(),
        n_streams=min(len(audios), 8), unit_scale=predictor.unit_scale,
        device=predictor.device,
    )
    results = []
    model_sr = predictor.config.sample_rate
    feed = int(0.1 * model_sr)
    for clip_i, audio in enumerate(audios):
        audio = _resampled([audio], sr, model_sr, predictor.device)[0]
        slot = pool.open_stream(one_hot[clip_i], template)
        outs, n_pk, lat = [], 0, 0.0
        for off in range(0, len(audio), feed):
            tic = time.perf_counter()
            got = pool.push(slot, audio[off : off + feed], last=off + feed >= len(audio))
            lat += time.perf_counter() - tic
            n_pk += 1
            outs.append(got)
        outs.append(pool.poll(slot))
        pool.close_stream(slot)
        results.append(np.concatenate(outs))
        if n_pk:
            print(f"clip {clip_i}: {len(results[-1])} frames live, "
                  f"{lat / n_pk * 1e3:.1f} ms compute/100 ms packet")
    return results


def _stream(predictor, audios, one_hot, template, sr, args):
    """Each clip chunk by chunk through the streaming predictor (100 ms
    packets), with the wall latency per emitted chunk."""
    import torch

    from audio2face_tpu_torch.models.faceformer import AUDIO_SR
    from audio2face_tpu_torch.serving import _resampled
    from audio2face_tpu_torch.streaming import StreamingFaceFormerPredictor

    stream = StreamingFaceFormerPredictor(
        state_dict=predictor.model.state_dict(), n_verts=predictor.n_verts,
        n_onehot=predictor.n_onehot,
        chunk_seconds=args.chunk_seconds, left_seconds=args.left_seconds,
        lookahead_seconds=args.lookahead_seconds,
        dtype=None if args.f32 else torch.bfloat16,
        unit_scale=predictor.unit_scale, device=predictor.device,
    )
    results = []
    feed = int(0.1 * AUDIO_SR)  # simulated 100 ms microphone packets
    for clip_i, audio in enumerate(audios):
        audio = _resampled([audio], sr, AUDIO_SR, predictor.device)[0]
        stream.start_stream(one_hot[clip_i], template)
        outs, n_chunks, lat = [], 0, 0.0
        for off in range(0, len(audio), feed):
            tic = time.perf_counter()
            got = stream.push(audio[off : off + feed])
            dt = time.perf_counter() - tic
            if got.size:
                n_chunks += 1
                lat += dt
            outs.append(got)
        outs.append(stream.flush())
        results.append(np.concatenate(outs))
        if n_chunks:
            print(f"clip {clip_i}: {n_chunks} chunks, "
                  f"{lat / n_chunks * 1e3:.1f} ms compute/chunk "
                  f"({args.chunk_seconds * 1e3:.0f} ms audio each, "
                  f"lookahead {args.lookahead_seconds:.1f}s)")
    return results


if __name__ == "__main__":
    main()
