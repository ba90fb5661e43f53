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
either the weights are random (smoke mode). The streaming decoder is not
ported yet: ``--streaming`` raises and names the ROADMAP.md item that
brings it.
"""

import argparse
import os

import numpy as np

_NOT_PORTED = {
    "streaming": "the streaming front ends: ROADMAP.md queue 1 item 2",
}


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
    parser.add_argument("--streaming", action="store_true", help="not ported yet")
    parser.add_argument("--config", default=None,
                        help="experiment YAML for a frame model "
                             "(audio2mesh/voca/song2face); omit for faceformer")
    parser.add_argument("--dataset", choices=["vocaset", "biwi"], default=None,
                        help="faceformer dataset family (trainer checkpoints are "
                             "detected; REQUIRED as 'biwi' for BIWI-trained torch "
                             "checkpoints: frames run at 25 fps)")
    parser.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    for name, what in _NOT_PORTED.items():
        if getattr(args, name):
            raise NotImplementedError(f"--{name.replace('_', '-')} is not ported yet ({what})")

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
    results = predictor(audios, one_hot, template, sample_rate=rates.pop())

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


if __name__ == "__main__":
    main()
