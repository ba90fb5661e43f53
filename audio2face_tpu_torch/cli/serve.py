"""HTTP serving daemon (``http_server.py``), with an optional live port
(``live_server.py``).

Port of ``audio2face_tpu/cli/serve.py``. Serves a FaceFormer (default) or
frame-model checkpoint over HTTP with request coalescing, bounded-queue
backpressure and an optional warmup of every (batch, bucket) shape before
the port binds::

    python -m audio2face_tpu_torch.cli.serve --template assets/FLAME_sample.obj \
        --checkpoint logs/.../checkpoints/epoch=7-step=123 \
        --port 8571 --warmup-seconds 60 [--live-port 8572]

    curl -s -X POST --data-binary @clip.wav -H 'Content-Type: audio/wav' \
        'localhost:8571/v1/infer?subject=3' -o verts.npy

``--checkpoint`` takes a checkpoint of the port's trainer,
``--torch-checkpoint`` a reference PyTorch/Lightning ``.ckpt``; without
either the weights are random (smoke mode). Runs on the GPU unless
``--device cpu`` is given.
"""

import argparse

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--template", required=True, help="FLAME template .obj/.ply")
    parser.add_argument("--checkpoint", default=None, help="checkpoint of the port's trainer")
    parser.add_argument("--torch-checkpoint", default=None, help="reference .ckpt/.pt")
    parser.add_argument("--config", default=None,
                        help="experiment YAML for a frame model "
                             "(audio2mesh/voca/song2face); omit for faceformer")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8571)
    parser.add_argument("--batch", type=int, default=8,
                        help="max clips per coalesced predictor call")
    parser.add_argument("--max-queue", type=int, default=64,
                        help="bounded queue depth (backpressure past it)")
    parser.add_argument("--max-wait-ms", type=float, default=10.0,
                        help="straggler wait before dispatching a partial batch")
    parser.add_argument("--timeout", type=float, default=60.0,
                        help="default per-request queue timeout (seconds)")
    parser.add_argument("--load-shed", action="store_true",
                        help="reject requests with 429 the moment the queue "
                             "is full instead of holding the connection "
                             "(backpressure) until --timeout")
    parser.add_argument("--warmup-seconds", type=float, default=0.0,
                        help="run every (batch, bucket) shape for clips up to "
                             "this length once before binding the port "
                             "(0 = warm lazily on first use)")
    parser.add_argument("--live-port", type=int, default=0,
                        help="also serve LIVE streams (framed-TCP wire "
                             "protocol, live_server.py) on this port from the "
                             "same weights (0 = off)")
    parser.add_argument("--live-streams", type=int, default=8,
                        help="live pool size: concurrent sessions per GPU")
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--dataset", choices=["vocaset", "biwi"], default=None,
                        help="faceformer dataset family (trainer checkpoints are "
                             "detected; REQUIRED as 'biwi' for BIWI-trained torch "
                             "checkpoints: frames run at 25 fps)")
    parser.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    from audio2face_tpu_torch.http_server import ServingDaemon
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    template = np.asarray(FaceMesh.load(args.template).verts, np.float32)

    if args.config:
        from audio2face_tpu_torch.config import ExpConfig
        from audio2face_tpu_torch.serving import FramePredictor

        cfg = ExpConfig.from_yaml(args.config)
        if cfg.modelname == "faceformer":
            raise SystemExit("--config is for the frame models; omit it for faceformer")
        cls, kw = FramePredictor, dict(config=cfg, max_batch=args.batch, device=args.device)
    else:
        from audio2face_tpu_torch.serving import FaceFormerPredictor

        cls, kw = FaceFormerPredictor, dict(
            n_verts=template.size, max_batch=args.batch, bf16=not args.f32, device=args.device)
        if args.dataset:
            kw["dataset"] = args.dataset
    if args.torch_checkpoint:
        predictor = cls.from_torch_checkpoint(args.torch_checkpoint, **kw)
    elif args.checkpoint:
        predictor = cls.from_checkpoint(args.checkpoint, **kw)
    else:
        print("WARNING: no checkpoint given: serving random weights (smoke mode)")
        predictor = cls(**kw)

    if args.warmup_seconds > 0:
        print(f"warming every (batch, bucket) shape up to {args.warmup_seconds:.0f}s ...")
        n = predictor.warmup(args.warmup_seconds)
        print(f"warm: {n} calls")

    live = None
    if args.live_port:
        from audio2face_tpu_torch.live_server import LiveStreamingDaemon
        from audio2face_tpu_torch.multistream import StreamingServer

        if args.config:
            from audio2face_tpu_torch.frame_stream import FrameStreamPool

            pool = FrameStreamPool(
                predictor.config, state_dict=predictor.model.state_dict(),
                n_streams=args.live_streams, device=predictor.device,
            )
            server = StreamingServer(pool=pool)
        else:
            if predictor.dataset == "biwi":
                raise SystemExit(
                    "--live-port supports only vocaset faceformer checkpoints "
                    "(the streaming windows assume the 60 fps adapter)"
                )
            import torch

            server = StreamingServer(
                state_dict=predictor.model.state_dict(), n_verts=predictor.n_verts,
                n_onehot=predictor.n_onehot, n_streams=args.live_streams,
                dtype=None if args.f32 else torch.bfloat16, device=predictor.device,
            )
        live = LiveStreamingDaemon(
            server=server, template=template, host=args.host, port=args.live_port)
        live.start()
        print(f"live streaming on tcp://{args.host}:{live.port}  "
              f"({args.live_streams} concurrent sessions/GPU)")

    daemon = ServingDaemon(
        predictor, template, host=args.host, port=args.port,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        default_timeout=args.timeout, queue_block=not args.load_shed,
        extra_stats={"live": live.stats} if live is not None else None,
    )
    print(f"serving on http://{args.host}:{args.port}  "
          f"(POST /v1/infer, GET /healthz, GET /stats)", flush=True)
    daemon.serve_forever()


if __name__ == "__main__":
    main()
