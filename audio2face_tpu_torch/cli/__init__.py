"""Command-line entry points of the port, run as
``python -m audio2face_tpu_torch.cli.<name>``: ``train`` (fit a config on
VOCASET, BIWI or their synthetic stand-ins, then predict and score one test
sentence), ``evaluate`` (LVE / FDD / MVE / max-L2 over a checkpoint's test
split, or between two saved animations), ``export`` (a trainer checkpoint
to a reference-loadable Lightning ``.ckpt``), ``serve`` (the HTTP daemon,
with an optional live port), ``infer`` (wav files to vertex animations and,
with ``--video``, rendered MP4s), ``render_offline`` (a saved vertex
animation to a video) and ``render_frames`` (to PNG frames and a video).
Each has ``main(argv=None)`` and runs on the GPU unless ``--device cpu`` is
given (``export`` runs no model and takes no device)."""
