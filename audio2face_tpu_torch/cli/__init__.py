"""Command-line entry points of the port, run as
``python -m audio2face_tpu_torch.cli.<name>``: ``infer`` (wav files to vertex
animations and, with ``--video``, rendered MP4s), ``render_offline`` (a saved
vertex animation to a video) and ``render_frames`` (to PNG frames and a
video)."""
