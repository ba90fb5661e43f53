"""HTTP serving daemon: speech in, vertex animation out, over the wire.

Port of ``audio2face_tpu/http_server.py``; ``/healthz`` reports the
predictor's torch device type (``"cuda"``) as its backend. The reference has no serving surface at all (prediction only runs inside
train.py's Lightning predict pass); ``serving_queue.BatchingServer`` gives
this repo an in-process coalescing front end. This module puts a network
face on it — a dependency-free (stdlib ``http.server``) daemon so clients
in any language can decode speech to FLAME vertex animations:

- ``POST /v1/infer`` — body is a WAV file (``audio/wav``/RIFF, any sample
  rate, uint8/int16/int32/float PCM, mono or stereo) or raw little-endian float32 PCM
  with an ``X-Sample-Rate`` header. Optional query params: ``subject``
  (style one-hot index, default 0) and ``timeout`` (seconds in queue).
  Response is the ``.npy`` serialization of the (T, 5023, 3) float32
  vertex animation (``application/x-npy``) with ``X-Frames``/``X-Verts``
  headers, or JSON (nested lists) when the client sends
  ``Accept: application/json``.
- ``GET /healthz`` — liveness + backend.
- ``GET /stats`` — request/error/timeout counters, in-flight gauge, the
  predictor calls made (``batches``: fewer than requests when requests
  coalesce), and percentiles over sliding windows of the requests'
  latency (``latency_ms``) and of their wait in the queue from submit to
  dispatch (``queue_wait_ms``).

Concurrent requests coalesce into padded batched predictor calls through
``BatchingServer`` (bounded queue, backpressure, per-request timeouts,
failure isolation), so GPU utilization tracks offered load. A caller may
``warmup()`` the predictor's (batch, bucket) shapes before ``start()``.

Live (chunked) sessions are deliberately not exposed over plain HTTP —
request/response framing can't carry them; use the in-process
``multistream.StreamingServer`` / ``frame_stream.FrameStreamPool`` APIs.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from audio2face_tpu_torch.serving_queue import BatchingServer

_LATENCY_WINDOW = 512  # sliding sample count for /stats percentiles


class ServingDaemon:
    """Own a predictor + BatchingServer + stats; serve them over HTTP.

    Usage::

        daemon = ServingDaemon(predictor, template, port=8571)
        daemon.start()            # returns once the socket is bound
        ...                       # POST /v1/infer, GET /healthz, GET /stats
        daemon.stop()
    """

    def __init__(
        self,
        predictor,
        template: np.ndarray,
        *,
        host: str = "127.0.0.1",
        port: int = 8571,
        max_wait_ms: float = 10.0,
        max_queue: Optional[int] = 64,
        default_timeout: Optional[float] = 60.0,
        queue_block: bool = True,
        extra_stats: Optional[dict] = None,
    ):
        if template.ndim != 2 or template.shape[1] != 3:
            raise ValueError(f"template must be (V, 3), got {template.shape}")
        self.predictor = predictor
        self.template = np.asarray(template, np.float32)
        self.host, self.port = host, port
        self.default_timeout = default_timeout
        # at max_queue depth: True = hold the connection (backpressure up to
        # the request timeout -> 503); False = load-shed immediately -> 429
        self.queue_block = queue_block
        self.batcher = BatchingServer(
            predictor, max_wait_ms=max_wait_ms, max_queue=max_queue
        )
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "ok": 0, "errors": 0, "timeouts": 0,
                       "rejected": 0, "in_flight": 0}
        # sibling surfaces' stats() callables merged into GET /stats under
        # their key (e.g. {"live": live_daemon.stats} from a2f-serve)
        self.extra_stats = dict(extra_stats or {})
        self._latencies: list[float] = []
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- stats

    def _count(self, key: str, delta: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += delta

    def _record_latency(self, seconds: float) -> None:
        with self._stats_lock:
            self._latencies.append(seconds)
            if len(self._latencies) > _LATENCY_WINDOW:
                del self._latencies[: -_LATENCY_WINDOW]

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
            lat = np.asarray(self._latencies, np.float64)
        out["batches"] = self.batcher.batches
        for key, seconds in (("latency_ms", lat),
                             ("queue_wait_ms", np.asarray(self.batcher.queue_waits(), np.float64))):
            if seconds.size:
                out[key] = {
                    "p50": round(float(np.percentile(seconds, 50)) * 1e3, 1),
                    "p95": round(float(np.percentile(seconds, 95)) * 1e3, 1),
                    "max": round(float(seconds.max()) * 1e3, 1),
                    "window": int(seconds.size),
                }
        for key, fn in self.extra_stats.items():
            try:
                out[key] = fn()
            except Exception as e:  # a sibling's failure must not 500 /stats
                out[key] = {"error": str(e)}
        return out

    # ----------------------------------------------------------- request

    def infer(self, audio: np.ndarray, sample_rate: int, subject: int,
              timeout: Optional[float]) -> np.ndarray:
        """One clip through the coalescing queue (called per HTTP request,
        possibly from many handler threads at once)."""
        n_onehot = self.predictor.n_onehot
        if not 0 <= subject < n_onehot:
            raise ValueError(f"subject must be in [0, {n_onehot}), got {subject}")
        one_hot = np.eye(n_onehot, dtype=np.float32)[subject]
        fut = self.batcher.submit(
            audio, one_hot, self.template, sample_rate,
            timeout=timeout, block=self.queue_block,
        )
        return fut.result()

    # ------------------------------------------------------------ server

    def start(self) -> int:
        """Bind the socket and serve on a daemon thread; returns the bound
        port (useful with port=0)."""
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def serve_forever(self) -> None:
        """Foreground variant for the CLI."""
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        try:
            self._httpd.serve_forever()
        finally:
            self.batcher.close()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.batcher.close()


def decode_audio_body(body: bytes, content_type: str,
                      sample_rate_header: Optional[str]) -> tuple[np.ndarray, int]:
    """Decode a request body to (mono float32 waveform, sample_rate).

    WAV (RIFF) bodies carry their own rate; raw float32 PCM needs the
    X-Sample-Rate header. PCM normalization (uint8/int16/int32 -> [-1, 1],
    stereo -> channel mean) is shared with the CLI and the BIWI loader
    (utils/audio_io.py)."""
    if body[:4] == b"RIFF" or "audio/wav" in content_type:
        from audio2face_tpu_torch.utils.audio_io import read_wav

        return read_wav(body)
    if sample_rate_header is None:
        raise ValueError(
            "raw PCM bodies need an X-Sample-Rate header (or send a WAV file)"
        )
    if len(body) % 4:
        raise ValueError("raw PCM body length is not a multiple of 4 bytes (float32)")
    wav = np.frombuffer(body, np.float32)
    if wav.size == 0:
        raise ValueError("empty audio body")
    return wav, int(sample_rate_header)


def _make_handler(daemon: ServingDaemon):
    class Handler(BaseHTTPRequestHandler):
        # one daemon, many handler instances (one per request)
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: stats replace the access log
            pass

        def _reply(self, code: int, payload: bytes, content_type: str,
                   headers: Optional[dict] = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def _reply_json(self, code: int, obj: dict) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                device = getattr(daemon.predictor, "device", None)
                self._reply_json(200, {
                    "status": "ok",
                    "backend": "cpu" if device is None else device.type,
                    "model": type(daemon.predictor).__name__,
                })
            elif path == "/stats":
                self._reply_json(200, daemon.stats())
            else:
                self._reply_json(404, {"error": f"no such path: {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            # Read the body BEFORE any reply: under HTTP/1.1 keep-alive an
            # unread body is parsed as the NEXT request line, desyncing the
            # connection for every later request on it. When the body can't
            # be read (bad/absent Content-Length, chunked encoding), close
            # the connection instead of guessing at the framing.
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = -1
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if length < 0 or "chunked" in te:
                self.close_connection = True
                self._reply_json(
                    400, {"error": "a valid Content-Length is required "
                                   "(chunked bodies are not supported)"}
                )
                return
            body = self.rfile.read(length) if length else b""
            if url.path != "/v1/infer":
                self._reply_json(404, {"error": f"no such path: {url.path}"})
                return
            daemon._count("requests")
            daemon._count("in_flight")
            t0 = time.monotonic()
            try:
                q = parse_qs(url.query)
                subject = int(q.get("subject", ["0"])[0])
                timeout = (
                    float(q["timeout"][0]) if "timeout" in q
                    else daemon.default_timeout
                )
                if not body:
                    raise ValueError("empty request body")
                audio, sr = decode_audio_body(
                    body, self.headers.get("Content-Type", ""),
                    self.headers.get("X-Sample-Rate"),
                )
                verts = daemon.infer(audio, sr, subject, timeout)
            except (ValueError, KeyError) as e:
                daemon._count("errors")
                self._reply_json(400, {"error": str(e)})
                return
            except TimeoutError as e:
                daemon._count("timeouts")
                self._reply_json(503, {"error": f"queue timeout: {e}"})
                return
            except Exception as e:  # queue.Full, predictor failures, ...
                import queue as _queue

                if isinstance(e, _queue.Full):
                    daemon._count("rejected")
                    self._reply_json(429, {"error": "serving queue is full"})
                else:
                    daemon._count("errors")
                    self._reply_json(500, {"error": repr(e)})
                return
            finally:
                daemon._count("in_flight", -1)
            daemon._count("ok")
            daemon._record_latency(time.monotonic() - t0)
            headers = {
                "X-Frames": str(verts.shape[0]),
                "X-Verts": str(verts.shape[1]),
                # animation clock: 60 fps (vocaset / frame models), 25 (BIWI)
                "X-FPS": str(getattr(daemon.predictor, "fps", 60)),
            }
            if "application/json" in self.headers.get("Accept", ""):
                self._reply(
                    200,
                    json.dumps({"shape": list(verts.shape),
                                "vertices": verts.tolist()}).encode(),
                    "application/json", headers,
                )
            else:
                buf = io.BytesIO()
                np.save(buf, np.ascontiguousarray(verts, np.float32))
                self._reply(200, buf.getvalue(), "application/x-npy", headers)

    return Handler
