"""TCP wire surface for live streaming inference.

Port of ``audio2face_tpu/live_server.py``, with the same wire format.
The in-process live path — ``StreamingServer`` batching N concurrent
sessions onto one GPU (multistream.py FaceFormer pool or
frame_stream.py frame-model pool) — gets a network front end here, the
streaming counterpart of the offline HTTP daemon (http_server.py): a
dependency-free (stdlib ``socketserver``) framed-TCP protocol so clients
in any language can stream microphone audio in and receive vertex
animation frames back while still speaking. Mirrors the live use the
reference targets with its windowed dataset geometry
(src/dataset/vocaset.py:408-430) but never ships a server for.

Wire protocol (all integers little-endian)::

    message := type(1 byte) + length(uint32) + payload[length]

    client -> server
      b"H"  JSON hello {"subject": int (default 0),
                        "sample_rate": int (must equal the pool's),
                        "timeout": float seconds to wait for a free slot
                                   (default 0 = fail fast when full)}
      b"A"  raw float32 PCM chunk (any size; the pool re-chunks)
      b"P"  poll (empty payload) — collect frames produced for this
            session by other sessions' pushes without feeding audio
      b"E"  end of audio (empty payload)

    server -> client
      b"O"  JSON hello-ack {"verts": V, "fps": F, "sample_rate": SR,
                            "streams": N}
      b"V"  raw float32 (T, V, 3) vertex frames; T = length / (V*3*4)
      b"D"  end of animation (sent after b"E" once the tail is decoded);
            the server closes the connection afterwards
      b"X"  JSON {"error": msg}; the server closes the connection

Any b"A"/b"P" may be answered by zero or one b"V" (frames decode in
pool-chunk granularity, and a session also receives frames whenever OTHER
sessions' pushes advance the shared batched step). Between client
messages the handler idles on a short socket timeout and polls, so
piggybacked frames reach slow senders without waiting for their next
chunk.

Every session costs one pool slot for the connection's lifetime;
``hello.timeout`` bounds how long a connect waits for a free slot
(bounded-pool backpressure, the live analogue of the HTTP daemon's 429).
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Optional

import numpy as np

from audio2face_tpu_torch.multistream import StreamingServer

_HEADER = struct.Struct("<cI")
MAX_PAYLOAD = 1 << 28  # 256 MiB: caps a malicious/corrupt length word


def send_msg(sock: socket.socket, typ: bytes, payload: bytes = b"") -> None:
    """Write one framed message (blocking, complete)."""
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"payload of {len(payload)} bytes exceeds the frame cap")
    sock.sendall(_HEADER.pack(typ, len(payload)) + payload)


def recv_msg(sock: socket.socket) -> Optional[tuple[bytes, bytes]]:
    """Read one framed message; None on clean EOF at a frame boundary.

    Raises ``socket.timeout`` when the socket has a timeout and no header
    byte arrives in it (mid-frame timeouts keep blocking until the frame
    completes — a frame, once started, is read whole)."""
    head = _recv_exact(sock, _HEADER.size, allow_eof=True)
    if head is None:
        return None
    typ, length = _HEADER.unpack(head)
    if length > MAX_PAYLOAD:
        raise ValueError(f"frame of {length} bytes exceeds the {MAX_PAYLOAD} cap")
    old = sock.gettimeout()
    sock.settimeout(None)  # finish the started frame even on a slow sender
    try:
        payload = _recv_exact(sock, length) if length else b""
    finally:
        sock.settimeout(old)
    return typ, payload


def _recv_exact(sock: socket.socket, n: int, allow_eof: bool = False):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if allow_eof and not buf:
                return None
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


class LiveStreamingDaemon:
    """Own a ``StreamingServer`` (or build one) + serve it over framed TCP.

    Usage::

        daemon = LiveStreamingDaemon(server=StreamingServer(variables, n_verts))
        port = daemon.start()      # returns once the socket is bound
        ...                        # clients connect and stream
        daemon.stop()

    ``idle_poll_ms`` is how often an idle connection polls its session for
    frames produced by other sessions' pushes.
    """

    def __init__(
        self,
        server: Optional[StreamingServer] = None,
        template: Optional[np.ndarray] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        idle_poll_ms: float = 50.0,
        max_slot_wait: float = 30.0,
        hello_deadline: float = 30.0,
        **server_kwargs,
    ):
        if server is None:
            server = StreamingServer(**server_kwargs)
        elif server_kwargs:
            raise TypeError("pass either server= or StreamingServer arguments, not both")
        self.server = server
        if template is not None and (
            template.ndim != 2 or template.shape != (server.n_verts // 3, 3)
        ):
            raise ValueError(
                f"template must be ({server.n_verts // 3}, 3), got {template.shape}"
            )
        self.template = None if template is None else np.asarray(template, np.float32)
        self.hello_deadline = float(hello_deadline)
        self.host, self.port = host, int(port)
        self.idle_poll = max(idle_poll_ms, 1.0) / 1e3
        self.max_slot_wait = float(max_slot_wait)
        self._stats_lock = threading.Lock()
        self._stats = {"connections": 0, "sessions": 0, "rejected": 0,
                       "errors": 0, "frames_out": 0, "samples_in": 0}
        self._tcpd: Optional[socketserver.ThreadingTCPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _count(self, key: str, delta: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += delta

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["streams"] = self.server.n_streams
        return out

    # ------------------------------------------------------------ server

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        self._tcpd = _make_tcpd(self)
        self.port = self._tcpd.server_address[1]
        self._thread = threading.Thread(
            target=self._tcpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.port

    def serve_forever(self) -> None:
        """Foreground variant for the CLI."""
        self._tcpd = _make_tcpd(self)
        self.port = self._tcpd.server_address[1]
        self._tcpd.serve_forever()

    def stop(self) -> None:
        if self._tcpd is not None:
            self._tcpd.shutdown()
            self._tcpd.server_close()
            self._tcpd = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ----------------------------------------------------- one connection

    def handle_connection(self, sock: socket.socket) -> None:
        self._count("connections")
        sess = None
        try:
            sock.settimeout(self.idle_poll)
            hello = self._read_hello(sock)
            if hello is None:
                return
            subject, timeout = hello
            srv = self.server
            one_hot = np.eye(srv.n_onehot, dtype=np.float32)[subject]
            template = self._template()
            try:
                sess = srv.open_session(
                    one_hot, template,
                    wait=timeout > 0,
                    timeout=min(timeout, self.max_slot_wait) or None,
                )
            except (RuntimeError, TimeoutError):
                self._count("rejected")
                send_msg(sock, b"X", json.dumps(
                    {"error": f"all {srv.n_streams} stream slots are busy"}
                ).encode())
                return
            self._count("sessions")
            send_msg(sock, b"O", json.dumps({
                "verts": srv.n_verts // 3,
                "fps": srv.fps,
                "sample_rate": srv.sample_rate,
                "streams": srv.n_streams,
            }).encode())
            self._pump_messages(sock, sess)
        except (ConnectionError, BrokenPipeError, OSError):
            pass  # peer went away; release the slot and move on
        except Exception as e:  # protocol/server error: tell the client
            self._count("errors")
            try:
                send_msg(sock, b"X", json.dumps({"error": str(e)}).encode())
            except OSError:
                pass
        finally:
            if sess is not None:
                sess.close()

    def _read_hello(self, sock: socket.socket):
        """Parse the hello frame; None on EOF. A connection that never says
        hello is dropped after ``hello_deadline`` so it can't pin a handler
        thread forever (it holds no slot either way)."""
        import time

        deadline = time.monotonic() + self.hello_deadline
        while True:
            try:
                msg = recv_msg(sock)
                break
            except socket.timeout:
                if time.monotonic() > deadline:
                    raise ValueError("no hello within the deadline")
        if msg is None:
            return None
        typ, payload = msg
        if typ != b"H":
            raise ValueError(f"expected hello (H) first, got {typ!r}")
        hello = json.loads(payload.decode() or "{}")
        srv = self.server
        sr = int(hello.get("sample_rate", srv.sample_rate))
        if sr != srv.sample_rate:
            raise ValueError(
                f"live streams must send {srv.sample_rate} Hz PCM, got {sr} "
                "(resample client-side; the offline HTTP daemon accepts any rate)"
            )
        subject = int(hello.get("subject", 0))
        if not 0 <= subject < srv.n_onehot:
            raise ValueError(
                f"subject must be in [0, {srv.n_onehot}), got {subject}"
            )
        return subject, float(hello.get("timeout", 0.0))

    def _pump_messages(self, sock: socket.socket, sess) -> None:
        while True:
            try:
                msg = recv_msg(sock)
            except socket.timeout:
                self._send_frames(sock, sess.poll())
                continue
            if msg is None:
                return  # client hung up without E; slot released in finally
            typ, payload = msg
            if typ == b"A":
                if len(payload) % 4:
                    raise ValueError(
                        f"audio payload of {len(payload)} bytes is not a "
                        "whole number of float32 samples"
                    )
                audio = np.frombuffer(payload, "<f4")
                self._count("samples_in", audio.size)
                self._send_frames(sock, sess.push(audio))
            elif typ == b"P":
                self._send_frames(sock, sess.poll())
            elif typ == b"E":
                self._send_frames(sock, sess.flush())
                send_msg(sock, b"D")
                return
            else:
                raise ValueError(f"unknown message type {typ!r}")

    def _send_frames(self, sock: socket.socket, frames: np.ndarray) -> None:
        if frames.size:
            self._count("frames_out", frames.shape[0])
            send_msg(sock, b"V",
                     np.ascontiguousarray(frames, "<f4").tobytes())

    def _template(self) -> np.ndarray:
        if self.template is None:
            return np.zeros((self.server.n_verts // 3, 3), np.float32)
        return self.template


def _make_tcpd(daemon: LiveStreamingDaemon) -> socketserver.ThreadingTCPServer:
    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            daemon.handle_connection(self.request)

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    return Server((daemon.host, daemon.port), Handler)


class LiveClient:
    """Reference Python client for the wire protocol (used by the tests and
    as the template for clients in other languages).

    Usage::

        with LiveClient(port, subject=2, timeout=5.0) as c:
            frames = c.send(pcm_chunk)        # (T, V, 3), possibly T=0
            ...
            frames = c.finish()               # tail frames through b"D"
    """

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        *,
        subject: int = 0,
        sample_rate: Optional[int] = None,
        timeout: float = 0.0,
        io_timeout: float = 300.0,
    ):
        self._sock = socket.create_connection((host, port), timeout=io_timeout)
        hello = {"subject": subject, "timeout": timeout}
        if sample_rate is not None:
            hello["sample_rate"] = sample_rate
        send_msg(self._sock, b"H", json.dumps(hello).encode())
        typ, payload = self._expect({b"O"})
        self.info = json.loads(payload.decode())
        self.n_verts = int(self.info["verts"])
        self.fps = int(self.info["fps"])

    def _expect(self, types: set) -> tuple[bytes, bytes]:
        msg = recv_msg(self._sock)
        if msg is None:
            raise ConnectionError("server closed the connection")
        typ, payload = msg
        if typ == b"X" and b"X" not in types:
            raise RuntimeError(json.loads(payload.decode())["error"])
        if typ not in types:
            raise RuntimeError(f"unexpected message {typ!r}")
        return msg

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.n_verts, 3), np.float32)

    def _frames_of(self, payload: bytes) -> np.ndarray:
        return np.frombuffer(payload, "<f4").reshape(-1, self.n_verts, 3)

    def send(self, audio: np.ndarray) -> np.ndarray:
        """Push a PCM chunk; returns frames decoded so far (maybe empty).

        One b"A" is answered by at most one b"V" — but never zero-or-one
        deterministically, so this drains the socket until it would block."""
        send_msg(self._sock, b"A",
                 np.ascontiguousarray(audio, "<f4").tobytes())
        return self.poll(drain_only=False)

    def poll(self, drain_only: bool = True) -> np.ndarray:
        """Collect any frames the server has pushed since the last call."""
        if drain_only:
            send_msg(self._sock, b"P")
        # a push/poll is answered by 0..n V frames; read with a short grace
        out = [self._empty()]
        old = self._sock.gettimeout()
        self._sock.settimeout(0.25)
        try:
            while True:
                try:
                    msg = recv_msg(self._sock)
                except socket.timeout:
                    break
                if msg is None:
                    raise ConnectionError("server closed the connection")
                typ, payload = msg
                if typ == b"X":
                    raise RuntimeError(json.loads(payload.decode())["error"])
                if typ != b"V":
                    raise RuntimeError(f"unexpected message {typ!r}")
                out.append(self._frames_of(payload))
        finally:
            self._sock.settimeout(old)
        return np.concatenate(out)

    def finish(self) -> np.ndarray:
        """End the stream; returns every remaining frame (through b"D")."""
        send_msg(self._sock, b"E")
        out = [self._empty()]
        while True:
            typ, payload = self._expect({b"V", b"D"})
            if typ == b"D":
                break
            out.append(self._frames_of(payload))
        return np.concatenate(out)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
