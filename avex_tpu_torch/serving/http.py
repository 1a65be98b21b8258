"""Stdlib HTTP front end for :class:`~avex_tpu_torch.serving.InferenceService`.

Port of ``avex_tpu/serving/http.py``.

A deliberately dependency-free server (``http.server.ThreadingHTTPServer``):
each request thread decodes its payload on the host and blocks on the
service's Future, so concurrent requests coalesce into one device batch —
the HTTP thread pool is the natural producer side of the micro-batcher.
A request waits at most ``request_timeout`` seconds for its row.

Endpoints:

- ``POST /embed`` (or ``/logits``): one audio clip per request. Payload is
  sniffed by magic bytes: ``.npy`` (float waveform; pass ``?sr=`` if not at
  the model rate), RIFF/WAV, FLAC, or JSON ``{"wav": [...], "sr": 16000}``.
  Response: ``{"output": [...], "shape": [...]}``.
- ``GET /healthz``: liveness.
- ``GET /info``: model/service metadata + batching stats.

When constructed with a :class:`~avex_tpu_torch.serving.ServicePool` (multi-model
co-hosting), three more routes appear; the bare routes above keep serving
the pool's default (first) model:

- ``POST /models/<name>/embed`` (or ``/logits``): per-model inference.
- ``GET /models/<name>/info``: that model's metadata + stats.
- ``GET /models``: the pool roster.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from avex_tpu_torch._native import decode_audio_bytes
from avex_tpu_torch.serving.pool import ServicePool

__all__ = ["AvexHTTPServer"]


def _decode_payload(body: bytes, sr_hint: Optional[int]) -> Tuple[np.ndarray, Optional[int]]:
    """Sniff and decode one request body into (waveform, sample_rate).

    sample_rate ``None`` means "already at the model rate" (npy/JSON without
    an explicit ``sr``).
    """
    if body[:6] == b"\x93NUMPY":
        wav = np.load(io.BytesIO(body), allow_pickle=False)
        return np.asarray(wav, np.float32), sr_hint
    if body[:4] in (b"RIFF", b"fLaC"):
        wav, sr = decode_audio_bytes(body, mono=True)
        return wav, sr
    payload = json.loads(body.decode("utf-8"))
    wav = np.asarray(payload["wav"], np.float32)
    return wav, payload.get("sr", sr_hint)


class _Handler(BaseHTTPRequestHandler):
    service = None  # default service, injected by AvexHTTPServer subclassing
    pool = None  # ServicePool for /models/* routes (None = single-model)
    request_timeout = None  # seconds a request waits for its row (None = no limit)
    server_version = "avex-tpu-torch"

    def log_message(self, *args) -> None:
        """Suppress stdlib per-request stderr logging."""

    def _send(self, code: int, obj: Any) -> None:
        data = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _route(self, path: str) -> Tuple[Any, str]:
        """Resolve a request path to ``(service, tail)``.

        ``/models/<name>/<tail>`` targets a pooled model; anything else
        targets the default service with the whole path as the tail.
        Returns ``(None, tail)`` for an unknown pooled name (already 404'd).
        """
        if self.pool is not None and path.startswith("/models/"):
            name, _, tail = path[len("/models/"):].partition("/")
            if name not in self.pool:
                self._send(
                    404,
                    {"error": f"unknown model {name!r}", "models": self.pool.names()},
                )
                return None, tail
            return self.pool.get(name), tail
        return self.service, path.lstrip("/")

    def do_GET(self) -> None:  # noqa: N802 (stdlib API)
        """Route GET /healthz, /info, /models and /models/<name>/info."""
        path = urlparse(self.path).path
        if path == "/healthz":
            self._send(200, {"status": "ok"})
            return
        if path == "/models" and self.pool is not None:
            self._send(200, self.pool.info())
            return
        service, tail = self._route(path)
        if service is None:
            return
        if tail == "info":
            self._send(200, service.info())
        else:
            self._send(404, {"error": f"unknown path {path}"})

    def do_POST(self) -> None:  # noqa: N802 (stdlib API)
        """Route POST [/models/<name>]/embed|/logits: decode, submit, await."""
        url = urlparse(self.path)
        # Read the body up front so every response path — including the
        # 404/409 errors below — leaves the connection fully drained. With
        # stdlib HTTP/1.0 (no keep-alive) this is belt-and-braces, but it
        # makes a future protocol_version="HTTP/1.1" bump safe: leftover
        # body bytes would otherwise corrupt the next request on a
        # kept-alive connection.
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        service, mode = self._route(url.path)
        if service is None:
            return
        if mode not in ("embed", "logits"):
            self._send(404, {"error": f"unknown path {url.path}"})
            return
        if mode != service.config.mode:
            self._send(
                409,
                {"error": f"service is configured for mode={service.config.mode!r}"},
            )
            return
        try:
            query = parse_qs(url.query)
            sr = int(query["sr"][0]) if "sr" in query else None
            wav, wav_sr = _decode_payload(body, sr)
            out = np.asarray(service.submit(wav, sr=wav_sr).result(timeout=self.request_timeout))
            self._send(200, {"output": out.tolist(), "shape": list(out.shape)})
        except Exception as err:  # noqa: BLE001 — map to a 400, never crash the server
            self._send(400, {"error": f"{type(err).__name__}: {err}"})


class AvexHTTPServer:
    """Threaded HTTP server bound to an :class:`InferenceService` or a
    :class:`~avex_tpu_torch.serving.ServicePool` (multi-model co-hosting).

    ``port=0`` binds an ephemeral port (read it back from ``.port``) — used
    by tests and by schedulers that allocate ports externally.
    """

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 request_timeout: Optional[float] = None) -> None:
        pool = service if isinstance(service, ServicePool) else None
        default = pool.default if pool is not None else service
        handler = type(
            "_BoundHandler", (_Handler,),
            {"service": default, "pool": pool, "request_timeout": request_timeout},
        )
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.service = default
        self.pool = pool
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._loop_ident: Optional[int] = None  # the thread running the accept loop
        self._loop_done = threading.Event()  # set while no accept loop runs
        self._loop_done.set()
        self._closed = False  # stop() closed the socket

    def _serve(self) -> None:
        self._loop_ident = threading.get_ident()
        try:
            self._httpd.serve_forever()
        finally:
            self._loop_done.set()

    def start(self) -> "AvexHTTPServer":
        """Serve on a daemon thread; returns self for ``with``-style use."""
        self._loop_done.clear()
        self._thread = threading.Thread(target=self._serve, daemon=True, name="avex-http")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        """Serve on the calling thread until :meth:`stop` is called (from
        another thread, or from a signal handler on this one, also before
        the loop begins) or until ``KeyboardInterrupt`` unwinds out of it;
        then call :meth:`stop` to close the socket."""
        self._loop_ident = threading.get_ident()
        self._loop_done.clear()
        if self._closed:  # a stop() came first
            self._loop_done.set()
            return
        self._serve()

    def stop(self) -> None:
        """Shut down the listener and join the serving thread.

        Called on the thread that runs the accept loop (a signal handler that
        interrupted :meth:`serve_forever`), it cannot wait for that loop: it
        asks a helper thread to end it and returns; the loop ends within its
        poll interval and its caller closes the socket with a second call."""
        if not self._loop_done.is_set():
            if threading.get_ident() == self._loop_ident:
                threading.Thread(target=self._httpd.shutdown, daemon=True, name="avex-http-stop").start()
                return
            self._httpd.shutdown()
        self._closed = True
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self) -> "AvexHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
