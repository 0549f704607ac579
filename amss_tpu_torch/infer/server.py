"""An HTTP serving daemon over exported artifacts, on the standard library
alone (``amss_tpu/infer/server.py``).

A serving host loads an artifact (``infer/export.py``: no model code, no
tracing) and answers over HTTP: ``http.server``'s threaded accept loop, one
lock around the artifact (requests take turns on the one card; concurrency
comes from batching, not from parallel dispatch).

Endpoints of an offline artifact (kind "offline"):
  GET  /healthz            -> {"status": "ok", kind, n_speakers, sample_rate}
  POST /separate           body: 16- or 32-bit PCM WAV at the artifact's rate
                           -> {"speakers": [<base64 wav>, ...], "sample_rate"}

Endpoints of a realtime artifact (kind "realtime", n_streams == 1):
  POST /stream/reset       start a new stream (zero the state)
  POST /stream/push        body: exactly chunk_samples raw float32 LE samples
                           -> raw float32 LE bytes, [n_speakers, chunk] in C
                           order, lagging by ``lag`` samples; the header
                           X-End-Frame may carry the utterance's frame count

Start it with ``python -m amss_tpu_torch serve --export-dir DIR --port 8080``
or ``SeparationServer(artifact_dir).serve_forever()``.
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import wave as wave_mod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from amss_tpu_torch.infer.export import RealtimeArtifact, ServingArtifact


def wav_bytes_decode(data: bytes) -> tuple[np.ndarray, int]:
    """A WAV file's bytes -> (float32 samples of its first channel, rate), as
    ``data/store.py::_read_wav`` reads a file (16- or 32-bit PCM)."""
    with wave_mod.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch)[:, 0]
    return x, sr


def wav_bytes_encode(x: np.ndarray, sample_rate: int) -> bytes:
    """Samples -> a 16-bit PCM WAV file's bytes, as
    ``infer/evaluate.py::write_wav`` writes one."""
    pcm = np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


class SeparationServer:
    """HTTP front over a ServingArtifact or RealtimeArtifact directory, run
    on ``device`` (``cuda`` unless the caller names another)."""

    def __init__(self, artifact_dir: str, host: str = "127.0.0.1", port: int = 8080,
                 device=None):
        with open(os.path.join(artifact_dir, "export_meta.json")) as f:
            self.kind = json.load(f).get("kind", "offline")
        if self.kind == "realtime":
            self.art = RealtimeArtifact(artifact_dir, device=device)
            if self.art.b != 1:
                raise ValueError(
                    "the HTTP stream endpoints serve one stream per server (this artifact "
                    f"has n_streams={self.art.b}); several streams are pushed together, "
                    "through RealtimeArtifact.separate_streams in the process")
        else:
            self.art = ServingArtifact(artifact_dir, device=device)
        self._lock = threading.Lock()  # one artifact call at a time
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; the caller owns logging
                pass

            def _reply(self, code: int, body: bytes, ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj):
                self._reply(code, json.dumps(obj).encode())

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok", "kind": server.kind,
                                     "n_speakers": server.art.n_speakers,
                                     "sample_rate": server.art.sample_rate})
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    self._route_post()
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 -- the daemon answers 500 with the cause
                    self._json(500, {"error": repr(e)[:300]})

            def _route_post(self):
                if self.path == "/separate" and server.kind == "offline":
                    wave, sr = wav_bytes_decode(self._body())
                    if sr != server.art.sample_rate:
                        raise ValueError(f"wav is {sr} Hz; artifact serves "
                                         f"{server.art.sample_rate} Hz")
                    with server._lock:
                        est = server.art.separate_all([wave])[0]
                    self._json(200, {
                        "speakers": [base64.b64encode(wav_bytes_encode(est[s], sr)).decode()
                                     for s in range(est.shape[0])],
                        "sample_rate": sr,
                    })
                elif self.path == "/stream/reset" and server.kind == "realtime":
                    with server._lock:
                        server.art.reset()
                    self._json(200, {"status": "reset"})
                elif self.path == "/stream/push" and server.kind == "realtime":
                    chunk = np.frombuffer(self._body(), np.float32)
                    if chunk.shape != (server.art.c,):
                        raise ValueError(f"push body must be {server.art.c} float32 samples, "
                                         f"got {chunk.shape[0]}")
                    ef = self.headers.get("X-End-Frame")
                    end_frame = int(ef) if ef is not None else None
                    with server._lock:
                        out = server.art.push(chunk, end_frame=end_frame)
                    self._reply(200, np.ascontiguousarray(out).tobytes(),
                                "application/octet-stream")
                else:
                    raise ValueError(f"no route {self.path} for a {server.kind} artifact")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
