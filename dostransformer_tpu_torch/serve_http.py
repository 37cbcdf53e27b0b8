"""Dependency-free HTTP model server over the serving path.

Counterpart of dostransformer_tpu/serve_http.py, ported as it stands:
featurize -> (train ->) checkpoint or exported artifact -> network endpoint.
Stdlib-only (http.server) — no new dependencies.

Protocol (binary npz both ways — the same exchange format as data/io.py, so
clients reuse ``save_samples`` to build request bodies):

  POST /predict   body: featurized samples npz  ->  npz {dos, sample_id, mp_id}
  GET  /healthz   ->  JSON {"status": "ok", "batch_size": ...}

Device access is serialized with a lock (one card; a graph's capture runs
inside it); request decode and response encode run concurrently on the
ThreadingHTTPServer's threads. ``coalesce_ms > 0`` replaces the lock with a
CoalescingBatcher (serve_batch.py), whose one worker thread is then the only
one that touches the card: concurrent requests merge into one predictor
call, paying at most that much extra latency for much higher throughput
under load.

    server = make_server(predictor, port=8000, coalesce_ms=2.0)
    server.serve_forever()
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from dostransformer_tpu_torch.data.graph import RequestError
from dostransformer_tpu_torch.data.io import load_samples


def make_server(predictor, host: str = "127.0.0.1", port: int = 0,
                coalesce_ms: float = 0.0,
                max_body_mb: int = 256) -> ThreadingHTTPServer:
    """HTTP server around a Predictor / ExportedPredictor. ``port=0`` binds
    an ephemeral port (read it back from ``server.server_address``).
    ``coalesce_ms > 0`` micro-batches concurrent requests into single
    device dispatches (serve_batch.CoalescingBatcher); the batcher is
    stopped by ``server.server_close()``. ``max_body_mb`` bounds a request
    body — each connection gets its own thread, so an unbounded (or
    negative) Content-Length would let one client allocate arbitrary
    memory (or pin a thread on a never-ending read)."""
    device_lock = threading.Lock()
    max_body = max_body_mb * (1 << 20)
    batcher = None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; callers log themselves
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {
                    "status": "ok",
                    "batch_size": getattr(predictor, "batch_size", None)})
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send_json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if length < 0:
                self._send_json(400, {"error": "bad Content-Length"})
                return
            if length > max_body:
                self._send_json(413, {
                    "error": f"request body {length} bytes exceeds the "
                             f"{max_body}-byte limit"})
                return
            try:
                samples = load_samples(io.BytesIO(self.rfile.read(length)))
            except Exception as e:  # malformed payload -> client error
                self._send_json(400, {"error": f"bad request body: {e}"})
                return
            try:
                if batcher is not None:
                    dos = batcher.predict(samples)  # serializes internally
                else:
                    with device_lock:
                        dos = predictor.predict(samples)
            except RequestError as e:
                # client-side input errors ONLY (empty request,
                # shape-envelope or schema mismatch — the serving path
                # raises these as RequestError with actionable messages).
                # Other ValueErrors (e.g. a drifted exported artifact's
                # shape mismatch) are SERVER faults and fall through to
                # the 500 below so monitoring/retries see the outage.
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:
                # anything else is a SERVER failure (a failed kernel launch
                # or graph capture, OOM): 5xx so clients/load balancers
                # retry and monitoring sees it, never a silent 4xx
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            buf = io.BytesIO()
            np.savez_compressed(
                buf, dos=dos,
                sample_id=np.asarray([s.sample_id for s in samples]),
                mp_id=np.asarray([s.mp_id for s in samples]))
            self._send(200, buf.getvalue(), "application/octet-stream")

    class Server(ThreadingHTTPServer):
        def server_close(self):
            if batcher is not None:
                batcher.close()
            super().server_close()

    server = Server((host, port), Handler)
    # start the batcher worker only AFTER the socket bound: a bind failure
    # (EADDRINUSE under a retry loop) must not leak a worker thread per
    # attempt. Handlers read `batcher` from the closure at request time.
    if coalesce_ms and coalesce_ms > 0:
        from dostransformer_tpu_torch.serve_batch import CoalescingBatcher

        batcher = CoalescingBatcher(predictor, max_delay_ms=coalesce_ms)
    server.predictor = predictor  # introspection/testing handle
    return server
