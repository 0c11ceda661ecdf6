"""Stdlib HTTP front end for RetrievalEngine (no extra dependencies).

Port of ripor_tpu/serve/http.py. Endpoints:
  POST /retrieve   {"queries": ["...", ...]}
                   -> {"results": [[[docid, score], ...], ...]}
  GET  /stats      engine.stats() JSON
  GET  /healthz    200 {"status": "ok"}
  GET  /profile    ?ms=1000: a torch.profiler trace (host, and the card's
                   kernels where CUDA is present) of live traffic, written
                   as a Chrome trace under ServeConfig.profile_dir. Opt-in
                   (ServeConfig.enable_profile; 403 otherwise), ms capped
                   at 30 s, one trace at a time (409).

Each query is submitted to the engine's microbatcher individually, so
concurrent HTTP clients (the server is threading) share device batches.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ripor_tpu_torch.serve.engine import RetrievalEngine

# only one trace may run at a time (two handler threads must not race the
# profiler)
_PROFILE_LOCK = threading.Lock()
MAX_PROFILE_MS = 30_000


def _capture_trace(out_dir: str, ms: float) -> str:
    """Profile whatever the process runs for ``ms`` milliseconds; returns
    the Chrome trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        time.sleep(ms / 1e3)
    finally:
        prof.stop()        # never leak a running trace
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def _make_handler(engine: RetrievalEngine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet; engine.stats() observes
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                self._json(200, engine.stats())
            elif self.path.startswith("/profile"):
                self._profile()
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def _profile(self):
            # Opt-in only, and the output dir is pinned server-side: a
            # client-supplied path would let any caller write to arbitrary
            # directories, and the default-off gate keeps a 0.0.0.0 bind
            # from exposing a thread-blocking, disk-writing endpoint.
            if not engine.scfg.enable_profile:
                self._json(403, {"error": "profiling disabled "
                                 "(ServeConfig.enable_profile)"})
                return
            q = parse_qs(urlparse(self.path).query)
            try:
                ms = min(float(q.get("ms", ["1000"])[0]), MAX_PROFILE_MS)
            except ValueError:
                ms = float("nan")
            if not ms > 0:        # rejects <=0 AND NaN
                self._json(400, {"error": "bad ms parameter"})
                return
            if not _PROFILE_LOCK.acquire(blocking=False):
                self._json(409, {"error": "a trace is already running"})
                return
            out = engine.scfg.profile_dir
            try:
                path = _capture_trace(out, ms)
            except (RuntimeError, OSError) as e:
                self._json(500, {"error": f"trace failed: {e}"})
                return
            finally:
                _PROFILE_LOCK.release()
            self._json(200, {"trace_dir": out, "trace": path,
                             "captured_ms": ms})

        def do_POST(self):
            if self.path != "/retrieve":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                queries = req["queries"]
                if not (isinstance(queries, list)
                        and all(isinstance(q, str) for q in queries)):
                    raise ValueError("queries must be a list of strings")
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            futures = [engine.submit(q) for q in queries]
            try:
                results = [f.result(timeout=300) for f in futures]
            except Exception as e:        # a failed batch fails the request
                self._json(500, {"error": str(e)})
                return
            self._json(200, {"results": results})

    return Handler


def serve_http(engine: RetrievalEngine, host: str = "127.0.0.1",
               port: int = 8600, block: bool = True) -> ThreadingHTTPServer:
    """Start the engine's batcher + an HTTP server. With block=False the
    server runs on a daemon thread (port via server.server_address[1] —
    pass port=0 for an ephemeral one) and the caller owns shutdown:
    server.shutdown(); server.server_close(); engine.stop()."""
    engine.start()
    server = ThreadingHTTPServer((host, port), _make_handler(engine))
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
            engine.stop()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
