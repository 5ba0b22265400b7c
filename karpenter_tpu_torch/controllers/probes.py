"""Health/readiness probes + metrics endpoint: the operator's HTTP surface
(a copy of the JAX package's `controllers/probes.py`; /debug/programs
serves the port's prewarm manifest).

Reference pkg/operator/operator.go:183-221: the manager
serves /healthz and /readyz (readiness gated on the informers/CRDs being
synced) plus the Prometheus registry on the metrics port. This framework's
single-process operator starts the same three endpoints on a background
thread when `Options.probe_port` is set (port 0 picks a free one):

- /healthz  — liveness: the process serves requests.
- /readyz   — readiness: the cluster-state cache is synced with the store
  (the same barrier every controller takes before acting, cluster.go:118).
- /metrics  — the Prometheus-style exposition of karpenter_tpu_torch.metrics.
- /debug/solves       — recent solve-trace summaries from the bounded
  telemetry ring (karpenter_tpu_torch.tracing; docs/observability.md). Always
  on: the ring + phase histograms are the default-cost telemetry tier.
- /debug/solves/<id>  — the full phase waterfall of one trace; a wire
  correlation id returns BOTH the client- and server-side halves. An
  unknown (or garbage) id answers 404 with a JSON error body — the
  endpoint's content type never depends on whether the lookup hit.
- /debug/programs     — the prewarm catalog (solver/aot.py
  aot_manifest.json in the build's hash directory): every prewarmed
  (entry x rung x relax) combo with its bucket signature, build seconds,
  first-launch milliseconds, the bytes its tensors hold, and each kernel's
  registers and shared memory from the ptxas log.

When constructed with enable_profiling=True (operator.go:183 --enable-
profiling gate) it additionally serves the pprof analogs from
karpenter_tpu_torch.profiling — and flips the tracing detail gate, so traces
carry per-dispatch sub-spans (pod_xs/kernel/fetch) while the gate is up:

- /debug/pprof/profile?seconds=N — sampling CPU profile of every live
  thread, collapsed-stack format (add &top=1 for a pprof-top table).
  N is clamped to MAX_PROFILE_SECONDS; non-numeric or non-positive N
  answers 400 (a handler thread must never block on attacker-shaped
  query strings).
- /debug/pprof/heap — tracemalloc top allocation sites.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from karpenter_tpu_torch import metrics, tracing

# hard ceiling on one /debug/pprof/profile sampling window: the handler
# thread blocks for the whole window, so the query string must not be able
# to park it for arbitrary time (operator.go:183's pprof has the same
# property via http server timeouts)
MAX_PROFILE_SECONDS = 60.0


class ProbeServer:
    def __init__(
        self,
        kube,
        cluster,
        port: int = 0,
        host: str = "127.0.0.1",
        enable_profiling: bool = False,
    ):
        self.kube = kube
        self.cluster = cluster
        self.enable_profiling = enable_profiling
        self._host = host
        self._port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._detail_set = False  # we flipped the tracing detail gate

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> None:
        kube, cluster = self.kube, self.cluster
        profiling_on = self.enable_profiling
        # the pprof gate doubles as the per-span-detail gate: while it is
        # up, traces record each dispatch's pod_xs/kernel/fetch sub-spans
        if profiling_on and not tracing.detail_enabled():
            tracing.set_detail(True)
            self._detail_set = True

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _reply(self, code: int, body: str, ctype="text/plain"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, "ok")
                elif self.path == "/readyz":
                    try:
                        ready = cluster.synced(kube)
                    except Exception:
                        ready = False
                    self._reply(200 if ready else 503, "ok" if ready else "state not synced")
                elif self.path == "/metrics":
                    try:
                        body = metrics.REGISTRY.render()
                    except Exception as e:  # registry mutating mid-render
                        self._reply(503, f"metrics unavailable: {e}")
                        return
                    self._reply(200, body, ctype="text/plain; version=0.0.4")
                elif self.path == "/debug/solves":
                    # newest first; summaries only (spans via /<id>)
                    body = json.dumps(
                        [
                            t.to_dict(summary=True)
                            for t in reversed(tracing.RING.snapshot())
                        ]
                    )
                    self._reply(200, body, ctype="application/json")
                elif self.path.startswith("/debug/solves/"):
                    ident = self.path[len("/debug/solves/"):]
                    found = tracing.RING.find(ident)
                    if not found:
                        # a JSON 404 body for unknown AND garbage ids:
                        # a dashboard polling a rotated-out trace id must
                        # get machine-readable "gone", not a text/plain
                        # surprise
                        self._reply(
                            404,
                            json.dumps(
                                {
                                    "error": "no trace with this id in the ring",
                                    "id": ident,
                                }
                            ),
                            ctype="application/json",
                        )
                        return
                    # a wire id matches the client- AND server-side halves
                    # of one logical trace; the waterfall is the spans
                    # ordered by t0 within each half
                    body = json.dumps(
                        {"id": ident, "traces": [t.to_dict() for t in found]}
                    )
                    self._reply(200, body, ctype="application/json")
                elif self.path == "/debug/programs":
                    # the prewarm catalog (solver/aot.py): reads the
                    # manifest only — never builds or launches in a handler
                    try:
                        from karpenter_tpu_torch.solver import aot

                        body = json.dumps(aot.program_catalog())
                    except Exception as e:
                        self._reply(503, f"catalog unavailable: {e}")
                        return
                    self._reply(200, body, ctype="application/json")
                elif self.path.startswith("/debug/pprof/") and profiling_on:
                    from urllib.parse import parse_qs, urlparse

                    from karpenter_tpu_torch import profiling

                    url = urlparse(self.path)
                    q = parse_qs(url.query)
                    if url.path == "/debug/pprof/profile":
                        try:
                            seconds = float(q.get("seconds", ["1"])[0])
                        except ValueError:
                            self._reply(400, "seconds must be a number")
                            return
                        if not (seconds > 0):  # also rejects NaN
                            self._reply(400, "seconds must be positive")
                            return
                        sampler = profiling.profile_cpu(
                            min(seconds, MAX_PROFILE_SECONDS)
                        )
                        body = (
                            sampler.render_top()
                            if q.get("top", ["0"])[0] == "1"
                            else sampler.render_collapsed()
                        )
                        self._reply(200, body)
                    elif url.path == "/debug/pprof/heap":
                        self._reply(200, profiling.heap_snapshot())
                    else:
                        self._reply(404, "unknown pprof endpoint")
                else:
                    self._reply(404, "not found")

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._detail_set:
            tracing.set_detail(False)
            self._detail_set = False
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
