"""Zero-dependency scrape endpoint for a running SparseEngine.

A stdlib :class:`http.server.ThreadingHTTPServer` on a daemon thread,
exposing:

* ``GET /metrics`` — Prometheus text exposition, concatenating the
  engine's registry, the graph registry's, the tune cache's (when it is
  a :class:`~repro_torch.tune.cache.PlanCache`), and the process default —
  deduplicated, so sharing one :class:`MetricsRegistry` across tiers
  (the common case) emits each series once;
* ``GET /health`` — ``engine.health()`` as JSON (breakers, degradation,
  failure/deadline accounting);
* ``GET /memory[?top_k=N]`` — the registry's exact device-byte
  attribution (:meth:`~repro_torch.serve.registry.GraphRegistry
  .memory_report`) as JSON; 404 when accounting is disabled
  (``mem=False``);
* ``GET /stats`` — ``engine.stats()`` as JSON (throughput, padding
  waste, bucket occupancy, exec-cache hits, the registry's counters);
* ``GET /explain/<graph>[?op=spmm|sddmm]`` — the plan explainer's
  report (:func:`repro_torch.obs.explain.explain_entry`) as JSON;
  unknown graphs are 404, sharded graphs (which explain rejects) and
  bad ops 400.

Start one with ``engine.serve_http()`` or directly::

    with ObsHTTPServer(engine) as srv:
        urllib.request.urlopen(srv.url + "/metrics")

Port 0 (the default) binds an ephemeral port; read it back from
``srv.port``/``srv.url``.
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_EXPOSITION_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _jsonable(obj):
    """numpy-tolerant JSON fallback for health/stats payloads."""
    if hasattr(obj, "item"):        # numpy scalar
        return obj.item()
    if hasattr(obj, "tolist"):      # numpy array
        return obj.tolist()
    if isinstance(obj, set):
        return sorted(obj)
    return str(obj)


class ObsHTTPServer:
    """Scrape endpoint wrapping one engine; context-manager friendly."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # keep scrapes silent
                pass

            def do_GET(self):
                try:
                    outer._route(self)
                except BrokenPipeError:
                    pass
                except Exception as exc:      # surface, don't kill thread
                    try:
                        outer._send(self, 500, "text/plain; charset=utf-8",
                                    f"internal error: {exc}\n")
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-torch-obs-http",
            daemon=True)
        self._started = False

    # ------------------------------------------------------ lifecycle ---
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "ObsHTTPServer":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "ObsHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------- routing ---
    def _registries(self):
        """All metric registries visible from the engine, deduped by
        identity (tiers usually share one)."""
        from repro_torch.obs.metrics import default_registry
        from repro_torch.tune.cache import PlanCache

        regs = [self.engine.metrics, self.engine.registry.metrics]
        pc = getattr(self.engine.registry, "tune_cache", None)
        if isinstance(pc, PlanCache):
            regs.append(pc.metrics)
        regs.append(default_registry())
        seen, out = set(), []
        for r in regs:
            if r is not None and id(r) not in seen:
                seen.add(id(r))
                out.append(r)
        return out

    def _send(self, handler, status: int, ctype: str, body: str) -> None:
        payload = body.encode()
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        handler.wfile.write(payload)

    def _send_json(self, handler, status: int, doc) -> None:
        self._send(handler, status, "application/json",
                   json.dumps(doc, default=_jsonable) + "\n")

    def _route(self, handler) -> None:
        parsed = urllib.parse.urlsplit(handler.path)
        path = parsed.path
        if path == "/metrics":
            body = "".join(r.exposition() for r in self._registries())
            self._send(handler, 200, _EXPOSITION_TYPE, body)
        elif path == "/health":
            self._send_json(handler, 200, self.engine.health())
        elif path == "/memory":
            registry = self.engine.registry
            if getattr(registry, "mem", None) is None:
                self._send_json(handler, 404,
                                {"error": "byte accounting disabled"})
                return
            query = urllib.parse.parse_qs(parsed.query)
            top_k = int(query.get("top_k", ["8"])[0])
            self._send_json(handler, 200,
                            registry.memory_report(top_k=top_k))
        elif path == "/stats":
            self._send_json(handler, 200, self.engine.stats())
        elif path.startswith("/explain/"):
            name = urllib.parse.unquote(path[len("/explain/"):])
            query = urllib.parse.parse_qs(parsed.query)
            op = query.get("op", ["spmm"])[0]
            from repro_torch.obs.explain import explain_entry

            try:
                report = explain_entry(self.engine.registry, name, op=op)
            except KeyError:
                self._send_json(handler, 404,
                                {"error": f"unknown graph {name!r}"})
                return
            except ValueError as exc:       # sharded graphs, bad op
                self._send_json(handler, 400, {"error": str(exc)})
                return
            self._send_json(handler, 200, report)
        else:
            self._send_json(handler, 404,
                            {"error": f"unknown path {path!r}",
                             "routes": ["/metrics", "/health", "/memory",
                                        "/stats", "/explain/<graph>"]})


def serve_obs_http(engine, host: str = "127.0.0.1",
                   port: int = 0) -> ObsHTTPServer:
    """Start (and return) a scrape endpoint for ``engine``."""
    return ObsHTTPServer(engine, host=host, port=port).start()
