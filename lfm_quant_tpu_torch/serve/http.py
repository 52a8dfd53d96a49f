"""The HTTP front door of the scoring service (stdlib, JSON).

Port of ``serve.py``'s front door (``extract_request_id``, the access
log, ``make_http_server``, ``run_http``), started by ``python -m
lfm_quant_tpu_torch.serve --http PORT``:

    GET /score?universe=c2&month=199001   → the month's scores (propagates
                                            X-Request-Id / traceparent;
                                            echoes the trace id and the
                                            phase breakdown)
    GET /stats                            → the stats rollup (+ts)
    GET /healthz                          → 200 ok | 503 + reason
                                            (+ SLO-burn/drift detail)
    GET /metrics                          → Prometheus text exposition

``/stats`` and ``/healthz`` share one ``service.snapshot()`` call per
request. Failure semantics (serve/errors.py ``http_status``):

    shed (queue at LFM_SERVE_QUEUE_MAX)     → 429 + Retry-After
    circuit open (consecutive failures)     → 503 + Retry-After
    deadline expired / client timed out     → 504
    batcher thread dead (service unready)   → 503
    unknown universe / month                → 404
    /healthz degraded                       → 503 + {"ok": false, reason}

``LFM_ACCESS_LOG`` (default off) writes one JSON line per request.
The fleet's ``/fleet`` and ``/sync`` belong to a later slice of the port.
"""

from __future__ import annotations

import json
import os
import threading
import time


def extract_request_id(headers) -> str | None:
    """Inbound trace identity: ``X-Request-Id`` wins
    (opaque, echoed verbatim after sanitizing), else the W3C
    ``traceparent`` header's 32-hex trace-id field
    (``00-<trace-id>-<span-id>-<flags>``) — so a request entering from
    any tracing fabric keeps its identity through submit → batch →
    dispatch → response. None means the batcher mints a fresh id."""
    rid = headers.get("X-Request-Id")
    if rid:
        return rid
    tp = headers.get("traceparent")
    if tp:
        parts = tp.strip().split("-")
        if len(parts) >= 3 and len(parts[1]) == 32:
            return parts[1]
    return None


def access_log_dest() -> str:
    """``LFM_ACCESS_LOG``: unset/``0`` = off (default), ``1``/
    ``stdout`` = one JSON line per request to stdout, anything else =
    a file path appended to (line-buffered)."""
    return os.environ.get("LFM_ACCESS_LOG", "").strip()


_ACCESS_LOCK = threading.Lock()
_ACCESS_FH = None
_ACCESS_PATH = None


def access_log(record: dict) -> None:
    """Emit one structured access-log line (strict JSON). Knob-gated,
    default OFF; the write happens under a lock so concurrent client
    threads can never tear a line. Never raises — logging must not be
    able to fail a request that already succeeded."""
    global _ACCESS_FH, _ACCESS_PATH
    dest = access_log_dest()
    if not dest or dest == "0":
        return
    try:
        line = json.dumps(record, default=str)
        with _ACCESS_LOCK:
            if dest in ("1", "stdout"):
                print(line, flush=True)
                return
            if _ACCESS_FH is None or _ACCESS_PATH != dest:
                if _ACCESS_FH is not None:
                    _ACCESS_FH.close()
                _ACCESS_FH = open(dest, "a", buffering=1)
                _ACCESS_PATH = dest
            _ACCESS_FH.write(line + "\n")
    except OSError:
        pass


def _access_record(universe, month, status, request_id=None,
                   resp=None, error=None) -> dict:
    """The one access-line shape (both the HTTP front door and the
    demo driver emit it): request identity, routing, outcome, and the
    per-request phase breakdown when the request completed."""
    rec = {
        "ts": round(time.time(), 6),
        "request_id": request_id,
        "universe": universe,
        "month": month,
        "status": status,
    }
    if resp is not None:
        rec.update(request_id=resp.request_id,
                   generation=resp.generation,
                   bucket=(resp.phases or {}).get("width"),
                   latency_ms=resp.latency_ms,
                   n_scores=int(resp.scores.size),
                   **(resp.phases or {}))
    if error is not None:
        rec["error"] = f"{type(error).__name__}: {error}"
    return rec


def _status_of(exc) -> int:
    from lfm_quant_tpu_torch.serve.errors import http_status

    return http_status(exc)


def make_http_server(service, port: int):
    """Build (but do not run) the stdlib JSON front door — split from
    :func:`run_http` so tests can bind port 0 and drive real HTTP
    round trips (the header-propagation contract needs actual headers
    on the wire). Returns the ``ThreadingHTTPServer``."""
    from concurrent.futures import TimeoutError as FutureTimeout
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from lfm_quant_tpu_torch.serve.batcher import clean_request_id
    from lfm_quant_tpu_torch.serve.errors import ServeError, http_status

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload, retry_after_s=None,
                  request_id=None):
            body = json.dumps(payload, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if request_id:
                # Echo the trace identity (propagated or minted) so
                # the caller — and every proxy between — can correlate
                # this response with the span/access-log/exemplar
                # records carrying the same id.
                self.send_header("X-Request-Id", str(request_id))
            if retry_after_s is not None:
                # HTTP Retry-After is whole seconds; never advertise 0
                # (clients would hot-loop the open circuit).
                self.send_header("Retry-After",
                                 str(max(1, int(retry_after_s + 0.999))))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str, content_type: str):
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            url = urlparse(self.path)
            try:
                if url.path in ("/healthz", "/stats"):
                    # ONE snapshot call per request: both views derive
                    # from the same locked reads and carry the same
                    # scrape ts — no torn state across a concurrent
                    # refresh or breaker transition.
                    snap = service.snapshot()
                    if url.path == "/stats":
                        return self._send(200, snap["stats"])
                    # Readiness: 503 + reason when the batcher is dead or
                    # the circuit is open — a load balancer must stop
                    # routing here. SLO-burn and score-drift detail
                    # rides along without flipping ok.
                    h = snap["health"]
                    return self._send(200 if h.get("ok") else 503, h,
                                      retry_after_s=h.get("retry_after_s"))
                if url.path == "/metrics":
                    # Prometheus text exposition: live
                    # histograms/rates/gauges plus the absorbed
                    # telemetry counters. text/plain; version=0.0.4 is
                    # the format's registered content type.
                    return self._send_text(
                        200, service.metrics_text(),
                        "text/plain; version=0.0.4; charset=utf-8")
                if url.path == "/score":
                    q = parse_qs(url.query)
                    u, m = q["universe"][0], int(q["month"][0])
                    # Sanitize ONCE at the front door: the error-path
                    # access-log line below must carry the same bounded
                    # id the span/exemplars will (a raw hostile header
                    # would land unsanitized in every degraded-request
                    # log line — exactly the ones incidents care about).
                    rid_in = clean_request_id(
                        extract_request_id(self.headers))
                    try:
                        r = service.score(u, m, request_id=rid_in)
                    except Exception as e:  # noqa: BLE001 — logged+reraised
                        access_log(_access_record(
                            u, m, _status_of(e), request_id=rid_in,
                            error=e))
                        raise
                    access_log(_access_record(u, m, 200, resp=r))
                    return self._send(200, {
                        "universe": r.universe, "month": r.month,
                        "generation": r.generation,
                        "request_id": r.request_id,
                        "latency_ms": r.latency_ms,
                        "phases": r.phases,
                        "firm_idx": r.firm_idx.tolist(),
                        "scores": r.scores.tolist()},
                        request_id=r.request_id)
                return self._send(404, {"error": "unknown path"})
            except KeyError as e:
                return self._send(404, {"error": str(e)})
            except FutureTimeout:
                return self._send(504, {"error": "scoring timed out"})
            except ServeError as e:
                # The failure-semantics table (module docstring): shed →
                # 429, open circuit / dead batcher → 503, expired
                # deadline → 504 — each with Retry-After when known.
                return self._send(http_status(e),
                                  {"error": f"{type(e).__name__}: {e}"},
                                  retry_after_s=e.retry_after_s)
            except Exception as e:  # noqa: BLE001 — a request must answer
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def run_http(service, port: int):
    """Minimal stdlib JSON front door (demo-grade: one service, GET
    only; a production deployment would sit behind a real gateway)."""
    httpd = make_http_server(service, port)
    print(f"[serve] http on 127.0.0.1:{httpd.server_address[1]} "
          f"(/score?universe=NAME&month=YYYYMM, /stats, /healthz, "
          f"/metrics)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


