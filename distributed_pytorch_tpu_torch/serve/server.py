"""Streaming HTTP front-end over the async scheduler — stdlib asyncio
only, so CI and air-gapped images need no web framework.

Endpoints:
* `POST /v1/completions` — body `{"prompt": [ids] | "text",
  "max_tokens": N, "stream": true, "deadline_s": s}`. With
  `stream` (the default) the response is Server-Sent Events: one
  `data: {"token": id[, "text": piece]}` event per generated token, a
  final `data: {"done": true, "reason": ...}`, then `data: [DONE]`.
  `stream: false` collects and returns one JSON body. String prompts
  need tiktoken (the prepare scripts' GPT-2 BPE); token-id lists always
  work. Queue-full / deadline shed maps to HTTP 429 — backpressure is an
  explicit status, never a hang.
* `GET /healthz` — READINESS, not just liveness: 200 with a queue/slot
  snapshot while serving; **503** when the scheduler's background step
  loop has died (engine error) or the server is draining. The router
  tier health-gates dispatch on exactly this signal, so a sick replica
  stops receiving traffic within one probe interval.
* `GET /metrics` — Prometheus text exposition (serve/metrics.py).
* `POST /admin/drain` — draining restart, phase 1: stop admission (new
  submits shed with cause 'draining', healthz flips 503 so the router
  hands traffic to the other replicas), let queued requests reach slots
  and live streams retire. Poll healthz until `drained` is true, then
  replace the process — zero in-flight streams lost.

Observability plane:
* Every completion carries a trace id — the `X-Trace-Id` request header
  when present (the router tier sends one so a failed-over stream is ONE
  trace), else minted here. Lifecycle spans (queue wait, chunked
  prefill, decode, retire — serve/scheduler.py) land in the process
  trace ring; the final payload (SSE done event / JSON body) carries the
  id and a compact span summary, and `GET /debug/trace/<id>` replays the
  full set (`?fmt=chrome` for a Perfetto-loadable file).
* `GET /debug/timeline` — the engine's step-level flight recorder: the
  last N fused steps' `{step_ms, n_live, prefill_tokens, emitted,
  blocks_in_use, preemptions}` records (`?n=` bounds the count).

Client disconnects matter at decode timescales: a dropped SSE consumer
must not hold a slot for its remaining budget. The completion handler
watches the connection's read side concurrently with the token stream —
EOF (close/reset) cancels the request, and the scheduler frees the slot
before the next fused step. The read side is also bounded the other way:
a stalled (slowloris) client that never finishes its request head/body
would hold a connection slot forever, so parsing runs under a
per-connection read timeout — 408 and close.
"""

from __future__ import annotations

import asyncio
import json
import time
import urllib.parse
from typing import Optional

from distributed_pytorch_tpu_torch.obs import trace as obs_trace
from distributed_pytorch_tpu_torch.serve.control import normalize_class
from distributed_pytorch_tpu_torch.serve.scheduler import (RequestHandle,
                                                           Scheduler,
                                                           ShedError)

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 8 * 1024 * 1024


def _response(status: int, body: bytes, content_type: str,
              extra: str = "") -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed", 408: "Request Timeout",
              409: "Conflict", 413: "Payload Too Large",
              429: "Too Many Requests", 500: "Internal Server Error",
              503: "Service Unavailable"}.get(status, "OK")
    return (f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n{extra}\r\n").encode() + body


def _json_response(status: int, obj: dict) -> bytes:
    return _response(status, json.dumps(obj).encode(), "application/json")


class ServeApp:
    """Bind a `Scheduler` to a localhost HTTP port.

    >>> app = ServeApp(scheduler, port=0)       # 0 = ephemeral (tests)
    >>> await app.start(); print(app.port)
    >>> await app.stop()
    """

    def __init__(self, scheduler: Scheduler, *, host: str = "127.0.0.1",
                 port: int = 8000, encoder=None,
                 default_max_tokens: int = 64,
                 request_timeout_s: float = 30.0):
        self.scheduler = scheduler
        self.host = host
        self.port = port
        self.encoder = encoder            # tiktoken-like, or None (ids only)
        self.default_max_tokens = default_max_tokens
        self.request_timeout_s = request_timeout_s
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set[asyncio.StreamWriter] = set()

    @property
    def tracer(self) -> obs_trace.TraceRecorder:
        return obs_trace.get_recorder()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def abort(self) -> None:
        """Crash-style teardown: close the listening socket AND rip every
        open connection's transport out from under its handler — what a
        SIGKILL does to the process, minus the process. The in-process
        fault-injection tests use this to make a replica 'die'
        mid-stream; normal shutdown uses stop(), which leaves streams to
        finish."""
        if self._server is not None:
            self._server.close()
            self._server = None
        for w in list(self._writers):
            try:
                w.transport.abort()
            except Exception:
                pass

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            await self._handle_conn_inner(reader, writer)
        finally:
            self._writers.discard(writer)

    async def _handle_conn_inner(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        try:
            # bounded read: a stalled client mid-request-head must not
            # hold this connection slot forever (slowloris) — 408, close
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                          self.request_timeout_s)
        except asyncio.TimeoutError:
            try:
                writer.write(_json_response(
                    408, {"error": "timed out reading request"}))
                await writer.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                writer.close()
            return
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionError):
            writer.close()
            return
        try:
            if len(head) > _MAX_HEADER_BYTES:
                writer.write(_json_response(413, {"error": "headers too "
                                                           "large"}))
                return
            request_line, *header_lines = head.decode(
                "latin-1").split("\r\n")
            parts = request_line.split(" ")
            if len(parts) < 2:
                writer.write(_json_response(400, {"error": "bad request"}))
                return
            method, fullpath = parts[0].upper(), parts[1]
            path, _, qs = fullpath.partition("?")
            query = {k: v[0] for k, v in
                     urllib.parse.parse_qs(qs).items()}
            headers = {}
            for line in header_lines:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()

            if method == "GET" and path == "/healthz":
                writer.write(self._healthz())
            elif method == "GET" and path == "/metrics":
                body = self.scheduler.metrics.render_prometheus().encode()
                writer.write(_response(
                    200, body, "text/plain; version=0.0.4; charset=utf-8"))
            elif method == "GET" and path == "/metrics.json":
                # the federation surface: the router pulls this on the
                # health-probe cadence to build /metrics/fleet — raw
                # per-bucket counts so fleet sums stay bit-exact
                writer.write(_json_response(
                    200, self.scheduler.metrics.snapshot()))
            elif method == "GET" and path.startswith("/debug/trace/"):
                writer.write(self._debug_trace(path, query))
            elif method == "GET" and path == "/debug/timeline":
                writer.write(self._debug_timeline(query))
            elif method == "POST" and path == "/v1/completions":
                await self._completions(reader, writer, headers)
            elif method == "POST" and path == "/admin/drain":
                self.scheduler.drain()
                writer.write(_json_response(200, {
                    "draining": True, "drained": self.scheduler.drained,
                    "live_slots": self.scheduler.engine.n_live,
                    "queue_depth": self.scheduler.queue_depth}))
            elif path in ("/healthz", "/metrics", "/metrics.json",
                          "/v1/completions", "/admin/drain",
                          "/debug/timeline") \
                    or path.startswith("/debug/trace/"):
                writer.write(_json_response(405, {"error": "method not "
                                                           "allowed"}))
            else:
                writer.write(_json_response(404, {"error": "not found"}))
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()

    def _healthz(self) -> bytes:
        """Readiness probe. 200 only while the step loop is alive and the
        server is admitting; 503 (with the reason in the body) when the
        loop died or a drain is in progress — the router tier gates
        dispatch on exactly this status. The body always carries the
        load gauges the router's least-loaded pick reads (the same
        numbers /metrics exports as serve_queue_depth /
        serve_slot_occupancy), so one probe serves both purposes."""
        sched = self.scheduler
        eng = sched.engine
        ready = sched.healthy and not sched.draining
        body = {"ok": ready, "live_slots": eng.n_live,
                "free_slots": eng.n_free,
                "queue_depth": sched.queue_depth,
                "n_slots": eng.n_slots,
                "occupancy": round(eng.occupancy, 4),
                "draining": sched.draining}
        if sched.draining:
            body["drained"] = sched.drained
        if sched.failed is not None:
            body["failed"] = str(sched.failed)
        # cache-aware routing: the replica's radix-prefix digest (top-k
        # chain digests by cached depth, HBM or host tier) rides the
        # health probe so the router can dispatch sticky-by-prefix —
        # no extra poll, no extra endpoint
        digest = getattr(eng, "kv_digest", None)
        if callable(digest):
            body["kv_digest"] = digest()
        return _json_response(200 if ready else 503, body)

    def _debug_trace(self, path: str, query: dict) -> bytes:
        """`GET /debug/trace/<id>`: the request's recorded spans.
        Default is the compact summary (offsets in ms from the trace's
        first span); `?fmt=chrome` returns a Chrome-trace/Perfetto JSON
        file for that trace alone."""
        tid = path.rsplit("/", 1)[1]
        spans = self.tracer.spans_for(tid)
        if not spans:
            return _json_response(404, {"error": f"no spans for trace "
                                                 f"{tid!r} (expired from "
                                                 f"the ring, or unknown)"})
        if query.get("fmt") in ("chrome", "perfetto"):
            return _json_response(200, self.tracer.to_chrome(tid))
        return _json_response(200, {"trace_id": tid,
                                    "n_spans": len(spans),
                                    "spans": self.tracer.summary(tid)})

    def _debug_timeline(self, query: dict) -> bytes:
        """`GET /debug/timeline[?n=512]`: the engine flight recorder's
        last n per-step records — the post-hoc ITL-spike diagnosis feed
        the aggregate histograms can't provide."""
        fl = getattr(self.scheduler.engine, "flight", None)
        if fl is None:
            return _json_response(404, {"error": "engine has no flight "
                                                 "recorder"})
        try:
            n = max(1, int(query.get("n", "512")))
        except ValueError:
            return _json_response(400, {"error": "bad n"})
        return _json_response(200, {
            "entries": fl.entries(n), "n_steps": fl.total,
            "dropped": fl.dropped, "capacity": fl.capacity})

    # ------------------------------------------------------------------

    async def _completions(self, reader, writer, headers) -> None:
        # request receipt is the replica-side trace origin: the incoming
        # X-Trace-Id (the router's, so a failover stays ONE trace) or a
        # freshly minted id when this replica is unfronted
        t_req = time.perf_counter()
        trace_id = headers.get("x-trace-id") or obs_trace.new_trace_id()
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            writer.write(_json_response(400, {"error": "bad "
                                                       "content-length"}))
            return
        if n > _MAX_BODY_BYTES:
            writer.write(_json_response(413, {"error": "body too large"}))
            return
        try:
            body = json.loads((await asyncio.wait_for(
                reader.readexactly(n), self.request_timeout_s)) or b"{}")
        except asyncio.TimeoutError:
            writer.write(_json_response(
                408, {"error": "timed out reading request body"}))
            return
        except (json.JSONDecodeError, asyncio.IncompleteReadError):
            writer.write(_json_response(400, {"error": "invalid JSON "
                                                       "body"}))
            return

        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if self.encoder is None:
                writer.write(_json_response(
                    400, {"error": "no tokenizer available; send 'prompt' "
                                   "as a list of token ids"}))
                return
            prompt = self.encoder.encode(prompt, allowed_special="all")
        if not isinstance(prompt, list) or not prompt \
                or not all(isinstance(t, int) for t in prompt):
            writer.write(_json_response(
                400, {"error": "'prompt' must be a non-empty list of "
                               "token ids (or text with a tokenizer)"}))
            return
        max_tokens = int(body.get("max_tokens", self.default_max_tokens))
        if max_tokens < 1:
            writer.write(_json_response(400, {"error": "max_tokens must "
                                                       "be >= 1"}))
            return
        deadline = body.get("deadline_s")
        stream = bool(body.get("stream", True))
        # SLO class: body field wins, then the X-SLO-Class header (the
        # router forwards either), then the SLO_CLASS_DEFAULT knob
        try:
            slo_class = normalize_class(
                body.get("slo_class") or headers.get("x-slo-class"))
        except ValueError as e:
            writer.write(_json_response(400, {"error": str(e),
                                              "trace_id": trace_id}))
            return

        try:
            handle = self.scheduler.submit(
                prompt, max_tokens,
                deadline_s=float(deadline) if deadline is not None
                else None, trace_id=trace_id, slo_class=slo_class)
        except ShedError as e:
            writer.write(_json_response(
                429 if e.cause in ("queue_full", "rate_limited") else 503,
                {"error": str(e), "cause": e.cause,
                 "trace_id": trace_id}))
            return

        if stream:
            await self._stream_sse(reader, writer, handle, trace_id,
                                   t_req)
        else:
            try:
                ret = await handle.result()
            except ShedError as e:
                writer.write(_json_response(429, {"error": str(e),
                                                  "cause": e.cause,
                                                  "trace_id": trace_id}))
                return
            except Exception as e:         # engine death: explicit 500
                writer.write(_json_response(500, {
                    "error": str(e),
                    "cause": getattr(e, "cause", "internal"),
                    "trace_id": trace_id}))
                return
            body = {"tokens": ret.tokens[ret.prompt_len:],
                    "text": self._decode(ret.tokens[ret.prompt_len:]),
                    "reason": ret.reason, "n_prompt": ret.prompt_len,
                    "trace_id": trace_id}
            wv = self.scheduler.metrics.weights_version
            if wv:
                body["weights_version"] = wv
            spans = self._close_http_span(trace_id, t_req,
                                          len(handle.tokens))
            if spans:
                body["spans"] = spans
            writer.write(_json_response(200, body))

    def _close_http_span(self, trace_id: str, t_req: float,
                         streamed: int) -> list[dict]:
        """Record the replica-HTTP span (request receipt -> now) and
        return the request's compact span summary, offsets relative to
        t_req — the base a dispatching router re-anchors on its own
        clock to stitch one cross-process timeline."""
        tr = self.tracer
        if not tr.enabled:
            return []
        tr.add("replica.http", trace_id, t0=t_req,
               dur=time.perf_counter() - t_req, cat="server",
               streamed=streamed)
        return tr.summary(trace_id, base=t_req)

    def _decode(self, toks: list[int]) -> Optional[str]:
        if self.encoder is None:
            return None
        try:
            return self.encoder.decode(toks)
        except Exception:
            return None

    async def _stream_sse(self, reader, writer, handle: RequestHandle,
                          trace_id: str, t_req: float) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        # The disconnect watch: the client sends nothing after the POST
        # body, so a completed read means EOF/reset -> the consumer is
        # gone -> cancel so the slot frees before the next fused step.
        eof_task = asyncio.ensure_future(reader.read(1))
        next_tok: Optional[asyncio.Future] = None
        try:
            while True:
                next_tok = asyncio.ensure_future(handle.__anext__())
                done, _ = await asyncio.wait(
                    {next_tok, eof_task},
                    return_when=asyncio.FIRST_COMPLETED)
                if eof_task in done:
                    handle.cancel()
                    next_tok.cancel()
                    return
                try:
                    tok = next_tok.result()
                except StopAsyncIteration:
                    break
                except ShedError as e:
                    writer.write(self._sse({"error": str(e),
                                            "cause": e.cause}))
                    await writer.drain()
                    return
                except (ConnectionError, asyncio.CancelledError):
                    raise
                except Exception as e:     # engine death mid-stream: an
                    writer.write(self._sse({  # explicit event, not a hang
                        "error": str(e),
                        "cause": getattr(e, "cause", "internal")}))
                    await writer.drain()
                    return
                event = {"token": tok}
                piece = self._decode([tok])
                if piece is not None:
                    event["text"] = piece
                writer.write(self._sse(event))
                await writer.drain()
            ret = handle.retired
            done_ev = {"done": True, "reason": ret.reason,
                       "n_tokens": len(handle.tokens),
                       "trace_id": trace_id}
            wv = self.scheduler.metrics.weights_version
            if wv:
                done_ev["weights_version"] = wv
            # the span summary rides the done event so the router (or any
            # client) gets the replica-side timeline without a second
            # round-trip — offsets are relative to request receipt
            spans = self._close_http_span(trace_id, t_req,
                                          len(handle.tokens))
            if spans:
                done_ev["spans"] = spans
            writer.write(self._sse(done_ev))
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            handle.cancel()
            raise
        finally:
            eof_task.cancel()
            if next_tok is not None:
                next_tok.cancel()

    @staticmethod
    def _sse(obj: dict) -> bytes:
        return f"data: {json.dumps(obj)}\n\n".encode()
