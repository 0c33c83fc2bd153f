"""Async streaming serving gateway (DESIGN.md §Serving API).

A stdlib-asyncio HTTP/1.1 front end over a
:class:`~repro.serving.pools.FleetRuntime`:

* ``POST /v1/completions`` — OpenAI-compatible completions. With
  ``"stream": true`` the response is server-sent events, one
  ``data: {...}`` chunk per engine flush. The flush unit is the
  engine's (n_max, K) emitted-token sync: a decode_k scan emits up to
  K tokens per jitted dispatch, and the gateway streams exactly what
  each dispatch synced — streamed token ids are BITWISE the offline
  drain path's (the stream never re-decodes, it observes the same
  slot_out the batch path returns).
* ``GET /health`` — liveness + per-pool occupancy/queue snapshot.
* ``GET /metrics`` — Prometheus text exposition
  (:mod:`repro.serving.metrics`): per-pool engine counters, router
  stats, LIVE routing boundaries, gateway HTTP counters, re-planner
  counters.
* ``POST /admin/replan`` — force one re-planner tick; returns its
  report (the periodic loop runs the same tick on a timer).

Engine dispatches are blocking jitted calls, so one background driver
task steps every busy engine in a thread-pool executor under the
gateway lock, then flushes each live request's newly-synced tokens to
its stream queue. Handlers never touch engines directly; submission
also goes through the lock. Everything here is stdlib — the CI smoke
host has no aiohttp/uvicorn/prometheus_client, and does not need them.

The byte-chunk tokenizer stub has no detokenizer, so ``text`` fields
carry the canonical rendering ``" <id>"`` per token (concatenating
chunk texts reproduces the full text); raw ids ride along in the
``token_ids`` extension field, which is what the parity tests compare.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.engine import EngineDead
from repro_torch.serving.metrics import Metric, fleet_metrics, render_prometheus
from repro_torch.serving.pools import FleetRuntime, GatewayRequest
from repro_torch.serving.reconfigure import (HealthPolicy, PoolDownError,
                                       recover_pool)
from repro_torch.serving.replanner import Replanner

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable"}


class RequestError(Exception):
    """Maps straight to a structured 4xx/5xx JSON body.
    ``retry_after`` (seconds) adds a Retry-After header — the 503
    contract during a crash-recovery blackout window."""

    def __init__(self, status: int, message: str,
                 etype: str = "invalid_request_error",
                 param: Optional[str] = None,
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.status = status
        self.retry_after = retry_after
        self.body = {"error": {"message": message, "type": etype,
                               "param": param, "code": None}}


@dataclasses.dataclass
class _Stream:
    """Per-request delivery state: the queue the HTTP handler awaits,
    how many tokens were already flushed, and where the request went."""
    queue: asyncio.Queue
    pool: str
    l_in_effective: int
    prompt_tokens: int
    flushed: int = 0


def _render(tokens: List[int]) -> str:
    return "".join(f" {t}" for t in tokens)


class ServingGateway:
    """Asyncio serving gateway over a FleetRuntime."""

    def __init__(self, runtime: FleetRuntime, *,
                 replanner: Optional[Replanner] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 model_name: Optional[str] = None,
                 replan_interval_s: Optional[float] = None,
                 request_timeout_s: float = 300.0,
                 max_body_bytes: int = 1 << 20,
                 idle_sleep_s: float = 0.005,
                 health_policy: Optional[HealthPolicy] = None,
                 blackout_s: float = 0.25):
        self.runtime = runtime
        self.replanner = replanner
        # stall detector + crash-recovery blackout (DESIGN.md §Live
        # re-provisioning): a dead/wedged engine is rebuilt in-line by
        # the drive loop; its pool refuses NEW submissions (503 +
        # Retry-After) for blackout_s while salvaged requests migrate
        self.health = health_policy or HealthPolicy()
        self.blackout_s = blackout_s
        self.host = host
        self.port = port
        self.model_name = model_name or runtime.cfg.name
        self.replan_interval_s = replan_interval_s
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = max_body_bytes
        self.idle_sleep_s = idle_sleep_s
        self._rid = itertools.count()
        self._lock = asyncio.Lock()
        self._pending: Dict[int, _Stream] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._tasks: List[asyncio.Task] = []
        self._running = False
        self._started_at = time.time()
        # (method, path, status) -> count, for /metrics
        self._http: Dict[Tuple[str, str, int], int] = {}
        self.completions_done = 0
        self.tokens_streamed = 0
        self.flushes = 0

    # ------------------------------------------------------- lifecycle
    async def start(self) -> Tuple[str, int]:
        """Bind the listener (port 0 = ephemeral) and start the engine
        driver + optional periodic re-plan loop. Returns (host, port)."""
        self._running = True
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._tasks.append(asyncio.ensure_future(self._drive()))
        if self.replanner is not None and self.replan_interval_s:
            self._tasks.append(asyncio.ensure_future(self._replan_loop()))
        return self.host, self.port

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception:
                pass
        self._tasks.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # ---------------------------------------------------- engine drive
    async def _drive(self) -> None:
        """The ONLY place engines step while the gateway runs. Each
        pass: step every busy engine (executor — jitted dispatches
        block), then flush whatever tokens those dispatches synced."""
        loop = asyncio.get_running_loop()
        while self._running:
            async with self._lock:
                busy = [n for n, e in self.runtime.engines.items()
                        if e.busy()]
                for name in busy:
                    eng = self.runtime.engines[name]
                    try:
                        await loop.run_in_executor(None, eng.step)
                    except EngineDead:
                        self._recover(name)
                # wedged engines don't raise — their iteration clock
                # just stops advancing while busy; the health policy
                # spots the stall and the recovery path is identical
                for name in self.health.check(self.runtime):
                    self._recover(name)
                if self._pending:
                    self._flush()
            # yield to handlers; sleep longer when idle
            await asyncio.sleep(0 if busy else self.idle_sleep_s)

    def _recover(self, name: str) -> None:
        """Crash recovery under the gateway lock: salvage the dead
        engine's accepted requests from host mirrors, rebuild it, and
        migrate them one pool up (reconfigure.recover_pool). Live
        streams keep their SSE cursors — slot_out prefixes survive in
        the checkpoints — so clients see a pause, never a token gap."""
        recover_pool(self.runtime, name, blackout_s=self.blackout_s)
        for rid, st in self._pending.items():
            d = self.runtime._decisions.get(rid)
            if d is not None and d.pool != st.pool:
                st.pool = d.pool

    def _locate(self, rid: int, st: _Stream):
        """Engine currently holding ``rid`` (result, slot or queue).
        Prefers the recorded pool; a re-provision/recovery may have
        migrated the request, so fall back to scanning the fleet and
        re-pin the stream to wherever it landed."""
        def holds(eng) -> bool:
            return (rid in eng.results
                    or any(r is not None and r.rid == rid
                           for r in eng.slot_req)
                    or any(r.rid == rid for r in eng.waiting))
        eng = self.runtime.engines.get(st.pool)
        if eng is not None and holds(eng):
            return eng
        for name, eng in self.runtime.engines.items():
            if holds(eng):
                st.pool = name
                return eng
        return None

    def _flush(self) -> None:
        """Move newly-synced tokens from engine slot buffers to stream
        queues. slot_out is append-only for a live request (preemption
        checkpoints preserve the emitted prefix), so the flushed-count
        cursor is stable across swaps/recomputes/HOL reshuffles — and
        across engine rebuilds, whose checkpoints carry the same
        emitted-token prefix."""
        for rid in list(self._pending):
            st = self._pending[rid]
            eng = self._locate(rid, st)
            if eng is None:
                continue
            res = eng.results.get(rid)
            if res is None:
                for s, req in enumerate(eng.slot_req):
                    if req is not None and req.rid == rid:
                        out = eng.slot_out[s]
                        if len(out) > st.flushed:
                            st.queue.put_nowait(
                                ("tokens", list(out[st.flushed:])))
                            self.flushes += 1
                            self.tokens_streamed += len(out) - st.flushed
                            st.flushed = len(out)
                        break
                continue
            if len(res.output_tokens) > st.flushed:
                st.queue.put_nowait(
                    ("tokens", list(res.output_tokens[st.flushed:])))
                self.flushes += 1
                self.tokens_streamed += len(res.output_tokens) - st.flushed
                st.flushed = len(res.output_tokens)
            self.runtime.record_completion(rid, res)
            if self.replanner is not None and not res.shed:
                self.replanner.observe(st.l_in_effective,
                                       len(res.output_tokens))
            self.completions_done += 1
            st.queue.put_nowait(("done", res))
            del self._pending[rid]
            # evict the consumed request's host-dict entries (engine
            # result + routing/category records) — the long-running
            # path must stay flat in memory
            self.runtime.release(rid)

    async def _replan_loop(self) -> None:
        while self._running:
            await asyncio.sleep(self.replan_interval_s)
            async with self._lock:
                self.replanner.tick()

    # ------------------------------------------------------- HTTP core
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        status, method, path = 500, "?", "?"
        try:
            method, path, headers = await self._read_head(reader)
            body = await self._read_body(reader, headers)
            status = await self._route(method, path, body, writer)
        except RequestError as e:
            status = e.status
            extra = {}
            if e.retry_after is not None:
                # ceil: "Retry-After: 0" would tell clients to hammer a
                # pool that is still mid-blackout
                extra["Retry-After"] = str(max(1, int(e.retry_after + 1)))
            self._write_json(writer, e.status, e.body, extra)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionError, asyncio.TimeoutError):
            status = 400
        except Exception as e:                     # never kill the server
            self._write_json(writer, 500, {"error": {
                "message": f"internal error: {type(e).__name__}: {e}",
                "type": "server_error", "param": None, "code": None}})
        finally:
            self._http[(method, path, status)] = \
                self._http.get((method, path, status), 0) + 1
            try:
                await writer.drain()
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, asyncio.TimeoutError):
                pass

    async def _read_head(self, reader):
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                      timeout=30.0)
        request_line, *header_lines = \
            head.decode("latin-1").split("\r\n")
        parts = request_line.split()
        if len(parts) != 3:
            raise RequestError(400, f"malformed request line: "
                                    f"{request_line!r}")
        headers = {}
        for line in header_lines:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        return parts[0], parts[1], headers

    async def _read_body(self, reader, headers) -> bytes:
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError:
            raise RequestError(400, "bad Content-Length") from None
        if n > self.max_body_bytes:
            raise RequestError(413, f"body of {n} bytes exceeds the "
                                    f"{self.max_body_bytes} byte limit")
        return await reader.readexactly(n) if n else b""

    async def _route(self, method: str, path: str, body: bytes,
                     writer) -> int:
        path = path.split("?", 1)[0]
        if path == "/health":
            self._require(method, "GET")
            self._write_json(writer, 200, self._health())
            return 200
        if path == "/metrics":
            self._require(method, "GET")
            text = render_prometheus(self.metrics())
            self._write_raw(writer, 200, "text/plain; version=0.0.4",
                            text.encode())
            return 200
        if path == "/v1/completions":
            self._require(method, "POST")
            return await self._completions(body, writer)
        if path == "/admin/replan":
            self._require(method, "POST")
            if self.replanner is None:
                raise RequestError(503, "no re-planner configured",
                                   etype="server_error")
            async with self._lock:
                report = self.replanner.tick()
            self._write_json(writer, 200, report)
            return 200
        raise RequestError(404, f"unknown endpoint {path}")

    @staticmethod
    def _require(method: str, expected: str) -> None:
        if method != expected:
            raise RequestError(405, f"use {expected}")

    # ------------------------------------------------------ completions
    def _parse_completion(self, body: bytes) -> dict:
        try:
            obj = json.loads(body or b"")
        except json.JSONDecodeError as e:
            raise RequestError(400, f"body is not valid JSON: {e}") \
                from None
        if not isinstance(obj, dict):
            raise RequestError(400, "body must be a JSON object")
        prompt = obj.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise RequestError(400, "'prompt' must be a non-empty "
                                    "string", param="prompt")
        max_tokens = obj.get("max_tokens", 16)
        if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) \
                or max_tokens < 1:
            raise RequestError(400, "'max_tokens' must be a positive "
                                    "integer", param="max_tokens")
        stream = obj.get("stream", False)
        if not isinstance(stream, bool):
            raise RequestError(400, "'stream' must be a boolean",
                               param="stream")
        session = obj.get("session") or obj.get("user")
        if session is not None and not isinstance(session, str):
            raise RequestError(400, "'session' must be a string",
                               param="session")
        category = obj.get("category", "prose")
        if not isinstance(category, str):
            raise RequestError(400, "'category' must be a string",
                               param="category")
        return {"prompt": prompt, "max_tokens": max_tokens,
                "stream": stream, "session": session,
                "category": category}

    async def _completions(self, body: bytes, writer) -> int:
        p = self._parse_completion(body)
        rid = next(self._rid)
        st = _Stream(queue=asyncio.Queue(), pool="", l_in_effective=0,
                     prompt_tokens=self.runtime.tokenizer.count(
                         p["prompt"]))
        async with self._lock:
            try:
                decision = self.runtime.submit(GatewayRequest(
                    rid=rid, text=p["prompt"],
                    max_output_tokens=p["max_tokens"],
                    category=p["category"], session=p["session"]))
            except PoolDownError as e:
                raise RequestError(
                    503, f"{e} (pool rebuilding after a fault)",
                    etype="overloaded_error",
                    retry_after=e.retry_after) from None
            st.pool = decision.pool
            st.l_in_effective = decision.l_in_effective
            self._pending[rid] = st
            if self.replanner is not None:
                self.replanner.note_arrival()
        if p["stream"]:
            return await self._stream_response(rid, st, decision, writer)
        return await self._batch_response(rid, st, decision, writer)

    def _chunk(self, rid: int, tokens: List[int],
               finish: Optional[str]) -> dict:
        return {"id": f"cmpl-{rid}", "object": "text_completion",
                "created": int(self._started_at), "model": self.model_name,
                "choices": [{"index": 0, "text": _render(tokens),
                             "token_ids": tokens,
                             "logprobs": None,
                             "finish_reason": finish}]}

    def _finish_reason(self, res) -> str:
        if res.shed:
            return "shed"
        eos = self.runtime.config.eos_id
        if eos is not None and res.output_tokens \
                and res.output_tokens[-1] == eos:
            return "stop"
        return "length"

    async def _next_event(self, rid: int, st: _Stream):
        try:
            return await asyncio.wait_for(st.queue.get(),
                                          self.request_timeout_s)
        except asyncio.TimeoutError:
            self._pending.pop(rid, None)
            raise RequestError(500, f"request {rid} timed out after "
                                    f"{self.request_timeout_s}s",
                               etype="server_error") from None

    async def _stream_response(self, rid, st, decision, writer) -> int:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        while True:
            kind, payload = await self._next_event(rid, st)
            if kind == "tokens":
                self._write_sse(writer, self._chunk(rid, payload, None))
                await writer.drain()
                continue
            res = payload
            final = self._chunk(rid, [], self._finish_reason(res))
            final["fleetopt"] = self._annotation(decision, res)
            self._write_sse(writer, final)
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
            return 200

    async def _batch_response(self, rid, st, decision, writer) -> int:
        tokens: List[int] = []
        while True:
            kind, payload = await self._next_event(rid, st)
            if kind == "tokens":
                tokens.extend(payload)
                continue
            res = payload
            if res.shed:
                raise RequestError(
                    429, "shed by stability-aware admission: the pool's "
                         "queue-wait estimate exceeds max_queue_wait",
                    etype="overloaded_error")
            body = self._chunk(rid, tokens, self._finish_reason(res))
            body["usage"] = {
                "prompt_tokens": st.prompt_tokens,
                "completion_tokens": len(tokens),
                "total_tokens": st.prompt_tokens + len(tokens)}
            body["fleetopt"] = self._annotation(decision, res)
            self._write_json(writer, 200, body)
            return 200

    @staticmethod
    def _annotation(decision, res) -> dict:
        """Routing/engine provenance riding along each completion —
        which pool served it, whether C&R fired, what overload
        machinery it survived."""
        return {"pool": decision.pool,
                "compressed": decision.compressed,
                "compression_ms": decision.compression_ms,
                "l_total_effective": decision.l_total_effective,
                "prefill_iters": res.prefill_iters,
                "decode_iters": res.decode_iters,
                "queue_iters": res.queue_iters,
                "preemptions": res.preemptions,
                "shed": res.shed}

    # ---------------------------------------------------------- health
    def _health(self) -> dict:
        pools = {}
        for name, eng in self.runtime.engines.items():
            snap = eng.utilization_snapshot(detail=True)
            pools[name] = {
                "slots": eng.n_max, "c_max": eng.c_max,
                "occupancy": snap["occupancy"],
                "queue_depth": snap["queue_depth"]}
        return {"status": "ok", "model": self.model_name,
                "uptime_s": time.time() - self._started_at,
                "boundaries": list(self.runtime.router.boundaries),
                "gammas": list(self.runtime.router.gammas),
                "pools": pools,
                "in_flight": len(self._pending),
                "completions_done": self.completions_done}

    # --------------------------------------------------------- metrics
    def metrics(self) -> List[Metric]:
        """Fleet metrics plus the gateway's own HTTP / streaming /
        re-planner counters."""
        out = fleet_metrics(self.runtime)
        http = Metric("fleetopt_http_requests_total", "counter",
                      "HTTP requests by method, path and status")
        for (method, path, status), n in sorted(self._http.items()):
            http.add(n, method=method, path=path, status=str(status))
        out.append(http)
        out.append(Metric("fleetopt_streams_in_flight", "gauge",
                          "Requests admitted and not yet delivered")
                   .add(len(self._pending)))
        out.append(Metric("fleetopt_completions_total", "counter",
                          "Requests fully delivered (incl. shed)")
                   .add(self.completions_done))
        out.append(Metric("fleetopt_stream_flushes_total", "counter",
                          "SSE flush units delivered (one per engine "
                          "dispatch that synced new tokens)")
                   .add(self.flushes))
        out.append(Metric("fleetopt_stream_tokens_total", "counter",
                          "Tokens delivered through stream queues")
                   .add(self.tokens_streamed))
        if self.replanner is not None:
            out.append(Metric("fleetopt_replan_ticks_total", "counter",
                              "Re-planner cycles run")
                       .add(self.replanner.ticks))
            out.append(Metric("fleetopt_replan_applied_total", "counter",
                              "Re-plans that moved the live boundary "
                              "vector").add(self.replanner.applied))
            out.append(Metric("fleetopt_replan_window_weight", "gauge",
                              "Decayed observation weight in the "
                              "re-planner's histogram")
                       .add(self.replanner.hist.total_weight))
            out.append(Metric("fleetopt_replan_recommendation", "gauge",
                              "Outstanding re-provisioning "
                              "recommendations (count)")
                       .add(len(self.replanner.recommendations)))
        return out

    # ----------------------------------------------------- raw writers
    def _write_raw(self, writer, status: int, ctype: str, body: bytes,
                   extra_headers: Optional[Dict[str, str]] = None) -> None:
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (extra_headers or {}).items())
        writer.write(
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n{extra}"
            f"Connection: close\r\n\r\n".encode("latin-1") + body)

    def _write_json(self, writer, status: int, obj: dict,
                    extra_headers: Optional[Dict[str, str]] = None) -> None:
        self._write_raw(writer, status, "application/json",
                        json.dumps(obj).encode(), extra_headers)

    @staticmethod
    def _write_sse(writer, obj: dict) -> None:
        writer.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
