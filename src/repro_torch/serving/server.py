"""Live asyncio HTTP front end for the streaming label router (port of
``src/repro/serving/server.py``).

A stdlib-only HTTP/1.1 service (``asyncio.start_server``) accepts task
submissions and label queries, micro-batches pending submissions into the
serve tick (:func:`repro_torch.labelstream.router.serve_tick`) each
iteration, and answers queries from the finalized-label stream with
per-request wall-clock timestamps.

The router state stays on the server's device between ticks; per tick the
injection counts go to the device in one copy and the ``srv_*``
finalization outputs come back in one (:func:`~repro_torch.labelstream.
router.serve_out_numpy`). The tick runs on the event loop's default
executor thread with the server's device made current there, so nothing
depends on another thread's current device. Injection is throttled to each
shard's free backlog capacity, so the device never drops a request on its
own: ``submitted == answered + pending + in_system + dropped (+ shutdown)``
holds at every tick boundary.

Endpoints (JSON in/out):

  ``POST /tasks``          submit one task; body ``{"wait": bool,
                           "timeout_s": float}`` optional. ``wait`` long-
                           polls until the label finalizes or the timeout
                           fires (the TASK stays in the system; only the
                           HTTP wait times out). The reference's LM-text
                           fields (``"text"``, ``"label"``) need LM
                           features, which are not ported (ROADMAP A12b):
                           they get a 400.
  ``GET /labels/<id>``     current state of a submission.
  ``GET /stats``           counters, conservation check, wall-clock
                           latency percentiles, ``repro_torch.obs.timing``
                           rows.
  ``GET /healthz``         liveness.
  ``POST /shutdown``       graceful shutdown: stop accepting, drain.
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

_REASON = {200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found",
           429: "Too Many Requests", 503: "Service Unavailable"}


@dataclasses.dataclass
class _Req:
    """One submission's lifecycle. ``status`` walks pending (host queue)
    -> queued (on device) -> done | dropped | shutdown."""
    rid: int
    event: asyncio.Event
    t_submit: float
    status: str = "pending"
    shard: int = -1
    uid: int = -1
    label: Optional[int] = None
    conf: float = 0.0
    votes: int = 0
    tis_s: float = 0.0
    t_answer: Optional[float] = None

    def to_json(self) -> dict:
        d = dict(id=self.rid, status=self.status)
        if self.status == "done":
            d.update(label=self.label, conf=round(self.conf, 6),
                     votes=self.votes, tis_s=round(self.tis_s, 3),
                     latency_s=round(self.t_answer - self.t_submit, 6))
        return d


class LabelServer:
    """The live labeling service for one stream scenario, on ``device``.

    ``spec`` is a ``repro_torch.scenarios.ScenarioSpec`` (its ``serve``
    sub-spec carries host/port/timeouts; the workload and policy lower
    through ``to_serve_config``) or a ready serve-mode ``StreamConfig``
    (then the keyword overrides supply the HTTP surface). Drive it inside a
    running event loop (``await server.start()`` ... ``await
    server.close()``), or through :mod:`repro_torch.launch.serve`.
    """

    def __init__(self, spec, *, seed: int = 0, host: str = None,
                 port: int = None, tick_interval_s: float = None,
                 max_pending: int = None, request_timeout_s: float = None,
                 drain_timeout_s: float = None, device="cuda"):
        from repro_torch.device import resolve_device
        from repro_torch.labelstream.router import (
            StreamConfig, _as_serve_config, _validate_serve_config,
        )

        self.device = resolve_device(device)
        self.cfg = _as_serve_config(spec)
        _validate_serve_config(self.cfg)
        sv = None if isinstance(spec, StreamConfig) else spec.serve
        pick = lambda ov, dflt: ov if ov is not None else dflt
        self.host = pick(host, sv.host if sv else "127.0.0.1")
        self.port = pick(port, sv.port if sv else 0)
        self.tick_interval_s = pick(tick_interval_s,
                                    sv.tick_interval_s if sv else 0.01)
        self.max_pending = pick(max_pending, sv.max_pending if sv else 4096)
        self.request_timeout_s = pick(request_timeout_s,
                                      sv.request_timeout_s if sv else 30.0)
        self.drain_timeout_s = pick(drain_timeout_s,
                                    sv.drain_timeout_s if sv else 10.0)
        self.seed = seed

        S = self.cfg.n_shards
        self.state = None
        self._pending: collections.deque = collections.deque()
        self._reqs: dict = {}
        self._by_uid: dict = {}
        self._next_rid = 0
        # per-shard monotonic uid counters (every injected uid consumes a
        # slot whether or not it survives)
        self._next_uid = np.zeros((S,), np.int64)
        self._backlog = np.zeros((S,), np.int64)   # host view, post-tick
        self.submitted = 0
        self.answered = 0
        self.dropped = 0
        self.rejected = 0
        self.shutdown_unanswered = 0
        self.ticks = 0
        self.t_sim = 0.0
        self._in_flight = 0
        self._lat: list = []
        self._work: Optional[asyncio.Event] = None
        self._drained: Optional[asyncio.Event] = None
        self._closing = False
        self._closed = False
        self._server = None
        self._tick_task = None
        self._close_task = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _on_device(self):
        """The server's card made current on the calling thread (the
        executor's), or nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _init_state(self):
        from repro_torch.labelstream.router import serve_init
        with self._on_device():
            return serve_init(self.cfg, self.seed, self.device)

    async def start(self):
        loop = asyncio.get_running_loop()
        self._work = asyncio.Event()
        self._drained = asyncio.Event()
        self.state = await loop.run_in_executor(None, self._init_state)
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._tick_task = asyncio.create_task(self._tick_loop())
        return self

    async def close(self, *, drain: bool = True):
        """Graceful shutdown: stop accepting (new submissions get 503),
        drain in-flight tasks up to ``drain_timeout_s``, then resolve any
        stragglers as ``"shutdown"`` and stop the tick loop."""
        if self._closed:
            return
        self._closing = True
        self._work.set()
        if drain and self.drain_timeout_s > 0 \
                and (self._pending or self._by_uid):
            try:
                await asyncio.wait_for(self._drained.wait(),
                                       self.drain_timeout_s)
            except asyncio.TimeoutError:
                pass
        if self._closed:              # a concurrent close() finished first
            return
        self._closed = True
        if self._tick_task is not None:
            self._tick_task.cancel()
            try:
                await self._tick_task
            except asyncio.CancelledError:
                pass
        for req in list(self._pending) + list(self._by_uid.values()):
            if req.status in ("pending", "queued"):
                req.status = "shutdown"
                self.shutdown_unanswered += 1
                req.event.set()
        self._pending.clear()
        self._by_uid.clear()
        self._server.close()
        await self._server.wait_closed()

    # ------------------------------------------------------------------
    # tick driver (continuous batching)
    # ------------------------------------------------------------------
    def _inject_plan(self):
        """Micro-batch pending submissions into per-shard injection counts,
        least-loaded shard first, throttled to ``min(free backlog slots,
        max_arrivals_per_tick)`` per shard so the device cannot drop."""
        cfg = self.cfg
        S, M, Q = cfg.n_shards, cfg.max_arrivals_per_tick, cfg.backlog
        n_arr = np.zeros((S,), np.int64)
        room = np.minimum(M, Q - self._backlog)
        while self._pending:
            s = int(np.argmax(room - n_arr))
            if room[s] - n_arr[s] <= 0:
                break
            req = self._pending.popleft()
            req.shard = s
            req.uid = int(self._next_uid[s]) + int(n_arr[s])
            req.status = "queued"
            self._by_uid[(s, req.uid)] = req
            n_arr[s] += 1
        uid_base = self._next_uid.copy()
        self._next_uid += n_arr
        return n_arr, uid_base

    def _device_tick(self, n_arr, uid_base):
        """One serve tick and the copy of its outputs to the host (runs on
        the executor thread; wall clock lands in the
        ``repro_torch.obs.timing`` registry, so the first call's one-time
        costs show up as the cold-vs-warm split)."""
        from repro_torch.labelstream.router import (
            serve_out_numpy, serve_tick,
        )
        from repro_torch.obs import timing

        def step():
            with self._on_device():
                self.state, out = serve_tick(self.cfg, self.state, n_arr,
                                             uid_base)
                return serve_out_numpy(out)

        out, _ = timing.timeit("serve.tick", step)
        return out

    def _absorb(self, out, n_arr, uid_base):
        now = time.monotonic()
        fin, uids, labels = out["fin"], out["uid"], out["label"]
        votes, confs, tis = out["votes"], out["conf"], out["tis"]
        for s, w in zip(*np.nonzero(fin)):
            req = self._by_uid.pop((int(s), int(uids[s, w])), None)
            if req is None:
                continue
            req.status = "done"
            req.label = int(labels[s, w])
            req.votes = int(votes[s, w])
            req.conf = float(confs[s, w])
            req.tis_s = float(tis[s, w])
            req.t_answer = now
            self.answered += 1
            self._lat.append(now - req.t_submit)
            req.event.set()
        drp = out["dropped"]
        if drp.any():
            # device drops come off the TAIL of this tick's injection
            # (unreachable under the capacity throttle; kept for safety)
            for s in range(len(drp)):
                for k in range(int(drp[s])):
                    u = int(uid_base[s]) + int(n_arr[s]) - 1 - k
                    req = self._by_uid.pop((s, u), None)
                    if req is not None:
                        req.status = "dropped"
                        self.dropped += 1
                        req.event.set()
        self._backlog = out["backlog"].astype(np.int64)
        self._in_flight = int(out["in_flight"].sum())
        self.t_sim = float(out["t"])
        self.ticks += 1

    async def _tick_loop(self):
        loop = asyncio.get_running_loop()
        while True:
            if not self._pending and not self._by_uid:
                if self._closing:
                    self._drained.set()
                self._work.clear()
                await self._work.wait()
            t0 = time.monotonic()
            n_arr, uid_base = self._inject_plan()
            out = await loop.run_in_executor(
                None, self._device_tick, n_arr, uid_base)
            self._absorb(out, n_arr, uid_base)
            if self._closing and not self._pending and not self._by_uid:
                self._drained.set()
            lag = self.tick_interval_s - (time.monotonic() - t0)
            # always yield so request handlers interleave with the loop
            await asyncio.sleep(lag if lag > 0 else 0)

    # ------------------------------------------------------------------
    # HTTP surface
    # ------------------------------------------------------------------
    async def _handle(self, reader, writer):
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                parts = line.decode("latin-1").strip().split()
                if len(parts) != 3:
                    break
                method, path, version = parts
                headers = {}
                truncated = False
                while True:
                    h = await reader.readline()
                    if h == b"":
                        truncated = True   # EOF mid-headers: the client
                        break              # vanished; don't route a half
                    if h in (b"\r\n", b"\n"):   # request as an empty POST
                        break
                    k, _, v = h.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                if truncated:
                    break
                n = int(headers.get("content-length") or 0)
                body = await reader.readexactly(n) if n else b""
                status, obj = await self._route(method, path, body)
                keep = headers.get(
                    "connection",
                    "keep-alive" if version == "HTTP/1.1" else "close",
                ).lower() != "close"
                data = json.dumps(obj).encode()
                writer.write((
                    f"HTTP/1.1 {status} {_REASON.get(status, 'OK')}\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(data)}\r\n"
                    f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                    "\r\n").encode() + data)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass    # abrupt client disconnect; task lifecycle unaffected
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _route(self, method, path, body):
        if method == "POST" and path == "/tasks":
            return await self._post_task(body)
        if method == "GET" and path.startswith("/labels/"):
            return self._get_label(path[len("/labels/"):])
        if method == "GET" and path == "/healthz":
            return 200, dict(ok=not self._closing, ticks=self.ticks)
        if method == "GET" and path == "/stats":
            return 200, self.stats()
        if method == "POST" and path == "/shutdown":
            draining = bool(self._by_uid or self._pending)
            self._close_task = asyncio.get_running_loop().create_task(
                self.close())
            return 200, dict(ok=True, draining=draining)
        return 404, dict(error=f"no route {method} {path}")

    async def _post_task(self, body):
        try:
            payload = json.loads(body) if body else {}
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:       # json.JSONDecodeError included
            return 400, dict(error=str(e))
        if payload.get("text") is not None \
                or payload.get("label", -1) != -1:
            return 400, dict(
                error='"text"/"label" need an LM scenario '
                      '(features.kind="lm"); this server runs '
                      f'"{self.cfg.learner.feature_kind}" features')
        if self._closing:
            return 503, dict(error="shutting down")
        if len(self._pending) >= self.max_pending:
            self.rejected += 1
            return 429, dict(error="admission queue full")
        req = _Req(rid=self._next_rid, event=asyncio.Event(),
                   t_submit=time.monotonic())
        self._next_rid += 1
        self._reqs[req.rid] = req
        self._pending.append(req)
        self.submitted += 1
        self._work.set()
        if payload.get("wait"):
            timeout = float(payload.get("timeout_s",
                                        self.request_timeout_s))
            try:
                await asyncio.wait_for(req.event.wait(), timeout)
            except asyncio.TimeoutError:
                return 202, req.to_json()
        return (200 if req.status == "done" else 202), req.to_json()

    def _get_label(self, rid_s):
        try:
            rid = int(rid_s)
        except ValueError:
            return 400, dict(error=f"bad id {rid_s!r}")
        req = self._reqs.get(rid)
        if req is None:
            return 404, dict(error=f"unknown id {rid}")
        return 200, req.to_json()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        from repro_torch.obs import timing

        lat = np.asarray(self._lat) if self._lat else np.zeros((0,))
        in_system = len(self._by_uid)
        return dict(
            submitted=self.submitted, answered=self.answered,
            pending=len(self._pending), in_system=in_system,
            dropped=self.dropped, rejected=self.rejected,
            shutdown_unanswered=self.shutdown_unanswered,
            ticks=self.ticks, t_sim=self.t_sim,
            conservation=(self.submitted == self.answered
                          + len(self._pending) + in_system + self.dropped
                          + self.shutdown_unanswered),
            p50_latency_s=float(np.percentile(lat, 50)) if lat.size else None,
            p95_latency_s=float(np.percentile(lat, 95)) if lat.size else None,
            timing=[row for row in timing.summary()
                    if row["name"] == "serve.tick"],
            device=str(self.device),
        )


class ServeClient:
    """Minimal keep-alive asyncio client for :class:`LabelServer` (what
    the tests and the smoke runs drive load with)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._reader = self._writer = None

    async def connect(self):
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        return self

    async def aclose(self):
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None

    async def request(self, method: str, path: str, obj=None):
        if self._writer is None:
            await self.connect()
        body = json.dumps(obj).encode() if obj is not None else b""
        self._writer.write((
            f"{method} {path} HTTP/1.1\r\n"
            f"Host: {self.host}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await self._writer.drain()
        status_line = await self._reader.readline()
        if not status_line:
            raise ConnectionResetError("server closed connection")
        status = int(status_line.split()[1])
        n, keep = 0, True
        while True:
            h = await self._reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            k = k.strip().lower()
            if k == "content-length":
                n = int(v)
            elif k == "connection":
                keep = v.strip().lower() != "close"
        data = await self._reader.readexactly(n) if n else b""
        if not keep:
            await self.aclose()
        return status, (json.loads(data) if data else None)

    async def submit(self, *, wait: bool = False, timeout_s: float = None):
        obj = {"wait": wait}
        if timeout_s is not None:
            obj["timeout_s"] = timeout_s
        return await self.request("POST", "/tasks", obj)

    async def label(self, rid: int):
        return await self.request("GET", f"/labels/{rid}")

    async def stats(self):
        return (await self.request("GET", "/stats"))[1]

    async def shutdown(self):
        return await self.request("POST", "/shutdown", {})
