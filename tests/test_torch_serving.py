"""The port's live HTTP front end (``repro_torch.serving.server``) on the
CPU, mirroring tests/test_serving.py: conservation under concurrent
clients, request timeouts, abrupt disconnects, graceful shutdown and bad
requests, plus the launcher's smoke. Every test body is bounded by
``asyncio.wait_for`` (60 s), so a hang fails fast; each test starts its own
server on an ephemeral loopback port.
"""
import asyncio
import json

import pytest
import torch

from repro_torch.launch import serve as launch_serve
from repro_torch.obs import timing
from repro_torch.scenarios import get_scenario
from repro_torch.serving.server import LabelServer, ServeClient

LIMIT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _server(**kw):
    kw.setdefault("tick_interval_s", 0.0)
    return LabelServer(get_scenario("serve_default"), seed=0, port=0,
                       device="cpu", **kw)


def _run(coro):
    async def bounded():
        return await asyncio.wait_for(coro, LIMIT_S)
    return asyncio.run(bounded())


def test_conservation_under_concurrent_clients():
    """Every submission from racing keep-alive clients answers, and the
    ledger balances with zero device drops (capacity throttling). The
    timing registry is process-wide, so it starts empty here: a server run
    by an earlier test file in the same process would add its ticks."""
    timing.clear()

    async def main():
        srv = await _server().start()
        n_clients, per_client = 6, 5

        async def client():
            c = await ServeClient(srv.host, srv.port).connect()
            out = [await c.submit(wait=True, timeout_s=30.0)
                   for _ in range(per_client)]
            await c.aclose()
            return out

        results = await asyncio.gather(*[client()
                                         for _ in range(n_clients)])
        stats = srv.stats()
        await srv.close()
        return results, stats

    results, stats = _run(main())
    flat = [r for out in results for r in out]
    assert all(s == 200 and r["status"] == "done" for s, r in flat), flat
    n = len(flat)
    assert stats["submitted"] == stats["answered"] == n
    assert stats["dropped"] == 0 and stats["conservation"] is True
    assert stats["device"] == "cpu"
    assert len({r["id"] for _, r in flat}) == n
    for _, r in flat:
        assert r["label"] in (0, 1) and r["votes"] >= 1
        assert r["latency_s"] >= 0.0 and 0.5 <= r["conf"] <= 1.0
    (row,) = stats["timing"]
    assert row["name"] == "serve.tick" and row["calls"] == stats["ticks"]


def test_request_timeout_keeps_task_in_system():
    """A wait=True submission whose long-poll times out gets 202; the task
    stays in the system, finalizes later, and GET /labels/<id> finds it."""
    async def main():
        srv = await _server().start()
        c = await ServeClient(srv.host, srv.port).connect()
        status, r = await c.submit(wait=True, timeout_s=0.0)
        assert status == 202, (status, r)
        assert r["status"] in ("pending", "queued"), r
        rid = r["id"]
        while r["status"] != "done":
            await asyncio.sleep(0.02)
            status, r = await c.label(rid)
        stats = srv.stats()
        await c.aclose()
        await srv.close()
        return r, stats

    r, stats = _run(main())
    assert r["status"] == "done"
    assert stats["answered"] == stats["submitted"] == 1
    assert stats["conservation"] is True


def test_abrupt_client_disconnect():
    """A client that submits and vanishes before reading the response does
    not wedge the server or leak its task; a half request never becomes a
    submission."""
    async def main():
        srv = await _server().start()
        _, writer = await asyncio.open_connection(srv.host, srv.port)
        body = json.dumps({"wait": True, "timeout_s": 30.0}).encode()
        writer.write((f"POST /tasks HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        writer.close()
        _, writer = await asyncio.open_connection(srv.host, srv.port)
        writer.write(b"POST /tasks HTTP/1.1\r\nContent-Le")
        await writer.drain()
        writer.close()
        c = await ServeClient(srv.host, srv.port).connect()
        status, r = await c.submit(wait=True, timeout_s=30.0)
        assert status == 200 and r["status"] == "done", (status, r)
        stats = srv.stats()
        while stats["answered"] != stats["submitted"]:
            await asyncio.sleep(0.02)
            stats = srv.stats()
        await c.aclose()
        await srv.close()
        return stats

    stats = _run(main())
    assert stats["submitted"] == stats["answered"] == 2
    assert stats["conservation"] is True


def test_graceful_shutdown_resolves_stragglers():
    """close(drain=True) answers what it can in the drain window and
    resolves the rest as "shutdown"; the ledger still balances, and a
    second close is a no-op."""
    async def main():
        srv = await _server(drain_timeout_s=0.05).start()
        c = await ServeClient(srv.host, srv.port).connect()
        rids = []
        for _ in range(8):
            status, r = await c.submit(wait=False)
            assert status in (200, 202)
            rids.append(r["id"])
        await c.aclose()
        await srv.close(drain=True)
        await srv.close()
        return [srv._reqs[rid].status for rid in rids], srv.stats()

    states, stats = _run(main())
    assert all(s in ("done", "shutdown") for s in states), states
    assert stats["conservation"] is True
    assert stats["answered"] + stats["shutdown_unanswered"] == 8
    assert stats["pending"] == 0 and stats["in_system"] == 0


def test_shutdown_endpoint_and_503_while_closing():
    async def main():
        srv = await _server().start()
        c = await ServeClient(srv.host, srv.port).connect()
        status, r = await c.request("GET", "/healthz")
        assert status == 200 and r["ok"] is True
        status, r = await c.shutdown()
        assert status == 200 and r["ok"] is True
        while r["ok"]:
            await asyncio.sleep(0.01)
            status, r = await c.request("GET", "/healthz")
        # the server is closing: a submission on a live socket is refused
        refused = await c.submit()
        # the listener's close waits for open connections
        await c.aclose()
        await srv._close_task
        return refused, srv.stats()

    (status, body), stats = _run(main())
    assert status == 503 and "shutting down" in body["error"]
    assert stats["submitted"] == 0 and stats["conservation"] is True


def test_rejects_bad_requests():
    """400 on malformed JSON and on LM-only fields (accepted on an LM
    scenario), 404 on unknown routes and ids; none of the refused ones
    enter the ledger."""
    async def main():
        srv = await _server().start()
        out = {}
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        writer.write(b"POST /tasks HTTP/1.1\r\nHost: t\r\n"
                     b"Content-Length: 5\r\n\r\n{oops")
        await writer.drain()
        out["bad_json"] = int((await reader.readline()).split()[1])
        writer.close()
        c = await ServeClient(srv.host, srv.port).connect()
        out["no_route"] = (await c.request("GET", "/nope"))[0]
        out["bad_id"] = (await c.label(99))[0]
        out["not_int_id"] = (await c.label("x"))[0]
        status, r = await c.request("POST", "/tasks", {"text": "hello"})
        out["text"] = status
        assert "lm" in r["error"], r
        out["label"] = (await c.request("POST", "/tasks", {"label": 1}))[0]
        out["array"] = (await c.request("POST", "/tasks", [1, 2]))[0]
        stats = srv.stats()
        await c.aclose()
        await srv.close()
        return out, stats

    async def lm():
        srv = await LabelServer(get_scenario("lm_stream"), seed=0, port=0,
                                tick_interval_s=0.0, device="cpu").start()
        c = await ServeClient(srv.host, srv.port).connect()
        got = [(await c.submit(text="hello", label=1))[0],
               (await c.submit(label=0))[0]]
        await c.aclose()
        await srv.close(drain=False)
        return got

    out, stats = _run(main())
    assert out == {"bad_json": 400, "no_route": 404, "bad_id": 404,
                   "not_int_id": 400, "text": 400, "label": 400,
                   "array": 400}
    assert stats["submitted"] == 0 and stats["conservation"] is True
    assert _run(lm()) == [202, 202]


def test_admission_queue_bound_returns_429():
    async def main():
        srv = await _server(max_pending=2).start()
        # three submissions with no await that yields between them: the
        # tick loop has not run, so the first two are still pending
        got = [await srv._post_task(b"{}") for _ in range(3)]
        stats = srv.stats()
        await srv.close(drain=False)
        return [s for s, _ in got], stats

    statuses, stats = _run(main())
    assert statuses == [202, 202, 429] and stats["rejected"] == 1
    assert stats["conservation"] is True


def test_launcher_smoke():
    res = _run(launch_serve.smoke("serve_default", device="cpu"))
    assert res["ok"] and res["answered"] == res["submitted"] == 32
    assert res["conservation"] and res["answered_per_s"] > 0
    assert res["p50_latency_s"] <= res["p95_latency_s"]


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LabelServer(get_scenario("serve_default"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LabelServer(get_scenario("lm_stream"))
    assert LabelServer(get_scenario("lm_stream"), device="cpu")._lm
