"""Launcher for the live labeling service: serve any registry stream
scenario over HTTP (:class:`repro_torch.serving.server.LabelServer`; port
of ``src/repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --scenario serve_default
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario serve_default \\
        --port 8787 --tick-interval-s 0.02

The tick runs on the card unless ``--device cpu`` is given. ``--smoke``
starts the server on an ephemeral loopback port, submits 4 clients x 8
waiting tasks, checks that every submission is answered with conservation
intact, shuts down cleanly, and exits nonzero otherwise.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys


async def _serve_forever(args):
    from repro_torch.scenarios import get_scenario
    from repro_torch.serving.server import LabelServer

    spec = get_scenario(args.scenario)
    srv = LabelServer(spec, seed=args.seed, host=args.host, port=args.port,
                      tick_interval_s=args.tick_interval_s,
                      device=args.device)
    await srv.start()
    print(f"serving scenario {args.scenario!r} on "
          f"http://{srv.host}:{srv.port} ({srv.device}; POST /tasks, GET "
          "/labels/<id>, GET /stats, POST /shutdown)", flush=True)
    try:
        while not srv._closed:
            await asyncio.sleep(0.2)
    finally:
        await srv.close()


async def smoke(scenario: str = "serve_default", *, seed: int = 0,
                host: str = None, device="cuda", n_clients: int = 4,
                per_client: int = 8) -> dict:
    """Start a server on an ephemeral port, run ``n_clients`` keep-alive
    clients of ``per_client`` waiting submissions each, shut down, and
    return the result: ``ok`` (every submission answered, conservation
    intact), the counts, the wall-clock latency percentiles and answered
    tasks per second."""
    import time

    from repro_torch.scenarios import get_scenario
    from repro_torch.serving.server import LabelServer, ServeClient

    srv = LabelServer(get_scenario(scenario), seed=seed, host=host, port=0,
                      tick_interval_s=0.0, device=device)
    await srv.start()
    print(f"smoke: serving {scenario!r} on port {srv.port} ({srv.device})",
          flush=True)

    async def client():
        c = await ServeClient(srv.host, srv.port).connect()
        out = []
        for _ in range(per_client):
            out.append(await c.submit(wait=True, timeout_s=60.0))
        await c.aclose()
        return out

    t0 = time.perf_counter()
    results = await asyncio.gather(*[client() for _ in range(n_clients)])
    wall = time.perf_counter() - t0
    answered = [r for out in results for (status, r) in out
                if status == 200 and r["status"] == "done"]
    stats = srv.stats()
    c = await ServeClient(srv.host, srv.port).connect()
    await c.shutdown()
    await c.aclose()
    await srv.close()
    n = n_clients * per_client
    return dict(
        scenario=scenario, device=str(srv.device), submitted=n,
        answered=len(answered), conservation=stats["conservation"],
        p50_latency_s=stats["p50_latency_s"],
        p95_latency_s=stats["p95_latency_s"], ticks=stats["ticks"],
        wall_s=wall, answered_per_s=len(answered) / wall,
        timing=stats["timing"],
        ok=(len(answered) == n and stats["conservation"]
            and stats["answered"] == n))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="serve_default")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tick-interval-s", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="run the smoke workload and exit")
    args = ap.parse_args(argv)
    try:
        if not args.smoke:
            asyncio.run(_serve_forever(args))
            return
        res = asyncio.run(smoke(args.scenario, seed=args.seed,
                                host=args.host, device=args.device))
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return
    print(json.dumps(res))
    if not res["ok"]:
        raise SystemExit(f"serve smoke FAILED: {res['answered']}/"
                         f"{res['submitted']} answered")
    print("serve smoke OK", flush=True)


if __name__ == "__main__":
    main()
