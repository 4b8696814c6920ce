"""Elastic scaling = pool maintenance for hosts.

The paper's Maintainer evicts workers whose (TermEst-corrected) latency
exceeds PM_l; here the "workers" are GPU hosts and the "tasks" are training
steps / data fetches. A host that misses heartbeats or contributes steps
significantly slower than the threshold is evicted; the mesh shrinks to the
survivors, the step function is recompiled, and state is restored from the
last checkpoint with new shardings (training/checkpoint.py reshards on
device_put). The same TermEst estimator is reused because speculative
duplicate fetches censor observed latencies exactly as in the crowd setting.

The port's own copy of ``src/repro/distributed/elastic.py``: the host-side
monitor and the degree rule, with no device work, so it takes no
``device`` argument. The rebuild it feeds is a new
``launch.mesh.make_local_mesh`` and a checkpoint restored with the new
mesh's ``shardings`` (:mod:`repro_torch.training.checkpoint`).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.maintenance import termest_latency
from repro_torch.core.workers import Worker


@dataclass
class HostState:
    host_id: int
    stats: Worker = None            # reuse the Worker stat bookkeeping
    last_heartbeat: float = 0.0
    alive: bool = True

    def __post_init__(self):
        if self.stats is None:
            self.stats = Worker(self.host_id, mu=0.0, sigma=0.0, accuracy=1.0)


class HostMonitor:
    """Heartbeat + step-latency tracking with PM_l eviction."""

    def __init__(self, host_ids, *, pm_l: float, heartbeat_timeout: float = 60.0,
                 min_obs: int = 3, z: float = 1.645, clock=time.monotonic):
        self.hosts = {h: HostState(h) for h in host_ids}
        self.pm_l = pm_l
        self.hb_timeout = heartbeat_timeout
        self.min_obs = min_obs
        self.z = z
        self.clock = clock
        self.evicted: list = []
        t0 = self.clock()
        for h in self.hosts.values():   # construction counts as first beat
            h.last_heartbeat = t0

    def heartbeat(self, host_id):
        self.hosts[host_id].last_heartbeat = self.clock()

    def record_step(self, host_id, latency: float, *, terminated=False,
                    terminator_latency: float = 0.0):
        s = self.hosts[host_id].stats
        s.n_started += 1
        if terminated:  # a speculative duplicate beat this host
            s.n_terminated += 1
            s.terminator_latency_sum += terminator_latency
        else:
            s.n_completed += 1
            s.completed_latency_sum += latency
            s.completed_latency_sqsum += latency * latency

    def check(self):
        """Returns the list of hosts to evict now (heartbeat or latency)."""
        now = self.clock()
        out = []
        for h in self.hosts.values():
            if not h.alive:
                continue
            if now - h.last_heartbeat > self.hb_timeout:
                out.append((h.host_id, "heartbeat"))
                continue
            s = h.stats
            if s.n_started < self.min_obs:
                continue
            est = termest_latency(s)
            if not math.isfinite(est) or est <= self.pm_l:
                continue
            std = s.emp_std
            if not math.isfinite(std) or std <= 0:
                std = 0.5 * est
            n = max(s.n_completed + s.n_terminated, 1)
            if est - self.pm_l > self.z * std / math.sqrt(n):
                out.append((h.host_id, f"slow (est {est:.1f}s > {self.pm_l}s)"))
        for hid, why in out:
            self.hosts[hid].alive = False
            self.evicted.append((hid, why))
        return out

    @property
    def alive_hosts(self):
        return sorted(h.host_id for h in self.hosts.values() if h.alive)


def largest_valid_dp(n_hosts: int, global_batch: int) -> int:
    """Biggest data-parallel degree <= n_hosts that divides the batch."""
    for dp in range(n_hosts, 0, -1):
        if global_batch % dp == 0:
            return dp
    return 1
