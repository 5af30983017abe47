"""Straggler watchdog: per-host step-time accounting + slow-host reports
(the port of ``repro.launch.watchdog``).

On real multi-host deployments each host feeds this its step wall-times;
hosts whose EWMA exceeds ``threshold`` x the fleet median are flagged so the
scheduler can preempt/replace them (with deterministic (step, host) data
shards — data/packing.py — a replacement host replays its shard exactly).
A single host feeds one row; the accounting is the reference's
(``repro.launch.watchdog``), numpy only."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerWatchdog:
    n_hosts: int
    threshold: float = 1.5      # x median EWMA
    alpha: float = 0.3          # EWMA coefficient
    min_steps: int = 5

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self.steps = np.zeros(self.n_hosts, dtype=np.int64)

    def record(self, host: int, step_time_s: float) -> None:
        if self.steps[host] == 0:
            self.ewma[host] = step_time_s
        else:
            self.ewma[host] = (self.alpha * step_time_s
                               + (1 - self.alpha) * self.ewma[host])
        self.steps[host] += 1

    def stragglers(self) -> list[int]:
        """Hosts whose smoothed step time exceeds threshold x fleet median."""
        ready = self.steps >= self.min_steps
        if ready.sum() < max(self.n_hosts // 2, 1):
            return []
        med = float(np.median(self.ewma[ready]))
        if med <= 0:
            return []
        return [int(h) for h in np.nonzero(
            ready & (self.ewma > self.threshold * med))[0]]

    def report(self) -> dict:
        return {"median_s": float(np.median(self.ewma[self.steps > 0]))
                if (self.steps > 0).any() else 0.0,
                "stragglers": self.stragglers(),
                "ewma": self.ewma.round(4).tolist()}
