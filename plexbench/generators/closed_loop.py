"""Closed-loop clients over a pool of queries drawn on the device.

A mix file names this generator and gives its parameters:

* ``clients``: client threads, each sending its next request as soon as
  the last one's result is in;
* ``size_min``, ``size_max``, ``size_steps``: request sizes in keys,
  ``size_steps`` fixed points of the log-uniform distribution between the
  two (one size where they are equal); each client runs through all of them
  in an order drawn from the seed, then again, so every seed offers the
  same sizes;
* ``pool_log2``: the pool of ``2^pool_log2`` queries drawn in set-up; a
  request is a slice of it at an offset drawn from the seed, so no client
  does generator work in the window;
* ``absent_share``: the share of the pool drawn uniformly over the key
  range (inclusive) rather than from the keys; a few of those are the edge
  keys 0 and 2^64 - 1 (one of each in every 2^16 queries). The rest are
  keys drawn uniformly from the key set; with 0, every query is a key.

Each request goes through ``service.submit(q)`` and waits on the ticket's
``result()``.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

BIAS = -(1 << 63)          # xor with it flips the top bit: k ^ 2^63
U64 = (1 << 64) - 1
REQUEST_FIELDS = [("client", np.int32), ("index", np.int64),
                  ("offset", np.int64), ("size", np.int64),
                  ("t0", np.float64), ("t1", np.float64),
                  ("t2", np.float64), ("ok", np.bool_)]


def size_grid(mix: dict) -> np.ndarray:
    """The request sizes every client runs through."""
    lo, hi, k = mix["size_min"], mix["size_max"], mix["size_steps"]
    return np.round(lo * (hi / lo) ** ((np.arange(k) + 0.5) / k)) \
        .astype(np.int64)


def draw_pool(mix: dict, keys: torch.Tensor, gen: torch.Generator
              ) -> np.ndarray:
    """The uint64 query pool, drawn on the keys' device from the sorted
    biased ``keys`` and shuffled there."""
    dev = keys.device
    n_pool = 1 << mix["pool_log2"]
    n_abs = int(round(n_pool * mix["absent_share"]))
    lo, hi = int(keys[0]), int(keys[-1])
    if n_abs and hi - lo >= (1 << 63) - 1:
        raise ValueError("the key range is too wide to draw absent keys in "
                         "one int64 span")
    present = keys[torch.randint(0, keys.numel(), (n_pool - n_abs,),
                                 generator=gen, device=dev)]
    absent = torch.randint(lo, hi + 1, (n_abs,), generator=gen, device=dev)
    n_edge = min(n_abs // 2, max(n_pool >> 16, 1))
    absent[:n_edge] = BIAS                  # the key 0, biased
    absent[n_edge:2 * n_edge] = (1 << 63) - 1   # the key 2^64 - 1, biased
    pool = torch.cat([present, absent])
    del present, absent
    pool = pool[torch.randperm(n_pool, generator=gen, device=dev)]
    return pool.bitwise_xor_(BIAS).cpu().numpy().view(np.uint64)


class Load:
    """The pool and each client's requests, all drawn from the seed."""

    def __init__(self, mix: dict, keys: torch.Tensor, seed: int,
                 gen: torch.Generator):
        self.mix = mix
        self.clients = int(mix["clients"])
        self.sizes = size_grid(mix)
        self.seed = seed & U64
        self.pool = draw_pool(mix, keys, gen)

    def queries(self, offset: int, size: int) -> np.ndarray:
        return self.pool[offset:offset + size]

    def _plan(self, client: int, stream: int):
        """Client ``client``'s (offset, size) of each request in turn;
        ``stream`` 0 is the window's, 1 the warm-up's."""
        rng = np.random.default_rng([self.seed, client, stream])
        while True:
            for j in rng.permutation(self.sizes.size):
                size = int(self.sizes[j])
                yield int(rng.integers(0, self.pool.size - size + 1)), size

    def warm(self, service, timeout: float, seconds: float) -> None:
        """Every client at once, twice, through each size class (the
        smallest and largest request and each power of two between), from
        the start of the pool; then the clients as in the window, on
        requests of their own, for ``seconds``: the service's host and
        device allocators, its queue and the host's caches reach the
        window's steady state before it opens."""
        lo, hi = int(self.sizes.min()), int(self.sizes.max())
        sizes = sorted({lo, hi} | {1 << k for k in range(
            lo.bit_length(), hi.bit_length()) if lo < 1 << k < hi})
        errors = []

        def client():
            try:
                for _ in range(2):
                    for size in sizes:
                        service.submit(self.pool[:size]).result(timeout)
            except Exception as e:   # raised below in the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        t0 = time.perf_counter()
        Running(self, service, t0, t0 + seconds, _Discard(), timeout,
                stream=1).join(seconds + timeout)

    def start(self, service, t_start: float, t_end: float, sampler,
              timeout: float) -> "Running":
        """Start the clients; each sends its first request at ``t_start``
        (``time.perf_counter``) and its last one before ``t_end``.
        ``sampler.offer(client, index, offset, size, answer)`` sees every
        answer."""
        return Running(self, service, t_start, t_end, sampler, timeout)


class _Discard:
    def offer(self, *args) -> None:
        pass


class Running:
    def __init__(self, load: Load, service, t_start, t_end, sampler,
                 timeout, stream: int = 0):
        self.records = [[] for _ in range(load.clients)]
        self.errors: list[str] = []
        self.threads = [threading.Thread(
            target=self._client, daemon=True,
            args=(load, c, service, t_start, t_end, sampler, timeout,
                  stream))
            for c in range(load.clients)]
        for t in self.threads:
            t.start()

    def _client(self, load, c, service, t_start, t_end, sampler, timeout,
                stream):
        rec = self.records[c]
        plan = load._plan(c, stream)
        while time.perf_counter() < t_start:
            time.sleep(min(t_start - time.perf_counter(), 0.01))
        i = 0
        while time.perf_counter() < t_end:
            offset, size = next(plan)
            q = load.pool[offset:offset + size]
            t0 = time.perf_counter()
            t1 = t0
            try:
                ticket = service.submit(q)
                t1 = time.perf_counter()
                out = ticket.result(timeout)
                ok = True
            except Exception as e:     # counted as failed, never raised
                self.errors.append(f"client {c} request {i}: {e!r}")
                ok = False
            t2 = time.perf_counter()
            rec.append((c, i, offset, size, t0, t1, t2, ok))
            if ok:
                sampler.offer(c, i, offset, size, out)
            i += 1

    def join(self, timeout: float) -> tuple[np.ndarray, int]:
        """-> (every finished request, clients still waiting on one)."""
        deadline = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(deadline - time.perf_counter(), 0.0))
        lost = sum(t.is_alive() for t in self.threads)
        rows = [r for rec in self.records for r in list(rec)]
        return np.array(rows, dtype=REQUEST_FIELDS), lost


def make(mix: dict, keys: torch.Tensor, seed: int,
         gen: torch.Generator) -> Load:
    return Load(mix, keys, seed, gen)
