"""One run of one benchmark cell.

Everything a cell names is found by that name under the benchmark's folder
(the first of ``BENCHMARK.json``'s ``paths``):

* its configuration: the ``file`` of its ``configs`` entry, which names the
  key generator (``keygen/<keys>.py``), the plain reference
  (``references/<reference>.py``) and the service's settings;
* its traffic mix: ``traffic/<mix>.json``, which names its generator
  (``generators/<generator>.py``) and may give ``sample_requests``, the
  answered requests a client keeps for the check;
* each metric: ``metrics/<name>.py``, whose ``read(run)`` returns the
  metric's value from the run's record, or ``None`` where it finds nothing
  to read (the metric is then left out).

A run: the configuration's keys drawn on the device from its
``data_seed``, and the query pool and each client's requests from the run's
seed; the service built over the keys and warmed on the cell's request
sizes (set-up ends there); the clients for ``seconds`` (the window); then,
once the service is freed, a sample of the answers drawn from the seed
against the plain reference.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import importlib.util
import json
import multiprocessing
import pathlib
import resource
import subprocess
import sys
import time

import numpy as np

U64 = (1 << 64) - 1
BIAS = -(1 << 63)
RESULT_TIMEOUT_S = 60.0      # an answer later than this never came
SAMPLE_PER_CLIENT = 4        # answered requests each client keeps for the
                             # check, where the mix names no other number
TRACE_SPAN_S = 4.0           # the profiled end of a --trace 1 window
WARM_S = 5.0                 # the traffic run in set-up before the window
CHECK_THREADS = 4
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The cell's devices are not there."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.partition(".")[0] in FORBIDDEN})


class Bench:
    """``BENCHMARK.json`` at ``root`` and the benchmark's folder."""

    def __init__(self, root):
        self.root = pathlib.Path(root).resolve()
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._named("configs", name)["file"])
                          .read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        path = self.dir / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"plexbench_{kind}_{name}".replace("-", "_").replace(".", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones, or
        with ``trace`` the per-layer ones, each where it names the cell or
        names no cells."""
        return [m for m in self.spec["per_layer" if trace else "end_to_end"]
                if cell in m.get("workloads", [cell])]


class Sampler:
    """Each client's answers, ``k`` of them kept by reservoir sampling with a
    generator drawn from the seed: a uniform sample over the window."""

    def __init__(self, seed: int, clients: int, k: int):
        self.k = k
        self.rngs = [np.random.default_rng([seed & U64, c, 1])
                     for c in range(clients)]
        self.seen = [0] * clients
        self.kept: list[list] = [[] for _ in range(clients)]

    def offer(self, client: int, index: int, offset: int, size: int,
              answer: np.ndarray) -> None:
        n = self.seen[client]
        self.seen[client] = n + 1
        item = (index, offset, size, answer)
        if n < self.k:
            self.kept[client].append(item)
            return
        j = int(self.rngs[client].integers(0, n + 1))
        if j < self.k:
            self.kept[client][j] = item

    def items(self) -> list:
        return [it for kept in self.kept for it in kept]


@dataclasses.dataclass
class Run:
    """What a run recorded; the metrics' readers read it."""
    cell: dict
    config: dict
    device: object
    kind: str
    seconds: float               # the window's length
    t_start: float               # perf_counter at its start and end
    t_end: float
    setup_s: float
    build_s: float | None        # the program's own build time
    ctor_s: float                # the service's construction, synchronised
    stats0: dict                 # the service's counters at the window's
    stats1: dict                 # start and once it has closed
    requests: np.ndarray         # every finished request (closed_loop)
    lost: int                    # requests that never came
    keys: np.ndarray             # the sorted uint64 keys
    load: object                 # the traffic (pool and queries)
    span: object | None = None   # devtrace.Span of a --trace 1 run


def _counters(svc) -> dict:
    stats = getattr(svc, "stats", None)
    if stats is None:
        return {}
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if isinstance(getattr(stats, f.name), (int, float))}


def plex_service(keys: np.ndarray, config: dict, device):
    """The system under test: ``repro_torch``'s ``PlexService`` with the
    configuration's settings. Its build workers fork: the keys were drawn on
    the card, which the program's default (spawn once CUDA is initialised,
    through a scratch copy of the keys) answers with a copy of them in
    ``/dev/shm``, and a forked worker computes on the host only."""
    from repro_torch.serving import PlexService
    return PlexService(keys, device=device,
                       mp_context=multiprocessing.get_context("fork"),
                       **config["service"])


def nvidia_smi(index: int) -> dict:
    """The card's power limit and clocks as ``nvidia-smi`` reads them
    (empty where it cannot)."""
    fields = ("power.limit", "clocks.sm", "clocks.max.sm", "clocks.mem")
    names = ("power_limit_w", "clocks_sm_mhz", "clocks_max_sm_mhz",
             "clocks_mem_mhz")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return {n: float(v) for n, v in zip(names, out.strip().split(","))}
    except (OSError, subprocess.SubprocessError, ValueError):
        return {}


def check_answers(sampler: Sampler, load, keys: np.ndarray, ref) -> dict:
    """Every kept answer against the plain reference: (wrong answers,
    answers checked, requests checked)."""
    items = sampler.items()

    def wrong(item) -> int:
        _, offset, size, got = item
        want = ref.ranks(keys, load.queries(offset, size))
        got = np.asarray(got)
        if got.shape != want.shape:
            return size
        return int(np.count_nonzero(got != want))

    with concurrent.futures.ThreadPoolExecutor(CHECK_THREADS) as ex:
        n_wrong = sum(ex.map(wrong, items))
    return {"wrong": n_wrong, "answers": sum(it[2] for it in items),
            "requests": len(items)}


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sleep_until(t: float) -> None:
    while (left := t - time.perf_counter()) > 0:
        time.sleep(min(left, 0.05))


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_proc0: float | None = None,
             service_factory=plex_service, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line's object.
    ``service_factory(keys, config, device)`` builds what the clients call
    (the system under test by default)."""
    t_proc0 = time.perf_counter() if t_proc0 is None else t_proc0
    import torch
    from . import devtrace as tracing

    bench = Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"{workload} needs {cell['chips']} CUDA "
                           f"device(s); {torch.cuda.device_count()} visible")
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"

    # the key set is the configuration's (its own seed, as a deployment's
    # data is fixed); the run's seed draws the traffic over it
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(config["data_seed"]) & U64)
    keys_b = bench.module("keygen", config["keys"]).generate(
        int(config["n_keys"]), gen, dev)
    gen.manual_seed(seed & U64)
    load = bench.module("generators", mix["generator"]).make(
        mix, keys_b, seed, gen)
    keys = keys_b.bitwise_xor_(BIAS).cpu().numpy().view(np.uint64)
    del keys_b
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    svc = service_factory(keys, config, dev)
    _sync(torch, dev)
    ctor_s = time.perf_counter() - t0
    build_s = getattr(svc, "build_s", None)
    if hasattr(svc, "warmup"):
        svc.warmup()
    load.warm(svc, RESULT_TIMEOUT_S, WARM_S)
    if trace and dev.type == "cuda":
        tracing.warm()
    _sync(torch, dev)
    stats0 = _counters(svc)
    setup_s = time.perf_counter() - t_proc0

    sampler = Sampler(seed, load.clients,
                      int(mix.get("sample_requests", SAMPLE_PER_CLIENT)))
    t_start = time.perf_counter() + 0.05
    t_end = t_start + seconds
    running = load.start(svc, t_start, t_end, sampler, RESULT_TIMEOUT_S)
    prof = None
    if trace and dev.type == "cuda":
        prof = tracing.Profiled()
        _sleep_until(t_end - min(TRACE_SPAN_S, seconds / 2))
        prof.start()
        _sleep_until(t_end)
        prof.stop()
    else:
        _sleep_until(t_end)
    requests, lost = running.join(RESULT_TIMEOUT_S + 60.0)
    _sync(torch, dev)
    stats1 = _counters(svc)
    path = ("fused" if svc.fused else "per-shard") \
        if hasattr(svc, "fused") else type(svc).__name__
    if dev.type == "cuda":
        record = {"platform": "gpu", "kind": kind,
                  "count": cell["chips"],
                  "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
                  **nvidia_smi(dev.index)}
    else:
        record = {"platform": "cpu", "kind": kind, "count": 1,
                  "memory_peak_bytes": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss * 1024}
    if hasattr(svc, "close"):
        svc.close()
    del svc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checked = check_answers(sampler, load, keys,
                            bench.module("references", config["reference"]))
    run = Run(cell=cell, config=config, device=dev, kind=kind,
              seconds=seconds, t_start=t_start, t_end=t_end, setup_s=setup_s,
              build_s=build_s, ctor_s=ctor_s, stats0=stats0, stats1=stats1,
              requests=requests, lost=lost, keys=keys, load=load)
    t_reduce = time.perf_counter()
    if prof is not None:
        spans = [(name, a, b) for r in requests
                 for name, a, b in (("client.submit", r["t0"], r["t1"]),
                                    ("client.result", r["t1"], r["t2"]))
                 if b >= prof.h0 and a <= prof.h1]
        run.span = prof.reduce(spans)
        record.update(busy_s=run.span.busy_s, window_s=run.span.window_s)

    t_read = time.perf_counter()
    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    n_failed = int((~requests["ok"]).sum()) + lost
    checks = {
        "wrong_answers": {"value": checked["wrong"], "limit": 0,
                          "rule": "<="},
        "failed_requests": {"value": n_failed, "limit": 0, "rule": "<="},
        "checked_requests": {"value": checked["requests"],
                             "limit": load.clients, "rule": ">="},
    }
    correct = all(c["value"] <= c["limit"] if c["rule"] == "<="
                  else c["value"] >= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": int(requests.size) + lost,
              "failed": n_failed, "metrics": metrics, "device": record}
    if run.span is not None:
        result["breakdown"] = {"device_ops": run.span.device_ops,
                               "idle_gaps": run.span.idle_gaps}
    print(json.dumps({"workload": workload, "seed": seed, "path": path,
                      "requests": int(requests.size),
                      "checked_answers": checked["answers"],
                      "setup_s": setup_s, "build_s": build_s,
                      "ctor_s": ctor_s, "check_s": t_reduce - t_check,
                      "reduce_s": t_read - t_reduce,
                      "read_s": time.perf_counter() - t_read,
                      "errors": running.errors[:5]}),
          file=log)
    result["checks"] = checks
    return result
