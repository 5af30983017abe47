"""Parallel sharded PLEX build — fan the per-shard build over a pool.

The port's own copy of ``repro.core.parallel_build``. ``Snapshot.build`` is
a loop of independent per-shard ``build_plex`` calls (spline fit +
auto-tune + radix/CHT layer, no shared state), so the build is
embarrassingly parallel at shard granularity. This module is the fan-out
engine behind ``Snapshot.build(..., workers=N)``,
``PlexService(build_workers=N)`` and the streamed durable build
(``build_generation``):

* **Zero-copy key passing.** The frozen key array is never pickled into the
  workers. Three transports, picked automatically per (array, pool):

  - file-backed ``np.memmap`` keys: each worker re-maps the same file
    range read-only;
  - fork start method: the parent parks the array in a module-level table
    before the pool forks, so children inherit the pages copy-on-write;
  - spawn start method: one copy into a scratch file each worker memmaps
    read-only — in ``/dev/shm`` when it has room for the keys, else in
    ``tempfile.gettempdir()`` (a container's ``/dev/shm`` is often 64 MB;
    200M keys are 1.6 GB). The bytes are the same either way.

* **Shard-order streaming.** ``iter_built_shards`` yields ``(s, PLEX)`` in
  shard order as soon as each shard (and all its predecessors) completes,
  buffering only out-of-order completions, so the streamed snapshot writer
  never holds every shard's index in memory at once.

* **Bit-identity.** Workers run the exact same ``build_plex`` on the exact
  same key bytes; only the schedule changes (same planes, same tuning,
  same persisted bytes; ``tests/test_torch_parallel_build.py``).

* **No CUDA in a worker.** Fork is chosen only while this process has not
  initialised CUDA (``torch.cuda.is_initialized()``), spawn otherwise: a
  forked child of a process holding a CUDA context cannot use it and must
  not try. A spawned worker imports ``repro_torch.core`` and with it
  ``torch``, and nothing on that import path touches ``torch.cuda``. Each
  task checks, after its build, that its process has not initialised CUDA.

Workers strip ``PLEX.keys`` before returning (the parent re-attaches its
own ``keys[lo:hi]`` view), so result pickling moves only the index planes.
"""
from __future__ import annotations

import concurrent.futures
import itertools
import multiprocessing
import os
import pathlib
import shutil
import sys
import tempfile
import threading
import time
from typing import Iterator

import numpy as np

from ..obs.trace import TRACE
from ..resilience.faults import POINT_BUILD_SHARD, fire
from .plex import PLEX, build_plex

__all__ = ["SHM_DIR", "build_generation", "build_shard_plexes",
           "cuda_initialized", "iter_built_shards", "scratch_dir",
           "spans_of", "worker_env"]

# the spawn transport's first choice of scratch directory (RAM-backed)
SHM_DIR = "/dev/shm"
# free bytes /dev/shm must keep beyond the keys before it is chosen
_SHM_SLACK = 64 << 20

# -- worker-side shared key array --------------------------------------------
# one slot per worker process: set by the pool initializer, read by every
# task. Thread pools bypass this entirely (they share the parent's array).
_WORKER_KEYS: np.ndarray | None = None

# parent-side table for the fork transport: arrays parked here before the
# pool forks are inherited copy-on-write by the children. Keyed by a unique
# token so concurrent builds in one process never collide.
_INHERITED: dict[int, np.ndarray] = {}
_token_counter = itertools.count(1)
_token_lock = threading.Lock()


def cuda_initialized() -> bool:
    """Whether this process has initialised CUDA (``False`` when torch was
    never imported; the check itself initialises nothing)."""
    torch = sys.modules.get("torch")
    return torch is not None and bool(torch.cuda.is_initialized())


def worker_env() -> dict:
    """What a build worker's process holds: its pid, whether jax is
    imported and whether CUDA is initialised (submit it to a pool made
    like the build's to check the start method's effect)."""
    return {"pid": os.getpid(), "jax": "jax" in sys.modules,
            "cuda_initialized": cuda_initialized()}


def scratch_dir(nbytes: int) -> str:
    """Where the spawn transport writes ``nbytes`` of keys: ``SHM_DIR``
    when it exists and has room for them (plus a margin), else
    ``tempfile.gettempdir()``."""
    if os.path.isdir(SHM_DIR):
        try:
            if shutil.disk_usage(SHM_DIR).free >= nbytes + _SHM_SLACK:
                return SHM_DIR
        except OSError:
            pass
    return tempfile.gettempdir()


def _keys_descriptor(keys: np.ndarray, start_method: str):
    """-> (picklable transport descriptor, cleanup callable). The
    descriptor tells ``_pool_init`` how to materialise the key array in a
    worker without pickling it."""
    if isinstance(keys, np.memmap) and getattr(keys, "filename", None):
        return (("mmap", str(keys.filename), int(keys.offset),
                 str(keys.dtype.str), int(keys.size)), lambda: None)
    if start_method == "fork":
        with _token_lock:
            token = next(_token_counter)
        _INHERITED[token] = keys
        return ("inherit", token), lambda: _INHERITED.pop(token, None)
    # spawn/forkserver: one shared copy through a scratch file the workers
    # memmap read-only. Unlinked by the parent after the build; POSIX
    # keeps the pages alive for the workers' open maps.
    fd, path = tempfile.mkstemp(prefix="plex-build-keys-",
                                dir=scratch_dir(int(keys.nbytes)))
    try:
        with os.fdopen(fd, "wb") as fh:
            np.ascontiguousarray(keys).tofile(fh)
    except BaseException:
        os.unlink(path)
        raise

    def cleanup() -> None:
        try:
            os.unlink(path)
        except OSError:  # pragma: no cover
            pass

    return ("mmap", path, 0, str(keys.dtype.str), int(keys.size)), cleanup


def _pool_init(desc) -> None:
    """Worker initializer: materialise the shared key array once per
    worker process (module global), whatever the transport."""
    global _WORKER_KEYS
    kind = desc[0]
    if kind == "mmap":
        _, path, offset, dtype, n = desc
        _WORKER_KEYS = np.memmap(path, dtype=np.dtype(dtype), mode="r",
                                 offset=offset, shape=(n,))
    else:
        _WORKER_KEYS = _INHERITED[desc[1]]


def _build_shard_task(s: int, lo: int, hi: int, eps: int,
                      build_kw: dict) -> tuple[int, PLEX]:
    """One worker task: build shard ``s`` over the process-shared key
    array. ``keys`` is stripped before pickling the result back — the
    parent re-attaches its own view, so only index planes cross the pipe."""
    px = build_plex(_WORKER_KEYS[lo:hi], eps, **build_kw)
    if cuda_initialized():
        raise RuntimeError(f"build worker {os.getpid()} initialised CUDA")
    px.keys = None
    return s, px


def spans_of(offsets: np.ndarray, n_keys: int) -> list[tuple[int, int]]:
    """Per-shard [lo, hi) key spans from the shard offset table."""
    return [(int(offsets[s]),
             int(offsets[s + 1]) if s + 1 < len(offsets) else int(n_keys))
            for s in range(len(offsets))]


def _mp_context(mp_context=None) -> multiprocessing.context.BaseContext:
    """Pick the process start method: an explicit context wins; otherwise
    fork (cheapest, copy-on-write key inheritance) while this process has
    not initialised CUDA, spawn once it has (always on the card)."""
    if mp_context is not None:
        if isinstance(mp_context, str):
            return multiprocessing.get_context(mp_context)
        return mp_context
    if "fork" in multiprocessing.get_all_start_methods() \
            and not cuda_initialized():
        return multiprocessing.get_context("fork")
    return multiprocessing.get_context("spawn")


def iter_built_shards(keys: np.ndarray, offsets: np.ndarray, eps: int, *,
                      workers: int = 1, pool: str = "process",
                      mp_context=None, **build_kw
                      ) -> Iterator[tuple[int, PLEX]]:
    """Yield ``(shard_index, PLEX)`` in shard order, building up to
    ``workers`` shards concurrently.

    Each yielded PLEX has its ``keys`` re-attached as a view of the
    parent's ``keys`` array (same aliasing as the serial build). Results
    are yielded as soon as each shard *and all its predecessors* are done,
    so a streaming consumer can write shard ``s`` to disk while shards
    ``> s`` are still building. ``workers <= 1`` (or a single shard)
    degrades to the serial in-process loop — no pool, no transport."""
    spans = spans_of(offsets, keys.size)
    if workers <= 1 or len(spans) <= 1 or pool == "serial":
        for s, (lo, hi) in enumerate(spans):
            fire(POINT_BUILD_SHARD, shard=s)
            px = build_plex(keys[lo:hi], eps, **build_kw)
            if TRACE.enabled:
                TRACE.record("build.shard", px.stats.total_s,
                             shard=s, n_keys=hi - lo)
            yield s, px
        return

    workers = min(int(workers), len(spans))
    if pool == "thread":
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
        cleanup = lambda: None  # noqa: E731 - trivial no-op pair

        def submit(s: int, lo: int, hi: int):
            return ex.submit(
                lambda: (s, build_plex(keys[lo:hi], eps, **build_kw)))
    elif pool == "process":
        ctx = _mp_context(mp_context)
        desc, cleanup = _keys_descriptor(keys, ctx.get_start_method())
        ex = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx,
            initializer=_pool_init, initargs=(desc,))

        def submit(s: int, lo: int, hi: int):
            return ex.submit(_build_shard_task, s, lo, hi, eps, build_kw)
    else:
        raise ValueError(f"pool must be 'process', 'thread', or 'serial', "
                         f"got {pool!r}")

    try:
        futs = {submit(s, lo, hi): s for s, (lo, hi) in enumerate(spans)}
        ready: dict[int, PLEX] = {}
        next_s = 0
        for fut in concurrent.futures.as_completed(futs):
            s, px = fut.result()      # a worker failure propagates here
            if px.keys is None:       # process transport stripped the view
                lo, hi = spans[s]
                px.keys = keys[lo:hi]
            ready[s] = px
            while next_s in ready:
                fire(POINT_BUILD_SHARD, shard=next_s)
                nxt = ready.pop(next_s)
                if TRACE.enabled:
                    # worker-side CPU seconds (wall time overlaps shards)
                    TRACE.record("build.shard", nxt.stats.total_s,
                                 shard=next_s, pool=pool)
                yield next_s, nxt
                next_s += 1
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
        cleanup()


def build_shard_plexes(keys: np.ndarray, offsets: np.ndarray, eps: int, *,
                       workers: int = 1, pool: str = "process",
                       mp_context=None, **build_kw) -> list[PLEX]:
    """All shard PLEXes in shard order (the ``Snapshot.build`` fan-out)."""
    return [px for _, px in iter_built_shards(
        keys, offsets, eps, workers=workers, pool=pool,
        mp_context=mp_context, **build_kw)]


def build_generation(root, keys: np.ndarray, eps: int, *,
                     n_shards: int | None = None, workers: int = 1,
                     pool: str = "process", mp_context=None,
                     epoch: int = 0, fsync: bool = True,
                     manifest: bool = True, **build_kw) -> pathlib.Path:
    """Parallel build streamed straight into one durable generation.

    Shard planes are appended to the snapshot format *as each shard
    completes* (``persist.format.SnapshotWriter``) and the built PLEX is
    dropped immediately, so peak memory is the key array plus O(workers)
    in-flight shard indexes — never the whole assembled snapshot. With
    ``manifest=True`` the next generation number is taken from (and
    committed to) ``root/MANIFEST.json`` with a fresh empty WAL segment,
    making the directory directly servable by ``PlexService.open``.

    ``keys`` may be a read-only ``np.memmap`` of a raw uint64 file — the
    workers then re-map the file instead of copying anything, and the key
    plane is streamed to the output in bounded chunks.

    Returns the generation directory; raises before any manifest change on
    failure (a partial ``snapshot.plex.tmp`` is swept by the writer)."""
    from ..persist.format import SnapshotWriter
    from ..persist.manifest import (Manifest, gen_name, read_manifest,
                                    wal_name, write_manifest)
    from ..persist.wal import WriteAheadLog
    from .index import SHARD_MAX_KEYS, shard_offsets

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    keys = np.asarray(keys)
    if keys.dtype != np.uint64:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if keys.size == 0:
        raise ValueError("cannot build a generation from an empty key set")
    if n_shards is None:
        n_shards = -(-keys.size // SHARD_MAX_KEYS)
    offsets = shard_offsets(keys, max(int(n_shards), 1))

    gen = 0
    if manifest:
        man = read_manifest(root)
        gen = man.generation + 1 if man is not None else 0
    gen_dir = root / gen_name(gen)

    t0 = time.perf_counter()
    writer = SnapshotWriter(gen_dir, n_shards_hint=len(offsets), fsync=fsync)
    try:
        writer.add_plane("keys", keys)
        writer.add_plane("offsets", np.ascontiguousarray(offsets, np.int64))
        for s, px in iter_built_shards(keys, offsets, eps, workers=workers,
                                       pool=pool, mp_context=mp_context,
                                       **build_kw):
            writer.add_shard(s, px)
            # px goes out of scope here: the streamed build never holds
            # every shard's index at once
        writer.finalize(eps=int(eps), epoch=int(epoch), n_keys=keys.size,
                        build_s=time.perf_counter() - t0)
    except BaseException:
        writer.abort()
        raise
    if manifest:
        wal = WriteAheadLog.create(root / wal_name(gen), fsync=fsync)
        wal.close()
        write_manifest(root, Manifest.for_generation(gen), fsync=fsync)
    return gen_dir
