"""Versioned on-disk snapshot format (the durable half of ``core.Snapshot``).

One generation = one ``snapshot.plex`` file:

    [8B magic "PLEXSNP1"]
    [<QII  header_len, schema_version, header_crc32]
    [header JSON]
    [zero pad to 64B]          <- payload base
    [raw little-endian planes, each 64B-aligned]

The header JSON carries everything that is *not* a bulk array: eps, epoch,
the original build time, per-shard layer scalars (radix ``r``/``shift``/
``min_key``, CHT ``r``/``delta``/``max_depth``/``n_nodes``), the tuner's
decision, and — the part that makes warm starts cheap — the precomputed
host-plane statics (``eps_eff``, ``window``, padded data length, unified
static kernel parameters) that ``kernels.planes._host_planes`` normally
derives from the arrays at plane-build time. The plane directory maps each
array (global key array, shard offsets, per-shard spline keys/positions,
per-shard radix table or CHT cells) to (dtype, shape, payload-relative
offset, nbytes, crc32).

``load_snapshot`` therefore does no index work at all: every plane is
``np.memmap``'d read-only straight out of the file (read-only maps satisfy
the Snapshot freeze contract for free), the per-shard ``PLEX`` objects are
reassembled around the mapped arrays, and the stacked device layout is
built from the mapped planes plus the persisted statics — no spline scan,
no auto-tune, no slack/window re-derivation
(``kernels.planes._host_planes_from_mapped``). The O(n_keys) work left on
the warm path is what only the port keeps: the biased int64 key plane on the
host and, on the device, the key summary strided out of it.

Integrity: the header CRC is always verified on open (a torn header is a
``CorruptSnapshotError``), and every plane's extent is bounds-checked
against the file size, so a truncated half-written file is rejected
cheaply. Per-plane CRCs are verified only by ``validate_snapshot`` (or
``load_snapshot(verify=True)``) because checking them forces a full read —
the opposite of a lazy memmap open. Crash safety does not rest on this
file alone: the generation only becomes live when the manifest names it
(``manifest.write_manifest`` is the atomic commit point).

The port's copy of ``repro.persist.format``: for the same snapshot the file
is the reference's byte for byte, so each package opens the other's
generations. The header holds the reference's statics
(``kernels.planes.persisted_static``: the radix minimum as ``min_hi`` /
``min_lo``), which the port translates on load.
"""
from __future__ import annotations

import json
import os
import pathlib
import struct
import zlib
from typing import Any, Callable, Sequence

import numpy as np

from ..core.autotune import TuneResult
from ..core.cht import CHT
from ..core.index import Snapshot
from ..core.plex import PLEX, BuildStats
from ..core.radix_table import RadixTable
from ..core.spline import Spline
from ..kernels.planes import _HostPlanes, _host_planes_from_mapped, \
    _host_statics, persisted_static
from ..resilience.faults import POINT_SNAPSHOT_MAP, fire
from .manifest import fsync_dir

MAGIC = b"PLEXSNP1"
SCHEMA_VERSION = 1
SNAPSHOT_FILE = "snapshot.plex"

_FIXED = struct.Struct("<QII")        # header_len, schema_version, header_crc
_ALIGN = 64
_EMPTY_F = np.zeros(0)
_EMPTY_I = np.zeros(0, dtype=np.int64)


class CorruptSnapshotError(Exception):
    """The snapshot file is unreadable: bad magic/schema, torn header, a
    plane past EOF, or (under verification) a plane CRC mismatch."""


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr))


def _shard_meta(px: PLEX) -> dict:
    hs = _host_statics(px)            # scalars only, no plane construction
    if isinstance(px.layer, RadixTable):
        layer = dict(r=int(px.layer.r), min_key=int(px.layer.min_key),
                     shift=int(px.layer.shift), n_keys=int(px.layer.n_keys))
    else:
        layer = dict(r=int(px.layer.r), delta=int(px.layer.delta),
                     n_nodes=int(px.layer.n_nodes),
                     max_depth=int(px.layer.max_depth),
                     n_keys=int(px.layer.n_keys))
    return {
        "kind": hs.kind,
        "layer": layer,
        "tuning": {"kind": px.tuning.kind, "r": int(px.tuning.r),
                   "delta": None if px.tuning.delta is None
                   else int(px.tuning.delta)},
        "spline_eps": int(px.spline.eps),
        # persisted host-plane statics: open() never re-derives these
        "eps_eff": int(hs.eps_eff), "window": int(hs.window),
        "n_data": int(hs.n_data), "n_real": int(hs.n_real),
        "static": persisted_static(hs),
    }


def save_snapshot(gen_dir: str | pathlib.Path, snap: Snapshot, *,
                  fsync: bool = True) -> pathlib.Path:
    """Serialise ``snap`` into ``gen_dir/snapshot.plex`` (write-temp +
    rename; the *manifest* rename is the durability commit point, this
    rename just keeps partially-written files out of the directory's
    steady-state namespace)."""
    gen_dir = pathlib.Path(gen_dir)
    gen_dir.mkdir(parents=True, exist_ok=True)
    path = gen_dir / SNAPSHOT_FILE

    planes: list[tuple[str, np.ndarray]] = [
        ("keys", np.ascontiguousarray(snap.keys, dtype=np.uint64)),
        ("offsets", np.ascontiguousarray(snap.offsets, dtype=np.int64)),
    ]
    shards_meta = []
    for i, px in enumerate(snap.shards):
        shards_meta.append(_shard_meta(px))
        planes.append((f"s{i}.spline_keys",
                       np.ascontiguousarray(px.spline.keys, np.uint64)))
        planes.append((f"s{i}.spline_pos",
                       np.ascontiguousarray(px.spline.positions, np.int64)))
        larr = (px.layer.table if isinstance(px.layer, RadixTable)
                else px.layer.cells)
        planes.append((f"s{i}.layer", np.ascontiguousarray(larr, np.uint32)))

    directory = []
    rel = 0
    for name, arr in planes:
        directory.append({"name": name, "dtype": arr.dtype.str,
                          "shape": list(arr.shape), "offset": rel,
                          "nbytes": int(arr.nbytes), "crc32": _crc(arr)})
        rel = _align(rel + arr.nbytes)

    header = {
        "schema": SCHEMA_VERSION,
        "eps": int(snap.eps),
        "epoch": int(snap.epoch),
        "build_s": float(snap.build_s),
        "n_keys": int(snap.n_keys),
        "n_shards": int(snap.n_shards),
        "shards": shards_meta,
        "planes": directory,
    }
    hjson = json.dumps(header, separators=(",", ":")).encode()
    payload_base = _align(len(MAGIC) + _FIXED.size + len(hjson))

    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(_FIXED.pack(len(hjson), SCHEMA_VERSION, zlib.crc32(hjson)))
        f.write(hjson)
        f.write(b"\0" * (payload_base - f.tell()))
        for entry, (_, arr) in zip(directory, planes):
            f.write(b"\0" * (payload_base + entry["offset"] - f.tell()))
            f.write(np.ascontiguousarray(arr).tobytes())
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(gen_dir)
    return path


class SnapshotWriter:
    """Incremental writer for the v1 snapshot format — the streamed half
    of the parallel build (``core.parallel_build.build_generation``).

    ``save_snapshot`` needs the complete snapshot in memory to lay the
    header down first; at SOSD scale the build should instead append each
    shard's planes to disk *as it completes* and drop the shard index
    immediately. This writer makes that possible while keeping the file
    format identical: a header region of ``reserve`` bytes is left at the
    front, planes are appended 64B-aligned exactly as ``save_snapshot``
    lays them out, and ``finalize`` writes the JSON header into the
    reserve, padding it with trailing whitespace (valid JSON; the fixed
    header's ``hlen`` covers the padding, so ``_read_header``'s payload
    base lands exactly on the first plane). If the directory outgrows the
    reserve, the payload is shifted once to a larger base — correctness
    never depends on the estimate.

    The file is written as ``snapshot.plex.tmp`` and renamed at
    ``finalize`` (same publish discipline as ``save_snapshot``; the
    *manifest* rename remains the durability commit point). ``abort()``
    sweeps the temp file, so a failed build leaves no partial snapshot
    behind. Large planes (e.g. a memmapped SOSD key array) are written in
    bounded chunks, never materialised whole.
    """

    _CHUNK = 1 << 24              # 16 MiB per write/crc chunk

    def __init__(self, gen_dir: str | pathlib.Path, *,
                 n_shards_hint: int = 0, reserve: int | None = None,
                 fsync: bool = True):
        self.gen_dir = pathlib.Path(gen_dir)
        self.gen_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.gen_dir / SNAPSHOT_FILE
        self._tmp = self.path.with_suffix(".tmp")
        self._fsync = fsync
        if reserve is None:
            # ~450B shard meta + 3 directory entries per shard, with margin
            reserve = len(MAGIC) + _FIXED.size + 2048 \
                + 1024 * max(int(n_shards_hint), 1)
        self._base = _align(max(int(reserve), len(MAGIC) + _FIXED.size + 2))
        self._f = open(self._tmp, "wb+")
        self._dir: list[dict] = []
        self._shards: list[dict] = []
        self._rel = 0                 # aligned offset of the next plane
        self._payload_end = 0         # actual bytes written past the base

    def add_plane(self, name: str, arr: np.ndarray) -> None:
        """Append one plane (64B-aligned, CRC'd) and its directory entry.
        ``arr`` is streamed in chunks — a memmap is never copied whole."""
        arr = np.asarray(arr)
        flat = arr.reshape(-1)
        self._f.seek(self._base + self._rel)
        crc = 0
        step = max(self._CHUNK // max(arr.itemsize, 1), 1)
        for i in range(0, max(flat.size, 1), step):
            chunk = np.ascontiguousarray(flat[i:i + step])
            if chunk.size == 0:
                break
            crc = zlib.crc32(chunk, crc)
            self._f.write(chunk)
        self._dir.append({"name": name, "dtype": arr.dtype.str,
                          "shape": list(arr.shape), "offset": self._rel,
                          "nbytes": int(arr.nbytes), "crc32": crc})
        self._payload_end = self._rel + int(arr.nbytes)
        self._rel = _align(self._payload_end)

    def add_shard(self, s: int, px: PLEX) -> None:
        """Append shard ``s``'s planes + header metadata (shards must
        arrive in order — the streamed build yields them that way)."""
        if s != len(self._shards):
            raise ValueError(f"shard {s} appended out of order "
                             f"(expected {len(self._shards)})")
        self._shards.append(_shard_meta(px))
        self.add_plane(f"s{s}.spline_keys",
                       np.ascontiguousarray(px.spline.keys, np.uint64))
        self.add_plane(f"s{s}.spline_pos",
                       np.ascontiguousarray(px.spline.positions, np.int64))
        larr = (px.layer.table if isinstance(px.layer, RadixTable)
                else px.layer.cells)
        self.add_plane(f"s{s}.layer", np.ascontiguousarray(larr, np.uint32))

    def _regrow(self, hlen: int) -> None:
        """Shift the payload to a larger base (back-to-front so the
        overlapping copy never clobbers unread bytes). Runs at most once
        per file, only when the header outgrew the reserve."""
        new_base = _align(len(MAGIC) + _FIXED.size + hlen + 1024)
        off = self._payload_end
        while off > 0:
            n = min(self._CHUNK, off)
            off -= n
            self._f.seek(self._base + off)
            buf = self._f.read(n)
            self._f.seek(new_base + off)
            self._f.write(buf)
        self._base = new_base

    def finalize(self, *, eps: int, epoch: int = 0, n_keys: int,
                 build_s: float = 0.0) -> pathlib.Path:
        """Write the header into the reserve and publish the file
        (temp rename + optional fsync). The writer is closed after."""
        header = {
            "schema": SCHEMA_VERSION,
            "eps": int(eps),
            "epoch": int(epoch),
            "build_s": float(build_s),
            "n_keys": int(n_keys),
            "n_shards": len(self._shards),
            "shards": self._shards,
            "planes": self._dir,
        }
        hjson = json.dumps(header, separators=(",", ":")).encode()
        if len(MAGIC) + _FIXED.size + len(hjson) > self._base:
            self._regrow(len(hjson))
        # pad to the exact reserve: json.loads ignores trailing whitespace
        # and hlen covers it, so the payload base math stays exact
        hjson += b" " * (self._base - len(MAGIC) - _FIXED.size - len(hjson))
        self._f.seek(0)
        self._f.write(MAGIC)
        self._f.write(_FIXED.pack(len(hjson), SCHEMA_VERSION,
                                  zlib.crc32(hjson)))
        self._f.write(hjson)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self.path)
        if self._fsync:
            fsync_dir(self.gen_dir)
        return self.path

    def abort(self) -> None:
        """Close and sweep the temp file (no partial snapshot survives a
        failed build). Idempotent; safe after ``finalize`` (no-op).
        A generation directory this writer created and left empty is
        removed too (rmdir refuses non-empty dirs, so a directory holding
        a finalized snapshot or anything else is never touched)."""
        try:
            self._f.close()
        except OSError:  # pragma: no cover
            pass
        try:
            self._tmp.unlink()
        except OSError:
            pass
        try:
            self.gen_dir.rmdir()
        except OSError:
            pass


def _read_header(path: pathlib.Path) -> tuple[dict, int]:
    """-> (header dict, payload base offset); raises CorruptSnapshotError."""
    try:
        with open(path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise CorruptSnapshotError(f"{path}: bad magic {magic!r}")
            fixed = f.read(_FIXED.size)
            if len(fixed) < _FIXED.size:
                raise CorruptSnapshotError(f"{path}: truncated fixed header")
            hlen, schema, hcrc = _FIXED.unpack(fixed)
            if schema != SCHEMA_VERSION:
                raise CorruptSnapshotError(
                    f"{path}: schema {schema} != {SCHEMA_VERSION}")
            hjson = f.read(hlen)
    except OSError as e:
        raise CorruptSnapshotError(f"{path}: unreadable ({e})") from e
    if len(hjson) < hlen or zlib.crc32(hjson) != hcrc:
        raise CorruptSnapshotError(f"{path}: header checksum mismatch")
    return json.loads(hjson), _align(len(MAGIC) + _FIXED.size + hlen)


def _map_planes(path: pathlib.Path, header: dict, payload_base: int,
                names: set[str] | None = None
                ) -> tuple[dict[str, np.ndarray], int]:
    """Memmap the named planes (all of them by default). Returns the map
    plus the total bytes actually mapped — partial loads assert they map
    strictly less than a full load, so the accounting is part of the
    contract, not telemetry."""
    size = path.stat().st_size
    mm: dict[str, np.ndarray] = {}
    mapped = 0
    for e in header["planes"]:
        if names is not None and e["name"] not in names:
            continue
        off = payload_base + e["offset"]
        if off + e["nbytes"] > size:
            raise CorruptSnapshotError(
                f"{path}: plane {e['name']} extends past EOF "
                f"({off + e['nbytes']} > {size})")
        mm[e["name"]] = np.memmap(path, dtype=np.dtype(e["dtype"]),
                                  mode="r", offset=off,
                                  shape=tuple(e["shape"]))
        mapped += int(e["nbytes"])
    return mm, mapped


def _map_key_slice(path: pathlib.Path, header: dict, payload_base: int,
                   k_lo: int, k_hi: int) -> tuple[np.ndarray, int]:
    """Memmap rows [k_lo, k_hi) of the global key plane only — the raw
    little-endian fixed-width layout makes the byte offsets exact, so a
    device's host never maps key bytes outside its assigned range."""
    entry = next(e for e in header["planes"] if e["name"] == "keys")
    itemsize = np.dtype(entry["dtype"]).itemsize
    if not (0 <= k_lo <= k_hi <= int(entry["shape"][0])):
        raise ValueError(f"key range [{k_lo}, {k_hi}) outside plane "
                         f"shape {entry['shape']}")
    off = payload_base + entry["offset"] + k_lo * itemsize
    nbytes = (k_hi - k_lo) * itemsize
    if off + nbytes > path.stat().st_size:
        raise CorruptSnapshotError(
            f"{path}: key slice extends past EOF")
    sl = np.memmap(path, dtype=np.dtype(entry["dtype"]), mode="r",
                   offset=off, shape=(k_hi - k_lo,))
    return sl, nbytes


def validate_snapshot(gen_dir: str | pathlib.Path) -> bool:
    """Full-read integrity check: header CRC + every plane CRC. Raises
    ``CorruptSnapshotError`` on the first mismatch, returns True when the
    whole file verifies."""
    path = pathlib.Path(gen_dir) / SNAPSHOT_FILE
    header, payload_base = _read_header(path)
    mm, _ = _map_planes(path, header, payload_base)
    for e in header["planes"]:
        if _crc(mm[e["name"]]) != e["crc32"]:
            raise CorruptSnapshotError(
                f"{path}: plane {e['name']} checksum mismatch")
    return True


def _stub_tuning(meta: dict) -> TuneResult:
    """A reopened index keeps the tuner's *decision*, not its model grids
    (those exist for build-time inspection only)."""
    t = meta["tuning"]
    return TuneResult(kind=t["kind"], r=int(t["r"]),
                      delta=None if t["delta"] is None else int(t["delta"]),
                      predicted_lambda=0.0, predicted_bytes=0,
                      budget_bytes=0, radix_lambda=_EMPTY_F,
                      radix_bytes=_EMPTY_I, cht_lambda=_EMPTY_F,
                      cht_bytes=_EMPTY_I, cht_nodes=_EMPTY_I)


def _build_layer(meta: dict, cells: np.ndarray):
    lm = meta["layer"]
    if meta["kind"] == "radix":
        return RadixTable(r=int(lm["r"]), min_key=np.uint64(lm["min_key"]),
                          shift=int(lm["shift"]), table=cells,
                          n_keys=int(lm["n_keys"]))
    return CHT(r=int(lm["r"]), delta=int(lm["delta"]), cells=cells,
               n_nodes=int(lm["n_nodes"]), max_depth=int(lm["max_depth"]),
               n_keys=int(lm["n_keys"]))


def _host_planes(header: dict, mm: dict[str, np.ndarray],
                 shard_ids: Sequence[int],
                 bounds: Sequence[tuple[int, int]]) -> list[_HostPlanes]:
    """The stacked builder's per-shard ``_HostPlanes`` from the mapped
    planes + persisted statics — the zero-re-derivation warm path.
    ``shard_ids`` are absolute header shard indexes; ``bounds`` index the
    (possibly partial) mapped key plane in ``mm["keys"]``."""
    keys = mm["keys"]
    return [_host_planes_from_mapped(
        header["shards"][i], keys[lo:hi], mm[f"s{i}.spline_keys"],
        mm[f"s{i}.spline_pos"], mm[f"s{i}.layer"])
        for i, (lo, hi) in zip(shard_ids, bounds)]


def _shard_plane_names(lo: int, hi: int) -> set[str]:
    return {f"s{i}.{p}" for i in range(lo, hi)
            for p in ("spline_keys", "spline_pos", "layer")}


def _assemble_shards(header: dict, mm: dict[str, np.ndarray],
                     shard_ids: Sequence[int],
                     bounds: Sequence[tuple[int, int]],
                     eps: int) -> list[PLEX]:
    keys = mm["keys"]
    shards = []
    for i, (lo, hi) in zip(shard_ids, bounds):
        sm = header["shards"][i]
        spline = Spline(keys=mm[f"s{i}.spline_keys"],
                        positions=mm[f"s{i}.spline_pos"],
                        eps=int(sm["spline_eps"]), n_keys=int(sm["n_real"]))
        layer = _build_layer(sm, mm[f"s{i}.layer"])
        shards.append(PLEX(spline=spline, layer=layer,
                           tuning=_stub_tuning(sm), keys=keys[lo:hi],
                           eps=eps, stats=BuildStats(0.0, 0.0, 0.0, 0.0)))
    return shards


def load_snapshot(gen_dir: str | pathlib.Path, *, verify: bool = False,
                  shard_range: tuple[int, int] | None = None,
                  device=None) -> Snapshot:
    """Memmap one committed generation back into an immutable ``Snapshot``
    whose planes go to ``device`` (default: the CUDA card).

    No index construction happens: shards wrap the mapped arrays directly,
    and every stacked device layout built from the snapshot consumes the
    mapped planes plus the persisted statics via its ``host_planes_fn``
    hook.

    ``shard_range=(lo, hi)`` is the partial-load path for mesh serving: it
    maps *only* the byte ranges those shards need — the tiny offsets
    plane, the per-shard spline/layer planes in range, and the exact key
    rows the range covers (``_map_key_slice``; the raw 64B-aligned layout
    makes the offsets exact) — so a host never touches bytes it does not
    serve. The returned snapshot is a *local view*: ``keys``/``offsets``
    are rebased to the slice, while ``shard_base``/``key_base`` record the
    global position (the partitioner adds ``key_base`` back to get global
    row offsets). ``mapped_bytes`` reports exactly what was mapped; the
    distrib tests pin it strictly below a full load's. Under ``verify``
    the partial path checks every *fully* mapped plane's CRC (the sliced
    key plane cannot be verified without reading bytes outside the slice,
    which would defeat the point). ``distrib.loader`` serves such views,
    one a placement slot.
    """
    gen_dir = pathlib.Path(gen_dir)
    path = gen_dir / SNAPSHOT_FILE
    # chaos point for the open path: a trip here is indistinguishable from
    # an unreadable/corrupt generation, which is exactly what the service's
    # generation-by-generation fallback must survive
    fire(POINT_SNAPSHOT_MAP, gen_dir=gen_dir.name)
    header, payload_base = _read_header(path)
    eps = int(header["eps"])
    n_shards = int(header["n_shards"])
    n_keys = int(header["n_keys"])

    if shard_range is None:
        mm, mapped = _map_planes(path, header, payload_base)
        if verify:
            for e in header["planes"]:
                if _crc(mm[e["name"]]) != e["crc32"]:
                    raise CorruptSnapshotError(
                        f"{path}: plane {e['name']} checksum mismatch")
        keys = mm["keys"]
        offsets = np.asarray(mm["offsets"], dtype=np.int64)
        if keys.size != n_keys or offsets.size != n_shards:
            raise CorruptSnapshotError(f"{path}: header/plane shape mismatch")
        shard_ids = list(range(n_shards))
        bounds = [(int(offsets[i]),
                   int(offsets[i + 1]) if i + 1 < offsets.size else n_keys)
                  for i in range(offsets.size)]
        shards = _assemble_shards(header, mm, shard_ids, bounds, eps)
        all_bounds = bounds

        def fn(lo: int = 0, hi: int | None = None) -> list[_HostPlanes]:
            hi_ = n_shards if hi is None else hi
            return _host_planes(header, mm, range(lo, hi_),
                                all_bounds[lo:hi_])

        snap = Snapshot(keys, eps, offsets, shards, device=device,
                        build_s=float(header["build_s"]),
                        epoch=int(header["epoch"]), host_planes_fn=fn)
        snap.mapped_bytes = mapped
        return snap

    s_lo, s_hi = int(shard_range[0]), int(shard_range[1])
    if not (0 <= s_lo < s_hi <= n_shards):
        raise ValueError(f"shard_range ({s_lo}, {s_hi}) outside "
                         f"[0, {n_shards}]")
    names = {"offsets"} | _shard_plane_names(s_lo, s_hi)
    mm, mapped = _map_planes(path, header, payload_base, names)
    if verify:
        for e in header["planes"]:
            if e["name"] in mm and _crc(mm[e["name"]]) != e["crc32"]:
                raise CorruptSnapshotError(
                    f"{path}: plane {e['name']} checksum mismatch")
    offsets_g = np.asarray(mm["offsets"], dtype=np.int64)
    if offsets_g.size != n_shards:
        raise CorruptSnapshotError(f"{path}: header/plane shape mismatch")
    k_lo = int(offsets_g[s_lo])
    k_hi = int(offsets_g[s_hi]) if s_hi < n_shards else n_keys
    key_slice, key_bytes = _map_key_slice(path, header, payload_base,
                                          k_lo, k_hi)
    mm["keys"] = key_slice
    mapped += key_bytes
    shard_ids = list(range(s_lo, s_hi))
    bounds = [(int(offsets_g[i]) - k_lo,
               (int(offsets_g[i + 1]) if i + 1 < n_shards else n_keys) - k_lo)
              for i in shard_ids]
    shards = _assemble_shards(header, mm, shard_ids, bounds, eps)
    local_bounds = bounds

    def fn_partial(lo: int = 0, hi: int | None = None) -> list[_HostPlanes]:
        hi_ = (s_hi - s_lo) if hi is None else hi
        return _host_planes(header, mm, range(s_lo + lo, s_lo + hi_),
                            local_bounds[lo:hi_])

    snap = Snapshot(key_slice, eps, offsets_g[s_lo:s_hi] - k_lo, shards,
                    device=device, build_s=float(header["build_s"]),
                    epoch=int(header["epoch"]), host_planes_fn=fn_partial)
    snap.shard_base = s_lo
    snap.key_base = k_lo
    snap.mapped_bytes = mapped
    return snap
