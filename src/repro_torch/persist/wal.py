"""Append-only, checksummed delta write-ahead log.

One WAL segment belongs to one snapshot generation (the manifest binds
them). ``PlexService.insert()/delete()`` append a record *before* mutating
the in-memory ``DeltaBuffer``, so the durable state is always >= the served
state; replaying the segment over its snapshot reconstructs the exact
``_DeltaState`` (tombstone multiplicities are recomputed against the same
immutable snapshot, so they cannot drift).

File layout:

    [8B magic "PLEXWAL1"] [record]*
    record = <III-ish: u32 crc32 | u32 payload_nbytes | u8 opcode>
             [payload: raw little-endian uint64 keys]

The CRC covers the opcode byte + payload, so a torn header, a torn
payload, and a bit-flipped record are all detected. Recovery is
prefix-valid: ``replay`` returns every record up to the first invalid one
and reports how many trailing bytes were discarded; the caller (service
``open``) logs the discard and truncates the file back to the valid prefix
before appending again, so garbage can never be buried under new records.

Rotation (bounded recovery): a write-heavy epoch can append far more
record bytes than the delta it nets out to (insert/delete churn), making
replay cost proportional to *history* rather than *state*. ``rotate``
compacts the segment in place: a fresh segment seeded with a
``OP_CHECKPOINT`` record plus the buffer's replay-equivalent pending ops
is written to a temp file and atomically renamed over the live one — a
crash before the rename leaves the full old segment authoritative, after
it the compacted equivalent. ``replay`` restarts its record list at the
*last* checkpoint record, so both rename-compacted segments and any
future append-a-checkpoint scheme recover identically. The manifest never
changes: rotation preserves the generation's WAL name.

Durability: every append flushes, and fsyncs when the log was opened with
``fsync=True`` (the default for durable services; tests and benchmarks may
trade the fsync for speed — the prefix-recovery contract is unchanged).

The port's copy of ``repro.persist.wal``: the record layout is the
reference's byte for byte, so each package replays the other's segments.
Appends count in ``METRICS`` (``wal.append_records``, ``wal.append_bytes``,
``wal.append_us``) and record ``wal.append`` / ``wal.fsync`` spans in
``TRACE``.
"""
from __future__ import annotations

import logging
import os
import pathlib
import struct
import time
import zlib

import numpy as np

from ..obs.metrics import METRICS
from ..obs.trace import TRACE
from ..resilience.faults import POINT_WAL_APPEND, POINT_WAL_FSYNC, fire
from .manifest import fsync_dir

log = logging.getLogger("repro_torch.persist")

MAGIC = b"PLEXWAL1"
OP_INSERT = 1
OP_DELETE = 2
OP_CHECKPOINT = 3                  # state reset marker (rotation seam)
_OPS = (OP_INSERT, OP_DELETE)      # appendable mutation opcodes
_ALL_OPS = (OP_INSERT, OP_DELETE, OP_CHECKPOINT)
_REC = struct.Struct("<IIB")       # crc32, payload nbytes, opcode


def _encode_record(op: int, keys) -> bytes:
    """THE record framing (crc over opcode byte + payload, then the fixed
    header, then raw little-endian u64 keys) — single encoder shared by
    ``append`` and ``rotate`` so the two write paths can never drift."""
    if op not in _ALL_OPS:
        raise ValueError(f"unknown WAL opcode {op}")
    payload = np.ascontiguousarray(keys, dtype="<u8").tobytes()
    return _REC.pack(zlib.crc32(bytes([op]) + payload),
                     len(payload), op) + payload


class WriteAheadLog:
    """Append handle over one WAL segment (single-writer, like the delta
    buffer it guards — the service serialises appends under its lock)."""

    def __init__(self, path: pathlib.Path, fh, *, fsync: bool = True):
        self.path = path
        self._fh = fh
        self.fsync = bool(fsync)

    @classmethod
    def create(cls, path: str | pathlib.Path, *,
               fsync: bool = True) -> "WriteAheadLog":
        """Start a fresh (empty) segment, truncating any existing file."""
        path = pathlib.Path(path)
        fh = open(path, "wb")
        fh.write(MAGIC)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
        return cls(path, fh, fsync=fsync)

    @classmethod
    def open(cls, path: str | pathlib.Path, *, fsync: bool = True,
             truncate_at: int | None = None) -> "WriteAheadLog":
        """Open an existing segment for appending. ``truncate_at`` (from
        ``replay``'s valid-prefix length) drops a torn tail first, so new
        records are never appended after garbage."""
        path = pathlib.Path(path)
        fh = open(path, "r+b")
        if truncate_at is not None and truncate_at < path.stat().st_size:
            fh.truncate(max(truncate_at, len(MAGIC)))
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        fh.seek(0, os.SEEK_END)
        return cls(path, fh, fsync=fsync)

    def append(self, op: int, keys: np.ndarray) -> int:
        """Append one checksummed record; returns the record's byte size.
        The write is flushed (and fsync'd when enabled) before returning —
        the caller may only mutate the in-memory delta afterwards."""
        if op not in _OPS:
            raise ValueError(f"unknown WAL opcode {op}")
        # injection points for the chaos matrix: a trip anywhere in here
        # surfaces to the caller BEFORE the delta buffer mutates, so the
        # WAL-before-mutation invariant (durable >= served) always holds
        fire(POINT_WAL_APPEND)
        obs = METRICS.enabled or TRACE.enabled
        t0 = time.perf_counter() if obs else 0.0
        rec = _encode_record(op, keys)
        self._fh.write(rec)
        self._fh.flush()
        if self.fsync:
            fire(POINT_WAL_FSYNC)
            tf = time.perf_counter() if obs else 0.0
            os.fsync(self._fh.fileno())
            if obs:
                TRACE.record("wal.fsync", time.perf_counter() - tf)
        if obs:
            dur = time.perf_counter() - t0
            TRACE.record("wal.append", dur, bytes=len(rec), op=op)
            METRICS.counter("wal.append_records").inc()
            METRICS.counter("wal.append_bytes").inc(len(rec))
            METRICS.histogram("wal.append_us").observe(dur * 1e6)
        return len(rec)

    @property
    def size_bytes(self) -> int:
        return self._fh.tell()

    @property
    def closed(self) -> bool:
        return self._fh is None

    def rotate(self, ops) -> "WriteAheadLog":
        """Compact this segment in place and return the fresh handle.

        ``ops`` is an iterable of ``(opcode, keys)`` replay-equivalent to
        the live delta (``DeltaBuffer.pending_ops`` order: deletes before
        inserts). The new segment — magic, one ``OP_CHECKPOINT`` record,
        then the seed ops — is fully written and fsync'd to a temp file
        *before* the atomic rename, so a crash at any point leaves either
        the complete old history or the complete compacted state, never a
        mix. This handle is closed; append to the returned one.
        """
        tmp = self.path.with_suffix(self.path.suffix + ".rot")
        fh = open(tmp, "wb")
        fh.write(MAGIC)
        fh.write(_encode_record(OP_CHECKPOINT, np.zeros(0, dtype=np.uint64)))
        for op, keys in ops:
            if op not in _OPS:
                raise ValueError(f"unknown WAL opcode {op}")
            fh.write(_encode_record(op, keys))
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)         # the rotation commit point
        if self.fsync:
            fsync_dir(self.path.parent)
        old_bytes = self.size_bytes
        self.close()
        log.info("rotate(%s): compacted %d -> %d bytes", self.path,
                 old_bytes, fh.tell())
        return WriteAheadLog(self.path, fh, fsync=self.fsync)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @staticmethod
    def replay(path: str | pathlib.Path
               ) -> tuple[list[tuple[int, np.ndarray]], int, int]:
        """Decode the longest valid record prefix.

        Returns ``(records, valid_bytes, discarded_bytes)`` where
        ``records`` is ``[(opcode, uint64 key array), ...]`` in append
        order and ``valid_bytes`` is the truncation point a re-opened
        segment should use. A missing/too-short/wrong-magic file yields no
        records with everything discarded (the caller decides whether that
        is a fresh start or corruption)."""
        path = pathlib.Path(path)
        try:
            data = path.read_bytes()
        except FileNotFoundError:
            return [], 0, 0
        if data[:len(MAGIC)] != MAGIC:
            return [], 0, len(data)
        records: list[tuple[int, np.ndarray]] = []
        pos = len(MAGIC)
        while pos + _REC.size <= len(data):
            crc, nbytes, op = _REC.unpack_from(data, pos)
            end = pos + _REC.size + nbytes
            if op not in _ALL_OPS or nbytes % 8 or end > len(data):
                break
            payload = data[pos + _REC.size:end]
            if zlib.crc32(bytes([op]) + payload) != crc:
                break
            if op == OP_CHECKPOINT:
                # everything before the checkpoint is compacted history;
                # the records that follow rebuild the state from scratch
                records = []
            else:
                records.append((op, np.frombuffer(payload, dtype="<u8")
                                .astype(np.uint64)))
            pos = end
        return records, pos, len(data) - pos
