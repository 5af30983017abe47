"""Durability layer of the port: versioned snapshots + delta WAL +
generation manifest (the port's copy of ``repro.persist``; the bytes of all
three are the reference's, so each package opens the other's directories).

* ``format``   — the on-disk snapshot: raw little-endian planes behind a
  checksummed header, memmapped on open, with the stacked layout's statics
  persisted so ``open`` re-derives nothing the file holds.
* ``wal``      — the append-only, checksummed delta write-ahead log that
  ``PlexService.insert()/delete()`` append to before mutating the buffer.
* ``manifest`` — the atomic generation pointer (write-temp + fsync +
  rename): the single commit point.

Recovery contract: ``PlexService.open(dir)`` follows the manifest to the
last committed generation, replays the longest valid WAL prefix, and logs
(then ignores) everything else — uncommitted generation directories, stray
WAL segments and torn WAL tails.
"""
from .format import (SNAPSHOT_FILE, CorruptSnapshotError, load_snapshot,
                     save_snapshot, validate_snapshot)
from .manifest import (MANIFEST_NAME, CorruptManifestError, Manifest,
                       gen_name, read_manifest, wal_name, write_manifest)
from .wal import OP_CHECKPOINT, OP_DELETE, OP_INSERT, WriteAheadLog

__all__ = [
    "CorruptManifestError", "CorruptSnapshotError", "MANIFEST_NAME",
    "Manifest", "OP_CHECKPOINT", "OP_DELETE", "OP_INSERT", "SNAPSHOT_FILE",
    "WriteAheadLog", "gen_name", "load_snapshot", "read_manifest",
    "save_snapshot", "validate_snapshot", "wal_name", "write_manifest",
]
