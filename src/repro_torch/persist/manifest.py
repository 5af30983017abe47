"""Atomic generation manifest — the durability commit point.

``MANIFEST.json`` binds the triple (snapshot generation, WAL segment,
schema version). It is the *only* mutable name in a durable directory;
everything else (generation dirs, WAL segments) is written once under a
generation-numbered name and then either committed by a manifest rename or
abandoned. Publication is write-temp + fsync + atomic rename + directory
fsync, so a crash at any point leaves either the old or the new manifest —
never a torn one — and therefore the previous generation live:

    root/
      MANIFEST.json          -> {generation: 7, snapshot: "gen-000007",
                                 wal: "wal-000007.log", schema: 1}
      gen-000007/snapshot.plex
      wal-000007.log
      gen-000008/ ...        (uncommitted until the manifest names it)

The payload carries its own CRC so a storage-level partial write (possible
on filesystems without atomic rename semantics) is detected as
``CorruptManifestError`` rather than silently followed.

The port's copy of ``repro.persist.manifest``: the bytes are the
reference's, so each package follows the other's manifests. A failed
commit and a corrupt manifest write ``manifest.commit_failed`` and
``manifest.corrupt`` incident bundles when a manager is installed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import zlib

from ..obs.incident import report as _report_incident
from ..resilience.faults import POINT_MANIFEST_COMMIT, fire

MANIFEST_NAME = "MANIFEST.json"
SCHEMA_VERSION = 1


class CorruptManifestError(Exception):
    """The manifest exists but cannot be trusted (torn write, CRC or
    schema mismatch)."""


def gen_name(generation: int) -> str:
    """Directory name of one snapshot generation."""
    return f"gen-{generation:06d}"


def wal_name(generation: int) -> str:
    """WAL segment name bound to one snapshot generation."""
    return f"wal-{generation:06d}.log"


@dataclasses.dataclass(frozen=True)
class Manifest:
    generation: int
    snapshot: str             # generation dir name, relative to root
    wal: str                  # WAL segment name, relative to root
    schema: int = SCHEMA_VERSION

    @classmethod
    def for_generation(cls, generation: int) -> "Manifest":
        return cls(generation=int(generation),
                   snapshot=gen_name(generation), wal=wal_name(generation))


def _payload_bytes(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True).encode()


def fsync_dir(path: str | pathlib.Path) -> None:
    """fsync a directory so a rename inside it is durable (best-effort:
    some filesystems refuse directory fds). Shared by every rename-commit
    in the persist package."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def write_manifest(root: str | pathlib.Path, man: Manifest, *,
                   fsync: bool = True) -> pathlib.Path:
    """Atomically publish ``man`` as ``root/MANIFEST.json``."""
    root = pathlib.Path(root)
    payload = dataclasses.asdict(man)
    blob = json.dumps({"manifest": payload,
                       "crc32": zlib.crc32(_payload_bytes(payload))},
                      indent=1).encode()
    tmp = root / (MANIFEST_NAME + ".tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    path = root / MANIFEST_NAME
    try:
        # chaos point fires before the rename: a trip means nothing
        # committed — the previous manifest (and therefore generation)
        # stays live
        fire(POINT_MANIFEST_COMMIT)
        os.replace(tmp, path)          # the commit
    except BaseException as e:
        # a caught failure additionally sweeps the orphan temp, so an
        # aborted publish leaves the directory byte-identical (a crash
        # still may leave the temp; the next publish overwrites it)
        try:
            tmp.unlink()
        except OSError:  # pragma: no cover
            pass
        _report_incident("manifest.commit_failed", repr(e),
                         root=str(root), generation=man.generation)
        raise
    if fsync:
        fsync_dir(root)
    return path


def read_manifest(root: str | pathlib.Path) -> Manifest | None:
    """The committed manifest, or ``None`` when the directory has never
    been published to. Raises ``CorruptManifestError`` on a torn or
    mismatched file."""
    path = pathlib.Path(root) / MANIFEST_NAME
    try:
        raw = path.read_bytes()
    except FileNotFoundError:
        return None
    try:
        doc = json.loads(raw)
        payload = doc["manifest"]
        crc = int(doc["crc32"])
    except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
        _report_incident("manifest.corrupt", f"{path}: unreadable ({e})",
                         root=str(root))
        raise CorruptManifestError(f"{path}: unreadable ({e})") from e
    if zlib.crc32(_payload_bytes(payload)) != crc:
        _report_incident("manifest.corrupt", f"{path}: checksum mismatch",
                         root=str(root))
        raise CorruptManifestError(f"{path}: checksum mismatch")
    if payload.get("schema") != SCHEMA_VERSION:
        _report_incident("manifest.corrupt",
                         f"{path}: schema {payload.get('schema')}",
                         root=str(root))
        raise CorruptManifestError(
            f"{path}: schema {payload.get('schema')} != {SCHEMA_VERSION}")
    return Manifest(generation=int(payload["generation"]),
                    snapshot=str(payload["snapshot"]),
                    wal=str(payload["wal"]), schema=SCHEMA_VERSION)
