"""PLEX-indexed single-file tensor store (the port of
``repro.checkpoint.store``).

Layout:  [8B magic | 8B n | 8B metadata bytes | n x 32B records (sorted by
u64 name-hash) | metadata | tensor payloads]. A PLEX (``core.build_plex``,
eps 8) over the sorted name-hash column serves point reads: restoring one
tensor probes O(eps) records instead of scanning the table. Hashes are
unique by construction; a collision is refused at save time.

A leaf's name is its path: dict keys sorted and joined by ``/``, list and
tuple items as ``[i]`` (an ``AdamWState`` is a tuple: ``opt[0]`` is the
step, ``opt[1]/...`` the first moments). Tensors are stored as raw
little-endian buffers of their numpy dtype, with a JSON record of name,
dtype and shape, so the same tree writes the same bytes as the reference's
``save_pytree``, and either package reads the other's files. Writes are
atomic (a ``.tmp`` file, then a rename). Leaves may be numpy arrays,
numpy scalars or torch tensors (copied to the host); restores give numpy
arrays, which the caller places on its device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import struct

import numpy as np

from ..core import PLEX, build_plex

MAGIC = b"PLEXCKP1"
_REC = struct.Struct("<QQQQ")     # name_hash, offset, nbytes, meta_offset
INDEX_EPS = 8


def _hash_name(name: str) -> np.uint64:
    return np.uint64(int.from_bytes(
        hashlib.blake2b(name.encode(), digest_size=8).digest(), "little"))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array (a torch tensor is copied to the host)."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str | pathlib.Path, tree, *, step: int | None = None
                ) -> None:
    """Write ``tree`` to ``path`` (``step`` is accepted, as the
    reference's, and not stored)."""
    path = pathlib.Path(path)
    leaves = [(name, to_host(leaf)) for name, leaf in _flatten(tree)]
    hashes = [_hash_name(n) for n, _ in leaves]
    if len(set(int(h) for h in hashes)) != len(hashes):
        raise ValueError("name-hash collision")  # pragma: no cover
    order = np.argsort(np.asarray(hashes, dtype=np.uint64), kind="stable")

    recs = []
    payload_off = 0
    meta_blob = b""
    for i in order:
        name, arr = leaves[i]
        meta = json.dumps({"name": name, "dtype": str(arr.dtype),
                           "shape": list(arr.shape)}).encode()
        recs.append((int(hashes[i]), payload_off, arr.nbytes,
                     len(meta_blob)))
        meta_blob += struct.pack("<I", len(meta)) + meta
        payload_off += arr.nbytes

    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<QQ", len(recs), len(meta_blob)))
        for r in recs:
            f.write(_REC.pack(*r))
        f.write(meta_blob)
        for i in order:
            f.write(np.ascontiguousarray(leaves[i][1]).tobytes())
    os.replace(tmp, path)                 # atomic publish


@dataclasses.dataclass
class StoreReader:
    path: pathlib.Path
    hashes: np.ndarray          # sorted u64
    offsets: np.ndarray
    sizes: np.ndarray
    meta_offsets: np.ndarray
    payload_base: int
    plex: PLEX
    meta_blob: bytes

    @classmethod
    def open(cls, path: str | pathlib.Path) -> "StoreReader":
        path = pathlib.Path(path)
        with open(path, "rb") as f:
            if f.read(8) != MAGIC:
                raise ValueError(f"{path} is not a PLEX checkpoint")
            n, meta_len = struct.unpack("<QQ", f.read(16))
            raw = np.frombuffer(f.read(n * _REC.size), dtype=np.uint64
                                ).reshape(n, 4)
            meta_blob = f.read(meta_len)
            payload_base = f.tell()
        hashes = raw[:, 0].copy()
        return cls(path=path, hashes=hashes, offsets=raw[:, 1].copy(),
                   sizes=raw[:, 2].copy(), meta_offsets=raw[:, 3].copy(),
                   payload_base=payload_base,
                   plex=build_plex(hashes, eps=INDEX_EPS),
                   meta_blob=meta_blob)

    def _slot(self, name: str) -> int:
        h = _hash_name(name)
        i = int(self.plex.lookup(np.asarray([h]))[0])
        if i >= self.hashes.size or self.hashes[i] != h:
            raise KeyError(name)
        return i

    def meta(self, slot: int) -> dict:
        off = int(self.meta_offsets[slot])
        (ln,) = struct.unpack_from("<I", self.meta_blob, off)
        return json.loads(self.meta_blob[off + 4: off + 4 + ln])

    def names(self) -> list[str]:
        return [self.meta(i)["name"] for i in range(self.hashes.size)]

    def read(self, name: str) -> np.ndarray:
        """One tensor by name, through the PLEX over the name hashes."""
        slot = self._slot(name)
        meta = self.meta(slot)
        with open(self.path, "rb") as f:
            f.seek(self.payload_base + int(self.offsets[slot]))
            buf = f.read(int(self.sizes[slot]))
        return np.frombuffer(buf, dtype=np.dtype(meta["dtype"])
                             ).reshape(meta["shape"]).copy()


def read_tensor(path, name: str) -> np.ndarray:
    return StoreReader.open(path).read(name)


def load_pytree(path, like) -> object:
    """Restore into the structure of ``like`` (its names; its leaves are
    not read): numpy leaves, dicts, lists, tuples and named tuples as in
    ``like``."""
    reader = StoreReader.open(path)

    def fill(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: fill(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [fill(v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
            return type(tree)(vals) if not hasattr(tree, "_fields") else \
                type(tree)(*vals)
        return reader.read(prefix)
    return fill(like)
