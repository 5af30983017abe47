"""Checkpoint manager: asynchronous save, retention, resume-latest (the
port of ``repro.checkpoint.manager``).

``maybe_save(step, state)`` saves every ``every`` steps: the state is
copied to the host on the caller's thread (tensors leave the card there,
so the training loop may overwrite them at once), then a background
thread writes ``step_XXXXXXXX.ckpt`` (atomic rename in ``store``), updates
the ``LATEST`` marker only after the file is in place, and keeps the
newest ``keep`` checkpoints. ``restore_latest`` returns (step, state) as
numpy arrays. ``restore_sharded`` is the reference's elastic restore: it
takes the *destination* layout, a tree of ``parallel.NamedSharding`` over
any mesh, and gives this rank its block of every leaf
(``parallel.shard_tree``). A file holds each leaf whole, whatever mesh
saved it (the state is copied to the host whole, as the reference's
``device_get`` copies it), so any file restores onto any mesh shape. A
crash mid-save leaves a ``.tmp`` file that nothing reads, and the previous
checkpoint intact.
"""
from __future__ import annotations

import pathlib
import re
import threading
from typing import Any

import torch

from .store import load_pytree, save_pytree, to_host


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_host_tree(v) for v in tree]
        return (type(tree)(*vals) if hasattr(tree, "_fields")
                else type(tree)(vals))
    return to_host(tree) if isinstance(tree, torch.Tensor) else tree


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3,
                 every: int = 100):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.every = every
        self._thread: threading.Thread | None = None

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}.ckpt"

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.dir.glob("step_*.ckpt")
                      if (m := re.match(r"step_(\d+)\.ckpt", p.name)))

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, state: Any, *, blocking: bool = True) -> None:
        host_state = _host_tree(state)

        def work():
            save_pytree(self._path(step), host_state, step=step)
            (self.dir / "LATEST").write_text(str(step))
            self._gc()

        if blocking:
            work()
        else:
            self.wait()
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def maybe_save(self, step: int, state: Any, *, blocking: bool = False
                   ) -> bool:
        """Save at every ``every``-th step; ``state`` may be a function of
        no arguments giving the state, called only when a save is due."""
        if step % self.every:
            return False
        self.save(step, state() if callable(state) else state,
                  blocking=blocking)
        return True

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            self._path(s).unlink(missing_ok=True)

    def restore_latest(self, like: Any) -> tuple[int, Any] | None:
        """(step, state as numpy arrays in ``like``'s structure) of the
        newest checkpoint (``LATEST``'s when it names one on disk), or
        None."""
        self.wait()
        marker = self.dir / "LATEST"
        steps = self.steps()
        if not steps:
            return None
        step = int(marker.read_text()) if marker.exists() else steps[-1]
        if step not in steps:
            step = steps[-1]
        return step, load_pytree(self._path(step), like)

    def restore_sharded(self, like: Any, shardings: Any, *, device=None
                        ) -> tuple[int, Any] | None:
        """Elastic restore: ``restore_latest`` with each leaf cut to the
        block that its place in ``shardings`` (a tree shaped like ``like``)
        gives this rank, on ``device`` (default: the meshes' device)."""
        from ..parallel.sharding import shard_tree
        got = self.restore_latest(like)
        if got is None:
            return None
        step, host = got
        return step, shard_tree(host, shardings, device=device)
