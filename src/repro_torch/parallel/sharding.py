"""Logical-axis sharding rules (DP / FSDP / TP / EP), the port of
``repro.parallel.sharding``.

Every parameter and activation dimension carries a *logical* axis name; a
rules table maps logical names to mesh dim names. ``logical_spec`` resolves
them as the reference does: a mesh dim is dropped when the tensor dim is
not divisible by it (hubert's vocab 504 or qwen2-vl's 12 heads on a 16-way
``model`` dim stay replicated) and when the mesh has no such dim, a mesh
dim is used at most once per tensor, and trailing ``None`` entries are
trimmed. A spec is a tuple with one entry a tensor dim (to its last sharded
one): ``None``, one mesh dim name, or a tuple of names, the entries of the
reference's ``PartitionSpec``.

The rules read only the mesh's dim names and sizes, so a mesh is either a
``torch.distributed.device_mesh.DeviceMesh`` or a ``MeshShape`` (names and
sizes, no process group): the full-size placements are computable on one
host, as the reference computes them over an ``AbstractMesh``.

The reference hands a spec to GSPMD; the port places tensors itself.
``NamedSharding`` pairs a mesh and a spec: ``local(x)`` is the block of
``x`` that a rank holds, ``placements()`` the same layout as DTensor
placements. Where several mesh dims shard one tensor dim (FSDP's
``("pod", "data")`` on multi-pod meshes), the dim is split into the product
of their sizes, the first named dim the slowest, as JAX splits it; DTensor
expresses that as one ``Shard(dim)`` on each of those mesh dims, which
splits in mesh dim order, so the names must come in the mesh's order (the
rules list ``"pod"`` before ``"data"``, as the meshes do).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Sequence

import numpy as np
import torch

# logical axis -> tuple of mesh dims (in priority order; "pod" composes with
# "data" for the batch/FSDP dimension on multi-pod meshes)
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": (),                  # SP rule: set to ("model",) for long ctx
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_expert": ("model",),
    "act_kv_seq": ("model",),       # context-parallel KV caches (decode)
    # parameters
    "embed": (),                    # FSDP rule: becomes ("pod", "data")
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "expert": ("model",),
    "expert_mlp": (),
    "kv_lora": (),
    "q_lora": (),
    "rnn": ("model",),
    "conv": (),
    "norm": (),
    "lora": (),
}

Spec = tuple   # per tensor dim: None, a mesh dim name, or a tuple of names


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes, with no process group behind it."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError("one size per mesh dim name")


def mesh_dims(mesh) -> dict[str, int]:
    """{dim name: size} of a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_coordinate(mesh) -> dict[str, int]:
    """{dim name: index} of this rank in ``mesh``. A ``MeshShape`` names no
    rank, so only a one-rank shape has a coordinate (all zeros)."""
    if isinstance(mesh, MeshShape):
        if math.prod(mesh.sizes) != 1:
            raise ValueError(f"{mesh} has no rank of this process; pass "
                             "coords")
        return dict.fromkeys(mesh.axis_names, 0)
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


_state = threading.local()


def set_mesh_rules(mesh, overrides: dict[str, tuple[str, ...]] | None = None):
    """Install the active mesh and rule overrides (a context manager)."""
    rules = dict(LOGICAL_RULES)
    if overrides:
        rules.update(overrides)

    @contextlib.contextmanager
    def ctx():
        prev = getattr(_state, "cfg", None)
        _state.cfg = (mesh, rules)
        try:
            yield
        finally:
            _state.cfg = prev
    return ctx()


def bound(fn):
    """``fn`` run under the mesh and rules active now, on whatever thread
    calls it. The active mesh is thread-local, and on the card the autograd
    engine runs the backward pass, remat's recomputed forward included, on
    a thread of its own."""
    cfg = getattr(_state, "cfg", None)

    def run(*a, **kw):
        prev = getattr(_state, "cfg", None)
        _state.cfg = cfg
        try:
            return fn(*a, **kw)
        finally:
            _state.cfg = prev
    return run


def fsdp_rules(multi_pod: bool) -> dict[str, tuple[str, ...]]:
    """ZeRO-3-style: shard every weight's embed dim over the batch axes."""
    return {"embed": ("pod", "data") if multi_pod else ("data",)}


def expert_parallel_rules() -> dict[str, tuple[str, ...]]:
    """Overrides that leave only ``expert`` on ``model``: heads, kv_heads,
    mlp, vocab and rnn, which ``LOGICAL_RULES`` put on ``model``, stay
    whole, and the layout (``parallel.collectives``) runs no tensor
    parallelism, only the expert-parallel MoE."""
    return {ax: () for ax, mesh in LOGICAL_RULES.items()
            if "model" in mesh and ax != "expert"
            and not ax.startswith("act_")}


def current() -> tuple[Any, dict[str, tuple[str, ...]]]:
    """(the active mesh or None, the active rules)."""
    cfg = getattr(_state, "cfg", None)
    return cfg if cfg is not None else (None, LOGICAL_RULES)


def logical_spec(axes: Sequence[str | None], shape: Sequence[int] | None,
                 mesh=None, rules: dict[str, tuple[str, ...]] | None = None
                 ) -> Spec:
    """The spec of a tensor whose dims carry ``axes``, with the
    divisibility fallback (``src/repro/parallel/sharding.py:86``). A mesh or
    rules left out (or empty rules) come from ``set_mesh_rules``."""
    if mesh is None or not rules:
        cm, cr = current()
        mesh = cm if mesh is None else mesh
        rules = rules or cr
    if mesh is None:
        return ()
    dims = mesh_dims(mesh)
    used: set[str] = set()
    parts: list = []
    for i, ax in enumerate(axes):
        picked = []
        size = shape[i] if shape is not None else None
        cap = 1
        for m in (rules.get(ax, ()) if ax else ()):
            if m not in dims or m in used:
                continue
            n = dims[m]
            if size is not None and size % (cap * n):
                continue
            picked.append(m)
            used.add(m)
            cap *= n
        parts.append(tuple(picked) if len(picked) > 1 else
                     (picked[0] if picked else None))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: which block of a tensor each rank holds."""
    mesh: Any
    spec: Spec

    def _blocks(self, shape: Sequence[int]):
        """Per tensor dim: (its mesh dims, the number of blocks)."""
        dims = mesh_dims(self.mesh)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} for a {len(shape)}-d tensor")
        out = []
        for i, size in enumerate(shape):
            names = _names(self.spec[i]) if i < len(self.spec) else ()
            n = math.prod(dims[m] for m in names)
            if size % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"{n} ways ({self.spec})")
            out.append((names, n))
        return out

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(s // n for s, (_, n) in zip(shape, self._blocks(shape)))

    def index(self, shape: Sequence[int], coords: dict[str, int] | None = None
              ) -> tuple[slice, ...]:
        """The slices of a ``shape`` tensor held at ``coords`` (default:
        this rank's coordinate in the mesh); a dim over several mesh dims
        is split with the first of them the slowest."""
        coords = mesh_coordinate(self.mesh) if coords is None else coords
        dims = mesh_dims(self.mesh)
        out = []
        for size, (names, n) in zip(shape, self._blocks(shape)):
            b = 0
            for m in names:
                b = b * dims[m] + coords[m]
            step = size // n
            out.append(slice(b * step, (b + 1) * step))
        return tuple(out)

    def local(self, x, coords: dict[str, int] | None = None):
        """The block of ``x`` (a tensor or a numpy array) held at
        ``coords`` (default: this rank's), a view."""
        return x[self.index(x.shape, coords)]

    def placements(self) -> tuple:
        """The same layout as DTensor placements, one a mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        order = list(mesh_dims(self.mesh))
        place: list = [Replicate()] * len(order)
        for i, entry in enumerate(self.spec):
            names = _names(entry)
            at = [order.index(m) for m in names]
            if at != sorted(at):
                raise ValueError(f"{names} shard one dim out of the mesh's "
                                 f"order {tuple(order)}: DTensor splits in "
                                 "mesh order")
            for j in at:
                place[j] = Shard(i)
        return tuple(place)


def logical_sharding(axes: Sequence[str | None], shape: Sequence[int], mesh,
                     rules: dict[str, tuple[str, ...]] | None = None
                     ) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(axes, shape, mesh, rules))


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """``x`` as it is. The reference's ``with_sharding_constraint`` is a
    hint to GSPMD; the port places tensors explicitly (``shard_tree``) and
    its collectives are written where they run (``parallel.collectives``,
    called by the layers)."""
    return x


def _map(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``: the path is
    the dict keys joined by ``/`` (``ParamInit.axes_of``'s); list and tuple
    items (a segment's layers, which share their axes) add nothing."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_map(v, fn, prefix) for v in tree]
        return (type(tree)(*vals) if hasattr(tree, "_fields")
                else type(tree)(vals))
    return fn(prefix, tree)


def tree_shardings(params: Any, axes: dict[str, tuple[str | None, ...]],
                   mesh, rules: dict[str, tuple[str, ...]] | None = None
                   ) -> Any:
    """A ``NamedSharding`` tree matching ``params`` (any tree of tensors,
    numpy arrays or meta tensors: the leaves' shapes are all it reads)
    from the recorded logical axes; a leaf with none is replicated."""
    def one(path, leaf):
        ax = axes.get(path)
        if ax is None:
            return NamedSharding(mesh, ())
        return logical_sharding(ax, leaf.shape, mesh, rules)
    return _map(params, one)


def shard_tree(tree: Any, shardings: Any, *, device=None) -> Any:
    """Each leaf's block that ``shardings`` (a tree of the same structure)
    gives this rank, as a new contiguous tensor on
    ``device`` (default: the mesh's device; the card for a ``MeshShape``).
    Leaves may be tensors or numpy arrays."""
    from ..device import resolve_device

    def place(leaf, sh):
        if isinstance(leaf, dict):
            return {k: place(v, sh[k]) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            vals = [place(v, s) for v, s in zip(leaf, sh, strict=True)]
            return (type(leaf)(*vals) if hasattr(leaf, "_fields")
                    else type(leaf)(vals))
        dev = device
        if dev is None:
            dev = (resolve_device(None) if isinstance(sh.mesh, MeshShape)
                   or sh.mesh.device_type == "cuda" else
                   torch.device(sh.mesh.device_type))
        block = sh.local(leaf)
        if not isinstance(block, torch.Tensor):       # numpy: copy, then move
            return torch.from_numpy(np.array(block)).to(dev)
        return torch.empty(block.shape, dtype=block.dtype,
                           device=dev).copy_(block)
    return place(tree, shardings)
