"""The production layout's collectives over the groups of a ``DeviceMesh``
(what GSPMD inserts into the reference's program, written out).

* FSDP's gather (``Gather``): a weight whose ``embed`` dim the rules put on
  the batch dims (``fsdp_rules``) is all-gathered along that dim at its
  use, cast to the compute dtype first; its gradient is reduce-scattered
  back onto the blocks in the backward pass.
* Megatron's pair over ``model``: ``copy_to_model`` (forward identity,
  backward all-reduce) before a column-parallel product, and
  ``reduce_from_model`` (forward all-reduce, backward identity) after a
  row-parallel one. Every ``model`` rank then holds the whole activation
  and computes the same loss, so a weight replicated over ``model`` gets
  its whole gradient on every ``model`` rank.
* ``slice_replicated``: a rank's block of a tensor every ``model`` rank
  computed whole (the kv heads that its query heads read, where the kv
  heads are not split); the backward all-reduces the zero-padded
  gradient, so the whole gradient is back on every rank.
* ``gather_model``: the blocks of a tensor split over ``model`` gathered
  whole on every rank (backward: the rank's block of the gradient, which
  every rank holds whole); ``reduce_scatter_model``: a partial sum over
  ``model`` of which each rank keeps its block (backward: the gradient's
  blocks gathered), for a product whose contracted dim and whose output
  dim are both split (the RG-LRU's gates).
* ``batch_mean``: the mean over the batch ranks of a value each computed
  from its own tokens (the MoE's expert loads), once-counted in the
  gradient; ``batch_exclusive_sum``: the sum of a value over the batch
  ranks before this one, in the global batch's row order (the gspmd MoE's
  offsets of each expert's pairs).

Whether a dim is split is read from its spec (``logical_spec`` under the
active rules, ``Layout.weight``), never assumed: the rules drop a mesh dim
that does not divide a tensor dim, so minitron's 24 heads stay whole on a
16-way ``model`` while command-r's 96 split. ``Layout.weight`` also checks
that the block it is given is the one the rules give this rank.

Without a ``DeviceMesh`` ``layout()`` gives ``WHOLE``, the layout of one
process holding every weight whole: ``weight`` only casts, no dim is split
and no collective runs, so the layers have one body for both cases.

``LOG`` counts every collective the layout runs, by kind, with the bytes
of its result on this rank: ``LOG.as_dict()`` has the shape of the
reference's ``parse_collectives`` (``{kind: {"count", "bytes"},
"total_bytes"}``); ``LOG.tags`` counts the collectives a caller tagged
(the expert-parallel MoE's all-reduce). A one-rank group still runs its
collective (a copy).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from .sharding import (MeshShape, NamedSharding, current, logical_spec,
                       mesh_dims)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
BATCH_DIMS = ("pod", "data")


class CollectiveLog:
    """Count and result bytes of each kind of collective on this rank."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts = {k: [0, 0] for k in KINDS}
        self.tags: dict[str, int] = {}

    def record(self, kind: str, t: torch.Tensor, tag: str | None = None
               ) -> None:
        c = self.counts[kind]
        c[0] += 1
        c[1] += t.numel() * t.element_size()
        if tag is not None:
            self.tags[tag] = self.tags.get(tag, 0) + 1

    def as_dict(self) -> dict:
        out: dict = {k: {"count": c, "bytes": b}
                     for k, (c, b) in self.counts.items()}
        out["total_bytes"] = sum(b for _, b in self.counts.values())
        return out


LOG = CollectiveLog()


def _dist():
    import torch.distributed as dist
    return dist


def _collective(dist, name: str, old: str):
    """``dist.<name>``, or ``dist.<old>`` where torch does not have it yet:
    torch 2.13 names the one-tensor all-gather and reduce-scatter
    ``*_single`` and warns on the old names, which earlier versions alone
    have."""
    return getattr(dist, name, None) or getattr(dist, old)


def all_reduce_(t: torch.Tensor, group, op: str = "sum",
                tag: str | None = None) -> torch.Tensor:
    """``t`` summed (or maxed) over ``group``, in place; ``t`` must be
    contiguous. ``tag`` names it in ``LOG.tags``."""
    dist = _dist()
    LOG.record("all-reduce", t, tag)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim``, in rank
    order: a new contiguous tensor."""
    dist = _dist()
    n = dist.get_world_size(group)
    dim %= t.dim()
    src = t.contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    LOG.record("all-gather", out)
    _collective(dist, "all_gather_single", "all_gather_into_tensor")(
        out, src, group=group)
    if dim == 0:
        return out
    shape = list(src.shape)
    shape[dim] *= n
    return out.view(n, *src.shape).movedim(0, dim).reshape(shape)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` summed over ``group``, this rank's block of ``dim`` kept."""
    dist = _dist()
    n = dist.get_world_size(group)
    dim %= t.dim()
    shape = list(t.shape)
    shape[dim] //= n
    src = t.reshape(*t.shape[:dim], n, *shape[dim:]).movedim(dim, 0)
    src = src.reshape(n * shape[0], *shape[1:])
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    LOG.record("reduce-scatter", out)
    _collective(dist, "reduce_scatter_single", "reduce_scatter_tensor")(
        out, src, group=group)
    return out


class Gather(torch.autograd.Function):
    """FSDP's gather of a block along ``dim`` over ``groups`` (the mesh
    dims that split it, slowest first); backward: the gradient
    reduce-scattered back onto the block."""

    @staticmethod
    def forward(ctx, t, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        for g in reversed(groups):          # the fastest dim first
            t = all_gather(t, g, dim)
        return t

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:
            g = reduce_scatter(g, grp, ctx.dim)
        return g, None, None


class CopyToModel(torch.autograd.Function):
    """Forward: ``t`` as it is; backward: the gradient summed over
    ``group`` (each rank's block of a split product gives part of it)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class ReduceFromModel(torch.autograd.Function):
    """Forward: the sum over ``group`` (in place where ``t`` is a
    contiguous partial sum); backward: the gradient as it is (every rank's
    loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group, tag=None):
        if t.is_contiguous():
            ctx.mark_dirty(t)
            return all_reduce_(t, group, tag=tag)
        return all_reduce_(t.contiguous(), group, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class SliceReplicated(torch.autograd.Function):
    """Forward: ``t.narrow(dim, start, length)`` of a tensor every rank of
    ``group`` computed whole; backward: the zero-padded gradient summed
    over ``group``, the whole gradient on every rank."""

    @staticmethod
    def forward(ctx, t, dim, start, length, group):
        ctx.shape, ctx.dim, ctx.start, ctx.group = t.shape, dim, start, group
        return t.narrow(dim, start, length)

    @staticmethod
    def backward(ctx, g):
        full = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        full.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return all_reduce_(full, ctx.group), None, None, None, None


class GatherFromModel(torch.autograd.Function):
    """Forward: the blocks of ``group``'s ranks concatenated along ``dim``;
    backward: this rank's block of the gradient (every rank computes the
    same loss from the whole tensor, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, t, dim, group, start, length):
        ctx.dim, ctx.start, ctx.length = dim, start, length
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.start, ctx.length).contiguous(), None,
                None, None, None)


class ReduceScatterToModel(torch.autograd.Function):
    """Forward: ``t`` summed over ``group``, this rank's block of ``dim``
    kept; backward: the blocks of the gradient gathered (each rank's
    partial sum reaches every rank's block)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class BatchMean(torch.autograd.Function):
    """Forward: the mean over the batch ranks (``groups``, ``n`` ranks in
    all); backward: the gradient over ``n``, the share of one rank's loss in
    the replicated value's once-counted gradient."""

    @staticmethod
    def forward(ctx, t, groups, n):
        ctx.n = n
        out = t.contiguous().clone()
        for g in groups:
            all_reduce_(out, g)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Layout:
    """The active ``DeviceMesh`` and rules as the layers read them; with
    ``mesh`` None (``WHOLE``) every weight is whole and nothing is split."""

    def __init__(self, mesh, rules: dict):
        self.mesh, self.rules = mesh, rules
        self.dims = mesh_dims(mesh) if mesh is not None else {}
        self.batch = [d for d in BATCH_DIMS if d in self.dims]
        self.n_batch = math.prod(self.dims[d] for d in self.batch)
        self._specs: dict = {}

    # ---- the rules
    def spec(self, axes: Sequence, shape: Sequence[int]) -> tuple:
        if self.mesh is None:
            return ()
        key = (tuple(axes), tuple(shape))
        if key not in self._specs:
            self._specs[key] = logical_spec(axes, shape, self.mesh,
                                            self.rules)
        return self._specs[key]

    def names(self, spec: tuple, i: int) -> tuple[str, ...]:
        return _names(spec[i]) if i < len(spec) else ()

    def on_model(self, spec: tuple, i: int) -> bool:
        """Whether tensor dim ``i`` of ``spec`` is split over ``model``."""
        return "model" in self.names(spec, i)

    def split_dims(self, spec: tuple) -> set[str]:
        """The mesh dims that split some dim of ``spec``."""
        return {m for i in range(len(spec)) for m in self.names(spec, i)}

    def size(self, name: str) -> int:
        return self.dims.get(name, 1)

    def rank(self, name: str) -> int:
        return self.mesh.get_local_rank(name) if name in self.dims else 0

    def group(self, name: str):
        return self.mesh.get_group(name)

    def model_block(self, full: int) -> tuple[int, int]:
        """(start, length) of this rank's block of a dim of ``full`` split
        over ``model``."""
        n = self.size("model")
        return self.rank("model") * (full // n), full // n

    # ---- weights and activations
    def check(self, w: torch.Tensor, axes: Sequence, full: Sequence[int]
              ) -> tuple:
        """The spec of a ``full`` tensor with ``axes``; raises ValueError
        unless ``w`` is the block the rules give this rank."""
        spec = self.spec(axes, full)
        if self.mesh is None:
            return spec
        want = NamedSharding(self.mesh, spec).shard_shape(full)
        if tuple(w.shape) != want:
            raise ValueError(
                f"a weight with axes {tuple(axes)} of {tuple(full)} is "
                f"{tuple(w.shape)} here, but the active rules give this rank "
                f"{want} (spec {spec}): place it with tree_shardings under "
                "the rules passed to set_mesh_rules (LOGICAL_RULES with "
                "fsdp_rules or expert_parallel_rules)")
        return spec

    def weight(self, w: torch.Tensor, axes: Sequence, full: Sequence[int],
               dtype: torch.dtype) -> tuple[torch.Tensor, tuple]:
        """(``w`` cast to ``dtype`` with its ``embed`` dim gathered, its
        spec). ``w`` must be the block of a ``full`` tensor that the rules
        give this rank."""
        if self.mesh is None:
            return w.to(dtype), ()
        spec = self.check(w, axes, full)
        w = w.to(dtype)
        for i, ax in enumerate(axes):
            names = self.names(spec, i)
            if ax == "embed" and names:
                w = Gather.apply(w, i, [self.group(m) for m in names])
        return w, spec

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return x
        return CopyToModel.apply(x, self.group("model"))

    def reduce_from_model(self, x: torch.Tensor, tag: str | None = None
                          ) -> torch.Tensor:
        if self.mesh is None:
            return x
        return ReduceFromModel.apply(x, self.group("model"), tag)

    def slice_replicated(self, x: torch.Tensor, dim: int, start: int,
                         length: int) -> torch.Tensor:
        return SliceReplicated.apply(x, dim, start, length,
                                     self.group("model"))

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The blocks of ``model``'s ranks along ``dim``; the gradient goes
        back to this rank's block."""
        dim %= x.dim()
        length = x.shape[dim]
        return GatherFromModel.apply(x, dim, self.group("model"),
                                     self.rank("model") * length, length)

    def reduce_scatter_model(self, x: torch.Tensor, dim: int
                             ) -> torch.Tensor:
        """``x`` (a partial sum) summed over ``model``, this rank's block of
        ``dim`` kept."""
        return ReduceScatterToModel.apply(x, dim % x.dim(),
                                          self.group("model"))

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        return BatchMean.apply(t, [self.group(d) for d in self.batch],
                               self.n_batch)

    def batch_exclusive_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the batch ranks before this one, in the
        global batch's row order (``pod`` the slowest): one all-gather over
        each batch dim (no gradient)."""
        g, before = t[None], 0
        for d in reversed(self.batch):      # the fastest dim first
            g = all_gather(g, self.group(d), 0)
        for d in self.batch:
            before = before * self.size(d) + self.rank(d)
        return g[:before].sum(dim=0)

    def batch_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch ranks, in place (no gradient)."""
        for d in self.batch:
            all_reduce_(t, self.group(d))
        return t

    def reduce_grad_(self, g: torch.Tensor, spec: tuple) -> torch.Tensor:
        """A leaf's gradient summed over the batch dims that do not split
        it (those that do, FSDP's, were reduce-scattered by ``Gather``)."""
        split = self.split_dims(spec)
        for d in self.batch:
            if d not in split:
                all_reduce_(g, self.group(d))
        return g


WHOLE = Layout(None, {})
_cache: list = [None, None, WHOLE]       # (mesh, rules, Layout)


def layout() -> Layout:
    """The ``Layout`` of the mesh and rules ``set_mesh_rules`` installed,
    or ``WHOLE``: no mesh, or a shape-only ``MeshShape`` (no process group;
    the layers then run on whole weights). One ``Layout`` is kept for a
    mesh and rules of the same contents, so what it and ``Model`` derive
    from them is built once."""
    mesh, rules = current()
    if mesh is None or isinstance(mesh, MeshShape):
        return WHOLE
    if _cache[0] is not mesh or _cache[1] != rules:
        _cache[:] = [mesh, dict(rules), Layout(mesh, rules)]
    return _cache[2]
