"""Dry run of a cell at production scale: one rank of the production layout
traced on ``torch.device("meta")`` (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each step over 512 forced host devices
and reads XLA's memory and cost analyses. The port runs the same step, the
one the layout runs on a card (``make_train_step`` with AdamW for
``train``, ``make_prefill_step`` for ``prefill``, ``serve_step`` on the
split cache for ``decode``), once, for one rank of a fake process group
of the mesh's world size (``torch.testing._internal.distributed.fake_pg``:
its collectives return at once), with every tensor on ``meta``: shapes
only, nothing allocated or computed. It is a planner: it runs on the CPU by
design, as the reference's runs on forced host devices, and it is the only
module that starts the fake group. The rank's parameters and AdamW state
are its blocks under the production rules (``tree_shardings``, FSDP's
``embed`` split where ``cfg.fsdp``); the inputs are ``launch.specs``'s.

Three counts ride on the step (``StepCounter``):

* ``flops``: the products' FLOPs, K5 by its tile formula
  (``kernels.flash_attention.tile_flops``);
* ``bytes``: what every op reads and writes, unfused (no view counts), the
  counterpart of the reference's HLO "bytes accessed" upper band;
* ``memory.peak_bytes``: the most bytes alive at once, arguments included,
  each tensor storage counted from its creation until it is freed.

There is no ``hlo_extrapolated`` and no probe: XLA counts a while-loop body
once, so the reference compiles unrolled one- and two-group variants and
extrapolates. The port runs its layers in a Python loop and counts every
one. Every family of the registry traces: a record holds the step's counts
and, under ``state``, the bytes the rank holds (``state_bytes``).

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..configs import SHAPES, get_config, shape_supported
from ..configs.base import ArchConfig, ShapeConfig
from ..configs.registry import ARCH_IDS
from ..models.init import torch_dtype
from ..models.lm import Model
from ..models.steps import (make_prefill_step, make_serve_step,
                            make_train_step)
from ..optim import AdamWState
from ..optim.adamw import leaves
from ..parallel.collectives import LOG
from ..parallel.sharding import (LOGICAL_RULES, MeshShape, fsdp_rules,
                                 mesh_dims, set_mesh_rules, tree_shardings)
from .analytic import analytic_flops
from .mesh import production_mesh_shape
from .specs import batch_specs, decode_specs, local

# the records' directory (listed in .gitignore; never the reference's
# results/dryrun/)
RESULTS = pathlib.Path(__file__).resolve().parents[3] / "runs" / "dryrun"

# device memory of one NVIDIA H100 80GB HBM3, as torch.cuda.
# get_device_properties(0).total_memory reads it on that card (chip_smoke.py's
# lm_layout prints it as hbm_bytes)
H100_80GB_HBM3_BYTES = 85_017_493_504

# ops that allocate without writing: no bytes moved
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _flat(items) -> list:
    """The tensors among an op's arguments (tensors, or lists of them)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """FLOPs, the bytes every op reads and writes, and the live bytes of
    tensor storages, over what runs inside it. The FLOPs are those of the
    formulas ``torch.utils.flop_counter.FlopCounterMode`` counts by (its
    registry: the products, attention, K5's ``tile_flops``). ``track``
    registers tensors made before (the arguments); a storage counts from
    the op that made it until it is freed."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.formulas = flop_registry
        self.live: dict[int, int] = {}
        self.current = self.peak = self.bytes = self.flops = 0

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def track(self, tensors) -> int:
        """Register ``tensors``; -> the bytes newly counted."""
        added = 0
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.current += n
            added += n
            weakref.finalize(st, self._free, key)
        if self.current > self.peak:
            self.peak = self.current
        return added

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        outs = _flat(out if isinstance(out, (list, tuple)) else (out,))
        if func._schema.name not in _NO_TRAFFIC:
            self.bytes += (sum(_nbytes(t) for t in _flat(args))
                           + sum(_nbytes(t) for t in _flat(kwargs.values()))
                           + sum(_nbytes(t) for t in outs))
        formula = self.formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.track(outs)
        return out


@contextlib.contextmanager
def fake_mesh(shape: MeshShape, rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` over a fake process group of its world
    size, seen from ``rank``; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the dry run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape.sizes))
    try:
        yield init_device_mesh("cpu", shape.sizes,
                               mesh_dim_names=shape.axis_names)
    finally:
        dist.destroy_process_group()


def cell_rules(cfg: ArchConfig, mesh) -> tuple[dict, dict]:
    """(the rules, FSDP's overrides where ``cfg.fsdp``) of a cell: the
    reference's ``run_cell`` picks them so."""
    multi = "pod" in mesh_dims(mesh)
    overrides = fsdp_rules(multi) if cfg.fsdp else {}
    return dict(LOGICAL_RULES, **overrides), overrides


def _local_params(cfg: ArchConfig, mesh, rules) -> tuple[dict, dict]:
    """(this rank's parameter blocks on meta, their shardings)."""
    full, axes = Model(cfg).init_with_axes(device="meta")
    sh = tree_shardings(full, axes, mesh, rules)

    def block(t, s):
        if isinstance(t, dict):
            return {k: block(t[k], s[k]) for k in t}
        if isinstance(t, list):
            return [block(a, b) for a, b in zip(t, s)]
        return torch.empty(s.shard_shape(t.shape), dtype=t.dtype,
                           device="meta")
    return block(full, sh), sh


def _opt_state(params) -> AdamWState:
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        if isinstance(t, list):
            return [zeros(v) for v in t]
        return torch.empty_like(t)
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      zeros(params), zeros(params))


def _inputs(cfg: ArchConfig, shape: ShapeConfig, mesh, rules):
    if shape.kind == "decode":
        cache, tokens, pos = decode_specs(cfg, shape, mesh, rules)
        return local(cache), local(tokens), pos
    return local(batch_specs(cfg, shape, mesh, rules,
                             labels=shape.kind == "train"))


def state_bytes(cfg: ArchConfig, shape: ShapeConfig, mesh, rules) -> dict:
    """The bytes a rank holds as the step's arguments, in the reference's
    meaning (XLA's ``argument_size_in_bytes``): its parameter blocks, its
    AdamW state (train: m, v and the int32 step) and its inputs (decode:
    the cache, the tokens and the int32 position). As ``jax.jit`` drops an
    argument that is neither donated nor read, ``read_only`` leaves out what
    the step never reads outside training (where the parameters and state
    are donated): a ``frames`` config's token table, and the position of a
    decode step with no attention (rwkv6). ``held`` is everything the rank
    holds. A mesh may be a shape-only ``MeshShape``; nothing is traced."""
    params, _ = _local_params(cfg, mesh, rules)
    p = sum(_nbytes(t) for t in leaves(params))
    unread = 0
    if cfg.frontend == "frames" and shape.kind != "train":
        unread += _nbytes(params["embed"])
    opt = 2 * p + 4 if shape.kind == "train" else 0
    inp = _inputs(cfg, shape, mesh, rules)
    if shape.kind == "decode":
        cache, tokens, _ = inp
        n_in = sum(_nbytes(t) for t in _tensors((cache, tokens))) + 4
        if not any(cfg.layer_kind(i)[0] in ("gqa", "mla", "wattn")
                   for i in range(cfg.n_layers)):
            unread += 4
    else:
        n_in = sum(_nbytes(t) for t in _tensors(inp))
    return {"params": p, "optimizer": opt, "inputs": n_in,
            "held": p + opt + n_in,
            "argument_size_in_bytes": p + opt + n_in - unread}


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, rules,
               overrides) -> dict:
    """Run the cell's step once for this rank of ``mesh`` (a ``DeviceMesh``
    over a started group, fake or real) on meta tensors and count it: the
    counterpart of the reference's ``_lower_cell`` and its compile."""
    model = Model(cfg)
    t0 = time.perf_counter()
    with set_mesh_rules(mesh, overrides):
        params, _ = _local_params(cfg, mesh, rules)
        inputs = _inputs(cfg, shape, mesh, rules)
        opt = _opt_state(params) if shape.kind == "train" else None
        model.active_layout()   # its meta init of the full tree: uncounted
        LOG.reset()
        counter = StepCounter()
        args = counter.track(_tensors((params, opt, inputs)))
        if shape.kind == "decode":
            args += 4                          # the int32 position
        with counter:
            if shape.kind == "train":
                out = make_train_step(model)(params, opt, inputs)
            elif shape.kind == "prefill":
                out = make_prefill_step(model)(params, inputs)
            else:
                cache, tokens, _ = inputs
                out = make_serve_step(model)(params, cache, tokens,
                                             shape.seq_len - 1)
        coll = LOG.as_dict()
    st = state_bytes(cfg, shape, mesh, rules)
    seen: set = set()
    out_bytes = 0
    for t in _tensors(out):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            out_bytes += t.untyped_storage().nbytes()
    return {"flops": float(counter.flops),
            "bytes": float(counter.bytes), "collectives": coll,
            "memory": {"argument_size_in_bytes":
                       st["argument_size_in_bytes"],
                       "held_bytes": args,
                       "output_size_in_bytes": out_bytes,
                       "peak_bytes": counter.peak,
                       "temp_size_in_bytes": counter.peak - args},
            "state": st, "trace_s": time.perf_counter() - t0}


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             save: bool = True, verbose: bool = True,
             overrides_cfg: dict | None = None, tag: str = "",
             rank: int = 0, out_dir: pathlib.Path | None = None,
             hbm_bytes: int = H100_80GB_HBM3_BYTES) -> dict:
    """One cell's record (see the module docstring), written to
    ``out_dir`` (default ``RESULTS``) as ``<arch>__<shape>__<mesh>.json``.
    A MoE config runs the expert-parallel body (``moe_impl="shard_map"``,
    the reference's production override), recorded under ``overrides``."""
    cfg = get_config(arch)
    overrides_cfg = dict(overrides_cfg or {})
    if cfg.n_experts and "moe_impl" not in overrides_cfg:
        overrides_cfg["moe_impl"] = "shard_map"
    if overrides_cfg:
        cfg = dataclasses.replace(cfg, **overrides_cfg)
    shape = SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    mshape = production_mesh_shape(multi_pod=multi_pod)
    rules, overrides = cell_rules(cfg, mshape)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "ranks": math.prod(mshape.sizes), "rank": rank, "kind": shape.kind,
        "n_params": cfg.n_params(), "n_active_params": cfg.active_params(),
        "analytic": analytic_flops(cfg, shape),
        "tokens": shape.global_batch * (shape.seq_len
                                        if shape.kind != "decode" else 1),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "dtype": str(torch_dtype(cfg.dtype)).split(".")[1],
    }
    if overrides_cfg:
        rec["overrides"] = overrides_cfg
    with fake_mesh(mshape, rank) as mesh:
        traced = trace_cell(cfg, shape, mesh, rules, overrides)
    rec["step"] = "traced"
    rec["flops"], rec["bytes"] = traced["flops"], traced["bytes"]
    rec["collectives"] = traced["collectives"]
    rec["memory"] = dict(traced["memory"], hbm_bytes=hbm_bytes)
    rec["state"] = traced["state"]
    rec["trace_s"] = traced["trace_s"]
    if save:
        out_dir = pathlib.Path(out_dir or RESULTS)
        out_dir.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape_name}__{rec['mesh']}"
        if tag:
            name += f"__{tag}"
        (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))
    if verbose:
        print(json.dumps({k: rec.get(k) for k in
                          ("arch", "shape", "mesh", "step", "flops",
                           "trace_s")}))
        print("  memory:", rec["memory"])
        if "collectives" in rec:
            print("  collectives:", {k: v for k, v in
                                     rec["collectives"].items()
                                     if isinstance(v, dict) and v["count"]})
        print("  analytic:", rec["analytic"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig field override, e.g. moe_impl=shard_map")
    ap.add_argument("--tag", default="",
                    help="record suffix for A/B records")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh to trace")
    ap.add_argument("--out", default=None,
                    help=f"records' directory (default {RESULTS})")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    ov = _parse_overrides(args.override)
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, multi_pod=args.multi_pod,
                           overrides_cfg=ov or None, tag=args.tag,
                           rank=args.rank, out_dir=args.out)
            if "skipped" in rec:
                print(f"SKIP {a} {s}: {rec['skipped']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
