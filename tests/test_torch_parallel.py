"""The port's sharding rules, meshes and sharded restore against the
reference's (``repro.parallel.sharding``, ``repro.checkpoint``).

* ``logical_spec`` over a grid of meshes ((1, 1), (2, 4), (16, 16),
  (2, 16, 16)), rules (the defaults, ``fsdp_rules(False)``,
  ``fsdp_rules(True)``) and shapes that do and do not divide (hubert's
  vocab 504, qwen2-vl's 12 heads): the port's spec equals the entries of
  the reference's ``PartitionSpec`` over a JAX ``AbstractMesh`` of the same
  shape, exactly. The reference's own divisibility-fallback cases too.
* Every registry config at full width: the port's parameters on
  ``torch.device("meta")`` record the reference's logical axes (without
  the stacked-layer ``None``), and ``tree_shardings`` gives each leaf its
  reference leaf's spec without the stacked-layer entry, on (16, 16) and
  (2, 16, 16), with and without FSDP's rule.
* ``NamedSharding``'s blocks and DTensor placements, and
  ``CheckpointManager.restore_sharded``: a training state saved at world
  size 1 (the reference's bytes) and restored on 4 gloo ranks as (4, 1),
  (2, 2) and (2, 2, 1) with ``("pod", "data")`` over one dim; each rank's
  block equals its slice of the saved array and DTensor's
  ``distribute_tensor`` block.

Multi-rank runs are subprocesses (``run_ranks``): gloo over a ``FileStore``
under the test's ``tmp_path``, a timeout each, the group destroyed in a
``finally``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import save_pytree as r_save_pytree
from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.models import Model as RModel
from repro.parallel import sharding as rs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import (lm_arrays_from_params, stacked_axes,
                                 train_state_to_arrays)
from repro_torch.launch.mesh import (local_mesh_shape, make_local_mesh,
                                     production_mesh_shape)
from repro_torch.models import Model
from repro_torch.optim import AdamWState
from repro_torch.parallel import (LOGICAL_RULES, MeshShape, NamedSharding,
                                  fsdp_rules, logical_spec, set_mesh_rules,
                                  shard, tree_shardings)
from repro_torch.parallel.sharding import current

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": None, "fsdp": False, "fsdp_multi_pod": True}

# (logical axes, shape): dims that divide every mesh and dims that do not
CASES = [
    (("vocab", "embed"), (504, 1280)),              # hubert's vocab
    (("vocab", "embed"), (151936, 2048)),
    (("embed", "vocab"), (2048, 151936)),
    (("embed", "heads", "head_dim"), (1536, 12, 128)),   # qwen2-vl's heads
    (("embed", "kv_heads", "head_dim"), (1536, 2, 128)),
    (("heads", "head_dim", "embed"), (16, 128, 2048)),
    (("expert", "embed", "expert_mlp"), (64, 2048, 1408)),
    (("expert", "embed", "expert_mlp"), (160, 5120, 1536)),
    (("embed", None), (2048, 64)),
    (("norm",), (2048,)),
    (("embed", "mlp"), (3072, 8192)),
    (("rnn", None), (4096, 4096)),
    (("act_batch", "act_seq", "act_embed"), (32, 4096, 2048)),
    (("act_batch", "act_seq", "act_embed"), (2, 4096, 2048)),
    (("act_batch", "act_heads", "act_kv_seq"), (48, 12, 100)),
    (("act_expert", "act_batch", "act_embed"), (60, 16, 64)),
    ((None, "embed"), (5, 3000)),
    (("unknown", "embed"), (7, 4096)),
    (("embed", "embed"), (4096, 4096)),             # a mesh dim used once
]


def _rules(name):
    multi = RULES[name]
    return None if multi is None else dict(LOGICAL_RULES, **fsdp_rules(multi))


def _ref_rules(name):
    multi = RULES[name]
    return (None if multi is None
            else dict(rs.LOGICAL_RULES, **rs.fsdp_rules(multi)))


# ---------------------------------------------------------- logical_spec ----

@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_spec_matches_reference(mesh, rules):
    shape, names = MESHES[mesh]
    am, pm = AbstractMesh(shape, names), MeshShape(names, shape)
    for axes, dims in CASES:
        for sizes in (dims, None):
            want = tuple(rs.logical_spec(axes, sizes, am, _ref_rules(rules)))
            got = logical_spec(axes, sizes, pm, _rules(rules))
            assert got == want, (axes, sizes, got, want)


def test_logical_spec_divisibility_fallback():
    """The reference's ``test_logical_spec_divisibility_fallback`` cases on
    the port, beside the reference's answers, on (1, 1) and (16, 16)."""
    for shape in ((1, 1), (16, 16)):
        am = AbstractMesh(shape, ("data", "model"))
        pm = MeshShape(("data", "model"), shape)
        for axes, dims, rules in (
                (("vocab", "embed"), (504, 64),
                 {"vocab": ("model",), "embed": ()}),
                (("x",), (10,), {"x": ("nonexistent",)})):
            want = tuple(rs.logical_spec(axes, dims, am, rules))
            assert logical_spec(axes, dims, pm, rules) == want
    pm = MeshShape(("data", "model"), (1, 1))
    assert logical_spec(("vocab", "embed"), (504, 64), pm,
                        {"vocab": ("model",), "embed": ()}) == ("model",)
    assert logical_spec(("x",), (10,), pm, {"x": ("nonexistent",)}) == ()
    assert logical_spec(("vocab", "embed"), (504, 64),
                        MeshShape(("data", "model"), (1, 16)),
                        {"vocab": ("model",)}) == ()


def test_active_mesh_and_rules_come_from_set_mesh_rules():
    pm = MeshShape(("data", "model"), (16, 16))
    assert logical_spec(("vocab", "embed"), (512, 64)) == ()   # no mesh
    assert current()[0] is None
    with set_mesh_rules(pm, fsdp_rules(False)):
        assert current()[0] is pm
        assert logical_spec(("vocab", "embed"), (512, 64)) == (
            "model", "data")
        # empty rules mean the active ones, as the reference's ``or``
        assert logical_spec(("vocab", "embed"), (512, 64), pm, {}) == (
            "model", "data")
        x = torch.ones(2)
        assert shard(x, "act_batch") is x
    assert current()[0] is None


# ---------------------------------------------------- the parameter axes ----

def _ref_tree(arch):
    return RModel(r_get_config(arch)).init(abstract=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _flat(v, prefix)
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference_on_meta(arch):
    """Full width and depth on ``meta``: the reference's axes (a segment's
    without the stacked ``None``; ``stacked_axes`` restores it), every leaf
    on ``meta`` with the reference's per-layer shape."""
    assert set(ARCH_IDS) == set(R_ARCH_IDS)
    rparams, raxes = _ref_tree(arch)
    params, axes = Model(get_config(arch)).init_with_axes(device="meta")
    assert stacked_axes(axes) == raxes
    rshapes = dict(_flat(rparams))
    for path, leaf in _flat(params):
        assert leaf.device.type == "meta"
        want = rshapes[path].shape
        assert tuple(leaf.shape) == (want[1:] if path.startswith("seg")
                                     else want), path


@pytest.mark.parametrize("rules", ["default", "fsdp"])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_shardings_match_reference_full_width(arch, multi_pod, rules):
    ps = production_mesh_shape(multi_pod=multi_pod)
    am = AbstractMesh(ps.sizes, ps.axis_names)
    rrules = rs.fsdp_rules(multi_pod) if rules == "fsdp" else None
    prules = fsdp_rules(multi_pod) if rules == "fsdp" else None
    rparams, raxes = _ref_tree(arch)
    want = dict(_flat(rs.tree_shardings(
        rparams, raxes, am, rrules and dict(rs.LOGICAL_RULES, **rrules))))
    params, axes = Model(get_config(arch)).init_with_axes(device="meta")
    got = dict(_flat(tree_shardings(
        params, axes, ps, prules and dict(LOGICAL_RULES, **prules))))
    assert set(got) == set(want)
    for path, sh in got.items():
        spec = tuple(want[path].spec)
        if path.startswith("seg"):
            assert spec[:1] in ((), (None,)), (path, spec)
            spec = spec[1:]
        assert sh.spec == spec, (path, sh.spec, spec)
        assert sh.mesh == ps


# ------------------------------------------------------- NamedSharding ----

def test_blocks_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    pm = MeshShape(("pod", "data", "model"), (2, 4, 2))
    x = np.arange(16 * 6 * 4).reshape(16, 6, 4)
    sh = NamedSharding(pm, (("pod", "data"), None, "model"))
    assert sh.shard_shape(x.shape) == (2, 6, 2)
    assert sh.placements() == (Shard(0), Shard(0), Shard(2))
    seen = np.zeros(x.shape, int)
    for p in range(2):
        for d in range(4):
            for m in range(2):
                c = {"pod": p, "data": d, "model": m}
                blk = sh.local(x, c)
                want = x[(p * 4 + d) * 2:(p * 4 + d + 1) * 2, :,
                         m * 2:(m + 1) * 2]
                assert np.array_equal(blk, want)
                seen[sh.index(x.shape, c)] += 1
    assert (seen == 1).all()
    assert NamedSharding(pm, ()).placements() == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        NamedSharding(pm, (("data", "pod"),)).placements()
    with pytest.raises(ValueError, match="split"):
        NamedSharding(pm, ("data",)).index((6,), c)
    with pytest.raises(ValueError, match="coords"):
        NamedSharding(pm, ()).local(x)
    one = NamedSharding(local_mesh_shape(1), ("data",))
    assert np.array_equal(one.local(x), x)


def test_meshes_need_a_process_group():
    assert production_mesh_shape() == MeshShape(("data", "model"), (16, 16))
    assert production_mesh_shape(multi_pod=True) == MeshShape(
        ("pod", "data", "model"), (2, 16, 16))
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh("cpu")


# ---------------------------------------------------------- multi-rank ----

RANK_MAIN = """
import sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
try:
    main(*sys.argv[5:])
finally:
    dist.destroy_process_group()
"""


def run_ranks(body: str, world: int, tmp_path: pathlib.Path, *args,
              timeout: float = 120.0) -> None:
    """``body`` (defining ``main(*args)``) on ``world`` gloo ranks, each a
    subprocess given its rank, the world size, a ``FileStore`` path and
    ``tmp_path`` (``out``); fails with their output if any rank fails or
    the run outlasts ``timeout``."""
    store = tmp_path / f"store-{os.urandom(4).hex()}"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", body + RANK_MAIN, str(r), str(world),
         str(store), str(tmp_path), *map(str, args)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, outs[r][1][-3000:])
           for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad


RESTORE_BODY = """
def main(shape, names):
    import dataclasses
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_arrays_from_params, stacked_axes
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import Model
    from repro_torch.optim import AdamWState
    from repro_torch.parallel import (LOGICAL_RULES, MeshShape,
                                      NamedSharding, fsdp_rules,
                                      tree_shardings)
    names = tuple(names.split(","))
    ms = MeshShape(names, tuple(int(v) for v in shape.split("x")))
    mesh = device_mesh(ms, "cpu")
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"),
                              dtype="float32")
    params, axes = Model(cfg).init_with_axes(device="cpu")
    mgr = CheckpointManager(out + "/ckpt")
    tree = lm_arrays_from_params(cfg, params)       # the names, not read
    step, like = mgr.restore_latest({"params": tree, "opt": AdamWState(
        np.int32(0), tree, tree)})
    rules = dict(LOGICAL_RULES, **fsdp_rules("pod" in names))
    sh = tree_shardings(like["params"], stacked_axes(axes), mesh, rules)
    shardings = {"params": sh, "opt": AdamWState(NamedSharding(mesh, ()),
                                                 sh, sh)}
    step, got = mgr.restore_sharded(like, shardings)
    assert step == 3
    coord = dict(zip(names, mesh.get_coordinate()))
    blocks = sharded = 0

    def check(want, block, s, path):
        nonlocal blocks, sharded
        assert block.device.type == "cpu" and block.is_contiguous()
        sl = []
        for i, size in enumerate(want.shape):
            entry = s.spec[i] if i < len(s.spec) else None
            dims = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n, b = 1, 0
            for d in dims:
                n *= ms.sizes[names.index(d)]
                b = b * ms.sizes[names.index(d)] + coord[d]
            sl.append(slice(b * size // n, (b + 1) * size // n))
        assert np.array_equal(block.numpy(), want[tuple(sl)]), path
        dt = distribute_tensor(torch.from_numpy(np.array(want)), mesh,
                               s.placements()).to_local()
        assert torch.equal(dt, block), path
        blocks += 1
        sharded += block.numel() < want.size

    def walk(w, g, s, path):
        if isinstance(w, dict):
            for k in w:
                walk(w[k], g[k], s[k], path + "/" + k)
        elif isinstance(w, (list, tuple)):
            for i, (a, b, c) in enumerate(zip(w, g, s)):
                walk(a, b, c, f"{path}[{i}]")
        else:
            check(w, g, s, path)
    walk(like, got, shardings, "")
    assert sharded > 0 and blocks > sharded
    np.save(f"{out}/blocks-{shape}-{rank}.npy", np.array([blocks, sharded]))
"""


def _train_state():
    """A qwen2-moe smoke training state in the reference's layout."""
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32")
    params = Model(cfg).init(3, device="cpu")
    gen = torch.Generator().manual_seed(4)

    def noise(tree):
        if isinstance(tree, dict):
            return {k: noise(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [noise(v) for v in tree]
        return torch.randn(tree.shape, generator=gen)
    opt = AdamWState(step=torch.tensor(3, dtype=torch.int32),
                     m=noise(params), v=noise(params))
    return train_state_to_arrays(cfg, params, opt)


@pytest.mark.parametrize("shape,names", [("4x1", "data,model"),
                                         ("2x2", "data,model"),
                                         ("2x2x1", "pod,data,model")])
def test_restore_sharded_onto_four_ranks(tmp_path, shape, names):
    """Saved at world size 1 (the file is the reference's ``save_pytree``
    bytes for the same state), restored on 4 gloo ranks: every leaf's
    block equals its slice of the saved array and ``distribute_tensor``'s
    block under ``placements()``; FSDP's rule shards the embed dims over
    the batch dims (both of them on the 3-d mesh), the experts over
    ``model``."""
    from repro_torch.checkpoint import CheckpointManager
    state = _train_state()
    CheckpointManager(tmp_path / "ckpt").save(3, state)
    r_save_pytree(tmp_path / "ref.ckpt", state, step=3)
    assert ((tmp_path / "ckpt" / "step_00000003.ckpt").read_bytes()
            == (tmp_path / "ref.ckpt").read_bytes())
    run_ranks(RESTORE_BODY, 4, tmp_path, shape, names)
    counts = {tuple(np.load(tmp_path / f"blocks-{shape}-{r}.npy"))
              for r in range(4)}
    assert len(counts) == 1


def test_elastic_restore_onto_a_smaller_mesh_in_process(tmp_path):
    """The same restore without a process group: a one-rank shape-only
    mesh gives every leaf whole, on the device asked for."""
    from repro_torch.checkpoint import CheckpointManager
    state = _train_state()
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(3, state)
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32")
    _, axes = Model(cfg).init_with_axes(device="meta")
    ms = local_mesh_shape(1)
    sh = tree_shardings(state["params"], stacked_axes(axes), ms,
                        dict(LOGICAL_RULES, **fsdp_rules(False)))
    step, got = mgr.restore_sharded(
        state, {"params": sh, "opt": AdamWState(NamedSharding(ms, ()), sh,
                                                sh)}, device="cpu")
    assert step == 3
    want = dict(_flat(lm_arrays_from_params(cfg, Model(cfg).init(
        3, device="cpu"))))
    for path, leaf in _flat(got["params"]):
        assert np.array_equal(leaf.numpy(), want[path]), path
    assert int(got["opt"][0]) == 3
