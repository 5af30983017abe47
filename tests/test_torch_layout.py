"""The production layout (``parallel.collectives``: FSDP's gather and
tensor parallelism in the forward and backward) against the reference's
placement and the unsharded port model.

* **Placement.** For the smoke config of every arch and each supported
  kind (64 tokens, batch 4), under ``LOGICAL_RULES`` with ``fsdp_rules``
  where the arch's full config sets ``fsdp``, the bytes a rank holds as
  the step's arguments (``launch.dryrun.state_bytes`` on a (2, 2)
  ``MeshShape``) equal the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` on an ``AxisType.Auto``
  (2, 2) mesh (``repro.launch.dryrun._lower_cell``), byte for byte. The
  reference runs in two subprocesses (it forces 512 host devices).
* **Numbers across ranks.** One float32 smoke model of each family of the
  layout (phi3-mini, phi3-medium, minitron, command-r, hubert, qwen2-vl,
  qwen2-moe and deepseek-v2 with the expert-parallel body at a capacity
  factor that drops nothing, deepseek-v2's MLA with the absorbed decode
  too, rwkv6, recurrentgemma, and recurrentgemma with two kv heads) on 4
  gloo ranks as (2, 2) and (1, 4), placed by ``tree_shardings`` under
  ``LOGICAL_RULES`` + ``fsdp_rules``: the heads, the kv heads where they
  divide ``model``, the MLP, the RG-LRU's channels and the vocab split over
  ``model``, every weight's ``embed`` over ``data``. On (1, 4) the
  two-kv-head models read whole kv heads (``slice_replicated``) and decode
  through the context-parallel cache; on (2, 2) the cache is split by
  heads. MLA's latent cache is split by positions on both; recurrentgemma's
  ring of 16 slots by slots (its one kv head), or by kv heads for the
  two-kv-head variant on (2, 2), and its 20 decode steps wrap the ring.
  Against the unsharded port model on the same seed and batch: final
  hidden states, the aux loss (within 1e-6 relative), prefill logits and
  the decode steps' logits within 1e-5 of their largest magnitude; the
  loss within 1e-6 (relative) and every gradient's block, after the
  reduction over the batch ranks, within 1e-4 of the leaf's largest
  magnitude (recurrentgemma's within 5e-4: its float32 gradients move by
  2.7e-4 to 2.8e-4 of a leaf's largest magnitude when the embedding table
  moves by one ulp, ``test_recurrentgemma_gradient_floor``, so a layout's
  other summation order cannot be held closer than that floor); one train
  step's loss (``grad_accum`` 2 for the families without a MoE) within
  1e-5. AdamW alone: the blocks of the unsharded
  gradients through ``adamw_update`` with the leaves' specs (the norm over
  every rank's blocks) equal the blocks of the unsharded update within
  1e-6 of each leaf's largest magnitude.
* **The gspmd MoE across ranks.** qwen2-moe and deepseek-v2 with
  ``moe_impl="gspmd"`` at capacity factor 1 on 4 x 256 tokens, where the
  unsharded path drops pairs: every rank keeps exactly the unsharded
  path's pairs of its experts and its rows, at the same positions, and the
  numbers above hold.
* **The engine over a mesh.** recurrentgemma's ``ServeEngine`` on (1, 4),
  five requests of other lengths through two slots (late admissions into
  used slots, the ring wrapped, its per-slot ring rows), answers every
  request with the unsharded engine's tokens.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import shape_supported
from repro_torch.launch.dryrun import state_bytes
from repro_torch.parallel import LOGICAL_RULES, MeshShape, fsdp_rules
from test_torch_parallel import REPO, run_ranks

KINDS = ("train", "prefill", "decode")
MESHES = ("2x2", "1x4")
CELLS = [(a, k) for a in ARCH_IDS for k in KINDS
         if shape_supported(get_smoke(a), ShapeConfig("s", 64, 4, k))[0]]

REFERENCE = """
import json, sys
import repro.launch.dryrun as D          # forces 512 host devices
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get_config, get_smoke
from repro.configs.base import ShapeConfig
from repro.parallel.sharding import LOGICAL_RULES, fsdp_rules
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
out = {}
for cell in sys.argv[1:]:
    arch, kind = cell.split(":")
    ov = fsdp_rules(False) if get_config(arch).fsdp else {}
    lowered = D._lower_cell(get_smoke(arch), ShapeConfig("s", 64, 4, kind),
                            mesh, dict(LOGICAL_RULES, **ov), ov)
    mem = lowered.compile().memory_analysis()
    out[cell] = int(mem.argument_size_in_bytes)
print(json.dumps(out))
"""


def _start_reference() -> list:
    """The reference's lowering of every cell, in two subprocesses."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "JAX_PLATFORMS": "cpu"}
    cells = [f"{a}:{k}" for a, k in CELLS]
    return [subprocess.Popen([sys.executable, "-c", REFERENCE, *cells[i::2]],
                             cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for i in range(2)]


def _reference_bytes(procs) -> dict:
    """{"arch:kind": argument bytes} from ``_start_reference``'s runs."""
    out = {}
    try:
        for p in procs:
            so, se = p.communicate(timeout=300)
            assert p.returncode == 0, se[-3000:]
            out.update(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the gloo ranks' results directory, the reference's argument bytes):
    the reference lowers while the ranks run."""
    out = tmp_path_factory.mktemp("layout")
    procs = _start_reference()
    try:
        for shape in MESHES:
            run_ranks(RANK, 4, out, shape, timeout=300)
    finally:
        ref = _reference_bytes(procs)
    return out, ref


@pytest.fixture(scope="module")
def reference_bytes(runs):
    return runs[1]


@pytest.fixture(scope="module")
def rank_runs(runs):
    return runs[0]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_match_reference(reference_bytes, arch, kind):
    rules = dict(LOGICAL_RULES,
                 **(fsdp_rules(False) if get_config(arch).fsdp else {}))
    mesh = MeshShape(("data", "model"), (2, 2))
    got = state_bytes(get_smoke(arch), ShapeConfig("s", 64, 4, kind), mesh,
                      rules)
    assert got["argument_size_in_bytes"] == reference_bytes[
        f"{arch}:{kind}"], (arch, kind, got)


# ------------------------------------------------ numbers across ranks ----

FAMILIES_SRC = """
FAMILIES = {"phi3-mini-3.8b": {}, "phi3-medium-14b": {}, "minitron-4b": {},
            "command-r-plus-104b": {}, "hubert-xlarge": {},
            "qwen2-vl-2b": {},
            "qwen2-moe-a2.7b": {"moe_impl": "shard_map",
                                "capacity_factor": 8.0},
            "deepseek-v2-236b": {"moe_impl": "shard_map",
                                 "capacity_factor": 8.0},
            "deepseek-v2-236b+absorbed": {"moe_impl": "shard_map",
                                          "capacity_factor": 8.0,
                                          "mla_absorb": True},
            "rwkv6-1.6b": {}, "recurrentgemma-9b": {},
            "recurrentgemma-9b+kv2": {"n_kv_heads": 2},
            "qwen2-moe-a2.7b+gspmd": {"moe_impl": "gspmd",
                                      "capacity_factor": 1.0},
            "deepseek-v2-236b+gspmd": {"moe_impl": "gspmd",
                                       "capacity_factor": 1.0}}
BATCH, SEQ, DECODE_SEQ, DECODE_STEPS = 4, 32, 16, 8
# the gspmd cases' tokens: 1,024 of them route 2,048 pairs to 8 experts,
# past the capacity of 128 a layer; recurrentgemma's steps pass its window
SEQS = {"qwen2-moe-a2.7b+gspmd": 256, "deepseek-v2-236b+gspmd": 256}
STEPS = {"recurrentgemma-9b": 20, "recurrentgemma-9b+kv2": 20}
# the engine's requests (seq id, prompt length, new tokens), batch 2
ENGINE = [(3, 2), (7, 20), (4, 18), (9, 12), (2, 25)]


def family_arch(name):
    return name.split("+")[0]


def family_config(name, **kw):
    import dataclasses
    from repro_torch.configs import get_smoke
    # the MoE's aux loss is a product of batch means: a rank's micro-batch
    # is its own rows' slice, not the reference's global one, so the MoE
    # trains with one micro-batch here
    accum = 1 if "moe_impl" in FAMILIES[name] else 2
    return dataclasses.replace(get_smoke(family_arch(name)), dtype="float32",
                               grad_accum=accum, **dict(FAMILIES[name], **kw))


def family_batch(name, cfg, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    seq = SEQS.get(name, SEQ)
    out = {"labels": rng.integers(0, cfg.vocab, (BATCH, seq))}
    out["labels"][:, :3] = -1                 # masked labels
    if cfg.frontend == "frames":
        out["frames"] = rng.normal(0, 1, (BATCH, seq, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (BATCH, seq))
    if cfg.mrope_sections:
        out["patch_embeds"] = rng.normal(0, 1, (BATCH, 8, cfg.d_model)
                                         ).astype(np.float32)
    out["prompt"] = rng.integers(0, cfg.vocab,
                                 (BATCH, STEPS.get(name, DECODE_STEPS)))
    return out


def engine_requests(vocab):
    import numpy as np
    rng = np.random.default_rng(2)
    return [(i, rng.integers(0, vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate(ENGINE)]


def recorded_routes():
    # a list that every layers.moe.route call appends its Routing to, and
    # the function that puts route back
    import repro_torch.layers.moe as M
    seen, orig = [], M.route

    def route(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]
    M.route = route

    def restore():
        M.route = orig
    return seen, restore
"""

RANK = FAMILIES_SRC + """
def main(shape):
    import numpy as np
    import torch
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import Model
    from repro_torch.models.lm import init_cache
    from repro_torch.models.steps import (loss_and_grad, make_prefill_step,
                                          make_train_step)
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import (LOGICAL_RULES, MeshShape, fsdp_rules,
                                      logical_sharding, set_mesh_rules,
                                      shard_tree, tree_shardings)
    dims = tuple(int(v) for v in shape.split("x"))
    mesh = device_mesh(MeshShape(("data", "model"), dims), "cpu")
    d, m = mesh.get_coordinate()
    over = fsdp_rules(False)
    rules = dict(LOGICAL_RULES, **over)
    bax = {"frames": ("act_batch", "act_seq", "act_embed"),
           "patch_embeds": ("act_batch", None, "act_embed"),
           "prompt": ("act_batch", None)}

    def mine(k, v):
        return torch.from_numpy(np.array(logical_sharding(
            bax.get(k, ("act_batch", "act_seq")), v.shape, mesh, rules
        ).local(v)))
    for i, name in enumerate(FAMILIES):
        cfg = family_config(name)
        model = Model(cfg)
        params, axes = model.init_with_axes(5, device="cpu")
        sh = tree_shardings(params, axes, mesh, rules)
        local = shard_tree(params, sh, device="cpu")
        data = family_batch(name, cfg, 100 + i)
        batch = {k: mine(k, v) for k, v in data.items() if k != "prompt"}
        res = {}
        with set_mesh_rules(mesh, over):
            routes, restore = recorded_routes()
            try:
                res["hidden"], res["aux"] = model.forward(local, batch)
            finally:
                restore()
            for j, r in enumerate(routes):
                res.update({f"route/{j}/idx": r.idx, f"route/{j}/pos": r.pos,
                            f"route/{j}/keep": r.keep})
            res["prefill"] = make_prefill_step(model)(local, batch)
            res["loss"], grads = loss_and_grad(model, local, batch)
            res.update({f"g/{j}": g for j, g in enumerate(grads)})
            if cfg.frontend != "frames":
                cache = init_cache(cfg, BATCH, DECODE_SEQ, device="cpu")
                prompt = mine("prompt", data["prompt"])
                steps = []
                for t in range(prompt.shape[1]):
                    lg, cache = model.serve_step(local, cache,
                                                 prompt[:, t:t + 1], t)
                    steps.append(lg)
                res["decode"] = torch.stack(steps, 1)
            if name == "recurrentgemma-9b" and dims[0] == 1:
                from repro_torch.serving.engine import Request, ServeEngine
                eng = ServeEngine(model, local, batch_size=2, max_seq=64,
                                  device="cpu")
                for sid, p, n in engine_requests(cfg.vocab):
                    eng.submit(Request(seq_id=sid, prompt=p, max_new=n))
                for f in eng.run():
                    res[f"engine/{f.seq_id}"] = torch.from_numpy(f.tokens)
            p2 = shard_tree(params, sh, device="cpu")
            res["train_loss"] = make_train_step(model)(
                p2, adamw_init(p2), batch)[0]
        # AdamW alone: this rank's blocks of the unsharded gradients
        whole = Model(family_config(name, moe_impl="gspmd"))
        full = {k: torch.from_numpy(v) for k, v in data.items()
                if k != "prompt"}
        _, g_full = loss_and_grad(whole, params, full)
        specs = leaves(sh)
        g_blk = [s.local(g).contiguous() for g, s in zip(g_full, specs)]
        p3 = shard_tree(params, sh, device="cpu")
        with set_mesh_rules(mesh, over):
            p3, _ = adamw_update(g_blk, adamw_init(p3), p3, lr=1e-2,
                                 specs=[s.spec for s in specs])
        res.update({f"p/{j}": t for j, t in enumerate(leaves(p3))})
        res.update({f"gfull/{j}": g for j, g in enumerate(g_full)})
        np.savez(f"{out}/{shape}-{name}-{d}-{m}.npz",
                 **{k: v.detach().numpy() for k, v in res.items()})
"""

ns: dict = {}
exec(FAMILIES_SRC, ns)
FAMILIES = list(ns["FAMILIES"])


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded port model's numbers of every family, by name."""
    from repro_torch.models import Model
    from repro_torch.models.lm import init_cache
    from repro_torch.models.steps import (loss_and_grad, make_prefill_step,
                                          make_train_step)
    from repro_torch.optim import adamw_init
    from repro_torch.serving.engine import Request, ServeEngine
    out = {}
    for i, name in enumerate(FAMILIES):
        cfg = ns["family_config"](name, moe_impl="gspmd")
        model = Model(cfg)
        params, axes = model.init_with_axes(5, device="cpu")
        data = ns["family_batch"](name, cfg, 100 + i)
        batch = {k: torch.from_numpy(v) for k, v in data.items()
                 if k != "prompt"}
        routes, restore = ns["recorded_routes"]()
        try:
            hidden, aux = model.forward(params, batch)
        finally:
            restore()
        r = {"axes": axes, "params": params,
             "hidden": hidden.detach().numpy(), "aux": aux.detach().numpy(),
             "routes": routes,
             "prefill": make_prefill_step(model)(params, batch).numpy()}
        loss, grads = loss_and_grad(model, params, batch)
        r["loss"], r["grads"] = loss.numpy(), [g.numpy() for g in grads]
        if cfg.frontend != "frames":
            cache = init_cache(cfg, ns["BATCH"], ns["DECODE_SEQ"],
                               device="cpu")
            prompt = torch.from_numpy(data["prompt"])
            r["decode"] = torch.stack(
                [model.serve_step(params, cache, prompt[:, t:t + 1], t)[0]
                 for t in range(prompt.shape[1])], 1).numpy()
        if name == "recurrentgemma-9b":
            eng = ServeEngine(model, params, batch_size=2, max_seq=64,
                              device="cpu")
            for sid, p, n in ns["engine_requests"](cfg.vocab):
                eng.submit(Request(seq_id=sid, prompt=p, max_new=n))
            r["engine"] = {f.seq_id: f.tokens for f in eng.run()}
        p2 = model.init(5, device="cpu")
        r["train_loss"] = make_train_step(model)(p2, adamw_init(p2),
                                                 batch)[0].numpy()
        out[name] = r
    return out


def _ranks(runs, shape, arch):
    dims = tuple(int(v) for v in shape.split("x"))
    return dims, {(d, m): dict(np.load(runs / f"{shape}-{arch}-{d}-{m}.npz"))
                  for d in range(dims[0]) for m in range(dims[1])}


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= tol * scale, (what, err, scale)


def _blocks(ref, shape):
    """Each leaf's sharding on the mesh ``shape`` (the ranks' rules)."""
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import tree_shardings
    dims = tuple(int(v) for v in shape.split("x"))
    ms = MeshShape(("data", "model"), dims)
    return leaves(tree_shardings(ref["params"], ref["axes"], ms,
                                 dict(LOGICAL_RULES, **fsdp_rules(False))))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_layout_forward_matches(rank_runs, unsharded, arch, shape):
    dims, ranks = _ranks(rank_runs, shape, arch)
    ref = unsharded[arch]
    rows = ns["BATCH"] // dims[0]
    for (d, m), got in ranks.items():
        sl = slice(d * rows, (d + 1) * rows)
        _close(got["hidden"], ref["hidden"][sl], 1e-5, ("hidden", d, m))
        np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-6)
        _close(got["prefill"], ref["prefill"][sl], 1e-5, ("prefill", d, m))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", [a for a in FAMILIES
                                  if ns["FAMILIES"][a].get("moe_impl")
                                  == "gspmd"])
def test_gspmd_moe_keeps_the_unsharded_pairs(rank_runs, unsharded, arch,
                                             shape):
    """Each MoE layer: every rank's top-k experts are the unsharded path's
    for its rows; of the pairs routed to its experts it keeps exactly those
    the unsharded path keeps, at the same positions within their expert
    (the offsets of the lower batch ranks' pairs), and keeps no other. The
    unsharded path drops pairs."""
    import torch as T
    dims, ranks = _ranks(rank_runs, shape, arch)
    ref = unsharded[arch]
    assert ref["routes"] and all(int((~r.keep).sum()) > 0
                                 for r in ref["routes"])
    from repro_torch.layers.moe import padded_experts
    e_loc = padded_experts(get_smoke(ns["family_arch"](arch)).n_experts
                           ) // dims[1]
    toks = ref["routes"][0].idx.shape[0] // dims[0]
    for (d, m), got in ranks.items():
        for j, want in enumerate(ref["routes"]):
            sl = slice(d * toks, (d + 1) * toks)
            idx = T.from_numpy(got[f"route/{j}/idx"])
            assert T.equal(idx, want.idx[sl]), (j, d, m)
            mine = (idx >= m * e_loc) & (idx < (m + 1) * e_loc)
            keep = T.from_numpy(got[f"route/{j}/keep"])
            assert T.equal(keep, want.keep[sl] & mine), (j, d, m)
            pos = T.from_numpy(got[f"route/{j}/pos"])
            assert T.equal(pos[mine], want.pos[sl][mine]), (j, d, m)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", [a for a in FAMILIES
                                  if get_smoke(ns["family_arch"](a)).frontend
                                  != "frames"])
def test_layout_decode_matches(rank_runs, unsharded, arch, shape):
    """(2, 2) splits the cache by kv heads; (1, 4) by positions for the
    two-kv-head models, whose eight steps span two ranks' positions (the
    other two ranks' partial softmax states weigh nothing). MLA's latents
    split by positions on both meshes (naive and absorbed decode);
    recurrentgemma's ring by its slots, 20 steps wrapping it."""
    dims, ranks = _ranks(rank_runs, shape, arch)
    ref = unsharded[arch]
    rows = ns["BATCH"] // dims[0]
    for (d, m), got in ranks.items():
        _close(got["decode"], ref["decode"][d * rows:(d + 1) * rows], 1e-5,
               ("decode", d, m))


# a gradient block's tolerance (of its leaf's largest magnitude), by arch
GRAD_TOL = {"recurrentgemma-9b": 5e-4}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_layout_loss_and_gradients_match(rank_runs, unsharded, arch, shape):
    """Every rank's loss is the whole batch's; every gradient, after the
    reduction over the batch ranks, is the rank's block of the unsharded
    gradient."""
    dims, ranks = _ranks(rank_runs, shape, arch)
    ref = unsharded[arch]
    specs = _blocks(ref, shape)
    tol = GRAD_TOL.get(ns["family_arch"](arch), 1e-4)
    for (d, m), got in ranks.items():
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        for j, (g, s) in enumerate(zip(ref["grads"], specs)):
            want = g[s.index(g.shape, {"data": d, "model": m})]
            _close(got[f"g/{j}"], want, tol, ("grad", j, s.spec, d, m))


@pytest.mark.parametrize("arch", [a for a in FAMILIES
                                  if ns["family_arch"](a) in GRAD_TOL])
def test_recurrentgemma_gradient_floor(unsharded, arch):
    """The unsharded model's float32 gradients with the embedding table
    moved by one ulp (a relative change of about 1.2e-7, the size of a
    reordered float32 sum) move by more than 1e-4 of a leaf's largest
    magnitude, and by at least half of ``GRAD_TOL``: the layout's other
    summation order is held to twice that floor, no wider."""
    from repro_torch.models import Model
    from repro_torch.models.steps import loss_and_grad
    ref = unsharded[arch]
    i = list(FAMILIES).index(arch)
    cfg = ns["family_config"](arch, moe_impl="gspmd")
    data = ns["family_batch"](arch, cfg, 100 + i)
    batch = {k: torch.from_numpy(v) for k, v in data.items()
             if k != "prompt"}
    table = ref["params"]["embed"]
    up = dict(ref["params"], embed=torch.nextafter(
        table, torch.full_like(table, float("inf"))))
    _, grads = loss_and_grad(Model(cfg), up, batch)
    floor = max(float(np.abs(g.numpy() - w).max() / np.abs(w).max())
                for g, w in zip(grads, ref["grads"]))
    tol = GRAD_TOL[ns["family_arch"](arch)]
    assert 1e-4 < floor and tol <= 2 * floor, (floor, tol)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_layout_train_step_loss_matches(rank_runs, unsharded, arch, shape):
    _, ranks = _ranks(rank_runs, shape, arch)
    for got in ranks.values():
        np.testing.assert_allclose(got["train_loss"],
                                   unsharded[arch]["train_loss"], rtol=1e-5)


def test_engine_over_the_mesh_matches(rank_runs, unsharded):
    """recurrentgemma's engine on (1, 4): every rank finishes the five
    requests with the unsharded engine's tokens (the ring's per-slot rows
    and the admitted slots' fresh state hold on the split cache)."""
    _, ranks = _ranks(rank_runs, "1x4", "recurrentgemma-9b")
    want = unsharded["recurrentgemma-9b"]["engine"]
    window = get_smoke("recurrentgemma-9b").window
    assert sum(p + n > window for p, n in ns["ENGINE"]) == 4
    for (d, m), got in ranks.items():
        for sid, tokens in want.items():
            assert np.array_equal(got[f"engine/{sid}"], tokens), (sid, d, m)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_adamw_step_matches(rank_runs, unsharded, arch, shape):
    """Each rank's step on its blocks of the unsharded gradients equals its
    blocks of the unsharded step on the same gradients (the ones that rank
    computed: a process's thread count can move the last bits of a
    gradient, which AdamW's first step turns into a move of up to lr where
    the clipped gradient is near its eps)."""
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.adamw import leaves
    dims, ranks = _ranks(rank_runs, shape, arch)
    ref = unsharded[arch]
    specs = _blocks(ref, shape)
    model = Model(ns["family_config"](arch, moe_impl="gspmd"))
    for (d, m), got in ranks.items():
        grads = [torch.from_numpy(got[f"gfull/{j}"])
                 for j in range(len(specs))]
        p3 = model.init(5, device="cpu")
        p3, _ = adamw_update(grads, adamw_init(p3), p3, lr=1e-2)
        for j, (p, s) in enumerate(zip(leaves(p3), specs)):
            p = p.numpy()
            want = p[s.index(p.shape, {"data": d, "model": m})]
            _close(got[f"p/{j}"], want, 1e-6, ("adamw", j, s.spec, d, m))


# ------------------------------------------------------------ one rank ----

def test_layout_refuses_a_block_the_rules_do_not_give():
    """On a (1, 1) gloo group every dim splits one way: a weight cut to
    half of its ``mlp`` dim is not the block the rules give, and the
    layout names it."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.layers.mlp import apply_mlp
    from repro_torch.parallel import set_mesh_rules
    from repro_torch.parallel.collectives import LOG
    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = device_mesh(MeshShape(("data", "model"), (1, 1)), "cpu")
        g = torch.Generator().manual_seed(0)
        p = {"wi_gate": torch.randn(8, 16, generator=g),
             "wi_up": torch.randn(8, 16, generator=g),
             "wo": torch.randn(16, 8, generator=g)}
        x = torch.randn(2, 3, 8, generator=g)
        LOG.reset()
        with set_mesh_rules(mesh, fsdp_rules(False)):
            y = apply_mlp(p, x, "swiglu", 16)
            with pytest.raises(ValueError, match="the active rules give"):
                apply_mlp(dict(p, wi_gate=p["wi_gate"][:, :8]), x, "swiglu",
                          16)
        # one rank: the layout's function is the whole MLP's, op for op
        assert torch.equal(y, apply_mlp(p, x, "swiglu"))
        log = LOG.as_dict()
        # three FSDP gathers over data and the row-parallel all-reduce
        assert log["all-gather"]["count"] == 3
        assert log["all-reduce"]["count"] == 1
        assert log["total_bytes"] == sum(log[k]["bytes"] for k in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all"))
    finally:
        dist.destroy_process_group()


def test_remat_recompute_keeps_the_layout_on_another_thread():
    """On the card the autograd engine runs the backward pass, and remat's
    recomputed layers with it, on a thread of its own, where the
    thread-local mesh of ``set_mesh_rules`` is not installed. A backward
    taken on another thread must still recompute each layer through the
    layout: its FSDP gathers are logged twice (forward and recompute),
    and its gradients equal those of a backward on the calling thread."""
    import dataclasses
    import tempfile
    import threading
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import set_mesh_rules
    from repro_torch.parallel.collectives import LOG
    cfg = dataclasses.replace(get_smoke("phi3-mini-3.8b"), dtype="float32",
                              remat="full")
    model = Model(cfg)
    params = model.init(3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = device_mesh(MeshShape(("data", "model"), (1, 1)), "cpu")
        grads = {}
        for where in ("here", "thread"):
            ts = leaves(params)
            for t in ts:
                t.requires_grad_(True)
            LOG.reset()
            with set_mesh_rules(mesh, fsdp_rules(False)):
                x, _ = model.forward(params, batch)
            gathers = LOG.as_dict()["all-gather"]["count"]
            loss = x.float().square().mean()
            if where == "here":
                grads[where] = torch.autograd.grad(loss, ts, allow_unused=True)
            else:
                box = []
                th = threading.Thread(target=lambda: box.append(
                    torch.autograd.grad(loss, ts, allow_unused=True)))
                th.start()
                th.join()
                grads[where] = box[0]
            for t in ts:
                t.requires_grad_(False)
            # the embedding's gather, then 7 a layer in the forward and 7
            # again in each layer's recompute
            assert gathers == 1 + 7 * cfg.n_layers
            assert LOG.as_dict()["all-gather"]["count"] == \
                1 + 14 * cfg.n_layers, where
        for a, b in zip(grads["here"], grads["thread"]):
            assert (a is None and b is None) or torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_layout_is_built_once_per_mesh_and_rules():
    """``set_mesh_rules`` makes a new rules dict each time it is entered;
    the ``Layout`` and the model's tree of shardings derived from the mesh
    and rules are kept while their contents stay the same, and built anew
    when the rules change. Without a mesh the layout is ``WHOLE``: nothing
    split, no collective."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import Model
    from repro_torch.parallel import set_mesh_rules
    from repro_torch.parallel.collectives import LOG, WHOLE, layout
    model = Model(get_smoke("phi3-mini-3.8b"))
    assert layout() is WHOLE and model.leaf_specs(WHOLE) is None
    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = device_mesh(MeshShape(("data", "model"), (1, 1)), "cpu")
        seen = []
        for rules in (fsdp_rules(False), fsdp_rules(False), None):
            with set_mesh_rules(mesh, rules):
                lay = model.active_layout()
                seen.append((lay, model.shardings(lay)))
        assert seen[0][0] is seen[1][0] and seen[0][1] is seen[1][1]
        assert seen[2][0] is not seen[0][0]
        assert seen[2][1] is not seen[0][1]
        LOG.reset()
        x = torch.ones(2, 3)
        assert WHOLE.reduce_from_model(x) is x
        assert WHOLE.weight(x, ("embed", "mlp"), (9, 9), torch.float32) \
            == (x, ())
        assert LOG.as_dict()["total_bytes"] == 0
    finally:
        dist.destroy_process_group()
    assert layout() is WHOLE
