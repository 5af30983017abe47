"""The port's expert-parallel MoE on gloo ranks against the reference's
``repro.layers.moe._apply_moe_shard_map``.

The same numpy layer (a router over 16 experts, 8 of them real, top-2,
two shared experts) and input (4 x 256 tokens of width 64, so 512 tokens
a rank) go through

* the reference, in a subprocess with four forced host devices and a mesh
  of ``AxisType.Auto`` axes (``jax.make_mesh``'s default Explicit axes make
  the reference's gspmd gather refuse to trace: R3), its ``apply_moe``
  with ``moe_impl="shard_map"`` under ``set_mesh_rules``; each device's
  ``idx`` and ``keep`` are read out of the traced body (the ``top_k`` and
  the boolean ``jnp.where`` conditions it calls), and ``jax.grad`` gives
  the gradient of ``sum(y * cot) + aux`` for every parameter and ``x``;
* the port on 4 gloo ranks (``run_ranks``) as (2, 2) and (1, 4), each rank
  holding its blocks by the port's rules (``x`` over ``data``, the experts
  over ``model``, the shared MLP tensor-parallel over ``model`` on its
  ``mlp`` dim), with the same loss on its slice of ``y``.

At capacity factor 8 no pair drops; at 1.0 the per-rank capacity is 128
slots, and 82 (2, 2) or 1,024 (1, 4: 1,024 tokens a rank) of the 2,048
(token, slot) pairs drop. ``idx`` and ``keep`` must be equal, rank for rank. ``y``,
``aux`` and the gradients (``x``'s per rank; the router's, the shared
MLP's block and the experts' summed over the batch ranks, the caller's
data-parallel reduction) in float32 within 1e-5 of each tensor's largest
magnitude. The port also runs the expert-parallel body on one rank (a
(1, 1) mesh), where it must equal the gspmd path bit for bit, forward and
backward, and must refuse experts split on their mlp dim.

The whole model goes over the same meshes too: qwen2-moe's smoke config
(two MoE layers, 8 experts padded to 16, float32, ``moe_impl="shard_map"``)
with the port's parameters carried into the reference's layout, the
reference's ``Model.forward`` and ``jax.value_and_grad(loss_fn)`` under the
Auto-axis mesh against the port's ``Model.forward`` on 4 gloo ranks, each
holding its blocks as ``tree_shardings`` places them under
``expert_parallel_rules`` (the experts over ``model``, all else whole). Each
rank's final hidden states equal its batch slice of the reference's within
1e-4 of their largest magnitude, ``aux`` and the loss within 1e-4, and
every parameter's gradient, summed over the batch ranks, the reference's
(the experts' slice of it) within 1e-3 of the leaf's largest magnitude,
the tolerances of the single-device training tests.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_parallel import REPO, run_ranks

MESHES = ("2x2", "1x4")
FACTORS = (8.0, 1.0)
TOL = 1e-5
DROPPED = {("2x2", 1.0): 82, ("1x4", 1.0): 1024}
N_EXPERTS, TOP_K, N_SHARED = 8, 2, 2
BATCH, SEQ = 4, 256

CFG = f"""
import dataclasses
def config(get_smoke, cf):
    return dataclasses.replace(
        get_smoke("qwen2-moe-a2.7b"), n_experts={N_EXPERTS}, top_k={TOP_K},
        n_shared={N_SHARED}, capacity_factor=cf, moe_impl="shard_map",
        dtype="float32")
"""

REFERENCE = CFG + """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_smoke
from repro.layers import moe as M
from repro.parallel.sharding import set_mesh_rules

out = sys.argv[1]
data = dict(np.load(out + "/inputs.npz"))
x, cot = jnp.asarray(data.pop("x")), jnp.asarray(data.pop("cot"))
p = {k: jnp.asarray(v) for k, v in data.items() if "/" not in k}
p["shared"] = {k.split("/")[1]: jnp.asarray(v) for k, v in data.items()
               if k.startswith("shared/")}


def traced(seen):
    # each device's idx (top_k) and the boolean conditions of jnp.where
    # (mine, then keep twice) in the shard_map body, by (data, model)
    top_k, where = jax.lax.top_k, jnp.where

    def rec(tag, v):
        jax.debug.callback(
            lambda a, d, m: seen.append((tag, int(d), int(m), np.asarray(a))),
            v, jax.lax.axis_index("data"), jax.lax.axis_index("model"))

    def top_k_rec(logits, k):
        g, i = top_k(logits, k)
        rec("idx", i)
        return g, i

    def where_rec(c, *a, **kw):
        if len(a) == 2 and c.dtype == jnp.bool_ and c.ndim == 1:
            rec("cond", c)
        return where(c, *a, **kw)
    return top_k, where, top_k_rec, where_rec


for shape in sys.argv[2].split(","):
    dims = tuple(int(v) for v in shape.split("x"))
    mesh = jax.make_mesh(dims, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for cf in map(float, sys.argv[3].split(",")):
        cfg = config(get_smoke, cf)
        seen = []
        top_k, where, top_k_rec, where_rec = traced(seen)
        jax.lax.top_k, jnp.where = top_k_rec, where_rec
        try:
            with set_mesh_rules(mesh, {}), mesh:
                y, aux = jax.jit(lambda pp, xx: M.apply_moe(pp, xx, cfg))(
                    p, x)
                jax.effects_barrier()
        finally:
            jax.lax.top_k, jnp.where = top_k, where

        def loss(pp, xx):
            yy, a = M.apply_moe(pp, xx, cfg)
            return jnp.sum(yy * cot) + a
        with set_mesh_rules(mesh, {}), mesh:
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        res = {"y": y, "aux": aux, "g/x": gx}
        res.update({"g/" + k: v for k, v in gp.items() if k != "shared"})
        res.update({"g/shared/" + k: v for k, v in gp["shared"].items()})
        for d in range(dims[0]):
            for m in range(dims[1]):
                mine = [a for t, dd, mm, a in seen
                        if t == "cond" and (dd, mm) == (d, m)]
                idx = [a for t, dd, mm, a in seen
                       if t == "idx" and (dd, mm) == (d, m)]
                assert len(mine) == 3 and len(idx) == 1, (len(mine), len(idx))
                res[f"idx/{d}/{m}"] = idx[0]
                keep = mine[0] & mine[1] & mine[2]
                assert sum((c == keep).all() for c in mine) >= 2
                res[f"keep/{d}/{m}"] = keep
                res[f"mine/{d}/{m}"] = mine[0] | mine[1] | mine[2]
        np.savez(f"{out}/ref-{shape}-{cf}.npz",
                 **{k: np.asarray(v) for k, v in res.items()})
"""

PORT = CFG + """
def main(shape, factors):
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.layers import moe
    from repro_torch.parallel import (MeshShape, logical_sharding,
                                      set_mesh_rules)
    dims = tuple(int(v) for v in shape.split("x"))
    mesh = device_mesh(MeshShape(("data", "model"), dims), "cpu")
    coord = dict(zip(("data", "model"), mesh.get_coordinate()))
    data = dict(np.load(out + "/inputs.npz"))
    axes = {"x": ("act_batch", "act_seq", "act_embed"),
            "cot": ("act_batch", "act_seq", "act_embed"),
            "router": ("embed", None),
            "w_gate": ("expert", "embed", "expert_mlp"),
            "w_up": ("expert", "embed", "expert_mlp"),
            "w_down": ("expert", "expert_mlp", "embed"),
            "shared/wi_gate": ("embed", "mlp"),
            "shared/wi_up": ("embed", "mlp"),
            "shared/wo": ("mlp", "embed")}
    local = {k: torch.from_numpy(np.array(logical_sharding(
        axes.get(k, ()), v.shape, mesh).local(v))) for k, v in data.items()}
    x, cot = local.pop("x"), local.pop("cot")
    for cf in map(float, factors.split(",")):
        cfg = config(get_smoke, cf)
        p = {k: v.clone().requires_grad_(True) for k, v in local.items()
             if "/" not in k}
        p["shared"] = {k.split("/")[1]: v.clone().requires_grad_(True)
                       for k, v in local.items() if k.startswith("shared/")}
        xg = x.clone().requires_grad_(True)
        routed, route = [], moe.route

        def recorded(*a, **kw):
            r = route(*a, **kw)
            routed.append(r)
            return r
        moe.route = recorded
        before = moe.ep_all_reduces
        try:
            with set_mesh_rules(mesh):
                y, aux = moe.apply_moe(p, xg, cfg)
        finally:
            moe.route = route
        assert moe.ep_all_reduces == before + 1
        (y * cot).sum().add(aux).backward()
        r, = routed
        res = {"y": y, "aux": aux, "idx": r.idx, "keep": r.keep.reshape(-1),
               "g/x": xg.grad}
        res.update({"g/" + k: v.grad for k, v in p.items() if k != "shared"})
        res.update({"g/shared/" + k: v.grad
                    for k, v in p["shared"].items()})
        if dims == (1, 1):      # one rank: the gspmd path, bit for bit
            q = {k: (v.detach().clone().requires_grad_(True)
                     if k != "shared" else
                     {kk: vv.detach().clone().requires_grad_(True)
                      for kk, vv in v.items()}) for k, v in p.items()}
            xq = x.clone().requires_grad_(True)
            gcfg = __import__("dataclasses").replace(cfg, moe_impl="gspmd")
            y2, aux2 = moe.apply_moe(q, xq, gcfg)
            (y2 * cot).sum().add(aux2).backward()
            assert torch.equal(y, y2) and torch.equal(aux, aux2)
            assert torch.equal(xg.grad, xq.grad)
            for k in ("router", "w_gate", "w_up", "w_down"):
                assert torch.equal(p[k].grad, q[k].grad), k
            for k in p["shared"]:
                assert torch.equal(p["shared"][k].grad, q["shared"][k].grad)
            # experts split on their mlp dim (tensor parallelism) refused
            half = dict(p, w_gate=p["w_gate"][..., :16].detach())
            try:
                with set_mesh_rules(mesh):
                    moe.apply_moe(half, x, cfg)
            except ValueError as e:
                assert "expert_parallel_rules" in str(e)
            else:
                raise AssertionError("split experts were not refused")
        np.savez(f"{out}/port-{shape}-{cf}-{coord['data']}-{coord['model']}"
                 ".npz", **{k: v.detach().numpy() for k, v in res.items()})
"""


def _inputs(tmp_path: pathlib.Path) -> dict:
    """The layer and input, numpy from a seed, in the reference's scales."""
    rng = np.random.default_rng(7)
    d, f, sf, e = 64, 32, 64, 16
    arrays = {
        "router": rng.normal(0, 1, (d, e)) / np.sqrt(d),
        "w_gate": rng.normal(0, 1, (e, d, f)) / np.sqrt(d),
        "w_up": rng.normal(0, 1, (e, d, f)) / np.sqrt(d),
        "w_down": rng.normal(0, 1, (e, f, d)) / np.sqrt(f),
        "shared/wi_gate": rng.normal(0, 1, (d, sf)) / np.sqrt(d),
        "shared/wi_up": rng.normal(0, 1, (d, sf)) / np.sqrt(d),
        "shared/wo": rng.normal(0, 1, (sf, d)) / np.sqrt(sf),
        "x": rng.normal(0, 1, (BATCH, SEQ, d)),
        "cot": rng.normal(0, 1, (BATCH, SEQ, d)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    np.savez(tmp_path / "inputs.npz", **arrays)
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's results of every mesh and factor."""
    out = tmp_path_factory.mktemp("moe_parallel")
    _inputs(out)
    factors = ",".join(map(str, FACTORS))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(out), ",".join(MESHES),
         factors], cwd=REPO, env={**os.environ, "PYTHONPATH": str(
            REPO / "src")}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        for shape in MESHES:
            run_ranks(PORT, 4, out, shape, factors)
        run_ranks(PORT, 1, out, "1x1", factors)
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return out


def _load(out, shape, cf):
    dims = tuple(int(v) for v in shape.split("x"))
    ref = dict(np.load(out / f"ref-{shape}-{cf}.npz"))
    port = {(d, m): dict(np.load(out / f"port-{shape}-{cf}-{d}-{m}.npz"))
            for d in range(dims[0]) for m in range(dims[1])}
    return dims, ref, port


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES)
def test_routing_is_the_references_rank_for_rank(runs, shape, cf):
    dims, ref, port = _load(runs, shape, cf)
    dropped = 0
    for (d, m), got in port.items():
        assert np.array_equal(got["idx"], ref[f"idx/{d}/{m}"]), (d, m)
        assert np.array_equal(got["keep"], ref[f"keep/{d}/{m}"]), (d, m)
        dropped += int(ref[f"mine/{d}/{m}"].sum() - ref[f"keep/{d}/{m}"].sum())
    assert dropped == DROPPED.get((shape, cf), 0)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES)
def test_output_and_aux_match(runs, shape, cf):
    dims, ref, port = _load(runs, shape, cf)
    rows = BATCH // dims[0]
    for (d, m), got in port.items():
        _close(got["y"], ref["y"][d * rows:(d + 1) * rows], ("y", d, m))
        _close(got["aux"], ref["aux"], ("aux", d, m))


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("shape", MESHES)
def test_every_gradient_matches(runs, shape, cf):
    """``x``'s gradient on each rank is its slice of the reference's; the
    router's, summed over the batch ranks, the reference's on every model
    rank; a model rank's experts' and its block of the shared MLP's, summed
    over the batch ranks, their slices."""
    dims, ref, port = _load(runs, shape, cf)
    rows, e_loc = BATCH // dims[0], 16 // dims[1]
    names = [k for k in ref if k.startswith("g/")]
    assert len(names) == 8
    for m in range(dims[1]):
        for k in names:
            if k == "g/x":
                for d in range(dims[0]):
                    _close(port[d, m][k], ref[k][d * rows:(d + 1) * rows],
                           (k, d, m))
                continue
            got = sum(port[d, m][k] for d in range(dims[0]))
            want = ref[k]
            if k in ("g/w_gate", "g/w_up", "g/w_down"):
                want = want[m * e_loc:(m + 1) * e_loc]
            if k.startswith("g/shared/"):       # the mlp dim over model
                f = 64 // dims[1]
                want = (want[m * f:(m + 1) * f] if k.endswith("wo")
                        else want[:, m * f:(m + 1) * f])
            _close(got, want, (k, m))


def test_one_rank_is_the_gspmd_path(runs):
    """The (1, 1) run asserted bit equality in the rank itself; its files
    say it ran both factors."""
    for cf in FACTORS:
        assert (runs / f"port-1x1-{cf}-0-0.npz").exists()


# ------------------------------------------------------ the whole model ----

MODEL_CFG = """
import dataclasses
def model_config(get_smoke):
    return dataclasses.replace(
        get_smoke("qwen2-moe-a2.7b"), n_experts=8, moe_impl="shard_map",
        dtype="float32")
"""

MODEL_REFERENCE = MODEL_CFG + """
import functools, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_smoke
from repro.models import Model
from repro.models.steps import loss_fn
from repro.parallel.sharding import set_mesh_rules

out = sys.argv[1]
data = dict(np.load(out + "/model-inputs.npz"))
batch = {k: jnp.asarray(data.pop(k)) for k in ("tokens", "labels")}
params = {}
for k, v in data.items():
    *path, leaf = k.split("/")
    node = params
    for part in path:
        node = node.setdefault(part, {})
    node[leaf] = jnp.asarray(v)
model = Model(model_config(get_smoke))
for shape in sys.argv[2].split(","):
    dims = tuple(int(v) for v in shape.split("x"))
    mesh = jax.make_mesh(dims, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with set_mesh_rules(mesh, {}), mesh:
        x, aux = jax.jit(model.forward)(params, batch)
        loss, grads = jax.jit(jax.value_and_grad(
            functools.partial(loss_fn, model)))(params, batch)
    res = {"x": x, "aux": aux, "loss": loss}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        res["g/" + "/".join(p.key for p in path)] = g
    np.savez(f"{out}/model-ref-{shape}.npz",
             **{k: np.asarray(v) for k, v in res.items()})
"""

MODEL_PORT = MODEL_CFG + """
def flat(tree, prefix):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for kk, vv in items
                for k, v in flat(vv, f"{prefix}/{kk}").items()}
    return {prefix: tree}


def main(shape):
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.convert import (lm_arrays_from_params,
                                     lm_params_from_arrays)
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.layers import moe
    from repro_torch.models import Model
    from repro_torch.models.steps import (AUX_COEF, chunked_ce_loss,
                                          loss_and_grad)
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import (LOGICAL_RULES, MeshShape,
                                      expert_parallel_rules, set_mesh_rules,
                                      shard_tree, tree_shardings)
    dims = tuple(int(v) for v in shape.split("x"))
    mesh = device_mesh(MeshShape(("data", "model"), dims), "cpu")
    d, m = mesh.get_coordinate()
    cfg = model_config(get_smoke)
    model = Model(cfg)
    data = dict(np.load(out + "/model-inputs.npz"))
    rows = slice(d * data["tokens"].shape[0] // dims[0],
                 (d + 1) * data["tokens"].shape[0] // dims[0])
    batch = {k: torch.from_numpy(data.pop(k)[rows])
             for k in ("tokens", "labels")}
    tree = {}
    for k, v in data.items():
        *path, leaf = k.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    params = lm_params_from_arrays(cfg, tree, device="cpu")
    _, axes = model.init_with_axes(device="meta")
    over = expert_parallel_rules()
    sh = tree_shardings(params, axes, mesh, dict(LOGICAL_RULES, **over))
    split = {k: s.spec for k, s in flat(sh, "").items() if s.spec}
    assert split == {f"/seg0/blk0/{i}/mlp/{w}": ("model",)
                     for i in range(cfg.n_layers)
                     for w in ("w_gate", "w_up", "w_down")}, split
    local = shard_tree(params, sh, device="cpu")
    ts = leaves(local)
    for t in ts:
        t.requires_grad_(True)
    before = moe.ep_all_reduces
    with set_mesh_rules(mesh, over):
        x, aux = model.forward(local, batch)
        ce = chunked_ce_loss(model, local, x, batch["labels"])
    assert moe.ep_all_reduces == before + cfg.n_layers
    # this rank's share of the batch mean, plus the replicated aux once
    (ce / dims[0] + AUX_COEF * aux).backward()
    grads = [t.grad for t in ts]
    for t in ts:
        t.grad = None
        t.requires_grad_(False)
    if dims[0] == 1:        # one batch rank: loss_and_grad's, bit for bit
        with set_mesh_rules(mesh, over):
            loss, want = loss_and_grad(model, local, batch)
        assert float(loss) == float(ce + AUX_COEF * aux)
        assert all(torch.equal(g, w) for g, w in zip(grads, want))
    it = iter(grads)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [fill(v) for v in t]
        return next(it)
    res = {"x": x.detach().numpy(), "aux": aux.detach().numpy(),
           "ce": ce.detach().numpy()}
    res.update({"g" + k: v for k, v in flat(lm_arrays_from_params(
        cfg, fill(local)), "").items()})
    np.savez(f"{out}/model-port-{shape}-{d}-{m}.npz", **res)
"""


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    """The reference model's and the port's results on every mesh, from
    the port's parameters (drawn from a seed) and a numpy batch."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_arrays_from_params
    from repro_torch.models import Model
    out = tmp_path_factory.mktemp("model_parallel")
    ns = {}
    exec(MODEL_CFG, ns)
    cfg = ns["model_config"](get_smoke)
    torch.manual_seed(0)
    tree = lm_arrays_from_params(cfg, Model(cfg).init(11, device="cpu"))
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v
    walk(tree, "")
    rng = np.random.default_rng(11)
    for k in ("tokens", "labels"):
        flat[k] = rng.integers(0, cfg.vocab, (BATCH, 32)).astype(np.int32)
    np.savez(out / "model-inputs.npz", **flat)
    ref = subprocess.Popen(
        [sys.executable, "-c", MODEL_REFERENCE, str(out), ",".join(MESHES)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for shape in MESHES:
            run_ranks(MODEL_PORT, 4, out, shape)
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_model_forward_over_the_mesh_matches(model_runs, shape):
    dims = tuple(int(v) for v in shape.split("x"))
    ref = dict(np.load(model_runs / f"model-ref-{shape}.npz"))
    rows = BATCH // dims[0]
    ce = []
    for d in range(dims[0]):
        for m in range(dims[1]):
            got = dict(np.load(model_runs / f"model-port-{shape}-{d}-{m}.npz"))
            want = ref["x"][d * rows:(d + 1) * rows]
            err = float(np.abs(got["x"] - want).max())
            assert err <= 1e-4 * float(np.abs(want).max()), (d, m, err)
            np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-4,
                                       atol=1e-4)
            ce.append(float(got["ce"]))
        # every model rank of a batch slice computes the same loss
        assert len(set(ce[-dims[1]:])) == 1, ce
    from repro_torch.models.steps import AUX_COEF
    loss = sum(ce[::dims[1]]) / dims[0] + AUX_COEF * float(ref["aux"])
    np.testing.assert_allclose(loss, float(ref["loss"]), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", MESHES)
def test_model_gradients_over_the_mesh_match(model_runs, shape):
    """Each parameter's gradient summed over the batch ranks is the
    reference's on every model rank; the experts' is their slice."""
    dims = tuple(int(v) for v in shape.split("x"))
    ref = dict(np.load(model_runs / f"model-ref-{shape}.npz"))
    port = {(d, m): dict(np.load(
        model_runs / f"model-port-{shape}-{d}-{m}.npz"))
        for d in range(dims[0]) for m in range(dims[1])}
    names = [k for k in ref if k.startswith("g/")]
    assert sorted(names) == sorted(k for k in port[0, 0] if k.startswith(
        "g/")) and len(names) > 10
    e_loc = 16 // dims[1]
    for m in range(dims[1]):
        for k in names:
            got = sum(port[d, m][k] for d in range(dims[0]))
            want = ref[k]
            if k.rsplit("/", 1)[1] in ("w_gate", "w_up", "w_down"):
                want = want[:, m * e_loc:(m + 1) * e_loc]
            err = float(np.abs(got - want).max())
            assert got.shape == want.shape and err <= 1e-3 * float(
                np.abs(want).max()), (k, m, err)
