"""The port's planners (``repro_torch.launch.analytic``, ``specs``,
``dryrun``, ``sweep``) against the reference's and against hand counts.

* ``analytic_flops`` and ``analytic_memory_bytes`` equal the reference's
  exactly for every (arch, shape) of the registry.
* ``input_specs``' global shapes and dtypes equal the reference's
  ``ShapeDtypeStruct``s for every supported cell; each meta block is its
  sharding's ``shard_shape`` on the production (16, 16) mesh.
* The dry run's tools: ``StepCounter``'s peak equals a hand count on a
  short sequence with a freed temporary, arguments included; K5's meta
  FLOP formula, as ``FlopCounterMode`` counts it, equals an explicit count
  of the tiles each kernel computes, causal and not; the collective log of
  a smoke prefill traced on a fake (2, 2) mesh counts the layout's
  collectives one by one.
* The command line: ``python -m repro_torch.launch.dryrun --arch
  hubert-xlarge --shape train_4k --out <tmp>`` traces the cell on the
  16x16 fake mesh, prints ``memory:`` and writes its record (about 30 s
  on an idle 8-core host; a 120 s timeout of its own); an MLA, an RWKV6
  and an RG-LRU cell on the 2x16x16 mesh trace too (the MLA prefill about
  20 s), and their collectives are counted layer by layer: the
  row-parallel reduces, the expert-parallel MoE's and its aux loss's batch
  means, RWKV's gathered receptance, the RG-LRU's gate reduce-scatter and
  the ring's log-sum-exp combine.
* Every registry config, with and without its production overrides, has
  its parameter shardings under the production rules on (16, 16) and
  (2, 16, 16) (``Model.shardings``); a smoke MoE traced on a fake (2, 2)
  mesh with ``moe_impl="gspmd"`` counts the gspmd body's collectives.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.launch import analytic as r_analytic
from repro.launch.specs import input_specs as r_input_specs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.registry import shape_supported
from repro_torch.kernels.flash_attention import KERNEL_TILES, tile_flops
from repro_torch.launch import analytic
from repro_torch.launch.dryrun import StepCounter, cell_rules
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.specs import TensorSpec, input_specs
from repro_torch.launch.sweep import cell_list
from test_torch_parallel import REPO

PAIRS = [(a, s) for a in ARCH_IDS for s in SHAPES]
SUPPORTED = [(a, s) for a, s in PAIRS
             if shape_supported(get_config(a), SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_analytic_model_matches_reference(arch, shape):
    from repro.configs import SHAPES as R_SHAPES
    cfg, rcfg = get_config(arch), r_get_config(arch)
    assert analytic.analytic_flops(cfg, SHAPES[shape]) == \
        r_analytic.analytic_flops(rcfg, R_SHAPES[shape])
    for n_data, n_model in ((16, 16), (32, 16), (4, 2)):
        assert analytic.analytic_memory_bytes(
            cfg, SHAPES[shape], n_data=n_data, n_model=n_model) == \
            r_analytic.analytic_memory_bytes(
                rcfg, R_SHAPES[shape], n_data=n_data, n_model=n_model)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                            TensorSpec):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,shape", SUPPORTED)
def test_input_specs_match_reference(arch, shape):
    from repro.configs import SHAPES as R_SHAPES
    cfg = get_config(arch)
    mesh = production_mesh_shape()
    rules, _ = cell_rules(cfg, mesh)
    want = dict(_flat(r_input_specs(r_get_config(arch), R_SHAPES[shape])))
    got = dict(_flat(input_specs(cfg, SHAPES[shape], mesh, rules)))
    assert sorted(got) == sorted(want)
    for k, spec in got.items():
        assert spec.shape == tuple(want[k].shape), k
        assert str(spec.dtype).split(".")[1] == str(want[k].dtype), k
        assert spec.local.device.type == "meta"
        assert tuple(spec.local.shape) == spec.sharding.shard_shape(
            spec.shape), k


def test_step_counter_peak_is_a_hand_count():
    """Arguments of 400 + 40 bytes; then a [10, 10] float32 product (400),
    a temporary that dies with its statement, and the live result."""
    a = torch.empty(10, 10, device="meta")
    b = torch.empty(10, device="meta")
    c = StepCounter()
    assert c.track([a, b, a]) == 440                    # a counted once
    with c:
        y = a @ a                                       # 440 + 400
        z = (y * 2).sum(0)                              # + 400 temp, + 40
        del y                                           # the temporary went
        w = a.view(100)                                 # a view: no bytes
        u = a + b                                       # + 400
    assert c.peak == 440 + 400 + 400 + 40
    assert c.current == 440 + 40 + 400
    assert w.untyped_storage()._cdata == a.untyped_storage()._cdata
    del z, u
    assert c.current == 440
    assert c.flops == 2 * 10 * 10 * 10


TILE_CASES = [(1, 300, 300, 8, 64, True), (2, 1000, 1000, 4, 128, True),
              (1, 256, 256, 2, 80, False), (3, 129, 513, 6, 32, False),
              (1, 64, 64, 1, 16, True), (2, 200, 500, 3, 96, True)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,skv,h,d,causal", TILE_CASES)
def test_k5_meta_flops_count_the_kernels_tiles(b, sq, skv, h, d, causal,
                                               dtype):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    q = torch.empty(b, sq, h, d, dtype=dtype, device="meta")
    k = torch.empty(b, skv, max(h // 2, 1), d, dtype=dtype, device="meta")
    with FlopCounterMode(display=False) as fc:
        out = flash_attention_fwd(q, k, k, causal=causal)
    assert out.shape == q.shape and out.device.type == "meta"
    bm, bn = KERNEL_TILES[dtype]
    tiles = 0                       # every (query block, key tile) computed
    for q0 in range(0, sq, bm):
        for k0 in range(0, skv, bn):
            if causal and k0 > min(q0 + bm, sq) - 1:
                continue            # past the block's last visible key
            tiles += 1
    want = tiles * 4 * bm * bn * d * b * h
    assert fc.get_total_flops() == want == tile_flops(b, sq, skv, h, d,
                                                      causal, dtype)


TRACE = """
import dataclasses, json, sys
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import cell_rules, fake_mesh, trace_cell
from repro_torch.parallel import MeshShape
cfg = dataclasses.replace(get_smoke("phi3-mini-3.8b"), n_layers=3)
shape = MeshShape(("data", "model"), (2, 2))
rules, over = cell_rules(cfg, shape)
with fake_mesh(shape, rank=3) as mesh:
    print(json.dumps(trace_cell(cfg, ShapeConfig("s", 64, 4, "prefill"),
                                mesh, rules, over)))
"""


def test_trace_logs_the_layouts_collectives():
    """A three-layer smoke prefill on rank 3 of a fake (2, 2) mesh: the
    vocab-parallel embedding's all-reduce, one after each layer's attention
    and MLP, and the logits' gather over ``model``."""
    r = subprocess.run([sys.executable, "-c", TRACE], cwd=REPO,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    coll = rec["collectives"]
    assert coll["all-reduce"]["count"] == 1 + 2 * 3
    # [2 rows, 64 tokens, 64 wide] bf16 a reduce
    assert coll["all-reduce"]["bytes"] == 7 * 2 * 64 * 64 * 2
    assert coll["all-gather"] == {"count": 1, "bytes": 2 * 512 * 2}
    assert coll["reduce-scatter"]["count"] == 0
    mem = rec["memory"]
    assert mem["peak_bytes"] > mem["argument_size_in_bytes"] > 0
    assert rec["flops"] > 0 and rec["bytes"] > 0


def _dryrun(tmp_path, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(tmp_path)], cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=timeout)


def test_dryrun_cell_subprocess(tmp_path):
    r = _dryrun(tmp_path, "--arch", "hubert-xlarge", "--shape", "train_4k")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "memory:" in r.stdout
    rec = json.loads((tmp_path / "hubert-xlarge__train_4k__16x16.json"
                      ).read_text())
    assert rec["step"] == "traced" and rec["ranks"] == 256
    assert rec["flops"] > 0 and rec["bytes"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] == mem["peak_bytes"] - mem["held_bytes"]
    assert rec["collectives"]["all-reduce"]["count"] > 0


def _layers(arch):
    cfg = get_config(arch)
    return [cfg.layer_kind(i) for i in range(cfg.n_layers)]


def _deepseek_prefill(coll):
    """deepseek-v2's prefill: the vocab-parallel embedding's reduce, each
    layer's attention and MLP (the dense layer 0) or expert-parallel MoE
    reduce over ``model``, and each MoE layer's aux means averaged over
    ``pod`` and ``data``; FSDP's gathers and the logits' gather."""
    kinds = _layers("deepseek-v2-236b")
    moe = sum(m == "moe" for _, m in kinds)
    assert coll["all-reduce"]["count"] == 1 + 2 * len(kinds) + 2 * moe
    assert coll["all-gather"]["count"] > len(kinds)
    assert coll["reduce-scatter"]["count"] == 0


def _rwkv_decode(coll):
    """rwkv6's decode (no FSDP): the embedding's reduce, each time mix's
    and channel mix's reduce, each channel mix's gathered receptance and
    the logits' gather."""
    n = len(_layers("rwkv6-1.6b"))
    assert coll["all-reduce"]["count"] == 1 + 2 * n
    assert coll["all-gather"]["count"] == n + 1
    assert coll["reduce-scatter"]["count"] == 0


def _griffin_decode(coll):
    """recurrentgemma's decode: the embedding's reduce, each mixer's and
    MLP's reduce, the ring's three combining reduces (its one kv head on
    16 model ranks: split by ring slots), and each RG-LRU's gate
    reduce-scatter."""
    kinds = _layers("recurrentgemma-9b")
    rings = sum(k == "wattn" for k, _ in kinds)
    rglru = sum(k == "rglru" for k, _ in kinds)
    assert coll["all-reduce"]["count"] == 1 + 2 * len(kinds) + 3 * rings
    assert coll["reduce-scatter"]["count"] == rglru
    assert coll["all-gather"]["count"] > rings


@pytest.mark.parametrize("arch,shape,counts", [
    ("deepseek-v2-236b", "prefill_32k", _deepseek_prefill),
    ("rwkv6-1.6b", "long_500k", _rwkv_decode),
    ("recurrentgemma-9b", "decode_32k", _griffin_decode)])
def test_mla_rwkv_rglru_cells_trace(tmp_path, arch, shape, counts):
    r = _dryrun(tmp_path, "--arch", arch, "--shape", shape, "--multi-pod")
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / f"{arch}__{shape}__2x16x16.json"
                      ).read_text())
    assert rec["step"] == "traced" and rec["ranks"] == 512
    assert rec["flops"] > 0 and rec["bytes"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] == \
        rec["state"]["argument_size_in_bytes"] > 0
    counts(rec["collectives"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_has_its_layout(arch):
    """``Model.shardings`` under the production rules (with FSDP's where
    the config sets it) on both production meshes, with and without the
    arch's production overrides: every leaf gets a sharding, and at least
    one is split over ``model``."""
    from repro_torch.models import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel.collectives import Layout
    for production in (False, True):
        cfg = get_config(arch, production=production)
        for multi in (False, True):
            mesh = production_mesh_shape(multi_pod=multi)
            rules, _ = cell_rules(cfg, mesh)
            sh = leaves(Model(cfg).shardings(Layout(mesh, rules)))
            assert sh and all(s.spec is not None for s in sh)
            assert any("model" in str(s.spec) for s in sh), (arch, multi)


GSPMD = """
import dataclasses, json
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import cell_rules, fake_mesh, trace_cell
from repro_torch.parallel import MeshShape
cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), moe_impl="gspmd")
shape = MeshShape(("data", "model"), (2, 2))
rules, over = cell_rules(cfg, shape)
with fake_mesh(shape, rank=1) as mesh:
    print(json.dumps(trace_cell(cfg, ShapeConfig("s", 64, 4, "prefill"),
                                mesh, rules, over)))
"""


def test_gspmd_moe_traces_over_ranks():
    """qwen2-moe's smoke prefill with the gspmd MoE on rank 1 of a fake
    (2, 2) mesh: per MoE layer one all-gather of the rank's experts' pair
    counts over ``data`` (the offsets of the global capacity count), the
    aux means' reduce over ``data`` and the combine's reduce over
    ``model``; the attention's reduce and the embedding's; the logits'
    gather."""
    r = subprocess.run([sys.executable, "-c", GSPMD], cwd=REPO,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-3000:]
    coll = json.loads(r.stdout.strip().splitlines()[-1])["collectives"]
    from repro_torch.configs import get_smoke
    n = get_smoke("qwen2-moe-a2.7b").n_layers
    assert coll["all-gather"]["count"] == n + 1
    # [8 local experts] int64 counts from each of the 2 data ranks, and
    # the [2 rows, 512 vocab] bf16 logits
    assert coll["all-gather"]["bytes"] == n * 2 * 8 * 8 + 2 * 512 * 2
    assert coll["all-reduce"]["count"] == 1 + 3 * n


def test_sweep_cells():
    """Every supported cell on both meshes, all traced: the ten families'
    20 + 11 (arch, shape) cells, on (16, 16) and (2, 16, 16)."""
    cells = cell_list()
    assert len(cells) == 2 * len(SUPPORTED) == 62
    assert {c[1] for c in cells} == set(ARCH_IDS)
    assert [c[0] for c in cells] == sorted(c[0] for c in cells)


def test_only_the_dry_run_starts_the_fake_group():
    src = REPO / "src" / "repro_torch"
    users = sorted(str(p.relative_to(src)) for p in src.rglob("*.py")
                   if "fake_pg" in p.read_text())
    assert users == [os.path.join("launch", "dryrun.py")]
    for p in list(src.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = p.read_text()
        assert "import jax" not in text and "from repro." not in text \
            and "import repro\n" not in text, p
