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
  and an RG-LRU cell write the state a rank holds and say that their step
  is not traced.
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


@pytest.mark.parametrize("arch,shape,family", [
    ("deepseek-v2-236b", "prefill_32k", "MLA"),
    ("rwkv6-1.6b", "long_500k", "RWKV6"),
    ("recurrentgemma-9b", "decode_32k", "RG-LRU")])
def test_unported_layouts_record_their_state(tmp_path, arch, shape, family):
    r = _dryrun(tmp_path, "--arch", arch, "--shape", shape, "--multi-pod")
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / f"{arch}__{shape}__2x16x16.json"
                      ).read_text())
    assert rec["step"] == (f"not traced: the {family} layout is queue 1 "
                           "item 12h-2")
    assert rec["ranks"] == 512 and "flops" not in rec
    assert rec["memory"]["argument_size_in_bytes"] == \
        rec["state"]["argument_size_in_bytes"] > 0


def test_sweep_cells():
    """Every supported cell on both meshes: 40 of the seven families the
    layout runs, 22 of the three whose layout is 12h-2."""
    from repro_torch.launch.dryrun import unported_family
    cells = cell_list()
    assert len(cells) == 2 * len(SUPPORTED) == 62
    traced = [c for c in cells if unported_family(get_config(c[1])) is None]
    assert len(traced) == 40
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
