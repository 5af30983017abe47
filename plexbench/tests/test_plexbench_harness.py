"""The harness on the CPU: it finds what a cell names by file, prints the
contract's keys, agrees with the plain reference at 1M keys, and loads
neither JAX nor the JAX package."""
import io
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import ROOT
from plexbench import harness

SEED = (1 << 31) + 12345     # a seed past 32 signed bits
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "checks"]


def run(root, workload, *, seconds=1.0, trace=False, **kw):
    return harness.run_cell(root, workload, SEED, seconds, trace,
                            device="cpu", log=io.StringIO(), **kw)


@pytest.mark.parametrize("workload", ["osm-uniform"])
def test_cell_runs_correct_with_the_contract_keys(small_root, workload):
    res = run(small_root, workload)
    assert list(res) == CONTRACT_KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"lookups_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert res["checks"]["wrong_answers"] == {"value": 0, "limit": 0,
                                              "rule": "<="}
    assert res["checks"]["checked_requests"]["value"] >= 2


def test_reference_agrees_with_the_service_at_1m_keys(small_root):
    """Every answer of whole requests, through ``submit``, equals the
    reference's, absent and edge keys among them; and the same seed draws
    the same keys and pool."""
    from repro_torch.serving import PlexService
    bench = harness.Bench(small_root)
    cfg = bench.config("sosd-osm-200m")
    assert cfg["n_keys"] == 1_000_000
    mix = dict(bench.mix("sosd-lookups"), absent_share=0.1)
    ref = bench.module("references", cfg["reference"])
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(SEED)
        kb = bench.module("keygen", cfg["keys"]).generate(
            cfg["n_keys"], gen, torch.device("cpu"))
        load = bench.module("generators", mix["generator"]).make(
            mix, kb, SEED, gen)
        keys = kb.bitwise_xor_(harness.BIAS).numpy().view(np.uint64)
        draws.append((keys.copy(), load.pool.copy()))
    assert np.array_equal(draws[0][0], draws[1][0])
    assert np.array_equal(draws[0][1], draws[1][1])
    assert np.all(keys[1:] >= keys[:-1]) and keys.size == 1_000_000
    pool = load.pool
    assert {0, (1 << 64) - 1} <= set(pool[:1 << 17].tolist())
    svc = PlexService(keys, device="cpu", **cfg["service"])
    try:
        for off, size in ((0, 5000), (70_000, 20_000), (pool.size - 9000,
                                                       9000)):
            q = pool[off:off + size]
            got = svc.submit(q).result(60)
            assert np.array_equal(got, ref.ranks(keys, q))
            assert np.array_equal(got, np.searchsorted(keys, q, "left"))
    finally:
        svc.close()


def test_new_config_mix_and_metric_are_found_by_file(small_root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus new entries of BENCHMARK.json, with no file edited."""
    pb = small_root / "plexbench"
    (pb / "keygen" / "dense.py").write_text(textwrap.dedent('''
        import torch
        def generate(n, gen, device):
            k = torch.arange(n, dtype=torch.int64, device=device) * 3
            return k.bitwise_xor_(-(1 << 63))
    '''))
    cfg = json.loads((pb / "configs" / "sosd-osm-200m.json").read_text())
    cfg.update(name="dense-test", keys="dense", n_keys=300_000)
    (pb / "configs" / "dense-test.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "sosd-lookups.json").read_text())
    mix.update(clients=3, size_min=256, size_max=512, size_steps=4)
    (pb / "traffic" / "small-3c.json").write_text(json.dumps(mix))
    (pb / "metrics" / "mean_size.py").write_text(textwrap.dedent('''
        def read(run):
            return float(run.requests["size"].mean())
    '''))
    (pb / "metrics" / "never_read.py").write_text(
        "def read(run):\n    return None\n")
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dense-test", "source": "a test",
                            "file": "plexbench/configs/dense-test.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dense-small", "config": "dense-test",
                              "traffic": "small-3c", "chips": 1,
                              "why": "a test"})
    spec["per_layer"] += [
        {"name": "mean_size", "unit": "lookups", "better": "higher",
         "source": "host_clock", "layer": "test", "moves": "lookups_per_s",
         "workloads": ["dense-small"]},
        {"name": "never_read", "unit": "s", "better": "lower",
         "source": "host_clock", "layer": "test", "moves": "lookups_per_s"}]
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run(small_root, "dense-small", trace=True)
    assert res["correct"] is True
    assert 256 <= res["metrics"]["mean_size"]["value"] <= 512
    # one that finds nothing is left out, and one that names other cells
    # is not read in this one
    assert set(res["metrics"]) == {"mean_size"}


def test_a_trace_run_on_the_cpu_reads_no_device_metric(small_root):
    res = run(small_root, "osm-uniform", trace=True)
    assert res["correct"] is True
    assert "breakdown" not in res
    assert not {"lookup_roofline", "device_idle_pct"} & set(res["metrics"])
    assert 0 <= res["metrics"]["cache_hit_pct"]["value"] <= 100


def test_no_jax_and_no_reference_package_after_a_run(small_root):
    """``plexbench/run.py`` imported and a whole run made in a fresh
    process: no module whose top-level name is jax, jaxlib, flax or repro
    (the port's name begins with the reference's, so names are compared
    whole)."""
    code = textwrap.dedent(f'''
        import io, runpy, sys
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
        runpy.run_path({str(ROOT / "plexbench" / "run.py")!r})
        from plexbench import harness
        res = harness.run_cell({str(small_root)!r}, "osm-uniform", 7, 0.5,
                               False, device="cpu", log=io.StringIO())
        assert res["correct"], res
        assert "repro_torch" in sys.modules
        print(harness.forbidden_modules())
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=small_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "reproducible_test_mod", object())
    monkeypatch.setitem(sys.modules, "repro.core.fake_test_mod", object())
    found = harness.forbidden_modules()
    assert "repro.core.fake_test_mod" in found
    assert "reproducible_test_mod" not in found
    assert not [m for m in found if m.startswith("repro_torch")]


def test_the_command_prints_no_result_without_a_card(tmp_path):
    """On the CPU the command exits non-zero with nothing on stdout."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "plexbench" / "run.py"), "--workload",
         "osm-uniform", "--seed", str(SEED), "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and plexbench/, the
    command finds no system under test and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "plexbench", tmp_path / "plexbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "plexbench/run.py", "--workload", "osm-uniform",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["osm-uniform"])
def test_the_command_on_the_card(card, workload):
    """One short run of each cell through the command, on the card."""
    out = subprocess.run(
        [sys.executable, "plexbench/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", "5", "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res) == CONTRACT_KEYS[:5] + ["breakdown", "checks"]
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"] * 1.01
