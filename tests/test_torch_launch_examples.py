"""The port's example drills (``repro_torch.launch.quickstart``,
``save_open``, ``mesh_serve``, ``chaos_drill`` and ``serve_paged``) on the
CPU at small sizes, against the reference's examples and library.

Each ``main([... "--device", "cpu"])`` must return 0 (its own assertions:
ranks equal ``np.searchsorted``, the reopened service equal to the live
one, the incident contract, the swap-in). Beside that: quickstart's tuning
equals ``repro.core.build_plex``'s on the same keys; mesh_serve's plan from
the generation's header equals ``repro.distrib.plan_from_dir``'s on that
generation; chaos_drill writes the same incident bundles, in the same
order, as ``examples/chaos_drill.py`` under the same faults.
"""
import importlib.util
import json
import pathlib
import re
import sys

import numpy as np
import pytest

import repro.distrib as RD
import repro.obs as R
from repro.core import build_plex as r_build_plex
from repro.data import generate as r_generate
from repro.obs import incident as r_incident_mod
from repro.resilience import FAULTS as RFAULTS
from repro_torch.launch import (chaos_drill, mesh_serve, quickstart,
                                save_open, serve_paged)
from repro_torch.obs import RECORDER, TRACE, METRICS
from repro_torch.obs import incident as incident_mod
from repro_torch.resilience import FAULTS

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"

# module -> small arguments on the CPU (the output directory is added)
SMALL = {
    "quickstart": (quickstart, ["--n", "50000", "--queries", "20000"]),
    "save_open": (save_open, ["--n", "50000", "--queries", "5000"]),
    "mesh_serve": (mesh_serve, ["--n", "80000", "--queries", "5000",
                                "--slots", "3"]),
    "chaos_drill": (chaos_drill, ["--n", "30000"]),
    "serve_paged": (serve_paged, ["--requests", "4", "--max-new", "4"]),
}


def _reset_all():
    for rec, inc, mets, trace in ((RECORDER, incident_mod, METRICS, TRACE),
                                  (R.RECORDER, r_incident_mod, R.METRICS,
                                   R.TRACE)):
        if rec.armed:
            rec.disarm()
        rec.clear()
        inc.uninstall()
        mets.disable()
        mets.reset()
        trace.disable()
        trace.clear()
    FAULTS.reset()
    RFAULTS.reset()


@pytest.fixture(autouse=True)
def _clean():
    _reset_all()
    yield
    _reset_all()


def _argv(name, tmp_path):
    mod, args = SMALL[name]
    out = list(args) + ["--device", "cpu"]
    if name in ("save_open", "mesh_serve", "chaos_drill"):
        out += ["--dir", str(tmp_path / name)]
    return mod, out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_launch_example_returns_zero(name, tmp_path):
    mod, argv = _argv(name, tmp_path)
    assert mod.main(argv) == 0


def test_quickstart_tuning_matches_reference(capsys):
    mod, argv = _argv("quickstart", None)
    assert mod.main(argv) == 0
    line = next(s for s in capsys.readouterr().out.splitlines()
                if s.startswith("auto-tuned radix layer:"))
    kind, r, delta = re.match(
        r"auto-tuned radix layer: (\w+) r=(\d+) delta=(\w+)", line).groups()
    t = r_build_plex(r_generate("osm", 50_000), eps=32).tuning
    assert (kind, int(r), delta) == (t.kind, t.r, str(t.delta))


def test_mesh_serve_plan_matches_reference(tmp_path, monkeypatch):
    """Every plan mesh_serve takes from a generation's header equals the
    reference's ``plan_from_dir`` on the same generation, field for
    field."""
    seen = []
    port_plan_from_dir = mesh_serve.plan_from_dir

    def both(gen_dir, n, **kw):
        plan = port_plan_from_dir(gen_dir, n, **kw)
        seen.append((plan, RD.plan_from_dir(gen_dir, n, **kw)))
        return plan
    monkeypatch.setattr(mesh_serve, "plan_from_dir", both)
    mod, argv = _argv("mesh_serve", tmp_path)
    assert mod.main(argv) == 0
    assert len(seen) == 1
    plan, ref = seen[0]
    assert plan.n_devices == ref.n_devices == 3
    for f in ("shard_start", "key_start", "active", "bound_keys", "weights"):
        assert np.array_equal(getattr(plan, f), getattr(ref, f)), f


def _bundles(root):
    return [(p.name, json.loads((p / "incident.json").read_text())["kind"])
            for p in sorted(pathlib.Path(root).iterdir())]


def test_chaos_drill_incidents_match_reference(tmp_path, monkeypatch):
    """The port's drill (its ``cuda`` outage) and the reference's example
    (its ``jnp`` outage) write the same bundles: kinds, order and
    directory names."""
    mod, argv = _argv("chaos_drill", tmp_path)
    assert mod.main(argv) == 0
    got = _bundles(tmp_path / "chaos_drill" / "incidents")
    health = json.loads(
        (tmp_path / "chaos_drill" / "chaos-health.json").read_text())
    assert list(health) == ["backend_outage", "merge_failure",
                            "commit_failure", "lkg_recovery"]
    _reset_all()
    spec = importlib.util.spec_from_file_location(
        "reference_chaos_drill", EXAMPLES / "chaos_drill.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    rdir = tmp_path / "reference"
    monkeypatch.setattr(sys, "argv", [
        "chaos_drill.py", "--n", "30000", "--dir", str(rdir / "service"),
        "--health-out", str(rdir / "health.json"),
        "--incident-dir", str(rdir / "incidents")])
    ref.main()
    want = _bundles(rdir / "incidents")
    assert got == want
    assert [k for _, k in got] == ["breaker.open", "merge.failure",
                                   "manifest.commit_failed",
                                   "generation.quarantine"]
    assert json.loads((rdir / "health.json").read_text()).keys() == \
        health.keys()
