"""``correct`` comes out false when the timed path is broken underneath,
and when the control (the reference at 32-bit key width) answers in the
service's place; on the CPU at small sizes, on the cell's fused path."""
import io
import json

import pytest
import torch

from plexbench import control, harness
from repro_torch.kernels import stacked_lookup as SL

SEED = 424242


@pytest.fixture(params=["osm-uniform"])
def cell(request, small_root):
    return small_root, request.param


def run(root, workload, **kw):
    log = io.StringIO()
    res = harness.run_cell(root, workload, SEED, 1.0, False, device="cpu",
                           log=log, **kw)
    return res, json.loads(log.getvalue().splitlines()[-1])


def test_each_cell_takes_its_path(cell):
    root, workload = cell
    res, info = run(root, workload)
    assert res["correct"] is True
    assert info["path"] == {"osm-uniform": "fused"}[workload]


def _broken(fault):
    real = SL.stacked_lookup

    def lookup(sp, probe, q, *args, **kwargs):
        out, sid, base = real(sp, probe, q, *args, **kwargs)
        out = out.clone()
        if fault == "answer_altered":
            out[out.numel() // 3] += 1
        else:                       # half of the batch left out
            out[out.numel() // 2:] = 0
        return out, sid, base
    return lookup


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_a_broken_kernel_is_not_correct(cell, monkeypatch, fault):
    root, workload = cell
    monkeypatch.setattr(SL, "stacked_lookup", _broken(fault))
    res, _ = run(root, workload)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0
    assert res["checks"]["failed_requests"]["value"] == 0


class _Flaky:
    """The service, with every third request of the window raising (the
    warm-up's requests go through)."""

    def __init__(self, keys, config, device):
        self.svc = harness.plex_service(keys, config, device)
        self.n = 0
        self.armed = False

    def warmup(self):
        self.svc.warmup()

    def submit(self, q):
        self.n += 1
        if self.armed and self.n % 3 == 0:
            raise RuntimeError("injected failure")
        return self.svc.submit(q)

    def close(self):
        self.svc.close()


def test_a_failing_request_is_not_correct(small_root):
    made = []

    def factory(keys, config, device):
        made.append(_Flaky(keys, config, device))
        return made[-1]

    real_start = harness.Sampler.__init__

    def arm(self, *args):
        made[-1].armed = True       # the sampler is made as the window opens
        real_start(self, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness.Sampler, "__init__", arm)
        res, _ = run(small_root, "osm-uniform", service_factory=factory)
    assert res["correct"] is False
    assert res["failed"] > 0
    assert res["checks"]["failed_requests"]["value"] == res["failed"]
    assert res["checks"]["wrong_answers"]["value"] == 0


def test_the_control_is_not_correct(cell):
    root, workload = cell
    bench = harness.Bench(root)
    res, info = run(root, workload, service_factory=control.factory(bench))
    assert info["path"] == "Narrowed"
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0
    assert res["checks"]["failed_requests"]["value"] == 0


def test_the_control_keeps_the_reference_on_distinct_high_words():
    """Narrowing alone makes the control wrong: where every key has its own
    high word and the queries are keys, it answers exactly."""
    import numpy as np
    from plexbench.references import lower_bound
    keys = (np.arange(1000, dtype=np.uint64) << np.uint64(32)) | np.uint64(7)
    c = control.Narrowed(keys, lower_bound.ranks)
    q = keys[::7]
    assert np.array_equal(c.submit(q).result(), lower_bound.ranks(keys, q))
    q = keys[::7] + np.uint64(1)      # between keys of one high word
    assert not np.array_equal(c.submit(q).result(),
                              lower_bound.ranks(keys, q))


def test_the_harness_runs_on_the_cpu_only_when_asked():
    """The CLI's path asks for the card; without one it raises NoDevice."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from conftest import ROOT
    with pytest.raises(harness.NoDevice):
        harness.run_cell(ROOT, "osm-uniform", SEED, 1.0, False,
                         log=io.StringIO())
