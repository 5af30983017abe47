"""The port's serving engine and PLEX page table against the reference.

``ServeEngine`` of ``repro_torch`` over the reference's parameters (carried
with ``lm_params_from_arrays``) answers ``test_system.py``'s aligned traffic
with the reference engine's tokens, exactly, and swaps the same pages;
``PageTable`` and ``PagedKVStore`` give the reference's answers under the
same operations, exactly. The late-admission test shows ROADMAP queue 3, R6:
the reference engine steps the whole batch for each position group and
overwrites the history of slots in other groups; the port steps each group
on its own slots, so every request answers as it does served alone. The
MoE configs' engines (deepseek-v2 swaps MLA's latent ``c``, qwen2-moe K and
V) answer the same traffic with the reference's tokens and pages. The
recurrent configs (rwkv6; recurrentgemma, whose ``wattn`` ring has a
window of 16) answer one aligned wave, in float32, with the reference's
tokens and swap nothing out, as the reference. Under late admission, slot
reuse and ring wrap the port answers every request as a fresh batch-1
engine does; the reference carries a retired request's recurrent state
into the next one in its slot (ROADMAP queue 3, R12), shown on rwkv6. The
launcher runs with ``--smoke --device cpu`` for the dense, MoE and
recurrent archs.
"""
import dataclasses
import importlib.util
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.models import Model as RModel
from repro.serving import ServeEngine as RServeEngine
from repro.serving.engine import Request as RRequest
from repro.serving.kv_cache import PagedKVStore as RPagedKVStore
from repro.serving.kv_cache import PageTable as RPageTable
from repro.serving.kv_cache import page_key as r_page_key
from repro_torch.configs import get_smoke
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.serving import PagedKVStore, PageTable, ServeEngine
from repro_torch.serving.engine import POSITIONAL, Request, cache_leaves
from repro_torch.serving.kv_cache import page_key


def _pair(dtype=None, seed=0, arch="minitron-4b"):
    """The reference's smoke model and params, and the port's model over
    the same params."""
    cfg = r_get_smoke(arch)
    tcfg = get_smoke(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype)
    rm = RModel(cfg)
    rparams, _ = rm.init(jax.random.PRNGKey(seed))
    tparams = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    return rm, rparams, Model(tcfg), tparams


def _serve(engine, request_cls, reqs):
    for seq_id, prompt, max_new in reqs:
        engine.submit(request_cls(seq_id=seq_id, prompt=prompt,
                                  max_new=max_new))
    return {f.seq_id: f for f in engine.run()}


def test_engine_matches_reference_on_aligned_traffic():
    """``test_system.py``'s traffic in the config's bfloat16: identical
    tokens, swapped pages and page table; the swapped KV within bfloat16's
    rounding of the tensor's scale."""
    rm, rparams, tm, tparams = _pair()
    reqs = [(i, np.arange(4) + i, 6) for i in range(4)]
    reng = RServeEngine(rm, rparams, batch_size=2, max_seq=64)
    teng = ServeEngine(tm, tparams, batch_size=2, max_seq=64, device="cpu")
    want = _serve(reng, RRequest, reqs)
    got = _serve(teng, Request, reqs)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for sid in want:
        assert np.array_equal(got[sid].tokens, want[sid].tokens), sid
        assert got[sid].swapped_pages == want[sid].swapped_pages
    assert teng.steps == reng.steps
    assert len(teng.kv_store.table) == len(reng.kv_store.table) >= 4
    kv, rkv = teng.kv_store.fetch(0, 9), reng.kv_store.fetch(0, 9)
    assert kv.shape == rkv.shape and kv.dtype == np.float32
    assert np.abs(kv - rkv).max() <= 5e-2 * np.abs(rkv).max()
    assert teng.kv_store.table.lookups > 0


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen2-moe-a2.7b"])
def test_moe_engine_matches_reference_on_aligned_traffic(arch):
    """The same traffic on the MoE configs, in their bfloat16: identical
    tokens and page counts; the swapped pages (deepseek-v2: the latent
    ``c`` of every layer, ``[T, n * kv_lora]``) of the reference's width,
    within bfloat16's rounding of the tensor's scale."""
    rm, rparams, tm, tparams = _pair(arch=arch)
    reqs = [(i, np.arange(4) + i, 6) for i in range(4)]
    reng = RServeEngine(rm, rparams, batch_size=2, max_seq=64)
    teng = ServeEngine(tm, tparams, batch_size=2, max_seq=64, device="cpu")
    want = _serve(reng, RRequest, reqs)
    got = _serve(teng, Request, reqs)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for sid in want:
        assert np.array_equal(got[sid].tokens, want[sid].tokens), sid
        assert got[sid].swapped_pages == want[sid].swapped_pages
        kv, rkv = teng.kv_store.fetch(sid, 9), reng.kv_store.fetch(sid, 9)
        assert kv.shape == rkv.shape and kv.dtype == np.float32
        assert np.abs(kv - rkv).max() <= 5e-2 * np.abs(rkv).max()
    width = (tm.cfg.kv_lora if tm.cfg.attn_type == "mla"
             else 2 * tm.cfg.n_kv_heads * tm.cfg.resolved_head_dim)
    assert kv.shape == (9, width * tm.segments[0].repeats)
    assert teng.steps == reng.steps
    assert len(teng.kv_store.table) == len(reng.kv_store.table) >= 4


def test_late_admission_keeps_other_slots_history():
    """R6: float32, batch 2; request 0 retires early, request 2 is admitted
    while request 1 is mid-sequence, and two position groups step from then
    on. The port answers every request as it does served alone; the
    reference answers request 1 otherwise."""
    rm, rparams, tm, tparams = _pair("float32")
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, 512, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(3, 2), (7, 12), (4, 6)])]

    def port_engine():
        return ServeEngine(tm, tparams, batch_size=2, max_seq=64,
                           device="cpu")

    together = _serve(port_engine(), Request, reqs)
    for req in reqs:
        alone = _serve(port_engine(), Request, [req])
        assert np.array_equal(together[req[0]].tokens,
                              alone[req[0]].tokens), req[0]
    ref = _serve(RServeEngine(rm, rparams, batch_size=2, max_seq=64),
                 RRequest, reqs)
    ref_alone = _serve(RServeEngine(rm, rparams, batch_size=2, max_seq=64),
                       RRequest, [reqs[1]])
    assert not np.array_equal(ref[1].tokens, ref_alone[1].tokens)
    assert np.array_equal(ref_alone[1].tokens, together[1].tokens)


RECURRENT = ["rwkv6-1.6b", "recurrentgemma-9b"]


def _port_engine(tm, tparams, batch_size):
    return ServeEngine(tm, tparams, batch_size=batch_size, max_seq=64,
                       device="cpu")


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engine_matches_reference_on_aligned_traffic(arch):
    """One wave of four aligned requests in four slots, float32: the
    reference's tokens and steps. No slot is reused, so R12 cannot show,
    and aligned slots share every ring position, so R13 cannot either."""
    rm, rparams, tm, tparams = _pair("float32", arch=arch)
    rng = np.random.default_rng(1)
    reqs = [(i, rng.integers(0, 512, 6).astype(np.int32), 12)
            for i in range(4)]
    reng = RServeEngine(rm, rparams, batch_size=4, max_seq=64)
    teng = _port_engine(tm, tparams, 4)
    want = _serve(reng, RRequest, reqs)
    got = _serve(teng, Request, reqs)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for sid in want:
        assert np.array_equal(got[sid].tokens, want[sid].tokens), sid
    assert teng.steps == reng.steps


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_swap_out_stores_nothing(arch):
    """A recurrent first block has no K/V or latents to page out: every
    request reports 0 pages and the page table stays empty, as the
    reference's."""
    rm, rparams, tm, tparams = _pair(arch=arch)
    reqs = [(i, np.arange(4) + i, 3) for i in range(3)]
    teng = _port_engine(tm, tparams, 2)
    got = _serve(teng, Request, reqs)
    want = _serve(RServeEngine(rm, rparams, batch_size=2, max_seq=64),
                  RRequest, reqs)
    assert [f.swapped_pages for f in got.values()] == [0, 0, 0]
    assert [f.swapped_pages for f in want.values()] == [0, 0, 0]
    assert teng._slot_kv(0, 4) is None and len(teng.kv_store.table) == 0


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_late_admission_reuse_and_wrap(arch):
    """float32, batch 2, five requests of other lengths: slots retire at
    different steps, later requests enter used slots beside sequences in
    flight, position groups split, and four sequences pass the smoke
    window of 16. Every request answers as in a fresh batch-1 port engine;
    before its first step every admitted slot's recurrent rows are zero
    and its ring row empty (R12, R13)."""
    _, _, tm, tparams = _pair("float32", arch=arch)
    rng = np.random.default_rng(2)
    reqs = [(i, rng.integers(0, 512, n).astype(np.int32), m)
            for i, (n, m) in enumerate([(3, 2), (7, 20), (4, 18), (9, 12),
                                        (2, 25)])]
    eng = _port_engine(tm, tparams, 2)
    admitted, reused = [], []
    admit = eng._admit

    def checked_admit():
        before = [s is not None for s in eng.slots]
        admit()
        for i, s in enumerate(eng.slots):
            if s is None or before[i]:
                continue
            admitted.append(i)
            reused.append(eng.steps > 0)
            for path, t in cache_leaves(eng.cache):
                if path[-1] not in POSITIONAL + ("kpos",):
                    assert not t[:, i].any(), (path, i)
            for ring in eng.ring.values():
                assert bool((ring[:, i] == -10**9).all())
    eng._admit = checked_admit
    together = _serve(eng, Request, reqs)
    assert len(admitted) == 5 and sum(reused) == 3
    window = get_smoke("recurrentgemma-9b").window
    assert sum(p.size + m > window for _, p, m in reqs) == 4
    for req in reqs:
        alone = _serve(_port_engine(tm, tparams, 1), Request, [req])
        assert np.array_equal(together[req[0]].tokens,
                              alone[req[0]].tokens), req[0]


def test_reference_engine_leaks_recurrent_state():
    """R12: rwkv6, float32, a reference engine of batch 1 serves request 1
    after request 0 in the same slot and answers it otherwise than alone;
    the port answers it as alone. This test asserts the reference's fault,
    so it fails on the day R12 is fixed."""
    rm, rparams, tm, tparams = _pair("float32", arch="rwkv6-1.6b")
    rng = np.random.default_rng(0)
    reqs = [(0, rng.integers(0, 512, 5).astype(np.int32), 4),
            (1, rng.integers(0, 512, 6).astype(np.int32), 8)]
    ref = _serve(RServeEngine(rm, rparams, batch_size=1, max_seq=64),
                 RRequest, reqs)
    ref_alone = _serve(RServeEngine(rm, rparams, batch_size=1, max_seq=64),
                       RRequest, [reqs[1]])
    port = _serve(_port_engine(tm, tparams, 1), Request, reqs)
    assert not np.array_equal(ref[1].tokens, ref_alone[1].tokens)
    assert np.array_equal(port[1].tokens, ref_alone[1].tokens)
    assert np.array_equal(port[0].tokens, ref[0].tokens)


def test_smoke_recurrent_phase_rehearses_on_cpu():
    """``chip_smoke.py``'s ``lm_recurrent`` phase on the smoke configs
    (recurrentgemma at 5 layers, a ring check of 40 tokens past its window
    of 16): both prefills launch no K5, the WKV's and the windowed
    attention's shares are measured, both float32 checks pass, and each
    engine's second wave enters used slots, checked fresh on admission.
    Each model's prefill and decode through the production layout on a
    one-rank gloo group equal the unsharded ones bit for bit, and
    recurrentgemma's decode crosses the wrap of its ring."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.phase_lm_recurrent(
        torch.device("cpu"), 0, rwkv_cfg=get_smoke("rwkv6-1.6b"),
        griffin_cfg=dataclasses.replace(get_smoke("recurrentgemma-9b"),
                                        n_layers=5),
        seq=256, prompt=16, max_new=8, ring_tokens=40)
    rw, gr = out["rwkv6"], out["recurrentgemma"]
    assert rw["k5_launches"] == gr["k5_launches"] == 0
    assert 0 < rw["wkv_share"] < 1 and 0 < gr["attention_share"] < 1
    assert rw["check"]["argmax_equal"] and gr["ring_check"]["tokens"] == 40
    for model in (rw, gr):
        assert model["serve"]["pages"] == 0
        assert model["serve"]["admissions"]["into_used_slots"] == 4
    assert gr["serve"]["admissions"]["ring_rows"] == 8
    for model in (rw, gr):
        lay = model["layout"]
        assert lay["k5_launches"] == 0 and lay["prefill_equal"]
        assert lay["hidden_equal"] and lay["logit_rows_equal"]
        assert all(d["equal"] for d in lay["decode"].values())
    ring = gr["layout"]["decode"]["ring_wrap"]
    window = get_smoke("recurrentgemma-9b").window
    assert ring["start"] < window < ring["start"] + ring["steps"]


def _table_ops(rng):
    """A run of inserts, removals and lookups that crosses several PLEX
    rebuilds (threshold 64)."""
    ops, live = [], []
    for step in range(12):
        seq = rng.integers(0, 1 << 20, 40)
        keys = page_key(seq, rng.integers(0, 16, 40))
        ops.append(("insert", keys, rng.integers(0, 1 << 30, 40)))
        live.extend(keys.tolist())
        if step % 3 == 2:
            ops.append(("remove", np.asarray(live[::5], np.uint64), None))
        probe = np.concatenate([np.asarray(live, np.uint64),
                                page_key(rng.integers(0, 1 << 20, 50), 3)])
        ops.append(("lookup", probe, None))
    return ops


def test_page_table_matches_reference():
    rng = np.random.default_rng(4)
    tt, rt = PageTable(rebuild_threshold=64), RPageTable(rebuild_threshold=64)
    for op, keys, vals in _table_ops(rng):
        if op == "insert":
            tt.insert(keys, vals)
            rt.insert(keys, vals)
        elif op == "remove":
            tt.remove(keys)
            rt.remove(keys)
        else:
            assert np.array_equal(tt.lookup(keys), rt.lookup(keys))
        assert len(tt) == len(rt)
    assert tt.rebuilds == rt.rebuilds > 2
    assert np.array_equal(tt.keys, rt.keys)
    assert np.array_equal(page_key(7, np.arange(5)),
                          r_page_key(7, np.arange(5)))


def test_paged_kv_store_matches_reference():
    rng = np.random.default_rng(5)
    ts = PagedKVStore(page_tokens=16, n_pages=64)
    rs = RPagedKVStore(page_tokens=16, n_pages=64)
    kvs = {sid: rng.normal(0, 1, (int(rng.integers(1, 80)), 12)
                           ).astype(np.float32) for sid in range(10)}
    for sid, kv in kvs.items():
        assert ts.store(sid, kv) == rs.store(sid, kv)
    for sid in (2, 5):
        ts.release(sid, kvs[sid].shape[0])
        rs.release(sid, kvs[sid].shape[0])
    assert ts.store(11, kvs[3]) == rs.store(11, kvs[3])
    assert sorted(ts.free) == sorted(rs.free)
    for sid in (0, 1, 3, 4, 6, 7, 8, 9, 11):
        n = kvs[sid if sid != 11 else 3].shape[0]
        got = ts.fetch(sid, n)
        assert np.array_equal(got, rs.fetch(sid, n))
        assert np.array_equal(got, kvs[sid if sid != 11 else 3])
    with pytest.raises(KeyError):
        ts.fetch(2, 4)
    with pytest.raises(MemoryError):
        ts.store(99, np.zeros((16 * 65, 2), np.float32))


def test_launcher_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "minitron-4b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] 3 requests, 12 tokens, .* tok/s\); page "
                     r"table: 3 pages, 0 PLEX rebuilds", out), out


@pytest.mark.parametrize("production", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen2-moe-a2.7b"])
def test_moe_launcher_runs_on_cpu(capsys, monkeypatch, arch, production):
    """The MoE archs through the launcher; ``--production`` applies the
    overrides (deepseek-v2: the absorbed MLA decode, which must run)."""
    from repro_torch.layers import mla
    absorbed = []
    orig = mla._decode_absorbed
    monkeypatch.setattr(mla, "_decode_absorbed",
                        lambda *a: absorbed.append(1) or orig(*a))
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"]
                      + (["--production"] if production else []))
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] 3 requests, 12 tokens, .* tok/s\); page "
                     r"table: 3 pages, 0 PLEX rebuilds", out), out
    assert bool(absorbed) == (production and arch == "deepseek-v2-236b")


@pytest.mark.parametrize("production", [False, True])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_launcher_runs_on_cpu(capsys, arch, production):
    """The recurrent archs through the launcher: no page is swapped out;
    ``--production`` (recurrentgemma: ``kv_replicate_to`` 16) leaves the
    ``wattn`` ring at its one KV head."""
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"]
                      + (["--production"] if production else []))
    out = capsys.readouterr().out
    assert re.search(r"\[serve\] 3 requests, 12 tokens, .* tok/s\); page "
                     r"table: 0 pages, 0 PLEX rebuilds", out), out


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = Model(get_smoke("minitron-4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tm, {}, batch_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "minitron-4b", "--smoke"])
