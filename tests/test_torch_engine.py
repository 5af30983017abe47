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
launcher runs with ``--smoke --device cpu`` for the dense and MoE archs.
"""
import dataclasses
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
from repro_torch.serving.engine import Request
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


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = Model(get_smoke("minitron-4b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tm, {}, batch_size=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--arch", "minitron-4b", "--smoke"])
