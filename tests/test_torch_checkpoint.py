"""The port's checkpoint store and manager against the reference's
(``repro.checkpoint``).

A training state (qwen2-vl's smoke parameters and AdamW moments after a
step) written by both packages gives byte-identical files: the port's
per-layer parameters and ``AdamWState`` go through
``convert.train_state_to_arrays`` into the reference's stacked layout and
names (``opt[0]``, ``opt[1]/...``). Each package opens the other's file
(point reads through its PLEX over the name hashes, ``load_pytree``), and
the port resumes from the reference's file with its exact state. Also the
port's versions of ``tests/test_substrate.py``'s store, manager and
elastic-restore tests.
"""
import dataclasses
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.checkpoint import load_pytree as r_load_pytree
from repro.checkpoint import save_pytree as r_save_pytree
from repro.checkpoint.store import StoreReader as RReader
from repro.configs import get_smoke as r_get_smoke
from repro.models import Model as RModel
from repro.models.steps import init_train_state as r_init_train_state
from repro.models.steps import make_train_step as r_make_train_step
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    read_tensor, save_pytree)
from repro_torch.checkpoint.store import StoreReader
from repro_torch.configs import get_smoke
from repro_torch.convert import (train_state_from_arrays,
                                 train_state_to_arrays)


def _reference_state():
    """The reference's (params, AdamW state) after one step, as numpy."""
    cfg = dataclasses.replace(r_get_smoke("qwen2-vl-2b"), dtype="float32")
    rm = RModel(cfg)
    params, opt, _ = r_init_train_state(rm, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (2, 16)),
                                   jnp.int32),
             "labels": jnp.asarray(rng.integers(0, cfg.vocab, (2, 16)),
                                   jnp.int32)}
    _, params, opt = jax.jit(r_make_train_step(rm, lr=1e-3))(params, opt,
                                                             batch)
    return {"params": jax.tree.map(np.asarray, params),
            "opt": jax.tree.map(np.asarray, opt)}


def test_files_are_byte_identical_and_cross_open(tmp_path):
    tcfg = dataclasses.replace(get_smoke("qwen2-vl-2b"), dtype="float32")
    ref = _reference_state()
    params, opt = train_state_from_arrays(tcfg, ref, device="cpu")
    assert isinstance(params["seg0"]["blk0"], list)     # the port's layout
    r_path, t_path = tmp_path / "ref.ckpt", tmp_path / "port.ckpt"
    r_save_pytree(r_path, ref, step=1)
    save_pytree(t_path, train_state_to_arrays(tcfg, params, opt), step=1)
    assert t_path.read_bytes() == r_path.read_bytes()
    # each package opens the other's file
    names = RReader.open(r_path).names()
    assert sorted(StoreReader.open(r_path).names()) == sorted(names)
    assert "opt[0]" in names and "opt[1]/seg0/blk0/mixer/wq" in names
    for name in names:
        np.testing.assert_array_equal(read_tensor(r_path, name),
                                      RReader.open(t_path).read(name))
    back = r_load_pytree(t_path, ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # the port resumes the reference's file with its exact state
    p2, o2 = train_state_from_arrays(tcfg, load_pytree(r_path, ref),
                                     device="cpu")
    again = train_state_to_arrays(tcfg, p2, o2)
    assert int(o2.step) == 1 and o2.step.dtype == torch.int32
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_managers_resume_each_other(tmp_path):
    """A directory written by one package's manager is resumed by the
    other's, ``LATEST`` and retention included."""
    tree = {"w": np.arange(6, dtype=np.float32), "opt": [np.int32(3)]}
    like = {"w": np.zeros(6, np.float32), "opt": [np.int32(0)]}
    RManager(tmp_path / "a", keep=2, every=1).save(4, tree)
    step, got = CheckpointManager(tmp_path / "a").restore_latest(like)
    assert step == 4 and np.array_equal(got["w"], tree["w"])
    mgr = CheckpointManager(tmp_path / "b", keep=2, every=2)
    for s in range(5):
        mgr.maybe_save(s, {"w": torch.full((6,), float(s)),
                           "opt": [np.int32(s)]}, blocking=False)
    mgr.wait()
    assert mgr.steps() == [2, 4]
    step, got = RManager(tmp_path / "b").restore_latest(like)
    assert step == 4 and got["w"][0] == 4.0 and int(got["opt"][0]) == 4


def test_store_roundtrip_and_point_reads():
    tree = {"p": {"w": np.random.default_rng(0).normal(
        0, 1, (17, 9)).astype(np.float32)},
        "opt": [np.arange(5), np.float64(2.5).reshape(())]}
    with tempfile.TemporaryDirectory() as td:
        p = pathlib.Path(td) / "t.ckpt"
        save_pytree(p, tree)
        back = load_pytree(p, tree)
        assert np.array_equal(back["p"]["w"], tree["p"]["w"])
        assert np.array_equal(back["opt"][0], tree["opt"][0])
        r = StoreReader.open(p)
        assert np.array_equal(r.read("p/w"), tree["p"]["w"])
        assert sorted(r.names()) == sorted(["p/w", "opt[0]", "opt[1]"])
        # torch leaves write the bytes of their numpy arrays
        q = pathlib.Path(td) / "torch.ckpt"
        save_pytree(q, {"p": {"w": torch.from_numpy(tree["p"]["w"])},
                        "opt": [torch.arange(5), tree["opt"][1]]})
        assert q.read_bytes() == p.read_bytes()


def test_manager_retention_resume_and_crash_safety():
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=2, every=2)
        like = {"w": np.zeros(3, np.float32)}
        saved = [s for s in range(7)
                 if mgr.maybe_save(s, {"w": np.full(3, s, np.float32)},
                                   blocking=True)]
        assert saved == [0, 2, 4, 6]
        assert mgr.steps() == [4, 6]
        step, st = mgr.restore_latest(like)
        assert step == 6 and st["w"][0] == 6
        # a stray .tmp (crash mid-save) must not break restore
        (pathlib.Path(td) / "step_00000008.tmp").write_bytes(b"garbage")
        step, _ = mgr.restore_latest(like)
        assert step == 6


def test_elastic_restore_device_put():
    """``restore_sharded`` places each leaf by its destination sharding
    (a 1 x 1 mesh, as the reference's test; several ranks in
    ``tests/test_torch_parallel.py``)."""
    from repro_torch.launch.mesh import local_mesh_shape
    from repro_torch.parallel import NamedSharding
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=1, every=1)
        state = {"w": np.arange(8, dtype=np.float32)}
        mgr.save(0, state)
        step, placed = mgr.restore_sharded(
            state, {"w": NamedSharding(local_mesh_shape(1), ("data",))},
            device="cpu")
        assert step == 0 and placed["w"].device == torch.device("cpu")
        assert np.array_equal(placed["w"].numpy(), state["w"])
