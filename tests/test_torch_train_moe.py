"""Train steps of the MoE and MLA families against the reference's:
``make_train_step`` of qwen2-moe's and deepseek-v2's smoke models (one
device, no mesh) in float32 with ``grad_accum`` 2, batches of 4 x 32
tokens, lr 1e-3, from the reference's initial state carried across
(``convert.train_state_from_arrays``).

* **Step by step.** Each of three steps starts from the reference's state
  after the step before, so each port step is held to the reference's
  alone: the losses within 1e-5, and at most 0.05% of the parameter
  elements more than 1e-5 from the reference's. Measured on the CPU: the
  losses equal to 4.8e-7 (qwen2-moe) and exactly (deepseek-v2); at most
  0.0093% of elements off (30 of 321,856 for qwen2-moe after step 1, 22
  of 239,072 for deepseek-v2), by at most 5.5e-4.
* **Chained.** Three steps of qwen2-moe, each from the port's own state:
  losses within 1e-5 (measured 9.5e-7), at most 0.05% of elements off
  (measured 0.0121% after step 3, 39 elements, by at most 1.3e-4), every
  element within 2 lr a step taken. deepseek-v2 chained the same way keeps
  its first two losses within 2.4e-6 (0.095% of elements off after step
  2), then its third differs by 3.7e-4 with 17% of elements off: the same
  third step from the reference's state gives the reference's loss
  exactly, so the divergence is the earlier steps' drift reaching a
  discrete choice (AdamW moves an element by about lr whatever its
  gradient's size), not the step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.models import Model as RModel
from repro.models.steps import init_train_state as r_init_train_state
from repro.models.steps import make_train_step as r_make_train_step
from repro_torch.configs import get_smoke
from repro_torch.convert import train_state_from_arrays, train_state_to_arrays
from repro_torch.models import Model
from repro_torch.models.steps import make_train_step

ARCHS = ["qwen2-moe-a2.7b", "deepseek-v2-236b"]
LR = 1e-3
LOSS_TOL = 1e-5
ELEM_TOL = 1e-5
FRACTION = 5e-4            # of parameter elements beyond ELEM_TOL


def _setup(arch):
    cfg = dataclasses.replace(r_get_smoke(arch), dtype="float32",
                              grad_accum=2)
    rm = RModel(cfg)
    rparams, ropt, _ = r_init_train_state(rm, jax.random.PRNGKey(1))
    tm = Model(dataclasses.replace(get_smoke(arch), dtype="float32",
                                   grad_accum=2))
    return rm, jax.jit(r_make_train_step(rm, lr=LR)), tm, rparams, ropt


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)}
    out["labels"][0, :3] = -1
    return out


def _port_state(tm, rparams, ropt):
    tree = {"params": jax.tree.map(np.asarray, rparams),
            "opt": jax.tree.map(np.asarray, ropt)}
    return train_state_from_arrays(tm.cfg, tree, device="cpu")


def _param_diff(tm, params, opt, rparams) -> np.ndarray:
    got = train_state_to_arrays(tm.cfg, params, opt)
    return np.concatenate([
        np.abs(g - np.asarray(w)).ravel()
        for g, w in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(rparams))])


@pytest.mark.parametrize("arch", ARCHS)
def test_each_train_step_matches_from_the_references_state(arch):
    rm, r_step, tm, rparams, ropt = _setup(arch)
    step = make_train_step(tm, lr=LR)
    for i in range(3):
        batch = _batch(rm.cfg, 10 + i)
        params, opt = _port_state(tm, rparams, ropt)
        loss, params, opt = step(params, opt,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        rloss, rparams, ropt = r_step(rparams, ropt,
                                      {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        assert abs(float(loss) - float(rloss)) <= LOSS_TOL, (i, float(loss),
                                                             float(rloss))
        diff = _param_diff(tm, params, opt, rparams)
        assert (diff > ELEM_TOL).mean() <= FRACTION, (i, (diff > ELEM_TOL
                                                          ).sum())
        assert diff.max() <= 2 * LR, (i, diff.max())


def test_chained_moe_train_steps_match():
    rm, r_step, tm, rparams, ropt = _setup("qwen2-moe-a2.7b")
    params, opt = _port_state(tm, rparams, ropt)
    step = make_train_step(tm, lr=LR)
    for i in range(3):
        batch = _batch(rm.cfg, 10 + i)
        rloss, rparams, ropt = r_step(rparams, ropt,
                                      {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        loss, params, opt = step(params, opt,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        assert abs(float(loss) - float(rloss)) <= LOSS_TOL, (i, float(loss),
                                                             float(rloss))
        diff = _param_diff(tm, params, opt, rparams)
        assert int(train_state_to_arrays(tm.cfg, params, opt)["opt"].step) \
            == i + 1
        assert diff.max() <= 2 * LR * (i + 1), diff.max()
        assert (diff > ELEM_TOL).mean() <= FRACTION, (i, (diff > ELEM_TOL
                                                          ).sum())
