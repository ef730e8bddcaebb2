"""The port's LM training pipeline (``repro_torch.launch.train
--model lm``) against the reference's ``_lm_pipeline``, on the CPU: its
batches are the reference's numbers, and one AdamW step (weight decay 0.1)
from the same params gives the reference's loss, moments and update.

Tolerances of the step (float32): the loss ``rtol=1e-5``; each leaf of
AdamW's moments (``0.1 * grad``, ``0.001 * grad**2``) by relative L2 1e-4
(the two packages' gradients differ by about 1e-5 relative); the
parameter update ``new - old`` by relative L2 1e-3 per leaf (Adam's first
step is ``lr * sign(grad)`` for any gradient above eps, so an element
whose gradient is rounding noise near 0 may step either way on either
side).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro.launch import train as jax_train
from repro.models import lm as jlm
from repro_torch import tree
from repro_torch.launch import train


def _args(**kw):
    base = dict(seed=0, lr=1e-3, batch=2, seq_len=32, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def _jax_lm_pipeline(monkeypatch, args, params=None):
    """The reference's ``_lm_pipeline`` with its ``lm.init`` replaced by
    ``params`` (its own init draws 47.85M params for nothing here)."""
    monkeypatch.setattr(jlm, "init", lambda key, cfg, dtype=None: params)
    return jax_train._lm_pipeline(args)


@pytest.mark.parametrize("step", [0, 1, 17])
def test_lm_batches_equal_reference(monkeypatch, step):
    args = _args(batch=3, seq_len=40)
    *_, jbatch_fn = _jax_lm_pipeline(monkeypatch, args)
    *_, batch_fn = train._lm_pipeline(args)
    got, want = batch_fn(step), jbatch_fn(step)
    for key in ("tokens", "targets"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_lm_step_matches_reference(monkeypatch):
    """One step of the CLI's pipeline from the reference's params: the
    same loss, AdamW moments and update (weight decay 0.1)."""
    args = _args()
    params, opt, loss_fn, batch_fn = train._lm_pipeline(args)
    jp = jax.tree.map(jnp.asarray, tree.tree_map(
        lambda a: a.numpy(), params))          # the port's draw, both sides
    _, jopt, jloss_fn, jbatch_fn = _jax_lm_pipeline(monkeypatch, args, jp)

    @jax.jit
    def jstep(p, s, batch):
        loss, grads = jax.value_and_grad(lambda q: jloss_fn(q, batch))(p)
        p, s = jopt.update(grads, s, p)
        return p, s, loss

    jnew, jstate, jloss = jstep(jp, jopt.init(jp), jbatch_fn(0))
    new, state, loss = train.make_step(opt, loss_fn)(
        (params, opt.init(params), None), batch_fn(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    flat = dict(tree.flatten_with_path(params))
    for want_tree, got_tree in ((jstate["m"], state["m"]),
                                (jstate["v"], state["v"])):
        got = dict(tree.flatten_with_path(got_tree))
        for k, w in tree_flatten_with_path(want_tree)[0]:
            w = np.asarray(w)
            assert np.linalg.norm(got[keystr(k)].numpy() - w) <= \
                1e-4 * np.linalg.norm(w), keystr(k)
    got = dict(tree.flatten_with_path(new))
    for k, w in tree_flatten_with_path(jnew)[0]:
        old = flat[keystr(k)].numpy()
        d_got, d_want = got[keystr(k)].numpy() - old, np.asarray(w) - old
        assert np.linalg.norm(d_got - d_want) <= \
            1e-3 * np.linalg.norm(d_want), keystr(k)
