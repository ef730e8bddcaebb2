"""The port's training runtime against the JAX reference, on the CPU:
optimizers, the tree walker, checkpoints and the fault-tolerant loop. The
same numpy inputs go through both packages. The DLRM loss, its gradients
and the training pipeline are in ``test_torch_train_dlrm.py``.
"""

import gc
import os
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro import checkpoint as jax_ckpt
from repro import optim as jax_optim
from repro_torch import checkpoint as ckpt
from repro_torch import optim, tree
from repro_torch.distributed.shardings import P, NamedSharding
from repro_torch.runtime import LoopConfig, StepFailure, TrainLoop

# f32 elementwise updates in the same order; XLA and torch may round a
# rsqrt, sqrt or pow differently by an ulp, which k steps carry and the
# cancellation in p - lr * update magnifies where the two nearly meet
OPT_TOL = dict(rtol=1e-5, atol=1e-7)


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal(6).astype(np.float32),
            "tables": [rng.standard_normal((16, 4)).astype(np.float32),
                       rng.standard_normal((12, 4)).astype(np.float32)]}


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _to_torch(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def _pairs(jax_tree, torch_tree):
    """{keystr: (jax leaf, torch leaf)}; asserts the same paths."""
    want = {keystr(p): np.asarray(x)
            for p, x in tree_flatten_with_path(jax_tree)[0]}
    got = {p: x for p, x in tree.flatten_with_path(torch_tree)}
    assert list(got) == list(want)
    return {k: (want[k], got[k]) for k in want}


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-momentum": lambda m: m.sgd(0.05, momentum=0.9),
    "adamw": lambda m: m.adamw(0.05),
    "adamw-decay": lambda m: m.adamw(0.05, weight_decay=0.1),
    "adagrad": lambda m: m.adagrad(0.5),
    "adagrad-rowwise": lambda m: m.adagrad(0.5, rowwise=True),
    "adafactor": lambda m: m.adafactor(0.5, min_dim_factored=4),
    "adafactor-unfactored": lambda m: m.adafactor(0.5),
    "partitioned": lambda m: m.partitioned(
        lambda ks: "table" if "tables" in ks else "dense",
        {"table": m.adagrad(0.5, rowwise=True), "dense": m.adamw(0.05)}),
}


class TestOptimizers:
    @pytest.mark.parametrize("name", list(OPTIMIZERS))
    def test_k_steps_match_reference(self, name):
        jopt, topt = OPTIMIZERS[name](jax_optim), OPTIMIZERS[name](optim)
        params = _np_params()
        jp, tp = _to_jax(params), _to_torch(params)
        js, ts = jopt.init(jp), topt.init(tp)
        rng = np.random.default_rng(1)
        for _ in range(5):
            g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
                np.float32), params)
            jp, js = jopt.update(_to_jax(g), js, jp)
            tp, ts = topt.update(_to_torch(g), ts, tp)
        for want, got in _pairs((jp, js), (tp, ts)).values():
            assert got.numpy().dtype == want.dtype
            np.testing.assert_allclose(got.numpy(), want, **OPT_TOL)

    def test_update_leaves_its_arguments(self):
        opt = optim.adamw(0.1)
        p = _to_torch(_np_params())
        before = [x.clone() for x in tree.leaves(p)]
        state = opt.init(p)
        opt.update(tree.tree_map(torch.ones_like, p), state, p)
        for a, b in zip(before, tree.leaves(p), strict=True):
            assert torch.equal(a, b)
        assert int(state["t"]) == 0 and state["t"].dtype == torch.int32

    def test_partitioned_routes_by_keystr(self):
        seen = []

        def label(ks):
            seen.append(ks)
            return "table" if "tables" in ks else "dense"

        opt = optim.partitioned(label, {"table": optim.adagrad(
            0.5, rowwise=True), "dense": optim.sgd(0.1)})
        state = opt.init(_to_torch(_np_params()))
        assert seen == ["['b']", "['tables'][0]", "['tables'][1]", "['w']"]
        assert list(state["table"]) == ["['tables'][0]", "['tables'][1]"]
        assert state["table"]["['tables'][1]"].shape == (12,)
        assert state["dense"] == ()
        paths = [p for p, _ in tree.flatten_with_path(state)]
        jstate = jax_optim.partitioned(label, {"table": jax_optim.adagrad(
            0.5, rowwise=True), "dense": jax_optim.sgd(0.1)}).init(
                _to_jax(_np_params()))
        assert paths == [keystr(p) for p, _ in
                         tree_flatten_with_path(jstate)[0]]
        assert paths[0] == "['table'][\"['tables'][0]\"]"


class TestTree:
    def test_matches_jax_tree_util(self):
        t = {"z": [1.0, (2.0, None, {"b": 3.0, "a": 4.0})], "a": ()}
        assert tree.flatten_with_path(t) == [
            (keystr(p), x) for p, x in tree_flatten_with_path(t)[0]]
        back = tree.unflatten(t, [10.0, 20.0, 30.0, 40.0])
        assert back == {"z": [10.0, (20.0, None, {"b": 40.0, "a": 30.0})],
                        "a": ()}
        assert tree.tree_map(lambda x, y: x + y, t, back) == \
            jax.tree.map(lambda x, y: x + y, t, back)
        with pytest.raises(ValueError):
            tree.flatten_up_to(t, {"z": [1.0], "a": ()})

    def test_an_update_leaves_no_cycle_holding_tensors(self):
        """Old params and grads die with their last reference, not at the
        next garbage collection (at dlrm-rm2 width a step's old tables and
        gradients are 6.7 GB each on the card)."""
        opt = OPTIMIZERS["partitioned"](optim)
        p = _to_torch(_np_params())
        state = opt.init(p)
        g = tree.tree_map(torch.ones_like, p)
        refs = [weakref.ref(x) for x in tree.leaves(p) + tree.leaves(g)]
        gc.disable()
        try:
            new, state = opt.update(g, state, p)
            del p, g, new
            assert [r() for r in refs] == [None] * len(refs)
        finally:
            gc.enable()


def _train_state(lib, params):
    """(params, partitioned opt state, loss) as launch/train.py builds it."""
    m = optim if lib == "torch" else jax_optim
    opt = OPTIMIZERS["partitioned"](m)
    if lib == "torch":
        p = _to_torch(params)
        return (p, opt.init(p), torch.zeros(()))
    p = _to_jax(params)
    return (p, opt.init(p), jnp.zeros(()))


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree_ = {"a": torch.arange(6).reshape(2, 3),
                 "b": [torch.ones(4), torch.zeros(2, dtype=torch.float64)]}
        ckpt.save(str(tmp_path), 7, tree_, meta={"loss": 1.5})
        assert ckpt.latest_step(str(tmp_path)) == 7
        like = tree.tree_map(torch.zeros_like, tree_)
        out = ckpt.restore(str(tmp_path), 7, like)
        for a, b in zip(tree.leaves(out), tree.leaves(tree_), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert ckpt.load_meta(str(tmp_path), 7)["loss"] == 1.5
        # a leaf comes back in its like leaf's dtype
        as_f32 = ckpt.restore(str(tmp_path), 7, {
            "a": torch.zeros(2, 3), "b": like["b"]})
        assert as_f32["a"].dtype == torch.float32

    def test_atomicity_tmpdirs_ignored(self, tmp_path):
        os.makedirs(tmp_path / ".tmp_half_written")
        assert ckpt.latest_step(str(tmp_path)) is None
        ckpt.save(str(tmp_path), 3, {"x": torch.ones(2)})
        assert ckpt.latest_step(str(tmp_path)) == 3

    def test_gc_keeps_newest(self, tmp_path):
        for s in (1, 2, 3, 4):
            ckpt.save(str(tmp_path), s, {"x": torch.ones(1) * s})
        ckpt.gc_old(str(tmp_path), keep=2)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                       if d.startswith("step_"))
        assert steps == [3, 4]

    def test_port_checkpoint_restores_into_the_reference(self, tmp_path):
        state = _train_state("torch", _np_params(2))
        state[1]["dense"]["t"].fill_(3)
        ckpt.save(str(tmp_path), 5, state)
        like = _train_state("jax", _np_params(3))
        out = jax_ckpt.restore(str(tmp_path), 5, like)
        for want, got in _pairs(out, state).values():
            np.testing.assert_array_equal(got.numpy(), want)
        assert out[1]["dense"]["t"].dtype == jnp.int32

    def test_reference_checkpoint_restores_into_the_port(self, tmp_path):
        state = _train_state("jax", _np_params(4))
        jax_ckpt.save(str(tmp_path), 9, state)
        out = ckpt.restore(str(tmp_path), 9, _train_state("torch",
                                                          _np_params(5)))
        for want, got in _pairs(state, out).values():
            np.testing.assert_array_equal(got.numpy(), want)
        assert out[1]["dense"]["t"].dtype == torch.int32

    def test_bf16_and_shardings_wait(self, tmp_path):
        """bf16 leaves are refused (the reference's checkpoints cannot
        round-trip one either); with shardings a leaf comes back as this
        rank's block, and a shardings tree without one sharding per leaf
        is refused."""
        with pytest.raises(TypeError):
            ckpt.save(str(tmp_path), 1, {"x": torch.ones(2,
                                                         dtype=torch.bfloat16)})
        assert ckpt.latest_step(str(tmp_path)) is None
        ckpt.save(str(tmp_path), 1, {"x": torch.arange(8.0)})
        with pytest.raises(ValueError):
            ckpt.restore(str(tmp_path), 1, {"x": torch.ones(2)}, {"x": None})
        # restore reads only the mesh's shape, this rank's coordinate and
        # its device, so no process group is needed here
        mesh = types.SimpleNamespace(shape={"data": 1, "model": 2},
                                     coord={"data": 0, "model": 1},
                                     device=torch.device("cpu"))
        out = ckpt.restore(str(tmp_path), 1, {"x": torch.ones(2)},
                           {"x": NamedSharding(mesh, P("model"))})
        assert torch.equal(out["x"], torch.arange(4.0, 8.0))

    @pytest.mark.parametrize("how", ["port", "savez_compressed"])
    def test_restore_onto_shardings_reads_blocks(self, tmp_path, how):
        """A block comes back exact whether the array is mapped from the
        file (stored, as ``save`` and ``np.savez`` write it) or read whole
        (compressed), a scalar leaf included."""
        full = {"c": torch.tensor(3, dtype=torch.int32),
                "w": torch.arange(48.0).reshape(6, 8)}
        if how == "port":
            ckpt.save(str(tmp_path), 1, full)
        else:
            d = tmp_path / "step_00000001"
            d.mkdir()
            np.savez_compressed(d / "arrays.npz", **{
                f"['{k}']": v.numpy() for k, v in full.items()})
        mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                     coord={"data": 1, "model": 2},
                                     device=torch.device("cpu"))
        out = ckpt.restore(str(tmp_path), 1, full, {
            "c": NamedSharding(mesh, P()),
            "w": NamedSharding(mesh, P("data", "model"))})
        assert out["c"].shape == () and int(out["c"]) == 3
        assert out["c"].dtype == torch.int32
        assert torch.equal(out["w"], full["w"][3:6, 4:6])


def _step(state, batch):
    p, count = state
    return (p - 0.1 * (p - batch), count + 1)


class TestTrainLoop:
    """The four cases of the reference's tests/test_runtime.py."""

    def _loop(self, tmp_path, total=20, **kw):
        cfg = LoopConfig(total_steps=total, ckpt_dir=str(tmp_path),
                         ckpt_every=5, **kw)
        return TrainLoop(cfg=cfg, step_fn=_step,
                         batch_fn=lambda step: torch.tensor(float(step)))

    @staticmethod
    def _init():
        return (torch.zeros(()), torch.zeros((), dtype=torch.int32))

    def test_runs_to_completion(self, tmp_path):
        state = self._loop(tmp_path).run(self._init())
        assert int(state[1]) == 20

    def test_crash_and_resume_loses_at_most_one_interval(self, tmp_path):
        loop = self._loop(tmp_path)
        loop.fail_after_steps = 12
        with pytest.raises(StepFailure):
            loop.run(self._init())
        assert ckpt.latest_step(str(tmp_path)) == 10
        state = self._loop(tmp_path).run(self._init())
        assert int(state[1]) == 20

    def test_resume_matches_uninterrupted(self, tmp_path):
        ref = self._loop(tmp_path / "ref").run(self._init())
        loop = self._loop(tmp_path / "crashy")
        loop.fail_after_steps = 7
        with pytest.raises(StepFailure):
            loop.run(self._init())
        out = self._loop(tmp_path / "crashy").run(self._init())
        assert torch.equal(out[0], ref[0]) and int(out[1]) == int(ref[1])

    def test_straggler_hook_fires(self, tmp_path):
        clock_state = {"t": 0.0}
        calls = []

        def clock():
            clock_state["t"] += 0.01
            return clock_state["t"]

        loop = self._loop(tmp_path, straggler_factor=2.0,
                          straggler_warmup=4)
        orig_attempt = loop._attempt

        def slow_attempt(state, batch):
            out = orig_attempt(state, batch)
            if int(state[1]) == 10:          # one slow step
                clock_state["t"] += 5.0
            return out

        loop._attempt = slow_attempt
        loop.clock = clock
        loop.on_straggler = lambda step, dt, med: calls.append(step)
        loop.run(self._init())
        assert calls == [10]

    def test_holds_no_state_but_the_newest(self, tmp_path):
        """The loop drops each state once the next exists (with the initial
        state handed over as the call's only reference)."""
        seen = []

        def step(state, batch):
            seen.append(weakref.ref(state[0]))
            assert [r() is not None for r in seen] == \
                [False] * (len(seen) - 1) + [True]
            return _step(state, batch)

        loop = self._loop(tmp_path, total=6)
        loop.step_fn = step
        gc.disable()
        try:
            init = [self._init()]
            assert int(loop.run(init.pop())[1]) == 6
        finally:
            gc.enable()

    def test_retry_guard_reruns_an_overrunning_step(self, tmp_path):
        clock_state = {"t": 0.0, "calls": 0}

        def slow_step(state, batch):
            clock_state["calls"] += 1
            clock_state["t"] += 2.0 if clock_state["calls"] == 1 else 0.1
            return _step(state, batch)

        loop = self._loop(tmp_path, total=3, max_step_time=1.0)
        loop.step_fn = slow_step
        loop.clock = lambda: clock_state["t"]
        state = loop.run(self._init())
        assert clock_state["calls"] == 4 and int(state[1]) == 3
