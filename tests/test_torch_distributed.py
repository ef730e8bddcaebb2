"""The port's mesh, sharding rules, block cuts, gradient compression,
checkpoints onto shardings and the sharded TrainLoop against the reference,
on the CPU.

The same numpy inputs (made here from a seed) go through both packages.
The reference runs in subprocesses with 8 forced XLA host devices, as
``tests/test_multidev.py`` runs it; the port runs in 8 gloo processes of
``torch.distributed`` (one spawn for every case). In order: the reference
writes its specs, index maps, collective orders, ``compressed_psum`` runs
and a checkpoint saved from a (2, 4) mesh; the port restores that
checkpoint onto (4, 2), saves one of its own from (4, 2) and runs its
cases; the reference restores the port's checkpoint onto (2, 4).

This file is also the script each side runs:

    python tests/test_torch_distributed.py jax|port|jax-restore IN OUT

Tolerances: ``compressed_psum`` f32 ``atol 1e-6``; a training run resumed
on another mesh ``atol 1e-5`` (its sums run in other orders); everything
else exact.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs, optim, tree
from repro_torch.distributed import mesh as M
from repro_torch.distributed.shardings import (P, batch_spec, block_index,
                                               make_param_specs, replicate)
from repro_torch.launch import mesh as launch_mesh

ROOT = Path(__file__).resolve().parents[1]
N_DEV = 8
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
AXES = ("data", "model")
COMP_TOL = dict(atol=1e-6)
RESUME_TOL = dict(atol=1e-5)
# block cuts: (mesh shape, axes, spec entries, array shape)
INDEX_CASES = [
    ((2, 4), AXES, ("model", None), (64, 8)),
    ((2, 4), AXES, (("model", "data"), None), (64, 8)),
    ((4, 2), AXES, (("model", "data"), None), (64, 8)),
    ((2, 4), AXES, (("data", "model"), None), (16, 3)),
    ((4, 2), AXES, (("data", "model"), None), (16, 3)),
    ((2, 4), AXES, ("data", "model"), (16, 8)),
    ((4, 2), AXES, ("model", "data"), (16, 8)),
    ((2, 4), AXES, (None, "model"), (5, 8)),
    ((2, 4), AXES, ("model",), (64,)),
    ((2, 4), AXES, (), (6, 7)),
    ((2, 2, 2), ("pod", "data", "model"), (("pod", "data"), None), (8, 2)),
    ((2, 2, 2), ("pod", "data", "model"), (("model", "pod"), "data"), (8, 4)),
]
COMP_CASES = [(m, bits) for m in MESHES for bits in (8, 4)]
COMP_STEPS = 20
# the sharded TrainLoop: RMC1's widths, 3 tables of 64 rows, batch 16
TRAIN_STEPS, CRASH_AFTER, N_TABLES, ROWS, BATCH = 6, 3, 3, 64, 16


def _spec_repr(spec) -> str:
    return repr(tuple(spec))


def _meta_mlperf(cfg):
    """dlrm-mlperf's parameter tree as meta tensors (shapes, no memory)."""
    def mlp(sizes):
        return [{"w": torch.empty(a, b, device="meta"),
                 "b": torch.empty(b, device="meta")}
                for a, b in zip(sizes[:-1], sizes[1:], strict=True)]
    bot = (cfg.n_dense,) + tuple(cfg.bot_mlp)
    return {"tables": [torch.empty(n, cfg.embed_dim, device="meta")
                       for n in cfg.n_rows],
            "bot": mlp(bot), "top": mlp((cfg.top_in,) + tuple(cfg.top_mlp)
                                        + (1,))}


def _recsys_opt():
    return optim.partitioned(
        lambda ks: "table" if ("tables" in ks or "items" in ks) else "dense",
        {"table": optim.adagrad(0.01, rowwise=True),
         "dense": optim.adamw(1e-3)})


def port_specs() -> dict[str, str]:
    """keystr path -> spec repr for every spec tree the reference's
    dlrm-mlperf bundle derives (``jax_specs`` makes the same keys)."""
    cfg = configs.DLRM_MLPERF
    params = _meta_mlperf(cfg)
    out = {}
    for tag, rules, orules in (
            ("1d", configs.PARAM_RULES,
             configs.recsys_opt_rules(configs.PARAM_RULES)),
            ("2d", configs.PARAM_RULES_2D, configs.OPT_RULES_2D)):
        specs = make_param_specs(params, rules)
        state = _recsys_opt().init(params)
        trees = {"params": specs,
                 "opt": make_param_specs(state, orules),
                 "adafactor": optim.adafactor(0.01).state_specs(params,
                                                                specs)}
        like = {"params": params, "opt": state,
                "adafactor": optim.adafactor(0.01).init(params)}
        for name, t in trees.items():
            for (path, _), s in zip(tree.flatten_with_path(like[name]),
                                    tree.flatten_up_to(like[name], t),
                                    strict=True):
                out[f"{tag}/{name}{path}"] = _spec_repr(s)
    for path, s in tree.flatten_with_path(replicate(params)):
        out[f"replicate{path}"] = _spec_repr(s)
    batch = _batch_like()
    for tag, axes in (("pod-data", ("pod", "data")), ("data", ("data",))):
        for path, s in tree.flatten_with_path(batch_spec(batch, axes)):
            out[f"batch-{tag}{path}"] = _spec_repr(s)
    return out


def _batch_like():
    return {"dense": np.zeros((16, 13), np.float32),
            "indices": np.zeros((16, 26, 1), np.int32),
            "labels": np.zeros((16,), np.float32), "step": np.zeros(())}


def make_inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    out = {"g": (rng.standard_normal((8, 64)) * 0.001).astype(np.float32),
           "ck/w": rng.standard_normal((16, 8)).astype(np.float32),
           "ck/tables0": rng.standard_normal((64, 4)).astype(np.float32),
           "ck/count": np.array(7, np.int32)}
    return out


# -- the reference side -------------------------------------------------------


def _jax_tree_ck(inp, jnp):
    return {"w": jnp.asarray(inp["ck/w"]),
            "tables": [jnp.asarray(inp["ck/tables0"])],
            "count": jnp.asarray(inp["ck/count"])}


CK_SPECS_24 = {"w": ("data", "model"), "tables": [("model", None)],
               "count": ()}
CK_SPECS_42 = {"w": ("model", "data"), "tables": [(("model", "data"), None)],
               "count": ()}


def jax_side(inp_path: str, out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from jax.tree_util import keystr, tree_flatten_with_path

    from repro import checkpoint as jck
    from repro import optim as joptim
    from repro.compat import make_mesh, shard_map
    from repro.configs.dlrm_mlperf import (CONFIG, PARAM_RULES,
                                           PARAM_RULES_2D)
    from repro.configs.recsys_common import (recsys_opt_rules,
                                             recsys_optimizer)
    from repro.distributed.compression import (CompressionState,
                                               compressed_psum)
    from repro.distributed.shardings import batch_spec as jbatch_spec
    from repro.distributed.shardings import make_param_specs as jspecs
    from repro.distributed.shardings import replicate as jreplicate
    from repro.models import dlrm

    assert len(jax.devices()) == N_DEV
    inp = dict(np.load(inp_path))
    res: dict[str, np.ndarray] = {}
    is_p = {"is_leaf": lambda x: isinstance(x, JP)}

    def flat_specs(prefix, like, specs):
        for (path, _), (_, s) in zip(
                tree_flatten_with_path(like)[0],
                tree_flatten_with_path(specs, **is_p)[0], strict=True):
            specs_out[f"{prefix}{keystr(path)}"] = _spec_repr(s)

    # specs of the dlrm-mlperf bundle
    specs_out: dict[str, str] = {}
    params = jax.eval_shape(lambda: dlrm.init(jax.random.PRNGKey(0), CONFIG))
    for tag, rules, orules in (
            ("1d", PARAM_RULES, recsys_opt_rules(PARAM_RULES)),
            ("2d", PARAM_RULES_2D,
             [("['table'][", JP(("model", "data")))] + PARAM_RULES_2D)):
        specs = jspecs(params, rules)
        state = jax.eval_shape(recsys_optimizer().init, params)
        ada = joptim.adafactor(0.01)
        flat_specs(f"{tag}/params", params, specs)
        flat_specs(f"{tag}/opt", state, jspecs(state, orules))
        flat_specs(f"{tag}/adafactor", jax.eval_shape(ada.init, params),
                   ada.state_specs(params, specs))
    flat_specs("replicate", params, jreplicate(params))
    batch = _batch_like()
    for tag, axes in (("pod-data", ("pod", "data")), ("data", ("data",))):
        flat_specs(f"batch-{tag}", batch, jbatch_spec(batch, axes))
    with open(os.path.join(out_dir, "specs.json"), "w") as f:
        json.dump(specs_out, f)

    # index maps of NamedSharding
    index = {}
    for i, (shape, axes, entries, ashape) in enumerate(INDEX_CASES):
        n = int(np.prod(shape))
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                                 axes)
        pos = {d: c for c, d in np.ndenumerate(mesh.devices)}
        imap = NamedSharding(mesh, JP(*entries)).devices_indices_map(ashape)
        index[str(i)] = {",".join(map(str, pos[d])): [
            [sl.indices(size)[0], sl.indices(size)[1]]
            for sl, size in zip(idx, ashape, strict=True)]
            for d, idx in imap.items()}
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f)

    for mname, shape in MESHES.items():
        mesh = make_mesh(shape, AXES)
        pos = {d: c for c, d in np.ndenumerate(mesh.devices)}

        def put(key, arr):
            for sh in arr.addressable_shards:
                d, m = pos[sh.device]
                res[f"{key}/{d},{m}"] = np.asarray(sh.data)

        # tiled collectives over a tuple of axes, in both orders
        for axes in (("data", "model"), ("model", "data")):
            tag = f"{mname}/{'-'.join(axes)}"
            n = int(np.prod(shape))
            gat = shard_map(
                lambda a=axes: jax.lax.all_gather(
                    jax.lax.axis_index(a)[None], a, tiled=True)[None],
                mesh=mesh, in_specs=(), out_specs=JP(AXES), check_vma=False)
            put(f"{tag}/all_gather", jax.jit(gat)())
            sct = shard_map(
                lambda a=axes: jax.lax.psum_scatter(
                    jnp.arange(2 * n, dtype=jnp.float32)
                    * (jax.lax.axis_index(a) + 1.0), a,
                    scatter_dimension=0, tiled=True),
                mesh=mesh, in_specs=(), out_specs=JP(AXES), check_vma=False)
            put(f"{tag}/psum_scatter", jax.jit(sct)())

        # compressed_psum: 20 error-feedback steps over "data"
        for bits in (8, 4):
            def step(g, r, bits=bits):
                out, st = compressed_psum(g, "data",
                                          CompressionState(residual=r), bits)
                return out, st.residual
            fn = jax.jit(shard_map(
                step, mesh=mesh, in_specs=(JP("data", None),) * 2,
                out_specs=(JP("data", None),) * 2, check_vma=False))
            g = jnp.asarray(inp["g"])
            r, acc = jnp.zeros_like(g), jnp.zeros_like(g)
            for k in range(COMP_STEPS):
                out, r = fn(g, r)
                acc = acc + out
                if k == 0:
                    put(f"{mname}/comp{bits}/first", out)
            put(f"{mname}/comp{bits}/acc", acc)
            put(f"{mname}/comp{bits}/residual", r)
            plain = jax.jit(shard_map(
                lambda g, bits=bits: compressed_psum(g, "data", None,
                                                     bits)[0],
                mesh=mesh, in_specs=JP("data", None),
                out_specs=JP("data", None), check_vma=False))(g)
            put(f"{mname}/comp{bits}/no_state", plain)

    # a checkpoint saved from (2, 4), and its blocks on (4, 2)
    mesh24, mesh42 = make_mesh((2, 4), AXES), make_mesh((4, 2), AXES)
    ck = _jax_tree_ck(inp, jnp)
    sh24 = jax.tree.map(lambda s: NamedSharding(mesh24, JP(*s)), CK_SPECS_24,
                        is_leaf=lambda x: isinstance(x, tuple))
    jck.save(os.path.join(out_dir, "jax_ckpt"), 1,
             jax.tree.map(jax.device_put, ck, sh24))
    pos42 = {d: c for c, d in np.ndenumerate(mesh42.devices)}
    for path, leaf in tree_flatten_with_path(ck)[0]:
        s = tree_flatten_with_path(CK_SPECS_42,
                                   is_leaf=lambda x: isinstance(x, tuple))
        sp = dict((keystr(p), v) for p, v in s[0])[keystr(path)]
        arr = jax.device_put(leaf, NamedSharding(mesh42, JP(*sp)))
        for sh in arr.addressable_shards:
            d, m = pos42[sh.device]
            res[f"ck42{keystr(path)}/{d},{m}"] = np.asarray(sh.data)
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


def jax_restore_side(inp_path: str, out_dir: str) -> None:
    """Restore the port's (4, 2) checkpoint onto (2, 4) with the
    reference's ``checkpoint.restore``; its blocks into ``jax_restore.npz``.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from jax.tree_util import keystr, tree_flatten_with_path

    from repro import checkpoint as jck
    from repro.compat import make_mesh

    inp = dict(np.load(inp_path))
    mesh = make_mesh((2, 4), AXES)
    like = _jax_tree_ck(inp, jnp)
    sh = jax.tree.map(lambda s: NamedSharding(mesh, JP(*s)), CK_SPECS_24,
                      is_leaf=lambda x: isinstance(x, tuple))
    out = jck.restore(os.path.join(out_dir, "port_ckpt"), 2, like, sh)
    pos = {d: c for c, d in np.ndenumerate(mesh.devices)}
    res = {}
    for (path, leaf), s in zip(tree_flatten_with_path(out)[0],
                               jax.tree.leaves(sh), strict=True):
        assert leaf.sharding == s
        for b in leaf.addressable_shards:
            d, m = pos[b.device]
            res[f"{keystr(path)}/{d},{m}"] = np.asarray(b.data)
    np.savez(os.path.join(out_dir, "jax_restore.npz"), **res)


# -- the port side (8 gloo processes) -----------------------------------------


def _named(mesh, spec_tree):
    from repro_torch.distributed.shardings import NamedSharding

    def one(s):
        return NamedSharding(mesh, P(*s))

    if isinstance(spec_tree, dict):
        return {k: _named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [_named(mesh, v) for v in spec_tree]
    return one(spec_tree)


def _save_peak(ck, named_sharding, *args, **kw) -> int:
    """``ck.save(*args, **kw)`` on this rank, returning the most bytes of
    gathered leaves and host copies alive at once: each new one (not a
    block of the saved tree itself) is registered as it is made, and the
    live ones are summed, by address, at each registration."""
    import weakref
    from unittest import mock

    blocks = {x.data_ptr() for x in tree.leaves(args[2])}
    live: dict[int, tuple] = {}
    peak = 0

    def track(x, addr: int, nbytes: int):
        nonlocal peak
        if addr not in blocks:
            for a in [a for a, (r, _) in live.items() if r() is None]:
                del live[a]
            live[addr] = (weakref.ref(x), nbytes)
            peak = max(peak, sum(n for _, n in live.values()))
        return x

    gather, host = named_sharding.gather, ck._host

    def tracked_gather(self, block):
        x = gather(self, block)
        return track(x, x.data_ptr(), x.numel() * x.element_size())

    def tracked_host(leaf):
        a = host(leaf)
        return track(a, a.__array_interface__["data"][0], a.nbytes)

    with mock.patch.object(named_sharding, "gather", tracked_gather), \
            mock.patch.object(ck, "_host", tracked_host):
        ck.save(*args, **kw)
    return peak


def _train_setup(mesh):
    """A tiny DLRM and the sharded step of its 2D hybrid loss, on this
    rank's blocks: (state, shardings, step_fn, batch_fn)."""
    import dataclasses

    from repro_torch.distributed.shardings import (NamedSharding,
                                                   shard_batch)
    from repro_torch.embedding.layout import RemapSpec, remap_table
    from repro_torch.launch.train import make_step
    from repro_torch.models import dlrm

    cfg = dataclasses.replace(configs.RMC1, n_tables=N_TABLES,
                              n_rows=(ROWS,) * N_TABLES, lookups=4)
    full = dlrm.init(0, cfg, device="cpu")
    rng = np.random.default_rng(5)
    rank_of = []
    for t in range(N_TABLES):
        spec = RemapSpec.from_counts(rng.integers(0, 50, ROWS), n_shards=8)
        full["tables"][t] = remap_table(full["tables"][t], spec)
        rank_of.append(NamedSharding(mesh, P(("model", "data"))).shard(
            torch.from_numpy(spec.rank_of.astype(np.int32))))
    pspecs = make_param_specs(full, configs.PARAM_RULES_2D)
    params = tree.tree_map(lambda x, s: NamedSharding(mesh, s).shard(x),
                           full, pspecs)
    opt = _recsys_opt()
    ostate = opt.init(params)
    ospecs = make_param_specs(ostate, configs.OPT_RULES_2D)
    shardings = tree.tree_map(lambda s: NamedSharding(mesh, s),
                              (pspecs, ospecs, P()))

    def loss_fn(p, batch):
        return dlrm.loss({**p, "rank_of": rank_of}, batch, cfg, mesh,
                         hybrid=True, table_2d=True)

    step_fn = make_step(opt, loss_fn, mesh, pspecs)

    def batch_fn(step):
        r = np.random.default_rng(1000 + step)
        batch = {"dense": torch.from_numpy(r.standard_normal(
                     (BATCH, cfg.n_dense)).astype(np.float32)),
                 "indices": torch.from_numpy(r.integers(
                     0, ROWS, (BATCH, N_TABLES, 4)).astype(np.int32)),
                 "labels": torch.from_numpy(
                     (r.random(BATCH) < 0.3).astype(np.float32))}
        return shard_batch(mesh, batch, axes=("data",))

    return (params, ostate, torch.zeros(())), shardings, step_fn, batch_fn


def port_worker(rank: int, inp_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch import checkpoint as ck
    from repro_torch.distributed.compression import (CompressionState,
                                                     compressed_psum)
    from repro_torch.distributed.mesh import all_gather, psum_scatter
    from repro_torch.distributed.shardings import NamedSharding
    from repro_torch.runtime import LoopConfig, StepFailure, TrainLoop

    torch.set_num_threads(1)
    M.init("cpu", rank=rank, world_size=N_DEV,
           store=dist.FileStore(os.path.join(out_dir, "store"), N_DEV))
    inp = {k: torch.from_numpy(v) for k, v in np.load(inp_path).items()}
    res: dict[str, np.ndarray] = {}
    meshes = {"2x4": M.make_mesh((2, 4), AXES, "cpu"),
              "4x2": launch_mesh.make_local_mesh(4, 2, "cpu")}
    assert all(m.shape == dict(zip(AXES, MESHES[k], strict=True))
               for k, m in meshes.items())
    for mname, mesh in meshes.items():
        res[f"{mname}/coord"] = np.array([mesh.coord[a] for a in AXES])
        for axes in (("data", "model"), ("model", "data")):
            tag = f"{mname}/{'-'.join(axes)}"
            n = mesh.axis_size(axes)
            res[f"{tag}/all_gather"] = all_gather(
                torch.tensor([mesh.axis_index(axes)]), mesh, axes)[None] \
                .numpy()
            res[f"{tag}/psum_scatter"] = psum_scatter(
                torch.arange(2 * n, dtype=torch.float32)
                * (mesh.axis_index(axes) + 1.0), mesh, axes).numpy()
        g = NamedSharding(mesh, P("data", None)).shard(inp["g"])
        for bits in (8, 4):
            st = CompressionState.zeros_like(g)
            acc = torch.zeros_like(g)
            for k in range(COMP_STEPS):
                out, st = compressed_psum(g, "data", st, bits, mesh=mesh)
                acc = acc + out
                if k == 0:
                    res[f"{mname}/comp{bits}/first"] = out.numpy()
            res[f"{mname}/comp{bits}/acc"] = acc.numpy()
            res[f"{mname}/comp{bits}/residual"] = st.residual.numpy()
            res[f"{mname}/comp{bits}/no_state"] = compressed_psum(
                g, "data", None, bits, mesh=mesh)[0].numpy()

    # the reference's (2, 4) checkpoint onto (4, 2), then ours from (4, 2)
    m42 = meshes["4x2"]
    like = {"w": torch.zeros(1), "tables": [torch.zeros(1)],
            "count": torch.zeros((), dtype=torch.int32)}
    sh42 = _named(m42, CK_SPECS_42)
    got = ck.restore(os.path.join(out_dir, "jax_ckpt"), 1, like, sh42)
    for path, leaf in tree.flatten_with_path(got):
        res[f"ck42{path}"] = leaf.numpy()
        res[f"ck42{path}/dtype"] = np.array(str(leaf.dtype))
    ck.save(os.path.join(out_dir, "port_ckpt"), 2, got, shardings=sh42)
    res["save/peak"] = np.array(_save_peak(
        ck, NamedSharding, os.path.join(out_dir, "peak_ckpt"), 2, got,
        shardings=sh42))

    # the sharded TrainLoop: uninterrupted, crashed and resumed on the same
    # mesh, crashed on (2, 4) and resumed on (4, 2)
    def run(mname, d, fail=None):
        state, sh, step_fn, batch_fn = _train_setup(meshes[mname])
        loop = TrainLoop(cfg=LoopConfig(total_steps=TRAIN_STEPS,
                                        ckpt_dir=os.path.join(out_dir, d),
                                        ckpt_every=1),
                         step_fn=step_fn, batch_fn=batch_fn,
                         fail_after_steps=fail)
        return loop.run(state, sh), sh

    def global_state(state, sh):
        return [s.gather(x).numpy() for x, s in zip(
            tree.leaves(state), tree.leaves(sh), strict=True)]

    ref, sh = run("2x4", "uninterrupted")
    res["train/uninterrupted"] = np.array(len(tree.leaves(ref)))
    for i, x in enumerate(global_state(ref, sh)):
        res[f"train/uninterrupted/{i}"] = x
    for tag, first, second in (("same", "2x4", "2x4"),
                               ("other", "2x4", "4x2")):
        try:
            run(first, f"crash_{tag}", fail=CRASH_AFTER)
            raised = 0
        except StepFailure:
            raised = 1
        res[f"train/{tag}/raised"] = np.array(raised)
        res[f"train/{tag}/latest"] = np.array(
            ck.latest_step(os.path.join(out_dir, f"crash_{tag}")))
        out, sh = run(second, f"crash_{tag}")
        for i, x in enumerate(global_state(out, sh)):
            res[f"train/{tag}/{i}"] = x
    np.savez(os.path.join(out_dir, f"port_{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def port_side(inp_path: str, out_dir: str) -> None:
    import torch.multiprocessing as mp
    mp.spawn(port_worker, args=(inp_path, out_dir), nprocs=N_DEV, join=True)


# -- the tests ----------------------------------------------------------------


def _run(side: str, inp: str, out: str) -> None:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    if side.startswith("jax"):
        env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_"
                   f"platform_device_count={N_DEV}")
    r = subprocess.run([sys.executable, __file__, side, inp, out], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"{side} side failed:\n{r.stdout[-3000:]}\n" \
        f"{r.stderr[-6000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("distributed")
    inp = str(d / "inputs.npz")
    np.savez(inp, **make_inputs())
    for side in ("jax", "port", "jax-restore"):
        _run(side, inp, str(d))
    ranks = [dict(np.load(d / f"port_{r}.npz")) for r in range(N_DEV)]
    with open(d / "specs.json") as f, open(d / "index.json") as g:
        return dict(ref=dict(np.load(d / "ref.npz")), ranks=ranks,
                    specs=json.load(f), index=json.load(g),
                    restored=dict(np.load(d / "jax_restore.npz")),
                    inp=dict(np.load(inp)))


def _pairs(runs, mname: str, key: str):
    """(port block, reference block) at every rank's mesh coordinate."""
    out = []
    for got in runs["ranks"]:
        d, m = got[f"{mname}/coord"]
        out.append((got[key], runs["ref"][f"{key}/{d},{m}"]))
    return out


# in-process: no process group needed


def test_init_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.init("cuda", rank=0, world_size=1, init_method="tcp://localhost:1")


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_mesh((1, 1), AXES, "cpu")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_ranks(multi_pod):
    with pytest.raises(RuntimeError, match="512 ranks" if multi_pod
                       else "256 ranks"):
        launch_mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_partition_spec_is_a_leaf_and_compares_as_a_tuple():
    s = P(("model", "data"), None)
    assert tuple(s) == (("model", "data"), None) and len(s) == 2
    assert tuple(P(("data",), ())) == ("data", None)     # as JAX normalises
    assert s == P(("model", "data"), None) and s != P("model", None)
    assert tree.leaves({"a": s, "b": [P()]}) == [s, P()]
    with pytest.raises(TypeError):
        P(3)


@pytest.mark.parametrize("case", range(len(INDEX_CASES)))
def test_block_cut_is_devices_indices_map(runs, case):
    shape, axes, entries, ashape = INDEX_CASES[case]
    want = runs["index"][str(case)]
    assert len(want) == int(np.prod(shape))
    for coord, idx in want.items():
        c = dict(zip(axes, map(int, coord.split(",")), strict=True))
        got = block_index(dict(zip(axes, shape, strict=True)), P(*entries),
                          ashape, c)
        assert [[s.start, s.stop] for s in got] == idx, coord


def test_block_cut_refuses_what_jax_refuses():
    shape = {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="divide"):
        block_index(shape, P("model"), (6,), {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="lacks"):
        block_index(shape, P("pod"), (8,), {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="twice"):
        block_index(shape, P("model", "model"), (8, 8),
                    {"data": 0, "model": 0})


@pytest.mark.parametrize("group", ["1d/params", "1d/opt", "1d/adafactor",
                                   "2d/params", "2d/opt", "2d/adafactor",
                                   "replicate", "batch-pod-data",
                                   "batch-data"])
def test_specs_match_reference(runs, group):
    """make_param_specs, the optimizer-state rules, adafactor's
    state_specs, replicate and batch_spec on dlrm-mlperf, compared as
    tuples."""
    want = {k: v for k, v in runs["specs"].items() if k.startswith(group)}
    got = {k: v for k, v in port_specs().items() if k.startswith(group)}
    assert want and got == want


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("axes", ["data-model", "model-data"])
@pytest.mark.parametrize("kind", ["all_gather", "psum_scatter"])
def test_tiled_collective_order_matches_jax(runs, mname, axes, kind):
    """Chunks of an all_gather or psum_scatter over a tuple of axes land
    where JAX puts them, in either order of the tuple."""
    for got, want in _pairs(runs, mname, f"{mname}/{axes}/{kind}"):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mname,bits", COMP_CASES)
@pytest.mark.parametrize("what", ["first", "acc", "residual", "no_state"])
def test_compressed_psum_matches_reference(runs, mname, bits, what):
    """20 error-feedback steps over the data axis: the first step's mean,
    their sum and the residual, and a step without state, per block."""
    for got, want in _pairs(runs, mname, f"{mname}/comp{bits}/{what}"):
        np.testing.assert_allclose(got, want, **COMP_TOL)


@pytest.mark.parametrize("leaf", ["['w']", "['tables'][0]", "['count']"])
def test_reference_checkpoint_restores_onto_another_mesh(runs, leaf):
    """Saved by the reference from (2, 4), restored by the port onto
    (4, 2): each rank's block is the reference's block on (4, 2)."""
    for got in runs["ranks"]:
        d, m = got["4x2/coord"]
        want = runs["ref"][f"ck42{leaf}/{d},{m}"]
        np.testing.assert_array_equal(got[f"ck42{leaf}"], want)
        assert str(got[f"ck42{leaf}/dtype"]) == (
            "torch.int32" if leaf == "['count']" else "torch.float32")


@pytest.mark.parametrize("leaf", ["['w']", "['tables'][0]", "['count']"])
def test_port_checkpoint_restores_into_reference(runs, leaf):
    """Saved by the port from (4, 2) (blocks gathered, rank 0 writes),
    restored by the reference onto (2, 4) with its own NamedShardings."""
    spec = {"['w']": ("data", "model"), "['tables'][0]": ("model", None),
            "['count']": ()}[leaf]
    full = runs["inp"]["ck/" + {"['w']": "w", "['tables'][0]": "tables0",
                                "['count']": "count"}[leaf]]
    for d in range(2):
        for m in range(4):
            idx = block_index({"data": 2, "model": 4}, P(*spec), full.shape,
                              {"data": d, "model": m})
            np.testing.assert_array_equal(
                runs["restored"][f"{leaf}/{d},{m}"], full[idx])


def test_sharded_save_holds_one_gathered_leaf_at_a_time(runs):
    """A sharded save from (4, 2) gathers its leaves one at a time: on
    every rank the gathered leaves and their host copies alive at once
    never exceed the largest whole leaf, where holding them all (``w`` and
    ``tables[0]``) would."""
    whole = [runs["inp"][k].nbytes for k in ("ck/w", "ck/tables0")]
    assert sum(whole) > max(whole)
    for got in runs["ranks"]:
        assert 0 < int(got["save/peak"]) <= max(whole)


def test_sharded_train_loop_resumes_exactly(runs):
    """Crashed after 3 of 6 steps on (2, 4) and resumed from its newest
    checkpoint on the same mesh: the state equals an uninterrupted run's."""
    for got in runs["ranks"]:
        assert int(got["train/same/raised"]) == 1
        assert int(got["train/same/latest"]) == CRASH_AFTER
        n = int(got["train/uninterrupted"])
        for i in range(n):
            np.testing.assert_array_equal(got[f"train/same/{i}"],
                                          got[f"train/uninterrupted/{i}"])


def test_sharded_train_loop_resumes_onto_another_mesh(runs):
    """Crashed on (2, 4), resumed on (4, 2) through restore(shardings):
    the state matches the uninterrupted (2, 4) run's, and every rank holds
    the same global state."""
    first = runs["ranks"][0]
    n = int(first["train/uninterrupted"])
    assert int(first["train/other/raised"]) == 1
    for got in runs["ranks"]:
        for i in range(n):
            np.testing.assert_allclose(got[f"train/other/{i}"],
                                       got[f"train/uninterrupted/{i}"],
                                       **RESUME_TOL)
            np.testing.assert_array_equal(got[f"train/other/{i}"],
                                          first[f"train/other/{i}"])


if __name__ == "__main__":
    {"jax": jax_side, "port": port_side,
     "jax-restore": jax_restore_side}[sys.argv[1]](*sys.argv[2:])
