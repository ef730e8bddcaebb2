"""The port's distributed embedding and mesh DLRM against the reference's
``shard_map``, rank block by rank block, on the CPU.

Both sides take the same numpy inputs (made here from a seed). The
reference runs in one subprocess with 8 forced XLA host devices, as
``tests/test_multidev.py`` runs it; the port runs in 8 gloo processes of
``torch.distributed`` (one spawn for every case). Each writes the block of
every output at every mesh coordinate, and each test compares the port's
block at a coordinate with the reference's at the same coordinate, on a
(2, 4) and a (4, 2) ("data", "model") mesh, so that the 2D layout's
model-major row owner and data-major batch order differ.

This file is also the script both sides run:

    python tests/test_torch_sharded.py jax|port INPUTS.npz OUT_DIR

Tolerances (f32): bags ``atol 1e-5``; logits, losses and gradients ``atol
1e-4``, as in ``tests/test_multidev.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_DEV = 8
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
V, DIM, B, L = 64, 8, 16, 5
BAG_TOL = dict(atol=1e-5)
MODEL_TOL = dict(atol=1e-4)

# function cases: arguments (input names), their specs and the output's,
# as plain tuples (each side makes its own PartitionSpecs of them)
T1, T2 = ("model", None), (("model", "data"), None)
IX, OUT, HYB = ("data", None), ("data", None), (("data", "model"), None)
FN_CASES = {
    "local_shard_lookup": dict(args=("table", "idx"), specs=(T1, IX),
                               out=("model", "data", None, None)),
    "bag_sum": dict(args=("table", "idx"), specs=(T1, IX), out=OUT),
    "bag_mean": dict(args=("table", "idx"), specs=(T1, IX), out=OUT,
                     kw=dict(mode="mean")),
    "bag_sum_scatter": dict(args=("table", "idx"), specs=(T1, IX), out=HYB,
                            kw=dict(scatter=True)),
    "bag_mean_scatter": dict(args=("table", "idx"), specs=(T1, IX), out=HYB,
                             kw=dict(mode="mean", scatter=True)),
    "bag_replicated_idx": dict(args=("table", "idx"),
                               specs=(T1, (None, None)), out=(None, None)),
    "make_sharded_bag": dict(args=("table", "idx"), specs=(T1, IX), out=OUT),
    "bag_2d": dict(args=("table", "idx"), specs=(T2, IX), out=HYB),
    "bag_2d_rank_of": dict(args=("stored", "idx", "rank_of"),
                           specs=(T2, IX, (("model", "data"),)), out=HYB),
    "remapped": dict(args=("stored", "rank_of", "idx"),
                     specs=(T1, ("model",), IX), out=OUT),
    "remapped_scatter": dict(args=("stored", "rank_of", "idx"),
                             specs=(T1, ("model",), IX), out=HYB,
                             kw=dict(scatter=True)),
}
GRAD_CASES = [c for c in FN_CASES if c != "local_shard_lookup"]
# DLRM under a mesh (RMC1's widths, 3 tables of 64 rows): remap on unless
# named, batch 16 (divides 8 ranks)
MODEL_CASES = {
    "forward": dict(kind="forward", remap=False),
    "forward_remap": dict(kind="forward"),
    "forward_hybrid": dict(kind="forward", hybrid=True),
    "forward_hybrid_2d": dict(kind="forward", hybrid=True, table_2d=True),
    "loss": dict(kind="loss"),
    "loss_hybrid": dict(kind="loss", hybrid=True),
    "loss_hybrid_2d": dict(kind="loss", hybrid=True, table_2d=True),
    "retrieval_score": dict(kind="retrieval"),
}
LOSS_CASES = [c for c, k in MODEL_CASES.items() if k["kind"] == "loss"]
N_TABLES, MODEL_ROWS, LOOKUPS, N_CAND = 3, 64, 4, 16


def _model_cfg(configs):
    import dataclasses
    return dataclasses.replace(configs.RMC1, n_tables=N_TABLES,
                               n_rows=(MODEL_ROWS,) * N_TABLES,
                               lookups=LOOKUPS)


def make_inputs() -> dict[str, np.ndarray]:
    """Every input of both sides, from one seed; the model's parameters are
    keyed ``p/<keystr path>``."""
    from repro_torch import configs, tree
    from repro_torch.embedding.layout import RemapSpec
    from repro_torch.models import dlrm

    rng = np.random.default_rng(0)
    spec = RemapSpec.from_counts(rng.integers(0, 50, V), n_shards=4)
    table = rng.standard_normal((V, DIM)).astype(np.float32)
    out = {"table": table, "stored": table[spec.perm],
           "rank_of": spec.rank_of.astype(np.int32),
           "idx": rng.integers(0, V, (B, L)).astype(np.int32),
           "w": rng.standard_normal((B, DIM)).astype(np.float32)}
    cfg = _model_cfg(configs)
    like = dlrm.init(0, cfg, device="cpu")
    for path, leaf in tree.flatten_with_path(like):
        out["p/" + path] = (rng.standard_normal(tuple(leaf.shape))
                            * 0.3).astype(np.float32)
    for t in range(N_TABLES):
        s = RemapSpec.from_counts(rng.integers(0, 50, MODEL_ROWS),
                                  n_shards=4)
        key = f"p/['tables'][{t}]"
        out[f"stored/{t}"] = out[key][s.perm]
        out[f"rank_of/{t}"] = s.rank_of.astype(np.int32)
    out["dense"] = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
    out["indices"] = rng.integers(0, MODEL_ROWS, (B, N_TABLES, LOOKUPS)) \
        .astype(np.int32)
    out["labels"] = (rng.random(B) < 0.3).astype(np.float32)
    out["candidates"] = rng.integers(0, MODEL_ROWS, N_CAND).astype(np.int32)
    return out


# -- the reference side (a subprocess with 8 XLA host devices) --------------


def jax_side(inp_path: str, out_dir: str, mname: str) -> None:
    """The reference's blocks on the mesh ``mname`` into
    ``ref_<mname>.npz``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.tree_util import keystr, tree_flatten_with_path

    from repro.compat import make_mesh, shard_map
    from repro.configs.dlrm_mlperf import PARAM_RULES, PARAM_RULES_2D
    from repro.distributed.shardings import make_param_specs
    from repro.embedding import sharded as S
    from repro.models import dlrm

    assert len(jax.devices()) == N_DEV
    inp = dict(np.load(inp_path))
    res: dict[str, np.ndarray] = {}

    def spec(t):
        return P(*t)

    def put_blocks(key, arr, mesh, sp=None):
        """Every device's block of ``arr`` (resharded to ``sp`` if given),
        keyed by the device's mesh coordinate."""
        if sp is not None:
            arr = jax.device_put(arr, NamedSharding(mesh, sp))
        pos = {d: c for c, d in np.ndenumerate(mesh.devices)}
        for sh in arr.addressable_shards:
            d, m = pos[sh.device]
            res[f"{key}/{d},{m}"] = np.asarray(sh.data)

    cfg = dataclasses.replace(dlrm.RMC1, n_tables=N_TABLES,
                              n_rows=(MODEL_ROWS,) * N_TABLES,
                              lookups=LOOKUPS)
    like = jax.eval_shape(lambda: dlrm.init(jax.random.PRNGKey(0), cfg))
    flat, treedef = tree_flatten_with_path(like)
    params = treedef.unflatten([jnp.asarray(inp["p/" + keystr(p)])
                                for p, _ in flat])
    stored = {**params, "tables": [jnp.asarray(inp[f"stored/{t}"])
                                   for t in range(N_TABLES)]}
    rank_of = [jnp.asarray(inp[f"rank_of/{t}"]) for t in range(N_TABLES)]
    batch = {k: jnp.asarray(inp[k]) for k in ("dense", "indices", "labels")}

    shape = MESHES[mname]
    mesh = make_mesh(shape, ("data", "model"))
    for name, c in FN_CASES.items():
        kw = c.get("kw", {})
        if name == "local_shard_lookup":
            def body(tb, ix):
                return S.local_shard_lookup(
                    tb, ix, jax.lax.axis_index("model"), tb.shape[0])[None]
        elif name.startswith("bag_2d"):
            def body(tb, ix, *ro):
                return S.sharded_embedding_bag_2d(tb, ix, *ro)
        elif name.startswith("remapped"):
            def body(tb, ro, ix, kw=kw):
                return S.sharded_remapped_bag(tb, ro, ix, "model", **kw)
        else:
            def body(tb, ix, kw=kw):
                return S.sharded_embedding_bag(tb, ix, "model", **kw)
        if name == "make_sharded_bag":
            fn = S.make_sharded_bag(mesh, spec(c["specs"][0]),
                                    spec(c["specs"][1]), spec(c["out"]))
        else:
            fn = shard_map(body, mesh=mesh,
                           in_specs=tuple(map(spec, c["specs"])),
                           out_specs=spec(c["out"]), check_vma=False)
        args = [jnp.asarray(inp[a]) for a in c["args"]]
        if name not in GRAD_CASES:
            put_blocks(f"{mname}/{name}/out", jax.jit(fn)(*args), mesh)
            continue

        def out_and_grad(a0, rest, fn=fn):
            """fn's output and the gradient of sum(out * w) (one
            compile for both)."""
            out, vjp = jax.vjp(lambda a: fn(a, *rest), a0)
            return out, vjp(jnp.asarray(inp["w"]))[0]

        out, g = jax.jit(out_and_grad)(args[0], args[1:])
        put_blocks(f"{mname}/{name}/out", out, mesh)
        put_blocks(f"{mname}/{name}/grad", g, mesh, spec(c["specs"][0]))
    # psum_scatter over the model axis of 3 rows per data rank
    fn = shard_map(lambda tb, ix: S.sharded_embedding_bag(
        tb, ix, "model", scatter=True), mesh=mesh,
        in_specs=(P("model", None), P("data", None)),
        out_specs=P(("data", "model"), None), check_vma=False)
    try:
        jax.jit(fn)(jnp.asarray(inp["table"]),
                    jnp.asarray(inp["idx"][:3 * shape[0]]))
        res[f"{mname}/indivisible/raised"] = np.array(0)
    except Exception:     # noqa: BLE001 - any refusal of the shape
        res[f"{mname}/indivisible/raised"] = np.array(1)

    for name, c in MODEL_CASES.items():
        remap = c.get("remap", True)
        hybrid, t2d = c.get("hybrid", False), c.get("table_2d", False)
        p = stored if remap else params
        ro = {"rank_of": rank_of} if remap else {}
        if c["kind"] == "forward":
            out = jax.jit(lambda pp, b, hybrid=hybrid, t2d=t2d, ro=ro:
                          dlrm.forward({**pp, **ro}, b, cfg, mesh,
                                       hybrid=hybrid, table_2d=t2d))(
                p, batch)
            put_blocks(f"{mname}/{name}/out", out, mesh,
                       P(("data", "model")) if hybrid else P("data"))
        elif c["kind"] == "loss":
            def f(pp, hybrid=hybrid, t2d=t2d, ro=ro):
                return dlrm.loss({**pp, **ro}, batch, cfg, mesh,
                                 hybrid=hybrid, table_2d=t2d)
            lv, g = jax.jit(jax.value_and_grad(f))(p)
            res[f"{mname}/{name}/loss"] = np.asarray(lv)
            specs = make_param_specs(
                p, PARAM_RULES_2D if t2d else PARAM_RULES)
            for (path, leaf), (_, sp) in zip(
                    tree_flatten_with_path(g)[0],
                    tree_flatten_with_path(
                        specs, is_leaf=lambda x: isinstance(x, P))[0],
                    strict=True):
                put_blocks(f"{mname}/{name}/grad{keystr(path)}", leaf,
                           mesh, sp)
        else:
            rb = {"dense": batch["dense"][:1],
                  "indices": batch["indices"][:1],
                  "candidates": jnp.asarray(inp["candidates"])}
            out = jax.jit(lambda pp, b: dlrm.retrieval_score(
                {**pp, "rank_of": rank_of}, b, cfg, mesh))(stored, rb)
            put_blocks(f"{mname}/{name}/out", out, mesh, P("data"))
    np.savez(os.path.join(out_dir, f"ref_{mname}.npz"), **res)


# -- the port side (8 gloo processes) ---------------------------------------


def port_worker(rank: int, inp_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import configs, tree
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed.shardings import (P, NamedSharding,
                                                   make_param_specs,
                                                   shard_batch, sync_grads)
    from repro_torch.embedding import sharded as S
    from repro_torch.models import dlrm

    torch.set_num_threads(1)
    M.init("cpu", rank=rank, world_size=N_DEV,
           store=dist.FileStore(os.path.join(out_dir, "store"), N_DEV))
    inp = {k: torch.from_numpy(v) for k, v in np.load(inp_path).items()}
    res: dict[str, np.ndarray] = {}
    cfg = _model_cfg(configs)
    like = dlrm.init(0, cfg, device="cpu")
    params = tree.unflatten(like, [inp["p/" + p] for p, _ in
                                   tree.flatten_with_path(like)])
    stored = {**params, "tables": [inp[f"stored/{t}"]
                                   for t in range(N_TABLES)]}
    rank_of = [inp[f"rank_of/{t}"] for t in range(N_TABLES)]
    batch = {k: inp[k] for k in ("dense", "indices", "labels")}

    def block(x, t):
        return NamedSharding(mesh, P(*t)).shard(x)

    for mname, shape in MESHES.items():
        mesh = M.make_mesh(shape, ("data", "model"), "cpu")
        res[f"{mname}/coord"] = np.array([mesh.coord["data"],
                                          mesh.coord["model"]])
        for name, c in FN_CASES.items():
            kw = c.get("kw", {})
            if name == "make_sharded_bag":
                fn = S.make_sharded_bag(mesh, P(*c["specs"][0]),
                                        P(*c["specs"][1]), P(*c["out"]))
                args = [inp[a].clone().requires_grad_(i == 0)
                        for i, a in enumerate(c["args"])]
                out = fn(*args)
                grad_of = args[0]
            else:
                args = [block(inp[a], s) for a, s in zip(c["args"],
                                                         c["specs"])]
                args[0].requires_grad_(True)
                grad_of = args[0]
                if name == "local_shard_lookup":
                    out = S.local_shard_lookup(args[0], args[1],
                                               mesh.axis_index("model"),
                                               args[0].shape[0])[None]
                elif name.startswith("bag_2d"):
                    out = S.sharded_embedding_bag_2d(*args, mesh=mesh)
                elif name.startswith("remapped"):
                    out = S.sharded_remapped_bag(*args, "model", **kw,
                                                 mesh=mesh)
                else:
                    out = S.sharded_embedding_bag(*args, "model", **kw,
                                                  mesh=mesh)
                out = M.out_boundary(out, mesh, P(*c["out"]))
            res[f"{mname}/{name}/out"] = out.detach().numpy()
            if name in GRAD_CASES:
                obj = (out * block(inp["w"], c["out"])).sum()
                (g,) = torch.autograd.grad(obj, [grad_of])
                if name == "make_sharded_bag":    # a global table's grad
                    g = block(g, c["specs"][0])
                g = sync_grads(mesh, [g], [P(*c["specs"][0])])[0]
                res[f"{mname}/{name}/grad"] = g.numpy()
        try:
            S.sharded_embedding_bag(block(inp["table"], T1),
                                    inp["idx"][:3], "model", scatter=True,
                                    mesh=mesh)
            res[f"{mname}/indivisible/raised"] = np.array(0)
        except ValueError:
            res[f"{mname}/indivisible/raised"] = np.array(1)

        for name, c in MODEL_CASES.items():
            remap = c.get("remap", True)
            hybrid, t2d = c.get("hybrid", False), c.get("table_2d", False)
            p = stored if remap else params
            rules = configs.PARAM_RULES_2D if t2d else configs.PARAM_RULES
            specs = make_param_specs(p, rules)
            pb = tree.tree_map(lambda x, s: NamedSharding(mesh, s).shard(x),
                               p, specs)
            if remap:
                rspec = P(("model", "data")) if t2d else P("model")
                pb = {**pb, "rank_of": [NamedSharding(mesh, rspec).shard(r)
                                        for r in rank_of]}
            bb = shard_batch(mesh, batch, axes=("data",))
            if c["kind"] == "forward":
                out = dlrm.forward(pb, bb, cfg, mesh, hybrid=hybrid,
                                   table_2d=t2d)
                res[f"{mname}/{name}/out"] = out.detach().numpy()
            elif c["kind"] == "loss":
                diff = {k: v for k, v in pb.items() if k != "rank_of"}
                leaves = [x.detach().requires_grad_()
                          for x in tree.leaves(diff)]
                pp = {**tree.unflatten(diff, leaves),
                      **({"rank_of": pb["rank_of"]} if remap else {})}
                lv = dlrm.loss(pp, bb, cfg, mesh, hybrid=hybrid,
                               table_2d=t2d)
                grads = sync_grads(mesh, tree.unflatten(
                    diff, list(torch.autograd.grad(lv, leaves))), specs)
                res[f"{mname}/{name}/loss"] = lv.detach().numpy()
                for path, g in tree.flatten_with_path(grads):
                    res[f"{mname}/{name}/grad{path}"] = g.numpy()
            else:
                rb = {"dense": batch["dense"][:1],
                      "indices": batch["indices"][:1],
                      "candidates": block(inp["candidates"], ("data",))}
                out = dlrm.retrieval_score(pb, rb, cfg, mesh)
                res[f"{mname}/{name}/out"] = out.detach().numpy()
    np.savez(os.path.join(out_dir, f"port_{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def port_side(inp_path: str, out_dir: str) -> None:
    import torch.multiprocessing as mp
    mp.spawn(port_worker, args=(inp_path, out_dir), nprocs=N_DEV, join=True)


# -- the tests --------------------------------------------------------------


def _run(side: str, *args: str, **env) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, __file__, side, *args], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc: subprocess.Popen, side: str) -> None:
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"{side} side failed:\n{out[-6000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference blocks, [port blocks of each rank]) from one run of the
    port and one of the reference per mesh, all started together."""
    d = tmp_path_factory.mktemp("sharded")
    inp = str(d / "inputs.npz")
    np.savez(inp, **make_inputs())
    refs = {m: _run("jax", inp, str(d), m, JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count="
                              f"{N_DEV}") for m in MESHES}
    port = _run("port", inp, str(d))
    _wait(port, "port")
    ref = {}
    for m, proc in refs.items():
        _wait(proc, f"reference ({m})")
        ref.update(np.load(d / f"ref_{m}.npz"))
    ranks = [dict(np.load(d / f"port_{r}.npz")) for r in range(N_DEV)]
    return ref, ranks


def _pairs(runs, mname: str, key: str):
    """(port block, reference block) at every rank's mesh coordinate."""
    ref, ranks = runs
    out = []
    for got in ranks:
        d, m = got[f"{mname}/coord"]
        out.append((got[f"{mname}/{key}"], ref[f"{mname}/{key}/{d},{m}"]))
    return out


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", list(FN_CASES))
def test_function_blocks_match_shard_map(runs, case, mname):
    for got, want in _pairs(runs, mname, f"{case}/out"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **BAG_TOL)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", GRAD_CASES)
def test_function_grads_match_jax_grad(runs, case, mname):
    """The table block's gradient of sum(out * w) after ``sync_grads``: the
    block of ``jax.grad`` through the reference's ``shard_map``."""
    for got, want in _pairs(runs, mname, f"{case}/grad"):
        np.testing.assert_allclose(got, want, **BAG_TOL)


@pytest.mark.parametrize("mname", list(MESHES))
def test_indivisible_scatter_raises_on_both_sides(runs, mname):
    """A reduce-scatter of 3 rows per data rank over the model axis."""
    ref, ranks = runs
    assert int(ref[f"{mname}/indivisible/raised"]) == 1
    assert all(int(r[f"{mname}/indivisible/raised"]) == 1 for r in ranks)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", [c for c in MODEL_CASES
                                  if c not in LOSS_CASES])
def test_model_blocks_match_reference(runs, case, mname):
    for got, want in _pairs(runs, mname, f"{case}/out"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_and_grads_match_reference(runs, case, mname):
    """The loss on every rank, and every parameter's gradient block after
    ``sync_grads``, against ``jax.value_and_grad`` of the reference's
    mesh loss."""
    ref, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[f"{mname}/{case}/loss"],
                                   ref[f"{mname}/{case}/loss"], **MODEL_TOL)
    head = f"{mname}/{case}/"
    keys = sorted(k[len(head):] for k in ranks[0]
                  if k.startswith(head + "grad"))
    assert {k.rsplit("/", 1)[0] for k in ref
            if k.startswith(head + "grad")} == {head + k for k in keys}
    assert len(keys) == 4 + 6 + N_TABLES      # bot, top, tables
    for k in keys:
        for got, want in _pairs(runs, mname, f"{case}/{k}"):
            np.testing.assert_allclose(got, want, **MODEL_TOL, err_msg=k)


if __name__ == "__main__":
    {"jax": jax_side, "port": port_side}[sys.argv[1]](*sys.argv[2:])
