"""The registry's recsys and GNN plans on a mesh: the port's plan functions
on 8 gloo ranks against the reference's plan functions under ``jit`` with
the plans' shardings on 8 XLA host devices, on a (2, 4) ("data", "model")
mesh, at narrow widths and cut batches (``_narrow``).

The cases (``CASES``): dlrm-mlperf's ``serve_p99`` and ``train_batch`` in
the registry's own layout (``hybrid`` dense sharding with 2D row-sharded
tables to train, 1D tables to serve; its tables' rows divide the 8-way
(model x data) grid); DIN's and BERT4Rec's ``train_batch``, ``serve_p99``
and ``retrieval_cand`` with their item tables row-sharded over ``model``
(each rank holds its row block of ``items`` and of its row-wise adagrad
accumulator; masked lookups summed over ``model``, BERT4Rec's tied output
and cloze loss on the rank's vocab block, its 16 checkpointed
microbatches; DIN's retrieval in chunks of ``DIN_CHUNK`` candidates, so
that its chunk loop runs collectives); and GraphSAGE's
``ogb_products`` (the edges sharded over ``data``, each segment sum summed
across them). The reference writes each output whole; each rank of the
port writes what its plan's ``fn`` returns, and each test holds a rank's
output against the reference's block at the rank's mesh coordinate under
the plan's specs (``CellPlan.local_specs``: the params' and the optimizer
state's blocks; the logits' rows). DIN's and BERT4Rec's train gradients
(``CellPlan.grads``, after the sum over the batch axes) are held as well,
against the reference plan's gradients: a one-step update at their
learning rates moves a param too little to show a wrong gradient.

This file is also the script both sides run:

    python tests/test_torch_registry_mesh.py jax|port INPUTS.npz OUT_DIR

Tolerances (f32): the logits and scores ``rtol=1e-5, atol=1e-6`` (the
SLS's psums, the hybrid reduce-scatter and the sharded logsumexp add in
other orders); the loss, every updated param and every optimizer-state
leaf after one step ``atol=1e-5``; the gradients ``atol=1e-4``.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_DEV = 8
MESH = (2, 4)
AXES = ("data", "model")
CASES = [("dlrm-mlperf", "serve_p99"), ("dlrm-mlperf", "train_batch"),
         ("din", "train_batch"), ("din", "serve_p99"),
         ("din", "retrieval_cand"), ("bert4rec", "train_batch"),
         ("bert4rec", "serve_p99"), ("bert4rec", "retrieval_cand"),
         ("graphsage-reddit", "ogb_products")]
# the train cells whose gradients are held too
GRAD_ARCHS = ("din", "bert4rec")
NARROW_DLRM = dict(name="narrow", dim=8, bot=(5, 16, 8), top=(24, 16, 1),
                   vocabs=[64, 128, 8, 96], lookups=3)
SHAPES = {"train_batch": dict(batch=64), "serve_p99": dict(batch=32),
          "retrieval_cand": dict(batch=1, n_candidates=48)}
DIN_CHUNK = 10          # the port's DIN retrieval: 3 chunks of a rank's 24
NARROW_DIN = dict(n_items=400, seq_len=12, attn_mlp=(8, 4), mlp=(16, 8))
NARROW_BERT = dict(n_items=208, seq_len=24, embed_dim=16, d_ff=32)
NARROW_SAGE = dict(d_in=6, n_classes=3, d_hidden=16)
PRODUCTS = dict(n_nodes=50, n_edges=256, d_feat=6)
SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=0, atol=1e-4)


def _narrow(pkg: str):
    """``pkg``'s registry (``repro`` or ``repro_torch``) at the narrow
    widths and cut batches; returns the function that restores it."""
    mod = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "configs.recsys_common", "configs.din_arch", "configs.bert4rec_arch",
        "configs.graphsage_reddit", "models.din", "models.bert4rec",
        "models.graphsage")}
    shapes = mod["configs.recsys_common"].RECSYS_SHAPES
    sage = mod["configs.graphsage_reddit"]
    saved = ({k: shapes[k] for k in SHAPES},
             mod["configs.din_arch"].CONFIG,
             mod["configs.bert4rec_arch"].CONFIG,
             sage.CFG_PRODUCTS, sage.SHAPES["ogb_products"],
             getattr(mod["models.din"], "RETRIEVAL_CHUNK", None))
    shapes.update(SHAPES)
    if saved[5] is not None:
        mod["models.din"].RETRIEVAL_CHUNK = DIN_CHUNK
    mod["configs.din_arch"].CONFIG = mod["models.din"].DINConfig(**NARROW_DIN)
    mod["configs.bert4rec_arch"].CONFIG = \
        mod["models.bert4rec"].Bert4RecConfig(**NARROW_BERT)
    sage.CFG_PRODUCTS = mod["models.graphsage"].SAGEConfig(**NARROW_SAGE)
    sage.SHAPES["ogb_products"] = PRODUCTS

    def restore():
        shapes.update(saved[0])
        mod["configs.din_arch"].CONFIG = saved[1]
        mod["configs.bert4rec_arch"].CONFIG = saved[2]
        sage.CFG_PRODUCTS = saved[3]
        sage.SHAPES["ogb_products"] = saved[4]
        if saved[5] is not None:
            mod["models.din"].RETRIEVAL_CHUNK = saved[5]
    return restore


def _bundle(pkg: str, arch: str):
    """The (narrowed) bundle of ``arch`` in ``pkg``'s registry; dlrm-mlperf
    at NARROW_DLRM's tables, in its registered layout."""
    if arch == "dlrm-mlperf":
        m = importlib.import_module(f"{pkg}.configs.dlrm_mlperf")
        return m.make_dlrm_bundle("narrow", m.make_config(**NARROW_DLRM),
                                  hybrid=True, table_2d=True)
    return importlib.import_module(f"{pkg}.configs.base").get_arch(arch)


def _batch(arch: str, cell: str, shapes: dict, rng) -> dict:
    """Random inputs for a plan's batch leaves ``{keystr path: (shape,
    dtype name)}``: ids within their ranges, masks, labels."""
    out = {}
    for path, (shape, dtype) in shapes.items():
        if dtype == "float32" and "labels" not in path \
                and "train_mask" not in path:
            out[path] = rng.standard_normal(shape).astype(np.float32)
        elif dtype == "float32":
            out[path] = (rng.random(shape) < 0.4).astype(np.float32)
        elif dtype == "bool":
            out[path] = rng.random(shape) < 0.8
        else:
            hi = {"dlrm-mlperf": 8, "din": NARROW_DIN["n_items"],
                  "bert4rec": NARROW_BERT["n_items"],
                  "graphsage-reddit": PRODUCTS["n_nodes"]}[arch]
            if "mask_pos" in path:
                hi = NARROW_BERT["seq_len"]
            if "labels" in path:
                hi = NARROW_SAGE["n_classes"]
            out[path] = rng.integers(0, hi, shape).astype(np.int32)
    if arch == "dlrm-mlperf":
        rows = NARROW_DLRM["vocabs"]
        out["['indices']"] = np.stack(
            [rng.integers(0, v, shapes["['indices']"][0][:1] + (3,))
             for v in rows], axis=1).astype(np.int32)
        for t, v in enumerate(rows):
            out[f"['rank_of'][{t}]"] = rng.permutation(v).astype(np.int32)
    return out


def make_inputs() -> dict[str, np.ndarray]:
    """Each case's params (the reference's init) and batch, by keystr
    path under ``<arch>/<cell>/p`` and ``<arch>/<cell>/b``."""
    import jax
    from jax.tree_util import keystr, tree_flatten_with_path

    import repro.configs  # noqa: F401
    restore = _narrow("repro")
    try:
        out = {}
        rng = np.random.default_rng(0)
        for arch, cell in CASES:
            bundle = _bundle("repro", arch)
            plan = bundle.steps[cell].make_fn(bundle, None, False)
            if arch == "graphsage-reddit":
                from repro.configs import graphsage_reddit
                from repro.models import graphsage
                params = graphsage.init(jax.random.PRNGKey(0),
                                        graphsage_reddit.CFG_PRODUCTS)
            else:
                params = bundle.init(jax.random.PRNGKey(0))
            for p, x in tree_flatten_with_path(params)[0]:
                out[f"{arch}/{cell}/p{keystr(p)}"] = np.asarray(x)
            shapes = {keystr(p): (tuple(x.shape), str(x.dtype))
                      for p, x in tree_flatten_with_path(plan.args[-1])[0]}
            for p, x in _batch(arch, cell, shapes, rng).items():
                out[f"{arch}/{cell}/b{p}"] = x
        return out
    finally:
        restore()


# -- the reference side (a subprocess with 8 XLA host devices) --------------


def jax_side(inp_path: str, out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from jax.tree_util import keystr, tree_flatten_with_path

    import repro.configs  # noqa: F401
    from repro.compat import make_mesh

    assert len(jax.devices()) == N_DEV
    inp = dict(np.load(inp_path))
    _narrow("repro")
    mesh = make_mesh(MESH, AXES)
    res: dict[str, np.ndarray] = {}

    def load(prefix, like):
        flat, treedef = tree_flatten_with_path(like)
        return treedef.unflatten([jnp.asarray(inp[prefix + keystr(p)])
                                  for p, _ in flat])

    def named(specs):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, JP))

    for arch, cell in CASES:
        bundle = _bundle("repro", arch)
        plan = bundle.steps[cell].make_fn(bundle, mesh, False)
        params = load(f"{arch}/{cell}/p", plan.args[0])
        batch = load(f"{arch}/{cell}/b", plan.args[-1])
        args = ((params, bundle.optimizer.init(params), batch)
                if len(plan.args) == 3 else (params, batch))
        fn = jax.jit(plan.fn, in_shardings=named(plan.in_specs),
                     out_shardings=named(plan.out_specs))
        with mesh:
            out = fn(*args)
        for path, x in tree_flatten_with_path(out)[0]:
            res[f"{arch}/{cell}{keystr(path)}"] = np.asarray(x)
        if cell == "train_batch" and arch in GRAD_ARCHS:
            with mesh:
                grads = _jax_grads(bundle, mesh, named, args)
            for path, x in tree_flatten_with_path(grads)[0]:
                res[f"grads/{arch}{keystr(path)}"] = np.asarray(x)
    np.savez(os.path.join(out_dir, "ref.npz"), **res)


def _jax_grads(bundle, mesh, named, args):
    """The reference train plan's gradients at ``args``: the plan run under
    ``jit`` with an optimizer whose update returns the gradients as the new
    params (laid out by the params' specs)."""
    import dataclasses

    import jax

    from repro import optim as joptim
    opt = bundle.optimizer
    bundle = dataclasses.replace(bundle, optimizer=joptim.Optimizer(
        opt.init, lambda g, s, p: (g, s)))
    plan = bundle.steps["train_batch"].make_fn(bundle, mesh, False)
    return jax.jit(plan.fn, in_shardings=named(plan.in_specs),
                   out_shardings=named(plan.out_specs))(*args)[0]


# -- the port side (8 gloo processes) ---------------------------------------


def port_worker(rank: int, inp_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    import repro_torch.configs  # noqa: F401
    from repro_torch import tree
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed.shardings import NamedSharding

    torch.set_num_threads(1)
    M.init("cpu", rank=rank, world_size=N_DEV,
           store=dist.FileStore(os.path.join(out_dir, "store"), N_DEV))
    inp = {k: torch.from_numpy(v) for k, v in np.load(inp_path).items()}
    _narrow("repro_torch")
    mesh = M.make_mesh(MESH, AXES, "cpu")
    res: dict[str, np.ndarray] = {
        "coord": np.array([mesh.coord[a] for a in AXES])}

    def load(prefix, like):
        return tree.unflatten(like, [inp[prefix + p] for p, _ in
                                     tree.flatten_with_path(like)])

    for arch, cell in CASES:
        bundle = _bundle("repro_torch", arch)
        plan = bundle.steps[cell].make_fn(bundle, mesh, False)
        params = load(f"{arch}/{cell}/p", plan.args[0])
        batch = load(f"{arch}/{cell}/b", plan.args[-1])
        args = ((params, bundle.optimizer.init(params), batch)
                if len(plan.args) == 3 else (params, batch))
        blocks = tree.tree_map(lambda x, s: NamedSharding(mesh, s).shard(x),
                               args, plan.local_specs())
        out = plan.fn(*blocks)
        for path, x in tree.flatten_with_path(out):
            res[f"{arch}/{cell}{path}"] = x.detach().numpy()
        if cell == "train_batch" and arch in GRAD_ARCHS:
            grads = plan.grads(blocks[0], blocks[2])[1]
            for path, x in tree.flatten_with_path(grads):
                res[f"grads/{arch}{path}"] = x.numpy()
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
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{side} side failed:\n{out[-6000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [port outputs of each rank]), both sides started
    together."""
    d = tmp_path_factory.mktemp("registry_mesh")
    inp = str(d / "inputs.npz")
    np.savez(inp, **make_inputs())
    ref = _run("jax", inp, str(d), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_DEV}")
    port = _run("port", inp, str(d))
    _wait(port, "port")
    _wait(ref, "reference")
    return dict(np.load(d / "ref.npz")), \
        [dict(np.load(d / f"port_{r}.npz")) for r in range(N_DEV)]


def _out_specs(arch: str, cell: str) -> dict:
    """{output path: spec of what a rank's fn returns}: a serve plan's
    out_spec, a train plan's param and optimizer-state layout and the
    replicated loss."""
    import repro_torch.configs  # noqa: F401
    from repro_torch import tree
    from repro_torch.distributed.shardings import P

    restore = _narrow("repro_torch")
    try:
        bundle = _bundle("repro_torch", arch)
        plan = bundle.steps["train_batch" if cell == "grads" else cell] \
            .make_fn(bundle, None, False)
    finally:
        restore()
    if cell == "grads":
        return {f"grads/{arch}{p}": s
                for p, s in tree.flatten_with_path(plan.in_specs[0])}
    specs = (plan.out_specs if len(plan.args) == 2 else
             (*plan.local_specs()[:2], P()))
    return {f"{arch}/{cell}{p}": s for p, s in tree.flatten_with_path(specs)}


def _pairs(runs, arch: str, cell: str):
    """(path, port output, reference block) at every rank's coordinate;
    ``cell`` "grads" for the train plan's gradients."""
    from repro_torch.distributed.shardings import block_index
    ref, ranks = runs
    specs = _out_specs(arch, cell)
    prefix = f"grads/{arch}[" if cell == "grads" else f"{arch}/{cell}"
    assert sorted(specs) == sorted(k for k in ref if k.startswith(prefix))
    out = []
    for got in ranks:
        coord = dict(zip(AXES, got["coord"].tolist(), strict=True))
        for key, spec in specs.items():
            want = ref[key]
            idx = block_index(dict(zip(AXES, MESH, strict=True)), spec,
                              want.shape, coord)
            out.append((key, got[key], want[idx]))
    return out


def test_dlrm_serve_p99_plan_matches_reference(runs):
    pairs = _pairs(runs, "dlrm-mlperf", "serve_p99")
    assert len(pairs) == N_DEV
    for key, got, want in pairs:
        assert got.shape == want.shape == (SHAPES["serve_p99"]["batch"]
                                           // MESH[0],)
        np.testing.assert_allclose(got, want, err_msg=key, **SERVE_TOL)


@pytest.mark.parametrize("arch,cell", [c for c in CASES
                                       if c[0] in GRAD_ARCHS
                                       and c[1] != "train_batch"])
def test_item_sharded_serve_plan_matches_reference(runs, arch, cell):
    """Each rank's rows of DIN's (B,) logits or of BERT4Rec's (B, n_items)
    scores (the vocab blocks gathered over ``model``), or its block of the
    candidates' scores."""
    pairs = _pairs(runs, arch, cell)
    assert len(pairs) == N_DEV
    shp = SHAPES[cell]
    rows = shp.get("n_candidates", shp["batch"]) // MESH[0]
    for key, got, want in pairs:
        assert got.shape == want.shape, key
        assert got.shape[0] == rows, key
        np.testing.assert_allclose(got, want, err_msg=key, **SERVE_TOL)


@pytest.mark.parametrize("arch,cell", [c for c in CASES
                                       if c[1] not in ("serve_p99",
                                                       "retrieval_cand")])
def test_train_plan_matches_reference(runs, arch, cell):
    """The loss, every updated param and every optimizer-state leaf after
    one step: dlrm-mlperf's 2D table blocks and row-wise accumulators, the
    replicated MLPs and AdamW moments; DIN's and BERT4Rec's row blocks of
    ``items`` and of their accumulators (a quarter of the rows each);
    GraphSAGE's replicated weights."""
    ref = runs[0]
    for key, got, want in _pairs(runs, arch, cell):
        assert got.shape == want.shape, key
        if arch in GRAD_ARCHS and "items" in key:
            assert got.shape[0] * MESH[1] == ref[key].shape[0], key
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), err_msg=key,
                                   **STEP_TOL)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_train_grad_blocks_match_reference(runs, arch):
    """DIN's and BERT4Rec's train gradients (``CellPlan.grads``: each
    rank's blocks after the sum over the batch axes, ``items`` its row
    block) against the reference plan's ``jax.grad`` at the rank's
    coordinate."""
    pairs = _pairs(runs, arch, "grads")
    assert any(k.endswith("['items']") for k, _, _ in pairs)
    for key, got, want in pairs:
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, err_msg=key, **GRAD_TOL)


if __name__ == "__main__":
    side, inp_path, out_dir = sys.argv[1:4]
    {"jax": jax_side, "port": port_side}[side](inp_path, out_dir)
