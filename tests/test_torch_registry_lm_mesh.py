"""The registry's LM plans on a mesh: the port's plan functions on 8 gloo
ranks against the reference's plan functions under ``jit`` with the plans'
shardings on 8 XLA host devices, each rank holding exactly its blocks of
every argument and output under the plan's ``in_specs`` and ``out_specs``.

The five LM archs run at narrow widths (``narrow_configs``) with the
registry's own rules, optimizers and mesh fields, and cut cells
(``NARROW_SHAPES``): ``train_4k`` (two microbatches of gradient
accumulation; FSDP for qwen3-moe and deepseek; the ZeRO-sharded AdamW
moments of nemotron and qwen3-moe; deepseek's Adafactor; each from a
random optimizer state), ``prefill_32k``
and three ``decode_32k`` steps over a random f32 cache (each rank's block
made by ``lm.init_cache`` under the mesh), on a (2, 4) and a
(4, 2) ("data", "model") mesh, and deepseek's and qwen3-moe's train cells
on a (2, 2, 2) ("pod", "data", "model") mesh under the multi-pod FSDP rules
(qwen3-moe's ZeRO moments keep the one-pod rules). The narrow
widths keep the traps of the full ones: kv heads that a model block cuts
(a half head on qwen3-1.7b's, a quarter on qwen3-moe's), qwen2's
replicated attention with context-parallel attention, tied embeddings,
qk-norm, MLA's latents, factored and unfactored Adafactor leaves, and a
vocab the axis divides. Each test holds a rank's block of an output (the
logits' vocab block, the cache's sequence block, the loss, each updated
param and optimizer-state leaf) against the reference's block at the
rank's mesh coordinate; deepseek's train gradients (``CellPlan.grads``) are
held as well, since its Adafactor step moves the params and state too
little to show a wrong gradient.

One more test builds every LM cell at full size on both production meshes
and holds rank 0's argument blocks (``CellPlan.local_specs``, which is
``in_specs`` for every LM cell) against the reference's ``in_specs`` blocks:
the same elements in each, and the same bytes except the AdamW moments,
which the port keeps in float32 where the reference keeps the params'
dtype (``repro_torch.optim``).

This file is also the script both sides run:

    python tests/test_torch_registry_lm_mesh.py jax|port INPUTS.npz OUT_DIR [GROUP]

Tolerances (f32): the loss, logits, caches and updated params ``atol
1e-4`` (``tests/test_torch_lm_mesh.py``'s LM tolerance), the optimizer
state ``atol 1e-5`` (the step tolerance of
``tests/test_torch_registry_mesh.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_DEV = 8
ARCHS = ["qwen3-1.7b", "qwen2-0.5b", "nemotron-4-15b", "qwen3-moe-30b-a3b",
         "deepseek-v3-671b"]
CELLS = ["train_4k", "prefill_32k", "decode_32k"]
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CASES = {m: [(a, c) for a in ARCHS for c in CELLS] for m in ("2x4", "4x2")}
CASES["2x2x2"] = [("deepseek-v3-671b", "train_4k"),
                  ("qwen3-moe-30b-a3b", "train_4k")]
NARROW_SHAPES = {"train_4k": dict(seq=16, batch=32),
                 "prefill_32k": dict(seq=32, batch=8),
                 "decode_32k": dict(seq=32, batch=8)}
DECODE_STEPS = 3
# the Adafactor case: a factored leaf and an unfactored one, the last dim
# over model and the row dim over data
ADA_LR = 1e-2
ADA_LEAVES = {"f": ((2, 256, 128), (None, "data", "model")),
              "u": ((64, 32), ("data", "model"))}
LM_TOL = dict(rtol=0, atol=1e-4)
# the archs whose train gradients are held as well: deepseek's Adafactor
# step moves a param by about its rate (1e-4) and its state by (1 - beta)
# g^2, which hide a wrong gradient from the step's checks
GRAD_ARCHS = ("deepseek-v3-671b",)
STATE_TOL = dict(rtol=0, atol=1e-5)
# rank 0's argument bytes at full size on 16 x 16, in GB (1e9), as the
# reference's in_specs give them: train (params, optimizer state), prefill
# (params), decode (params, cache); the state's only where the reference
# and the port keep it in one dtype (Adafactor's)
TABLE_GB = {
    "qwen3-1.7b": ((0.2, None), (0.2,), (0.2, 1.9)),
    "qwen2-0.5b": ((0.1, None), (0.1,), (0.1, 0.2)),
    "nemotron-4-15b": ((2.0, None), (2.0,), (2.0, 2.1)),
    "qwen3-moe-30b-a3b": ((0.3, None), (0.3,), (0.5, 1.6)),
    "deepseek-v3-671b": ((5.7, 0.2), (7.5,), (7.5, 1.2)),
}


def narrow_configs(pkg: str) -> dict:
    """Each LM arch's config of ``pkg`` (``repro`` or ``repro_torch``) at
    narrow width, its other fields (the mesh fields too) the registry's."""
    lm = importlib.import_module(f"{pkg}.models.lm")
    moe = importlib.import_module(f"{pkg}.models.moe")
    mla = importlib.import_module(f"{pkg}.models.mla")
    cfgs = {n: importlib.import_module(f"{pkg}.configs.base").get_arch(n).cfg
            for n in ARCHS}
    base = dict(d_model=64, d_ff=128, vocab=256)
    out = {
        "qwen3-1.7b": dict(base, n_layers=2, n_heads=4, n_kv_heads=2,
                           d_head=16),
        "qwen2-0.5b": dict(base, n_layers=2, n_heads=4, n_kv_heads=1,
                           d_head=16),
        "nemotron-4-15b": dict(base, n_layers=4, n_heads=8, n_kv_heads=2,
                               d_head=8),
        "qwen3-moe-30b-a3b": dict(base, n_layers=4, n_heads=4, n_kv_heads=1,
                                  d_head=16),
        "deepseek-v3-671b": dict(base, d_model=128, n_layers=3,
                                 n_dense_layers=1, n_heads=4, n_kv_heads=4),
    }
    out = {n: dataclasses.replace(cfgs[n], **kw) for n, kw in out.items()}
    q = out["qwen3-moe-30b-a3b"]
    out["qwen3-moe-30b-a3b"] = dataclasses.replace(q, moe=dataclasses.replace(
        q.moe, d_model=64, d_expert=32, n_experts=8, top_k=2))
    d = out["deepseek-v3-671b"]
    out["deepseek-v3-671b"] = dataclasses.replace(
        d, moe=dataclasses.replace(d.moe, d_model=128, d_expert=32,
                                   n_experts=8, top_k=2),
        mla=mla.MLAConfig(d_model=128, n_heads=4, q_lora_rank=32,
                          kv_lora_rank=16, nope_head_dim=16, rope_head_dim=8,
                          v_head_dim=16, rope_theta=d.mla.rope_theta))
    assert all(isinstance(c, lm.LMConfig) for c in out.values())
    assert isinstance(out["qwen3-moe-30b-a3b"].moe, moe.MoEConfig)
    return out


def _narrow(pkg: str):
    """``pkg``'s LM shapes cut to ``NARROW_SHAPES`` (in place, in the
    processes each side runs in); returns the narrow bundles by arch."""
    common = importlib.import_module(f"{pkg}.configs.lm_common")
    lm = importlib.import_module(f"{pkg}.models.lm")
    common.LM_SHAPES.update(NARROW_SHAPES)
    base = importlib.import_module(f"{pkg}.configs.base")
    out = {}
    for name, cfg in narrow_configs(pkg).items():
        b = base.get_arch(name)
        out[name] = dataclasses.replace(
            b, cfg=cfg, init=functools.partial(lm.init, cfg=cfg))
    return out


def make_inputs() -> dict[str, np.ndarray]:
    """Each arch's params (the port's init, f32, ``<arch>/p<path>``), its
    optimizer state after earlier steps (``_state_leaf``,
    ``<arch>/s<path>``), each cell's tokens and targets, and a random f32
    decode cache (``<arch>/cache/<name>``)."""
    import torch

    from repro_torch import tree
    from repro_torch.models import lm

    from repro_torch.configs import base

    rng = np.random.default_rng(0)
    out: dict[str, np.ndarray] = {}
    for name, cfg in narrow_configs("repro_torch").items():
        params = lm.init(3, cfg, device="cpu")
        for path, leaf in tree.flatten_with_path(params):
            out[f"{name}/p{path}"] = leaf.numpy()
        state = base.get_arch(name).optimizer.init(params)
        for path, leaf in tree.flatten_with_path(state):
            out[f"{name}/s{path}"] = _state_leaf(path, tuple(leaf.shape), rng)
        tr, pre, dec = (NARROW_SHAPES[c] for c in CELLS)
        for key, shape in (("train/tokens", (2, tr["batch"] // 2,
                                             tr["seq"])),
                           ("train/targets", (2, tr["batch"] // 2,
                                              tr["seq"])),
                           ("prefill/tokens", (pre["batch"], pre["seq"])),
                           ("decode/tokens", (DECODE_STEPS, dec["batch"]))):
            out[f"{name}/{key}"] = rng.integers(0, cfg.vocab, shape) \
                .astype(np.int32)
        cache = lm.init_cache(cfg, dec["batch"], dec["seq"], device="meta")
        for k, v in cache.items():
            out[f"{name}/cache/{k}"] = rng.standard_normal(
                tuple(v.shape)).astype(np.float32)
    from repro_torch import optim
    params = {k: torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32))
              for k, (shape, _) in ADA_LEAVES.items()}
    for path, leaf in tree.flatten_with_path(params):
        out[f"ada/p{path}"] = leaf.numpy()
        out[f"ada/g{path}"] = rng.standard_normal(tuple(leaf.shape)) \
            .astype(np.float32)
    for path, leaf in tree.flatten_with_path(
            optim.adafactor(ADA_LR).init(params)):
        out[f"ada/s{path}"] = _state_leaf(path, tuple(leaf.shape), rng)
    return out


def _state_leaf(path: str, shape: tuple, rng) -> np.ndarray:
    """A random optimizer-state leaf as earlier steps leave it: the step
    count 3, second moments and factored statistics positive, AdamW's
    first moments of either sign. (At zero moments the first step is
    ``sign(g)`` times the rate, and a gradient at rounding noise around 0
    flips it.)"""
    if path.endswith("['t']"):
        return np.array(3, dtype=np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if "['m']" in path:
        return 1e-2 * x
    return (1e-4 * (1.0 + 0.5 * np.tanh(x))).astype(np.float32)


def _train_batch(inp, name: str, nmb: int):
    """The train cell's batch: two microbatches, or one of both halves."""
    tok, tgt = inp[f"{name}/train/tokens"], inp[f"{name}/train/targets"]
    if nmb == 2:
        return tok, tgt
    return tok.reshape(1, -1, tok.shape[-1]), tgt.reshape(1, -1,
                                                          tgt.shape[-1])


def block_elems(mesh_shape: dict, shape, spec) -> int:
    """The elements of rank 0's block of a ``shape`` array under
    ``spec`` (entries as tuples of axis names or None)."""
    n = 1
    for i, size in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n *= size // math.prod(mesh_shape[a] for a in axes)
    return n


# -- the reference side (a subprocess with 8 XLA host devices) --------------


def jax_bytes() -> dict[str, np.ndarray]:
    """Rank 0's (elements, bytes) of each argument of every LM cell at full
    size on both production meshes, by the reference's in_specs."""
    import jax
    from jax.sharding import PartitionSpec as JP

    from repro.configs import base
    out = {}
    for mp, mesh_shape in ((False, dict(data=16, model=16)),
                           (True, dict(pod=2, data=16, model=16))):
        for name in ARCHS:
            bundle = base.get_arch(name)
            for cell in CELLS:
                plan = bundle.steps[cell].make_fn(bundle, None, mp)
                rows = []
                for arg, specs in zip(plan.args, plan.in_specs, strict=True):
                    leaves = jax.tree.leaves(arg)
                    spec_leaves = jax.tree.leaves(
                        specs, is_leaf=lambda x: isinstance(x, JP))
                    el = [block_elems(mesh_shape, x.shape, tuple(s))
                          for x, s in zip(leaves, spec_leaves, strict=True)]
                    rows.append((sum(el), sum(
                        e * np.dtype(x.dtype).itemsize
                        for e, x in zip(el, leaves, strict=True))))
                out[f"bytes/{name}/{cell}/{int(mp)}"] = np.array(rows)
    return out


def _groups() -> dict[str, tuple]:
    """The reference's work in groups of about equal compile time, one
    subprocess each: {name: (mesh, cases, whether it counts the full-size
    blocks)}."""
    out = {}
    for m in ("2x4", "4x2"):
        out[f"{m}-deepseek"] = (m, [c for c in CASES[m]
                                    if c[0] == "deepseek-v3-671b"], False)
        out[f"{m}-rest"] = (m, [c for c in CASES[m]
                                if c[0] != "deepseek-v3-671b"], False)
    out["2x2x2"] = ("2x2x2", CASES["2x2x2"], False)
    out["bytes"] = (None, [], True)
    return out


def jax_side(inp_path: str, out_dir: str, group: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from jax.tree_util import keystr, tree_flatten_with_path

    from repro.compat import make_mesh

    assert len(jax.devices()) == N_DEV
    inp = dict(np.load(inp_path))
    mname, cases, count = _groups()[group]
    res: dict[str, np.ndarray] = jax_bytes() if count else {}
    if mname is None:
        np.savez(os.path.join(out_dir, f"ref_{group}.npz"), **res)
        return
    bundles = _narrow("repro")
    shape, axes = MESHES[mname]
    mesh = make_mesh(shape, axes)

    def load(prefix, like):
        flat, treedef = tree_flatten_with_path(like)
        return treedef.unflatten([jnp.asarray(inp[prefix + keystr(p)])
                                  for p, _ in flat])

    def named(specs):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                            is_leaf=lambda x: isinstance(x, JP))

    def put(key, out):
        for path, x in tree_flatten_with_path(out)[0]:
            res[f"{key}{keystr(path)}"] = np.asarray(x.astype(jnp.float32))

    for name, cell in cases:
        bundle = bundles[name]
        plan = bundle.steps[cell].make_fn(bundle, mesh, len(shape) == 3)
        params = load(f"{name}/p", plan.args[0])
        fn = jax.jit(plan.fn, in_shardings=named(plan.in_specs),
                     out_shardings=named(plan.out_specs))
        key = f"{mname}/{name}/{cell}"
        with mesh:
            if cell == "train_4k":
                tok, tgt = _train_batch(inp, name, plan.args[2]["tokens"]
                                        .shape[0])
                args = (params, load(f"{name}/s",
                                     bundle.optimizer.init(params)),
                        {"tokens": jnp.asarray(tok),
                         "targets": jnp.asarray(tgt)})
                put(key, fn(*args))
                if name in GRAD_ARCHS:
                    put(f"grads/{mname}/{name}",
                        _jax_grads(bundle, mesh, len(shape) == 3, named,
                                   args)[0])
            elif cell == "prefill_32k":
                put(key, fn(params, jnp.asarray(inp[f"{name}/prefill/"
                                                    "tokens"])))
            else:
                cache = {k: jnp.asarray(inp[f"{name}/cache/{k}"])
                         for k in plan.args[1]}
                for i in range(DECODE_STEPS):
                    logits, cache = fn(params, cache, jnp.asarray(
                        inp[f"{name}/decode/tokens"][i]))
                    put(f"{key}/step{i}", logits)
                put(f"{key}/cache", cache)
    np.savez(os.path.join(out_dir, f"ref_{group}.npz"), **res)


def _jax_grads(bundle, mesh, multi_pod: bool, named, args):
    """The reference train plan's gradients at ``args``: the plan run under
    ``jit`` with an optimizer whose update returns the gradients as the new
    params (laid out by the params' specs)."""
    import jax

    from repro import optim as joptim
    opt = bundle.optimizer
    bundle = dataclasses.replace(bundle, optimizer=joptim.Optimizer(
        opt.init, lambda g, s, p: (g, s), opt.state_specs))
    plan = bundle.steps["train_4k"].make_fn(bundle, mesh, multi_pod)
    return jax.jit(plan.fn, in_shardings=named(plan.in_specs),
                   out_shardings=named(plan.out_specs))(*args)


# -- the port side (8 gloo processes) ---------------------------------------


def port_worker(rank: int, inp_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import optim, tree
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed.shardings import P, NamedSharding

    torch.set_num_threads(1)
    M.init("cpu", rank=rank, world_size=N_DEV,
           store=dist.FileStore(os.path.join(out_dir, "store"), N_DEV))
    inp = {k: torch.from_numpy(v) for k, v in np.load(inp_path).items()}
    bundles = _narrow("repro_torch")
    res: dict[str, np.ndarray] = {}

    def load(prefix, like):
        return tree.unflatten(like, [inp[prefix + p] for p, _ in
                                     tree.flatten_with_path(like)])

    def put(key, out):
        for path, x in tree.flatten_with_path(out):
            res[f"{key}{path}"] = x.detach().float().numpy()

    for mname, (shape, axes) in MESHES.items():
        mesh = M.make_mesh(shape, axes, "cpu")
        res[f"{mname}/coord"] = np.array([mesh.coord[a] for a in axes])
        if len(shape) == 2:
            opt = optim.adafactor(ADA_LR)
            params = {k: inp[f"ada/p['{k}']"] for k in ADA_LEAVES}
            specs = {k: P(*sp) for k, (_, sp) in ADA_LEAVES.items()}
            args = (tree.tree_map(lambda k: inp[f"ada/g['{k}']"],
                                  {k: k for k in ADA_LEAVES}),
                    load("ada/s", opt.init(params)), params)
            blocks = tree.tree_map(
                lambda x, sp: NamedSharding(mesh, sp).shard(x), args,
                (specs, opt.state_specs(params, specs), specs))
            put(f"{mname}/ada", opt.on_blocks(mesh, specs)(*blocks))
        for name, cell in CASES[mname]:
            bundle = bundles[name]
            plan = bundle.steps[cell].make_fn(bundle, mesh, len(shape) == 3)
            assert plan.layout is None
            params = load(f"{name}/p", plan.args[0])
            key = f"{mname}/{name}/{cell}"
            if cell == "train_4k":
                tok, tgt = _train_batch(inp, name, plan.args[2]["tokens"]
                                        .shape[0])
                args = (params, load(f"{name}/s",
                                     bundle.optimizer.init(params)),
                        {"tokens": tok, "targets": tgt})
            elif cell == "prefill_32k":
                args = (params, inp[f"{name}/prefill/tokens"])
            else:
                args = (params, {k: inp[f"{name}/cache/{k}"]
                                 for k in plan.args[1]},
                    inp[f"{name}/decode/tokens"][0])
            blocks = tree.tree_map(lambda x, s: NamedSharding(mesh, s)
                                   .shard(x), args, plan.local_specs())
            if cell == "train_4k" and name in GRAD_ARCHS:
                put(f"grads/{mname}/{name}",
                    plan.grads(blocks[0], blocks[2])[1])
            if cell != "decode_32k":
                put(key, plan.fn(*blocks))
                continue
            # the cache's block made by init_cache, filled with the input's
            p_b, cache = blocks[0], _cache_block(bundle.cfg, mesh, blocks[1])
            tok_spec = plan.local_specs()[2]
            with torch.no_grad():
                for i in range(DECODE_STEPS):
                    logits, cache = plan.fn(p_b, cache, NamedSharding(
                        mesh, tok_spec).shard(inp[f"{name}/decode/tokens"][i]))
                    put(f"{key}/step{i}", logits)
            put(f"{key}/cache", cache)
    np.savez(os.path.join(out_dir, f"port_{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def _cache_block(cfg, mesh, want: dict) -> dict:
    """``lm.init_cache``'s block of the narrow decode cache on this rank
    (its rows over the batch axes, its slots over ``model``), checked zero
    and filled with ``want``, the input cache's block; raises where
    ``init_cache``'s block has another shape, or where it makes a block of
    a cache whose slots do not split over ``model``."""
    import torch

    from repro_torch.configs.lm_common import LM_SHAPES
    from repro_torch.models import lm
    cfg = dataclasses.replace(cfg, batch_axes=tuple(
        a for a in mesh.axis_names if a != "model"))
    shp = LM_SHAPES["decode_32k"]
    with pytest.raises(ValueError, match="does not split"):
        lm.init_cache(cfg, shp["batch"], shp["seq"] + 1, torch.float32,
                      "cpu", mesh)
    cache = lm.init_cache(cfg, shp["batch"], shp["seq"], torch.float32,
                          "cpu", mesh)
    assert sorted(cache) == sorted(want)
    for k, x in cache.items():
        assert not x.any()
        x.copy_(want[k])
    return cache


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


def port_bytes() -> dict[str, np.ndarray]:
    """``jax_bytes``' counts for the port's plans (rank 0's blocks under
    ``local_specs``), with each plan's ``layout``."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import base
    from repro_torch.distributed.shardings import block_index
    out = {}
    for mp, mesh_shape in ((False, dict(data=16, model=16)),
                           (True, dict(pod=2, data=16, model=16))):
        coord = {a: 0 for a in mesh_shape}
        for name in ARCHS:
            bundle = base.get_arch(name)
            for cell in CELLS:
                plan = bundle.steps[cell].make_fn(bundle, None, mp)
                out[f"layout/{name}/{cell}/{int(mp)}"] = plan.layout
                rows = []
                for arg, specs in zip(plan.args, plan.local_specs(),
                                      strict=True):
                    el = [math.prod(s.stop - s.start for s in block_index(
                        mesh_shape, s, tuple(x.shape), coord))
                        for x, s in zip(tree.leaves(arg),
                                        tree.flatten_up_to(arg, specs),
                                        strict=True)]
                    rows.append((sum(el), sum(
                        e * torch.empty((), dtype=x.dtype).element_size()
                        for e, x in zip(el, tree.leaves(arg), strict=True))))
                out[f"bytes/{name}/{cell}/{int(mp)}"] = np.array(rows)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, [port outputs of each rank], the port's full-size
    block counts): the reference's subprocesses (``_groups``) and the
    port's 8 ranks started together, the counts taken while they run."""
    d = tmp_path_factory.mktemp("registry_lm_mesh")
    inp = str(d / "inputs.npz")
    np.savez(inp, **make_inputs())
    refs = {g: _run("jax", inp, str(d), g, JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count="
                              f"{N_DEV}") for g in _groups()}
    port = _run("port", inp, str(d))
    counts = port_bytes()
    _wait(port, "port")
    ref = {}
    for m, proc in refs.items():
        _wait(proc, f"reference ({m})")
        ref.update(np.load(d / f"ref_{m}.npz"))
    return ref, [dict(np.load(d / f"port_{r}.npz")) for r in range(N_DEV)], \
        counts, dict(np.load(inp))


def _out_specs(mname: str, name: str, cell: str) -> dict:
    """{output key: out_spec} of a case, decode's per step and its cache."""
    from repro_torch import tree
    from repro_torch.configs import lm_common
    full = dict(lm_common.LM_SHAPES)
    try:
        bundles = _narrow("repro_torch")
        plan = bundles[name].steps[cell].make_fn(bundles[name], None,
                                                 mname == "2x2x2")
    finally:
        lm_common.LM_SHAPES.update(full)
    key = f"{mname}/{name}/{cell}"
    if cell != "decode_32k":
        return {f"{key}{p}": s for p, s in
                tree.flatten_with_path(plan.out_specs)}
    out = {f"{key}/step{i}": plan.out_specs[0] for i in range(DECODE_STEPS)}
    out.update({f"{key}/cache{p}": s for p, s in
                tree.flatten_with_path(plan.out_specs[1])})
    return out


def _pairs(runs, mname: str, name: str, cell: str):
    """(key, port block, reference block) at every rank's coordinate."""
    from repro_torch.distributed.shardings import block_index
    ref, ranks, _, _ = runs
    shape, axes = MESHES[mname]
    specs = _out_specs(mname, name, cell)
    assert sorted(specs) == sorted(k for k in ref
                                   if k.startswith(f"{mname}/{name}/{cell}"))
    out = []
    for got in ranks:
        coord = dict(zip(axes, got[f"{mname}/coord"].tolist(), strict=True))
        for key, spec in specs.items():
            want = ref[key]
            idx = block_index(dict(zip(axes, shape, strict=True)), spec,
                              want.shape, coord)
            out.append((key, got[key], want[idx]))
    return out


@pytest.mark.parametrize("mname,name,cell",
                         [(m, a, c) for m, cases in CASES.items()
                          for a, c in cases])
def test_lm_plan_blocks_match_reference(runs, mname, name, cell):
    """Every output block of the cell on every rank: train's loss, updated
    params and optimizer state, prefill's logits and cache, decode's
    logits at each step and its cache after the last."""
    pairs = _pairs(runs, mname, name, cell)
    assert pairs
    for key, got, want in pairs:
        assert got.shape == want.shape, key
        state = cell == "train_4k" and key.split(cell, 1)[1][:3] == "[1]"
        tol = STATE_TOL if state else LM_TOL
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), err_msg=key,
                                   **tol)


@pytest.mark.parametrize("mname", list(MESHES))
def test_train_grad_blocks_match_reference(runs, mname):
    """The train plan's gradients (``CellPlan.grads``: the loss's
    gradient blocks after the data-parallel sum, FSDP's and MLA's TP
    backward included) of each ``GRAD_ARCHS`` arch, on every rank, against
    the reference's at the rank's coordinate."""
    from repro_torch import tree
    from repro_torch.configs import lm_common
    from repro_torch.distributed.shardings import block_index
    ref, ranks, _, _ = runs
    shape, axes = MESHES[mname]
    mesh_shape = dict(zip(axes, shape, strict=True))
    for name in GRAD_ARCHS:
        full = dict(lm_common.LM_SHAPES)
        try:
            bundle = _narrow("repro_torch")[name]
            plan = bundle.steps["train_4k"].make_fn(bundle, None,
                                                    len(shape) == 3)
        finally:
            lm_common.LM_SHAPES.update(full)
        specs = {f"grads/{mname}/{name}{p}": s
                 for p, s in tree.flatten_with_path(plan.in_specs[0])}
        assert sorted(specs) == sorted(k for k in ref
                                       if k.startswith(f"grads/{mname}/"
                                                       f"{name}["))
        for got in ranks:
            coord = dict(zip(axes, got[f"{mname}/coord"].tolist(),
                             strict=True))
            for key, spec in specs.items():
                want = ref[key]
                idx = block_index(mesh_shape, spec, want.shape, coord)
                assert got[key].shape == want[idx].shape, key
                np.testing.assert_allclose(got[key], want[idx], err_msg=key,
                                           **LM_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_full_size_blocks_match_reference(runs, name):
    """Every LM cell of ``name`` on both production meshes: ``layout`` is
    None, and rank 0's block of each argument under ``local_specs()`` has
    the elements of the reference's ``in_specs`` block, and its bytes
    except the AdamW moments (float32 in the port); the 16 x 16 blocks are
    the table's GB."""
    ref, _, counts, _ = runs
    adamw = name != "deepseek-v3-671b"
    for cell_i, cell in enumerate(CELLS):
        for mp in (0, 1):
            assert counts[f"layout/{name}/{cell}/{mp}"] is None
            got = counts[f"bytes/{name}/{cell}/{mp}"]
            want = ref[f"bytes/{name}/{cell}/{mp}"]
            np.testing.assert_array_equal(got[:, 0], want[:, 0])
            for arg in range(len(got)):
                if adamw and cell == "train_4k" and arg == 1:
                    assert got[arg, 1] == 4 * got[arg, 0]     # float32
                else:
                    assert got[arg, 1] == want[arg, 1], (cell, mp, arg)
        for arg, gb in enumerate(TABLE_GB[name][cell_i]):
            if gb is not None:
                got_gb = counts[f"bytes/{name}/{cell}/0"][arg, 1] / 1e9
                assert abs(got_gb - gb) <= 0.05 + 1e-9, (cell, arg, got_gb)


@pytest.mark.parametrize("mname", ["2x4", "4x2"])
def test_adafactor_on_blocks_matches_whole_update(runs, mname):
    """``adafactor``'s update on each rank's blocks (``on_blocks``: the row
    and column statistics, their mean and the update's RMS summed over the
    axes that shard them) against the reference's update of the whole
    arrays, for a factored leaf and an unfactored one: the new params'
    blocks and the state's."""
    import jax.numpy as jnp
    import torch
    from jax.tree_util import keystr, tree_flatten_with_path

    from repro import optim as joptim
    from repro_torch import optim, tree
    from repro_torch.distributed.shardings import P, block_index
    _, ranks, _, inp = runs
    shape, axes = MESHES[mname]
    params = {k: jnp.asarray(inp[f"ada/p['{k}']"]) for k in ADA_LEAVES}
    grads = {k: jnp.asarray(inp[f"ada/g['{k}']"]) for k in ADA_LEAVES}
    opt = joptim.adafactor(ADA_LR)
    state = opt.init(params)
    flat, treedef = tree_flatten_with_path(state)
    state = treedef.unflatten([jnp.asarray(inp[f"ada/s{keystr(p)}"])
                               for p, _ in flat])
    want = {keystr(p): np.asarray(x) for p, x in tree_flatten_with_path(
        opt.update(grads, state, params))[0]}
    specs = {k: P(*sp) for k, (_, sp) in ADA_LEAVES.items()}
    meta = {k: torch.empty(s, device="meta")
            for k, (s, _) in ADA_LEAVES.items()}
    out_specs = dict(tree.flatten_with_path(
        (specs, optim.adafactor(ADA_LR).state_specs(meta, specs))))
    assert sorted(out_specs) == sorted(want)
    for got in ranks:
        coord = dict(zip(axes, got[f"{mname}/coord"].tolist(), strict=True))
        for key, spec in out_specs.items():
            idx = block_index(dict(zip(axes, shape, strict=True)), spec,
                              want[key].shape, coord)
            tol = LM_TOL if key.startswith("[0]") else STATE_TOL
            np.testing.assert_allclose(got[f"{mname}/ada{key}"],
                                       want[key][idx], err_msg=key, **tol)


if __name__ == "__main__":
    {"jax": jax_side, "port": port_side}[sys.argv[1]](*sys.argv[2:])
