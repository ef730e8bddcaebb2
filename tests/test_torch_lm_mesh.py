"""The port's LM under a mesh (``models.moe``'s mesh variants, the mesh
branches of ``models.lm``) against the reference's ``shard_map``/``jit``,
rank by rank, on the CPU.

Both sides take the same numpy inputs (made here from a seed; the
parameters are the port's init). The reference runs in one subprocess per
mesh with 8 forced XLA host devices, as ``tests/test_multidev.py`` runs it;
the port runs in 8 gloo processes of ``torch.distributed`` (one spawn for
every case), as ``tests/test_torch_sharded.py`` does. The reference writes
each output whole; each rank of the port holds and writes its blocks: the
params' blocks under the reference's rules (``configs.lm_common``'s
``lm_param_rules``, with qwen2's replicated attention for the
context-parallel archs and ``serve_rules_2d`` for the 2D serving cases),
its batch rows of every output, the logits' vocab block and the caches'
sequence block (the plans' out_specs), and each gradient's block after the
data-parallel sum over the batch axes its spec leaves out, each with the
index of its block. Each test holds the port's block at a mesh coordinate
against the reference's block there, on a (2, 4) and a (4, 2) ("data",
"model") mesh.

The cases: ``moe_ffn_sharded`` and ``moe_ffn_2d`` (with a shared expert,
and with ``token_chunk``) at the reference's capacity_factor 8.0
(``tests/test_multidev.py:126-166``) and at one that drops assignments, so
that the capacity of each rank's own call is held to the token;
context-parallel ``backbone``, forward and gradients
(``tests/test_multidev.py:273-294``), and with ``seq_shard`` and grouped
remat; narrow qwen3-moe (sharded and 2D EP) and deepseek (MLA, a shared
expert, the router bias, MTP) ``train_loss`` and every gradient; ``prefill``
and three ``decode_step``s in both EP layouts, 2D with ``token_chunk``, and
with context-parallel attention.

This file is also the script both sides run:

    python tests/test_torch_lm_mesh.py jax|port INPUTS.npz OUT_DIR [MESH]

Tolerances (f32): the MoE functions ``atol 2e-5`` and context-parallel
``backbone`` ``atol 2e-4``, gradients ``5e-3``, as in
``tests/test_multidev.py``; the LM's losses, logits, caches and gradients
``atol 1e-4``, as in ``tests/test_torch_lm.py``.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_DEV = 8
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
FN_TOL = dict(atol=2e-5)
CP_TOL, CP_GRAD_TOL = dict(atol=2e-4), dict(atol=5e-3)
LM_TOL = dict(atol=1e-4)
DECODE_STEPS = 3
# the cache's slots past the prompt: the decode steps', rounded up so that
# the sequence splits over either mesh's model axis
CACHE_PAD = 4

# MoE function cases: the body, the shared expert, token_chunk, the
# capacity factor and the (B, T) of the input
FN_CASES = {
    "sharded": dict(kind="sharded", shared=0, cf=8.0, bt=(8, 6)),
    "sharded_shared": dict(kind="sharded", shared=1, cf=8.0, bt=(8, 6)),
    "2d": dict(kind="2d", shared=1, cf=8.0, bt=(8, 6)),
    "2d_chunk": dict(kind="2d", shared=1, cf=8.0, bt=(8, 6), chunk=6),
    "sharded_drop": dict(kind="sharded", shared=0, cf=0.5, bt=(8, 16)),
    "2d_drop": dict(kind="2d", shared=1, cf=0.5, bt=(8, 16)),
    "2d_chunk_drop": dict(kind="2d", shared=1, cf=0.5, bt=(8, 16), chunk=8),
}
DROP_CASES = [c for c in FN_CASES if c.endswith("_drop")]

# LM cases: the arch (``lm_configs``), what runs, the config's mesh fields
# and the (B, T) of the tokens
LM_CASES = {
    "cp_backbone": dict(arch="cp", kind="backbone", bt=(4, 64)),
    "cp_seq_shard": dict(arch="cp4", kind="backbone", bt=(4, 64),
                         kw=dict(seq_shard=True)),
    "qwen3_moe_loss": dict(arch="qwen3-moe", kind="loss", bt=(8, 16)),
    "qwen3_moe_loss_2d": dict(arch="qwen3-moe", kind="loss", bt=(8, 16),
                              kw=dict(ep_2d=True)),
    "deepseek_loss": dict(arch="deepseek", kind="loss", bt=(8, 16)),
    "qwen3_moe_serve": dict(arch="qwen3-moe", kind="serve", bt=(8, 16)),
    "qwen3_moe_serve_2d": dict(arch="qwen3-moe", kind="serve", bt=(8, 16),
                               kw=dict(ep_2d=True)),
    "deepseek_serve_2d_chunk": dict(arch="deepseek", kind="serve",
                                    bt=(8, 16),
                                    kw=dict(ep_2d=True, ep_token_chunk=16)),
    "qwen2_cp_serve": dict(arch="qwen2-cp", kind="serve", bt=(8, 16)),
}
GRAD_CASES = [c for c, k in LM_CASES.items() if k["kind"] != "serve"]
SERVE_CASES = [c for c, k in LM_CASES.items() if k["kind"] == "serve"]


def moe_config(moe_cls, c: dict):
    return moe_cls(d_model=16, d_expert=32, n_experts=8, top_k=2,
                   n_shared=c["shared"], capacity_factor=c["cf"])


def moe_specs(p_cls, c: dict) -> dict:
    """The in_specs of a function case's params (``tests/test_multidev.py``
    's), with either package's PartitionSpec class."""
    if c["kind"] == "sharded":
        specs = {"router": p_cls(), "w_gate": p_cls("model"),
                 "w_up": p_cls("model"), "w_down": p_cls("model")}
        shared = (p_cls(None, "model"), p_cls("model", None))
    else:
        specs = {"router": p_cls(), "w_gate": p_cls("model", None, "data"),
                 "w_up": p_cls("model", None, "data"),
                 "w_down": p_cls("model", "data", None)}
        shared = (p_cls(None, ("data", "model")),
                  p_cls(("data", "model"), None))
    if c["shared"]:
        specs["shared"] = {"w_gate": {"w": shared[0]},
                           "w_up": {"w": shared[0]},
                           "w_down": {"w": shared[1]}}
    return specs


def lm_configs(lm_mod, moe_cls, mla_cls) -> dict:
    """The narrow archs of the LM cases, for either package: the CP model of
    ``tests/test_multidev.py:273-294`` (and a 4-layer one with grouped
    remat), and the reduced qwen3-moe, deepseek and qwen2 of
    ``tests/test_models.py`` with the mesh fields of their registry
    bundles."""
    base = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=256, rope_theta=10_000.0, remat=False,
                q_chunk=64, kv_chunk=64, batch_axes=("data",))
    cp = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab=128, remat=False, q_chunk=16, kv_chunk=16,
              batch_axes=("data",), context_parallel=True)
    return {
        "cp": lm_mod.LMConfig(**cp),
        "cp4": lm_mod.LMConfig(**{**cp, "n_layers": 4, "remat": True,
                                  "remat_group": 2}),
        "qwen3-moe": lm_mod.LMConfig(
            **base, qk_norm=True, ep_axis="model",
            moe=moe_cls(d_model=64, d_expert=32, n_experts=8, top_k=2,
                        capacity_factor=2.0)),
        "deepseek": lm_mod.LMConfig(**{
            **base, "n_heads": 4, "n_kv_heads": 4}, n_dense_layers=1,
            mtp=True, ep_axis="model",
            mla=mla_cls(d_model=64, n_heads=4, q_lora_rank=32,
                        kv_lora_rank=16, nope_head_dim=16, rope_head_dim=8,
                        v_head_dim=16),
            moe=moe_cls(d_model=64, d_expert=32, n_experts=4, top_k=2,
                        n_shared=1, router_bias=True, capacity_factor=2.0)),
        "qwen2-cp": lm_mod.LMConfig(**{**base, "n_kv_heads": 1},
                                    qkv_bias=True, tie_embeddings=True,
                                    context_parallel=True),
    }


def _case_cfg(cfgs: dict, c: dict):
    return dataclasses.replace(cfgs[c["arch"]], **c.get("kw", {}))


def case_rules(c: dict, cfg):
    """The port's param rules of an LM case: ``serve_rules_2d`` for the
    2D serving cases, the Megatron rules otherwise, with the attention
    replicated (qwen2's override) where it is context-parallel."""
    from repro_torch.configs.lm_common import lm_param_rules, serve_rules_2d
    from repro_torch.distributed.shardings import P
    if c["kind"] == "serve" and cfg.ep_2d:
        return serve_rules_2d(cfg)
    rules = lm_param_rules(cfg)
    if cfg.context_parallel:
        rules = [(k, P()) for k in ("['wq']", "['wk']", "['wv']", "['wo']",
                                    "['bq']", "['bk']", "['bv']")] + rules
    return rules


def make_inputs() -> dict[str, np.ndarray]:
    """Every input of both sides from one seed: each function case's MoE
    params (``fn/<case>/p<keystr path>``) and input, each arch's params
    (the port's init, ``lm/<arch>/p<path>``) and each LM case's tokens."""
    import torch

    from repro_torch import tree
    from repro_torch.models import lm, mla, moe

    rng = np.random.default_rng(0)
    out: dict[str, np.ndarray] = {}
    for name, c in FN_CASES.items():
        gen = torch.Generator().manual_seed(1)
        p = moe.init_moe(gen, moe_config(moe.MoEConfig, c))
        for path, leaf in tree.flatten_with_path(p):
            out[f"fn/{name}/p{path}"] = leaf.numpy()
        out[f"fn/{name}/x"] = rng.standard_normal(
            (*c["bt"], 16)).astype(np.float32)
    for arch, cfg in lm_configs(lm, moe.MoEConfig, mla.MLAConfig).items():
        p = lm.init(2, cfg, device="cpu")
        for path, leaf in tree.flatten_with_path(p):
            out[f"lm/{arch}/p{path}"] = leaf.numpy()
    for name, c in LM_CASES.items():
        vocab = lm_configs(lm, moe.MoEConfig, mla.MLAConfig)[c["arch"]].vocab
        b, t = c["bt"]
        out[f"lm/{name}/tokens"] = rng.integers(
            1, vocab, (b, t + DECODE_STEPS)).astype(np.int32)
        out[f"lm/{name}/targets"] = rng.integers(0, vocab, (b, t)) \
            .astype(np.int32)
    return out


# -- the reference side (a subprocess with 8 XLA host devices) --------------


def jax_side(inp_path: str, out_dir: str, mname: str) -> None:
    """The reference's outputs and gradients on the mesh ``mname`` into
    ``ref_<mname>.npz``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.tree_util import keystr, tree_flatten_with_path

    from repro.compat import make_mesh, shard_map
    from repro.models import lm as jlm
    from repro.models import mla as jmla
    from repro.models import moe as jmoe

    assert len(jax.devices()) == N_DEV
    inp = dict(np.load(inp_path))
    res: dict[str, np.ndarray] = {}
    mesh = make_mesh(MESHES[mname], ("data", "model"))

    def load(prefix, like):
        flat, treedef = tree_flatten_with_path(like)
        return treedef.unflatten([jnp.asarray(inp[prefix + keystr(p)])
                                  for p, _ in flat])

    def put_grads(key, grads):
        for path, g in tree_flatten_with_path(grads)[0]:
            res[f"{key}/grad{keystr(path)}"] = np.asarray(g)

    xspec = P("data", None, None)
    for name, c in FN_CASES.items():
        x = jnp.asarray(inp[f"fn/{name}/x"])

        def run(cf, c=c, name=name, x=x):
            mcfg = moe_config(jmoe.MoEConfig, {**c, "cf": cf})
            params = load(f"fn/{name}/p", jax.eval_shape(
                lambda: jmoe.init_moe(jax.random.PRNGKey(0), mcfg)))
            if c["kind"] == "sharded":
                def body(p, xx):
                    return jmoe.moe_ffn_sharded(p, xx, mcfg)
            else:
                def body(p, xx):
                    return jmoe.moe_ffn_2d(p, xx, mcfg, batch_axes=("data",),
                                           token_chunk=c.get("chunk"))
            fn = shard_map(body, mesh=mesh,
                           in_specs=(moe_specs(P, c), xspec),
                           out_specs=xspec, check_vma=False)
            return np.asarray(jax.jit(fn)(params, x))

        res[f"{name}/out"] = run(c["cf"])
        if name in DROP_CASES:
            res[f"{name}/no_drop"] = run(8.0)

    cfgs = lm_configs(jlm, jmoe.MoEConfig, jmla.MLAConfig)
    for name, c in LM_CASES.items():
        cfg = _case_cfg(cfgs, c)
        params = load(f"lm/{c['arch']}/p", jax.eval_shape(
            lambda cfg=cfg: jlm.init(jax.random.PRNGKey(0), cfg)))
        b, t = c["bt"]
        toks = jnp.asarray(inp[f"lm/{name}/tokens"])
        if c["kind"] == "backbone":
            def obj(p, cfg=cfg, toks=toks):
                h = jlm.backbone(p, toks[:, :t], cfg, mesh)
                return (h ** 2).sum(), h
            (_, h), g = jax.jit(jax.value_and_grad(obj, has_aux=True))(
                params)
            res[f"{name}/out"] = np.asarray(h)
            put_grads(name, g)
        elif c["kind"] == "loss":
            batch = {"tokens": toks[:, :t],
                     "targets": jnp.asarray(inp[f"lm/{name}/targets"])}
            lv, g = jax.jit(jax.value_and_grad(
                lambda p, cfg=cfg, batch=batch: jlm.train_loss(
                    p, batch, cfg, mesh)))(params)
            res[f"{name}/loss"] = np.asarray(lv)
            put_grads(name, g)
        else:
            logits, cache = jax.jit(lambda p, tk, cfg=cfg: jlm.prefill(
                p, tk, cfg, mesh))(params, toks[:, :t])
            res[f"{name}/prefill"] = np.asarray(logits)
            cache = jax.tree.map(lambda a: jnp.pad(
                a, [(0, 0)] * 2 + [(0, CACHE_PAD)]
                + [(0, 0)] * (a.ndim - 3)), cache)
            step = jax.jit(lambda p, cc, tk, n, cfg=cfg: jlm.decode_step(
                p, cc, tk, n, cfg, mesh), static_argnums=3)
            for i in range(DECODE_STEPS):
                logits, cache = step(params, cache, toks[:, t + i], t + i)
                res[f"{name}/decode{i}"] = np.asarray(logits)
            for k, v in cache.items():
                res[f"{name}/cache/{k}"] = np.asarray(v.astype(jnp.float32))
    np.savez(os.path.join(out_dir, f"ref_{mname}.npz"), **res)


# -- the port side (8 gloo processes) ---------------------------------------


def port_worker(rank: int, inp_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed.shardings import (P, NamedSharding,
                                                   block_index,
                                                   make_param_specs,
                                                   sync_grads)
    from repro_torch.models import lm, mla, moe
    from repro_torch.models.common import make_generator

    torch.set_num_threads(1)
    M.init("cpu", rank=rank, world_size=N_DEV,
           store=dist.FileStore(os.path.join(out_dir, "store"), N_DEV))
    inp = {k: torch.from_numpy(v) for k, v in np.load(inp_path).items()}
    res: dict[str, np.ndarray] = {}
    cfgs = lm_configs(lm, moe.MoEConfig, mla.MLAConfig)

    def load(prefix, like):
        return tree.unflatten(like, [inp[prefix + p] for p, _ in
                                     tree.flatten_with_path(like)])

    def rows(x, axis=0):
        spec = P(*([None] * axis), "data")
        return NamedSharding(mesh, spec).shard(x)

    def put(key, block, spec, shape):
        """The rank's block and its index in the whole array."""
        res[key] = block.detach().float().numpy()
        res[key + "#idx"] = np.array(
            [(s.start, s.stop) for s in block_index(
                mesh.shape, spec, tuple(shape), mesh.coord)])

    def value_and_grads(fn, params, specs):
        """fn's value and every param block's gradient after the
        data-parallel sum over the batch axes its spec leaves out."""
        leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
        val, aux = fn(tree.unflatten(params, leaves))
        grads = torch.autograd.grad(val, leaves, materialize_grads=True)
        grads = sync_grads(mesh, list(grads), tree.leaves(specs),
                           ("data",))
        return val.detach(), aux, dict(zip(
            [p for p, _ in tree.flatten_with_path(params)], grads,
            strict=True))

    for mname, shape in MESHES.items():
        mesh = M.make_mesh(shape, ("data", "model"), "cpu")
        res[f"{mname}/coord"] = np.array([mesh.coord["data"],
                                          mesh.coord["model"]])
        for name, c in FN_CASES.items():
            mcfg = moe_config(moe.MoEConfig, c)
            params = load(f"fn/{name}/p", moe.init_moe(
                make_generator(0, torch.device("meta")), mcfg))
            blocks = tree.tree_map(lambda a, s: NamedSharding(mesh, s)
                                   .shard(a), params, moe_specs(P, c))
            x = rows(inp[f"fn/{name}/x"])
            if c["kind"] == "sharded":
                out = moe.moe_ffn_sharded(blocks, x, mcfg, mesh=mesh)
            else:
                out = moe.moe_ffn_2d(blocks, x, mcfg, batch_axes=("data",),
                                     token_chunk=c.get("chunk"), mesh=mesh)
            res[f"{mname}/{name}/out"] = out.numpy()

        for name, c in LM_CASES.items():
            cfg = _case_cfg(cfgs, c)
            whole = load(f"lm/{c['arch']}/p", lm.init(0, cfg, device="meta"))
            specs = make_param_specs(whole, case_rules(c, cfg))
            params = tree.tree_map(lambda a, s: NamedSharding(mesh, s)
                                   .shard(a), whole, specs)
            b, t = c["bt"]
            toks = rows(inp[f"lm/{name}/tokens"])
            key = f"{mname}/{name}"
            if c["kind"] == "backbone":
                def obj(p, cfg=cfg, toks=toks, specs=specs):
                    h = lm.backbone(p, toks[:, :t], cfg, mesh, specs=specs)
                    return (h ** 2).sum(), h
                _, h, grads = value_and_grads(obj, params, specs)
                res[f"{key}/out"] = h.detach().numpy()
                if cfg.seq_shard:          # the same call without it
                    off = dataclasses.replace(cfg, seq_shard=False)
                    _, h, g_off = value_and_grads(
                        lambda p, off=off: obj(p, off), params, specs)
                    res[f"{key}/off/out"] = h.detach().numpy()
                    for path, g in g_off.items():
                        res[f"{key}/off/grad{path}"] = g.numpy()
            elif c["kind"] == "loss":
                batch = {"tokens": toks[:, :t],
                         "targets": rows(inp[f"lm/{name}/targets"])}
                lv, _, grads = value_and_grads(
                    lambda p, cfg=cfg, batch=batch, specs=specs: (
                        lm.train_loss(p, batch, cfg, mesh, specs), None),
                    params, specs)
                res[f"{key}/loss"] = lv.numpy()
            else:
                c_spec = P(None, "data", "model")
                with torch.no_grad():
                    logits, cache = lm.prefill(params, toks[:, :t], cfg,
                                               mesh, specs)
                    put(f"{key}/prefill", logits, P("data", "model"),
                        (b, cfg.vocab))
                    # the cache grown by CACHE_PAD slots, re-split over model
                    cache = {k: NamedSharding(mesh, c_spec).shard(
                        torch.nn.functional.pad(
                            NamedSharding(mesh, c_spec).gather(v),
                            [0, 0] * (v.ndim - 3) + [0, CACHE_PAD]))
                        for k, v in cache.items()}
                    for i in range(DECODE_STEPS):
                        logits, cache = lm.decode_step(
                            params, cache, toks[:, t + i], t + i, cfg, mesh,
                            specs)
                        put(f"{key}/decode{i}", logits, P("data", "model"),
                            (b, cfg.vocab))
                for k, v in cache.items():
                    whole_shape = (v.shape[0], b, t + CACHE_PAD,
                                   *v.shape[3:])
                    put(f"{key}/cache/{k}", v, c_spec, whole_shape)
                continue
            for (path, g), leaf in zip(grads.items(), tree.leaves(whole),
                                       strict=True):
                put(f"{key}/grad{path}", g,
                    dict(tree.flatten_with_path(specs))[path], leaf.shape)
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
    """(reference outputs per mesh, [port blocks of each rank]) from one run
    of the port and one of the reference per mesh, all started together."""
    d = tmp_path_factory.mktemp("lm_mesh")
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
        ref.update({f"{m}/{k}": v for k, v in np.load(d / f"ref_{m}.npz")
                    .items()})
    ranks = [dict(np.load(d / f"port_{r}.npz")) for r in range(N_DEV)]
    return ref, ranks


def _block(ref_arr: np.ndarray, coord, mname: str, axis: int = 0):
    """The reference's block of a batch-row output at ``coord``: rows of
    data shard ``coord[0]`` along ``axis``."""
    n = MESHES[mname][0]
    step = ref_arr.shape[axis] // n
    return np.take(ref_arr, np.arange(coord[0] * step, (coord[0] + 1) * step),
                   axis=axis)


def _pairs(runs, mname: str, key: str):
    """(port block, reference block) at every rank's mesh coordinate: the
    block the port wrote the index of, else the rank's batch rows."""
    ref, ranks = runs
    out = []
    for got in ranks:
        want = ref[f"{mname}/{key}"]
        idx = got.get(f"{mname}/{key}#idx")
        if idx is None:
            want = _block(want, got[f"{mname}/coord"], mname)
        else:
            want = want[tuple(slice(a, b) for a, b in idx)]
        out.append((got[f"{mname}/{key}"], want))
    return out


def _grad_keys(runs, mname: str, case: str) -> list[str]:
    ref, ranks = runs
    head = f"{mname}/{case}/grad"
    ref_keys = sorted(k[len(f"{mname}/"):] for k in ref if k.startswith(head))
    port_keys = sorted(k[len(f"{mname}/"):] for k in ranks[0]
                       if k.startswith(head) and not k.endswith("#idx"))
    assert ref_keys == port_keys and ref_keys
    return ref_keys


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", list(FN_CASES))
def test_moe_blocks_match_shard_map(runs, case, mname):
    for got, want in _pairs(runs, mname, f"{case}/out"):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **FN_TOL)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", DROP_CASES)
def test_drop_cases_drop(runs, case, mname):
    """At the dropping capacity the reference's output differs from the
    same call at capacity_factor 8.0: assignments were dropped, and the
    port dropped the same ones (the test above)."""
    ref, _ = runs
    diff = np.abs(ref[f"{mname}/{case}/out"] - ref[f"{mname}/{case}/no_drop"])
    assert diff.max() > 1e-3


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", ["cp_backbone", "cp_seq_shard"])
def test_cp_backbone_and_grads_match_reference(runs, case, mname):
    """Context-parallel ``backbone`` (with ``seq_shard`` and grouped remat
    in ``cp_seq_shard``) and the gradient of ``sum(h ** 2)``."""
    for got, want in _pairs(runs, mname, f"{case}/out"):
        np.testing.assert_allclose(got, want, **CP_TOL)
    for k in _grad_keys(runs, mname, case):
        for got, want in _pairs(runs, mname, k):
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, **CP_GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("mname", list(MESHES))
def test_seq_shard_on_equals_off(runs, mname):
    """The port's ``seq_shard`` changes the layout between layers, not the
    values: the same call without it gives the same hidden states and
    gradients, on every rank."""
    _, ranks = runs
    key = f"{mname}/cp_seq_shard"
    for got in ranks:
        np.testing.assert_allclose(got[f"{key}/out"], got[f"{key}/off/out"],
                                   rtol=1e-6, atol=1e-6)
        grads = [k for k in got if k.startswith(f"{key}/grad")
                 and not k.endswith("#idx")]
        assert grads
        for k in grads:
            off = k.replace(f"{key}/grad", f"{key}/off/grad")
            np.testing.assert_allclose(got[k], got[off], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", [c for c in GRAD_CASES
                                  if LM_CASES[c]["kind"] == "loss"])
def test_train_loss_and_grads_match_reference(runs, case, mname):
    """The loss on every rank, and every parameter's gradient after the
    data-parallel sum, against ``jax.value_and_grad`` of the reference's
    ``train_loss`` under the mesh."""
    ref, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[f"{mname}/{case}/loss"],
                                   ref[f"{mname}/{case}/loss"], **LM_TOL)
    for k in _grad_keys(runs, mname, case):
        for got, want in _pairs(runs, mname, k):
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, **LM_TOL, err_msg=k)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("case", SERVE_CASES)
def test_prefill_and_decode_match_reference(runs, case, mname):
    """Prefill's last logits, three decode steps' logits (the rank's rows
    of its vocab block) and the final cache (its rows of its sequence
    block)."""
    keys = [f"{case}/prefill"] + [f"{case}/decode{i}"
                                  for i in range(DECODE_STEPS)]
    for k in keys:
        for got, want in _pairs(runs, mname, k):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, **LM_TOL, err_msg=k)
    ref, _ = runs
    caches = [k[len(f"{mname}/"):] for k in ref
              if k.startswith(f"{mname}/{case}/cache/")]
    assert caches
    for k in caches:
        for got, want in _pairs(runs, mname, k):
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, **LM_TOL, err_msg=k)


if __name__ == "__main__":
    {"jax": jax_side, "port": port_side}[sys.argv[1]](*sys.argv[2:])
