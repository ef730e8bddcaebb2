"""The port's LM (``repro_torch.models.lm``, ``configs``' LM archs) against
the JAX reference, on the CPU; its helpers serve the other LM test files
(test_torch_attention.py, test_torch_lm_bf16.py,
test_torch_lm_deepseek.py, test_torch_moe.py).

The reference's init is transplanted (``weights.from_jax_tree``) and the
same seeded numpy inputs go through both packages, on the reduced
variants of the five archs in tests/test_models.py. Tolerances, float32:
hidden states, logits, losses and every gradient leaf ``rtol=atol=1e-4``
(the reference's own tests hold prefill and decode at 2e-3; the port
holds tighter), the decode-vs-full property at the reference's 2e-3.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro.configs import lm_common as jax_lm_common
from repro.launch import train as jax_train
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro_torch import configs, tree, weights
from repro_torch.models import lm, mla, moe

TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _port(params, device="cpu"):
    return weights.from_jax_tree(jax.tree.map(np.asarray, params), device)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _value_and_grads(fn, params):
    """Port: the loss and {keystr path: gradient} of ``fn(params)``;
    leaves the loss does not reach get zeros, as ``jax.grad`` gives."""
    flat = tree.flatten_with_path(params)
    leaves = [x.detach().requires_grad_() for _, x in flat]
    loss = fn(tree.unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), {p: g for (p, _), g in zip(flat, grads,
                                                     strict=True)}


def _check_grads(got: dict, want_tree, tol=LM_TOL):
    want = {keystr(p): g for p, g in tree_flatten_with_path(want_tree)[0]}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert g.shape == want[path].shape, path
        _close(g, want[path], tol, path)


def _rel_l2(got, want) -> float:
    a, b = _np(got), _np(want)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------- LM ----
def small_lm(mod, **kw):
    base = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=256, rope_theta=10_000.0, remat=False,
                q_chunk=64, kv_chunk=64)
    base.update(kw)
    return mod.LMConfig(**base)


def lm_variants(mod, moe_cls, mla_cls):
    """tests/test_models.py's LM_VARIANTS, for either package."""
    return {
        "qwen3-1.7b": small_lm(mod, qk_norm=True, tie_embeddings=True),
        "qwen2-0.5b": small_lm(mod, n_kv_heads=1, qkv_bias=True,
                               tie_embeddings=True),
        "nemotron-4-15b": small_lm(mod, act="squared_relu"),
        "qwen3-moe-30b-a3b": small_lm(
            mod, qk_norm=True,
            moe=moe_cls(d_model=64, d_expert=32, n_experts=8, top_k=2,
                        capacity_factor=2.0)),
        "deepseek-v3-671b": small_lm(
            mod, n_heads=4, n_kv_heads=4, n_dense_layers=1, mtp=True,
            mla=mla_cls(d_model=64, n_heads=4, q_lora_rank=32,
                        kv_lora_rank=16, nope_head_dim=16, rope_head_dim=8,
                        v_head_dim=16),
            moe=moe_cls(d_model=64, d_expert=32, n_experts=4, top_k=2,
                        n_shared=1, router_bias=True, capacity_factor=2.0)),
    }


JAX_VARIANTS = lm_variants(jlm, jmoe.MoEConfig, jmla.MLAConfig)
VARIANTS = lm_variants(lm, moe.MoEConfig, mla.MLAConfig)

# the reference's entry points, jitted (one compile beats op-by-op
# dispatch at these sizes)
j_backbone = jax.jit(jlm.backbone, static_argnums=2)
j_prefill = jax.jit(jlm.prefill, static_argnums=2)
j_decode_step = jax.jit(jlm.decode_step, static_argnums=4)


def _tokens(b, t, vocab, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, vocab, (b, t)).astype(np.int32),
            rng.integers(0, vocab, (b, t)).astype(np.int32))


def lm_batches(toks, tgt):
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)},
            {"tokens": torch.from_numpy(toks),
             "targets": torch.from_numpy(tgt)})


def _pad_cache(cache, n=1):
    return {k: torch.nn.functional.pad(v, [0, 0] * (v.ndim - 3) + [0, n])
            for k, v in cache.items()}


def _jpad_cache(cache, n=1):
    return jax.tree.map(lambda c: jnp.pad(
        c, [(0, 0)] * 2 + [(0, n)] + [(0, 0)] * (c.ndim - 3)), cache)


def check_forward_loss_and_grads(name: str, jp=None):
    """Backbone, train_loss and every gradient of LM variant ``name``
    against the reference's (``jp``: its params, else drawn from key 0)."""
    jcfg, cfg = JAX_VARIANTS[name], VARIANTS[name]
    jp = jlm.init(jax.random.PRNGKey(0), jcfg) if jp is None else jp
    p = _port(jp)
    jb, tb = lm_batches(*_tokens(2, 64, cfg.vocab, 1))
    _close(lm.backbone(p, tb["tokens"], cfg),
           j_backbone(jp, jb["tokens"], jcfg), LM_TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: jlm.train_loss(q, jb, jcfg)))(jp)
    loss, grads = _value_and_grads(lambda q: lm.train_loss(q, tb, cfg), p)
    _close(loss, jloss, LM_TOL)
    _check_grads(grads, jgrads)


def check_prefill_and_decode(name: str, jp=None):
    """Prefill of 15 tokens (logits, and caches of exactly 15 slots in the
    compute dtype), then one decode step into a cache grown by one slot,
    against the reference's."""
    jcfg, cfg = JAX_VARIANTS[name], VARIANTS[name]
    jp = jlm.init(jax.random.PRNGKey(0), jcfg) if jp is None else jp
    p = _port(jp)
    toks, _ = _tokens(2, 16, cfg.vocab, 3)
    logits, cache = lm.prefill(p, torch.from_numpy(toks[:, :15]), cfg)
    jlogits, jcache = j_prefill(jp, jnp.asarray(toks[:, :15]), jcfg)
    _close(logits, jlogits, LM_TOL)
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        assert cache[key].dtype == torch.float32
        assert cache[key].shape[2] == 15
        _close(cache[key], jcache[key], LM_TOL)
    got, cache2 = lm.decode_step(p, _pad_cache(cache),
                                 torch.from_numpy(toks[:, 15]), 15, cfg)
    want, jcache2 = j_decode_step(jp, _jpad_cache(jcache),
                                    jnp.asarray(toks[:, 15]), 15, jcfg)
    _close(got, want, LM_TOL)
    for key in cache2:
        _close(cache2[key], jcache2[key], LM_TOL)


def check_decode_past_the_end(name: str, jp=None):
    """``length == max_len``: both write the last slot (the reference's
    ``dynamic_update_slice`` clamps its index) and return finite, equal
    logits."""
    jcfg, cfg = JAX_VARIANTS[name], VARIANTS[name]
    jp = jlm.init(jax.random.PRNGKey(0), jcfg) if jp is None else jp
    p = _port(jp)
    toks, _ = _tokens(2, 9, cfg.vocab, 8)
    _, cache = lm.prefill(p, torch.from_numpy(toks[:, :8]), cfg)
    _, jcache = j_prefill(jp, jnp.asarray(toks[:, :8]), jcfg)
    before = {k: v.clone() for k, v in cache.items()}
    got, cache = lm.decode_step(p, cache, torch.from_numpy(toks[:, 8]), 8,
                                cfg)
    want, jcache = j_decode_step(jp, jcache, jnp.asarray(toks[:, 8]), 8,
                                   jcfg)
    assert torch.isfinite(got).all()
    _close(got, want, LM_TOL)
    for key in cache:
        _close(cache[key], jcache[key], LM_TOL)
        torch.testing.assert_close(cache[key][:, :, :7],
                                   before[key][:, :, :7])
        assert not torch.equal(cache[key][:, :, 7], before[key][:, :, 7])


# the dense variants; the MoE and MLA ones run in test_torch_moe.py and
# test_torch_lm_deepseek.py (each file keeps to about 15 s)
DENSE = ["nemotron-4-15b", "qwen2-0.5b", "qwen3-1.7b"]


class TestLMFamily:
    @pytest.mark.parametrize("name", DENSE)
    def test_forward_loss_and_grads_match_reference(self, name):
        check_forward_loss_and_grads(name)

    @pytest.mark.parametrize("name", DENSE)
    def test_prefill_and_decode_match_reference(self, name):
        check_prefill_and_decode(name)

    def test_decode_past_the_end_clamps_on_both_sides(self):
        check_decode_past_the_end("qwen3-1.7b")

    @pytest.mark.parametrize("name", sorted(VARIANTS))
    def test_prefill_decode_consistency(self, name):
        """The reference's property (tests/test_models.py): decode on a
        prefix cache reproduces the full forward's logits. The MoE variant
        runs unclipped: with a finite capacity, prefill's t - 1 tokens and
        the full forward's t clip differently by design."""
        cfg = VARIANTS[name]
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=100.0))
        p = lm.init(0, cfg, device="cpu")
        toks = torch.from_numpy(_tokens(2, 16, cfg.vocab, 3)[0])
        full = lm.logits_fn(p, lm.backbone(p, toks, cfg), cfg)
        logits_p, cache = lm.prefill(p, toks[:, :15], cfg)
        _close(logits_p, full[:, 14], dict(rtol=0, atol=2e-3))
        logits_d, _ = lm.decode_step(p, _pad_cache(cache), toks[:, 15], 15,
                                     cfg)
        _close(logits_d, full[:, 15], dict(rtol=0, atol=2e-3))

    def test_chunked_ce_matches_full(self):
        cfg = VARIANTS["qwen3-1.7b"]
        jp = jlm.init(jax.random.PRNGKey(0), JAX_VARIANTS["qwen3-1.7b"])
        p = _port(jp)
        rng = np.random.default_rng(5)
        hidden = rng.standard_normal((2, 48, 64)).astype(np.float32)
        tgt = rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
        full = torch.log_softmax(lm.logits_fn(p, torch.from_numpy(hidden),
                                              cfg), -1)
        ref = -full.gather(-1, torch.from_numpy(tgt).long()[..., None]).mean()
        for chunk in (16, 48, 32):        # 32 exercises the padding path
            out = lm.chunked_ce(p, torch.from_numpy(hidden),
                                torch.from_numpy(tgt), cfg, t_chunk=chunk)
            _close(out, ref, dict(rtol=1e-5, atol=0))
            _close(out, jax.jit(jlm.chunked_ce, static_argnums=(3, 4))(
                jp, jnp.asarray(hidden), jnp.asarray(tgt),
                JAX_VARIANTS["qwen3-1.7b"], chunk), dict(rtol=1e-5, atol=0))

    def test_chunked_ce_keeps_no_vocab_sized_tensor(self):
        """Each chunk is checkpointed: the backward graph holds no (B, T,
        V) logits, only each chunk's inputs."""
        cfg = VARIANTS["qwen3-1.7b"]
        p = lm.init(0, cfg, device="cpu")
        hidden = torch.randn(2, 96, 64, requires_grad=True)
        tgt = torch.randint(0, cfg.vocab, (2, 96))
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(x) or x, lambda x: x):
            loss = lm.chunked_ce(p, hidden, tgt, cfg, t_chunk=32)
        loss.backward()
        assert saved and max(x.numel() for x in saved) < 32 * cfg.vocab

    @pytest.mark.parametrize("remat", [dict(remat=True),
                                       dict(remat=True, remat_group=2),
                                       dict(remat=False, remat_group=2)])
    def test_remat_gives_the_same_gradients(self, remat):
        cfg = dataclasses.replace(VARIANTS["qwen3-1.7b"], n_layers=4)
        p = lm.init(0, cfg, device="cpu")
        tb = lm_batches(*_tokens(2, 32, cfg.vocab, 7))[1]
        loss, grads = _value_and_grads(lambda q: lm.train_loss(q, tb, cfg), p)
        rcfg = dataclasses.replace(cfg, **remat)
        rloss, rgrads = _value_and_grads(
            lambda q: lm.train_loss(q, tb, rcfg), p)
        assert float(rloss) == float(loss)
        for path, g in grads.items():
            torch.testing.assert_close(rgrads[path], g, rtol=0, atol=0)

    def test_mesh_raises(self, tmp_path):
        """A mesh that is not a ``Mesh``, a mesh without the params'
        specs, or context-parallel attention whose specs split the
        attention over ``model``, raises; on a (1, 1) gloo mesh the mesh
        branches run (the vocab-parallel embedding, the Megatron FFN,
        sharded and 2D EP, context-parallel attention with the attention
        replicated as in qwen2's rules, sequence sharding, the
        sequence-split cache) and each of the four entry points, gradients
        too, equals its mesh-free call."""
        import torch.distributed as dist

        from repro_torch.configs.lm_common import lm_param_rules
        from repro_torch.distributed import mesh as M
        from repro_torch.distributed.shardings import P, make_param_specs
        cfg = dataclasses.replace(
            VARIANTS["qwen3-moe-30b-a3b"], ep_axis="model",
            context_parallel=True, seq_shard=True, batch_axes=("data",))
        p = lm.init(0, cfg, device="cpu")
        specs = make_param_specs(p, [(k, P()) for k in (
            "['wq']", "['wk']", "['wv']", "['wo']")] + lm_param_rules(cfg))
        toks, tgt = (torch.from_numpy(a) for a in _tokens(2, 16, cfg.vocab,
                                                          3))
        batch = {"tokens": toks, "targets": tgt}
        with pytest.raises(TypeError, match="Mesh"):
            lm.backbone(p, toks, cfg, mesh="mesh", specs=specs)
        with pytest.raises(ValueError, match="specs"):
            lm.backbone(p, toks, cfg, mesh="mesh")
        M.init("cpu", rank=0, world_size=1,
               store=dist.FileStore(str(tmp_path / "store"), 1))
        try:
            mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
            with pytest.raises(ValueError, match="context-parallel"):
                lm.backbone(p, toks, cfg, mesh, specs=make_param_specs(
                    p, lm_param_rules(cfg)))
            for ep_2d in (False, True):
                c = dataclasses.replace(cfg, ep_2d=ep_2d)
                calls = dict(mesh.calls)
                with torch.no_grad():
                    for got, want in (
                            (lm.backbone(p, toks, c, mesh, specs=specs),
                             lm.backbone(p, toks, c)),
                            (lm.prefill(p, toks, c, mesh, specs),
                             lm.prefill(p, toks, c)),
                            (lm.decode_step(
                                p, _pad_cache(lm.prefill(p, toks, c)[1]),
                                toks[:, 0], 16, c, mesh, specs)[0],
                             lm.decode_step(
                                 p, _pad_cache(lm.prefill(p, toks, c)[1]),
                                 toks[:, 0], 16, c)[0])):
                        for a, b in zip(tree.leaves(got), tree.leaves(want),
                                        strict=True):
                            torch.testing.assert_close(a, b, rtol=0, atol=0)
                loss, grads = _value_and_grads(
                    lambda q, c=c: lm.train_loss(q, batch, c, mesh, specs),
                    p)
                wloss, wgrads = _value_and_grads(
                    lambda q, c=c: lm.train_loss(q, batch, c), p)
                assert float(loss) == float(wloss)
                for path, g in wgrads.items():
                    torch.testing.assert_close(grads[path], g, rtol=0,
                                               atol=0, msg=path)
                assert dict(mesh.calls) != calls     # collectives ran
        finally:
            dist.destroy_process_group()

    def test_init_cache_matches_reference(self):
        for name in ("qwen3-1.7b", "deepseek-v3-671b"):
            cache = lm.init_cache(VARIANTS[name], 3, 20, device="cpu")
            jcache = jlm.init_cache(JAX_VARIANTS[name], 3, 20)
            assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} \
                == {k: (v.shape, torch.bfloat16) for k, v in jcache.items()}

    def test_init_matches_reference_layout(self):
        """The port's init draws the reference's tree: the same paths,
        shapes and dtypes (bf16 weights, float32 routers), the stacked L
        dim included."""
        for name in sorted(VARIANTS):
            p = lm.init(0, VARIANTS[name], torch.bfloat16, device="cpu")
            jp = jax.eval_shape(lambda n=name: jlm.init(
                jax.random.PRNGKey(0), JAX_VARIANTS[n], jnp.bfloat16))
            want = {keystr(k): (v.shape, str(v.dtype))
                    for k, v in tree_flatten_with_path(jp)[0]}
            got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for k, v in tree.flatten_with_path(p)}
            assert got == want, name


# ----------------------------------------------- configs, weights, ckpt --
ARCH_MODULES = {"qwen3-1.7b": "qwen3_1_7b", "qwen2-0.5b": "qwen2_0_5b",
                "nemotron-4-15b": "nemotron_4_15b",
                "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
                "deepseek-v3-671b": "deepseek_v3_671b"}


@pytest.mark.parametrize("name", sorted(ARCH_MODULES))
def test_lm_arch_configs_equal_reference(name):
    import importlib
    mod = importlib.import_module(f"repro.configs.{ARCH_MODULES[name]}")
    assert dataclasses.asdict(configs.LM_ARCHS[name]) == \
        dataclasses.asdict(mod.CONFIG)
    count = getattr(mod, "n_params", None) or mod.n_active
    assert configs.lm_n_active(name) == count()


class _Stop(Exception):
    pass


def test_lm_100m_and_shapes_equal_reference(monkeypatch):
    """``configs.LM_100M`` is the config ``repro.launch.train --model lm``
    builds (captured at its ``lm.init`` call)."""
    seen = {}

    def capture(key, cfg, dtype=None):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(jlm, "init", capture)
    with pytest.raises(_Stop):
        jax_train._lm_pipeline(argparse.Namespace(seed=0, lr=1e-3, batch=2,
                                                  seq_len=8))
    assert dataclasses.asdict(configs.LM_100M) == \
        dataclasses.asdict(seen["cfg"])
    assert configs.LM_SHAPES == jax_lm_common.LM_SHAPES
