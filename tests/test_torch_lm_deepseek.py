"""MLA (``repro_torch.models.mla``) and the deepseek-v3 LM variant (MLA,
shared + routed MoE with a router bias, the MTP head) against the JAX
reference, on the CPU; and, on that variant's tree, the transplant
(``weights.from_jax_tree``) and float32 checkpoints across the two
packages. Tolerances as in tests/test_torch_lm.py: MLA float32
``rtol=atol=1e-5``, the LM ``rtol=atol=1e-4``; transplants and
checkpoints bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from repro import checkpoint as jax_ckpt
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro_torch import checkpoint as ckpt
from repro_torch import tree
from repro_torch.models import lm, mla
from test_torch_lm import (JAX_VARIANTS, VARIANTS, _close, _np, _port,
                           check_decode_past_the_end,
                           check_forward_loss_and_grads,
                           check_prefill_and_decode)

NAME = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def jparams():
    """The reference's f32 params of the variant (drawn once per file)."""
    return jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0),
                                               JAX_VARIANTS[NAME])


# --------------------------------------------------------------- MLA ----
MLA_KW = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
              nope_head_dim=16, rope_head_dim=8, v_head_dim=16)


class TestMLA:
    @pytest.fixture(autouse=True)
    def _params(self, jparams):
        """The variant's first MLA block (its config is MLA_KW)."""
        self.jcfg = jmla.MLAConfig(**MLA_KW)
        self.cfg = mla.MLAConfig(**MLA_KW)
        assert JAX_VARIANTS[NAME].mla == self.jcfg
        self.jp = jax.tree.map(lambda a: a[0], jparams["dense_layers"]["attn"])
        self.p = _port(self.jp)

    def test_full_and_decode_match_reference(self):
        x = np.random.default_rng(5).standard_normal((2, 24, 64))
        x = x.astype(np.float32)
        out, (c, kr) = mla.mla_attention(self.p, torch.from_numpy(x),
                                         self.cfg)
        jout, (jc, jkr) = jax.jit(jmla.mla_attention, static_argnums=2)(
            self.jp, jnp.asarray(x), self.jcfg)
        for a, b in ((out, jout), (c, jc), (kr, jkr)):
            _close(a, b)
        # decode token 16 over a cache holding tokens 0..15 and zeros
        cache_c = np.zeros((2, 24, 16), np.float32)
        cache_kr = np.zeros((2, 24, 8), np.float32)
        cache_c[:, :16], cache_kr[:, :16] = np.asarray(jc)[:, :16], \
            np.asarray(jkr)[:, :16]
        tc, tkr = torch.from_numpy(cache_c), torch.from_numpy(cache_kr)
        got, tc2, _ = mla.mla_decode(self.p, torch.from_numpy(x[:, 16:17]),
                                     tc, tkr, 16, self.cfg)
        want, jc2, _ = jax.jit(jmla.mla_decode, static_argnums=5)(
            self.jp, jnp.asarray(x[:, 16:17]), jnp.asarray(cache_c),
            jnp.asarray(cache_kr), 16, self.jcfg)
        _close(got, want)
        _close(tc2, jc2)
        assert tc2 is tc          # written in place
        # the absorbed decode reproduces the full forward's row 16
        _close(got[:, 0], out[:, 16], dict(rtol=1e-4, atol=1e-5))


class TestDeepSeekVariant:
    def test_forward_loss_and_grads_match_reference(self, jparams):
        check_forward_loss_and_grads(NAME, jparams)

    def test_prefill_and_decode_match_reference(self, jparams):
        check_prefill_and_decode(NAME, jparams)

    def test_decode_past_the_end_clamps_on_both_sides(self, jparams):
        check_decode_past_the_end(NAME, jparams)


def test_from_jax_tree_on_an_lm_tree(jparams):
    """Stacked leaves, bf16 weights beside float32 routers (the
    reference's bf16 init keeps them float32), the MTP block: every leaf
    copied bit for bit in its dtype."""
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "router" in keystr(path)
        else a.astype(jnp.bfloat16), jparams)
    p = _port(jp)
    flat = dict(tree.flatten_with_path(p))
    for k, v in tree_flatten_with_path(jp)[0]:
        got = flat[keystr(k)]
        assert tuple(got.shape) == v.shape
        assert str(got.dtype) == f"torch.{v.dtype}"
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(v, np.float32))
    assert p["moe_layers"]["moe"]["w_gate"].shape == (1, 4, 64, 32)
    assert p["moe_layers"]["moe"]["router"].dtype == torch.float32
    assert "layer" in p["mtp"] and p["mtp"]["proj"].shape == (128, 64)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_f32_lm_checkpoint_restores_across_packages(tmp_path, writer,
                                                    jparams):
    jp = jparams
    p = _port(jp)
    if writer == "port":
        ckpt.save(str(tmp_path), 3, p)
        out = jax_ckpt.restore(str(tmp_path), 3, jp)
    else:
        jax_ckpt.save(str(tmp_path), 3, jp)
        out = ckpt.restore(str(tmp_path), 3, lm.init(
            5, VARIANTS[NAME], device="cpu"))
    want = {keystr(k): np.asarray(v)
            for k, v in tree_flatten_with_path(jp)[0]}
    got = {keystr(k): _np(v) for k, v in tree_flatten_with_path(out)[0]} \
        if writer == "port" else {k: _np(v)
                                  for k, v in tree.flatten_with_path(out)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bf16 = tree.tree_map(lambda a: a.to(torch.bfloat16), p)
    with pytest.raises(TypeError):
        ckpt.save(str(tmp_path), 4, bf16)
