"""MLPerf's DLRM-DCNv2 on the port (``models.dlrm``: ``DCNConfig``, ragged
bags, ``cross_net``; ``configs.dlrm_dcnv2``) against the plain reference
of ``ref_dlrm_dcnv2.py`` (no JAX: the JAX reference has no DCN), and the
ragged layout of the grouped SLS's plain version and backward.

The tests marked ``cuda`` hold the ragged kernel and the DCN forward's
graph route on the card and skip elsewhere; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dlrm_dcnv2.py
"""

import dataclasses

import pytest
import torch

import ref_dlrm_dcnv2 as ref_dcn
from repro_torch import configs
from repro_torch.configs import dlrm_dcnv2
from repro_torch.embedding.layout import lookup
from repro_torch.kernels import ref
from repro_torch.kernels.recflash_sls import (RecFlashSLSGrouped, describe,
                                              recflash_sls_grouped)
from repro_torch.models import dlrm
from repro_torch.models.common import bce_with_logits

# 4 tables, bags of 3, 1, 7 and 2 ids, D=8, 2 cross layers of rank 4
TINY = dlrm.DCNConfig(name="tiny-dcn", n_tables=4, n_dense=5, embed_dim=8,
                      n_rows=(30, 20, 50, 40), lookups=(3, 1, 7, 2),
                      bot_mlp=(16, 8), top_mlp=(12, 6), dcn_layers=2,
                      dcn_rank=4)
HOT = (3, 1, 50, 9)
# float32 on both sides: the bags are bit-equal (both add in lookup order);
# the products differ only in the order of their f32 sums (at most 40 terms,
# top_in = 40), and the cross network's addcmul and addmm round once where
# the reference's multiply, add and bias add round apart: a few ulps of
# unit-sized values
TOL = dict(rtol=1e-5, atol=1e-6)


def _model(cfg=TINY, seed=0, device="cpu", table_dtype=torch.float32):
    """(logical params with nonzero biases, the port's params: the tables
    stored in rank order and the remap attached, rank_of)."""
    params = dlrm.init(seed, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for layer in params["bot"] + params["top"] + params["cross"]:
        layer["b"] = torch.randn(layer["b"].shape, generator=gen,
                                 device=device) * 0.5
    params["tables"] = [t.to(table_dtype) for t in params["tables"]]
    rank_of = [torch.randperm(v, generator=gen, device=device)
               for v in cfg.n_rows]
    stored = [t[r.argsort()] for t, r in zip(params["tables"], rank_of,
                                              strict=True)]
    hot = [min(h, v) for h, v in zip(HOT * 8, cfg.n_rows)]
    port = dlrm.add_remap({**params, "tables": stored}, rank_of, hot)
    return params, port, rank_of


def _batch(cfg=TINY, b=32, seed=2, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = [torch.randint(0, v, (b, n), generator=gen, device=device)
           for v, n in zip(cfg.n_rows, cfg.lookups, strict=True)]
    return {"dense": torch.randn(b, cfg.n_dense, generator=gen,
                                 device=device),
            "indices": torch.cat(ids, dim=1).to(torch.int32),
            "labels": (torch.rand(b, generator=gen, device=device) < 0.3
                       ).float()}


@pytest.mark.parametrize("plain", [False, True])
def test_forward_matches_the_reference(plain):
    params, port, _ = _model()
    batch = _batch()
    want = ref_dcn.logits(params, batch["dense"], batch["indices"],
                          TINY.lookups)
    with torch.no_grad():
        got = dlrm.forward(port, batch, TINY, plain=plain)
    torch.testing.assert_close(got, want, **TOL)
    # the cross network and the bags move the logits
    flat = {**params, "cross": []}
    assert (ref_dcn.logits(flat, batch["dense"], batch["indices"],
                           TINY.lookups) - want).abs().max() > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_bags_equal_the_reference_bit_for_bit(dtype):
    params, port, _ = _model(table_dtype=dtype)
    idx = _batch()["indices"]
    got = dlrm.bags(port, idx, lookups=TINY.lookups)
    assert got.dtype == dtype and got.shape == (32, 4, 8)
    assert torch.equal(got.float(), ref_dcn.bags(params["tables"], idx,
                                                 TINY.lookups))
    assert torch.equal(dlrm.bags(port, idx, plain=True,
                                 lookups=TINY.lookups), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remap", [True, False])
def test_ragged_grouped_ref_equals_a_loop_over_tables(dtype, remap):
    """The ragged plain version against the per-table plain version over
    each table's own columns, bit for bit (both add in lookup order)."""
    _, port, _ = _model(table_dtype=dtype)
    tables, hot = port["tables"], port["hot_sizes"]
    rank_of = port["rank_of"] if remap else None
    idx = _batch()["indices"]
    got = ref.recflash_sls_grouped_ref(tables, hot, idx, rank_of,
                                       TINY.lookups)
    col = 0
    for t, (table, h, n) in enumerate(zip(tables, hot, TINY.lookups,
                                          strict=True)):
        ids = idx[:, col:col + n]
        ranks = ids if rank_of is None else lookup(rank_of[t], ids)
        assert torch.equal(got[:, t], ref.recflash_sls_ref(
            table[:h], table[h:], ranks))
        col += n
    assert torch.equal(recflash_sls_grouped(tables, hot, idx, rank_of,
                                            lookups=TINY.lookups), got)


def test_ragged_layout_is_checked():
    _, port, _ = _model()
    tables, hot, rank_of = port["tables"], port["hot_sizes"], port["rank_of"]
    idx = _batch()["indices"]
    desc = describe(tables, hot, rank_of)
    before = recflash_sls_grouped.launches
    for bad_idx, lookups, err in (
            (idx[:, :-1], TINY.lookups, TypeError),          # 12 columns
            (idx.long(), TINY.lookups, TypeError),
            (idx[:, None], TINY.lookups, TypeError),
            (idx, (3, 1, 7), ValueError),                  # 3 lengths
            (idx, (3, 0, 8, 2), ValueError)):              # an empty bag
        with pytest.raises(err):
            recflash_sls_grouped(tables, hot, bad_idx, rank_of, desc,
                                 lookups)
    assert recflash_sls_grouped.launches == before
    with pytest.raises(ValueError):
        ref.recflash_sls_grouped_ref(tables, hot, idx[:, :-1], rank_of,
                                     TINY.lookups)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_backward_equals_autograd_of_the_reference(dtype):
    """The Function's gradient of each table over ragged bags (ids read
    as ranks) against autograd through the reference's bags over the tables
    widened to float32: the Function adds each table's gradient in float32
    and rounds it once to the table's dtype, so a bf16 gradient may sit one
    bf16 ulp (2^-8 relative) from the float32 one rounded, where the two
    sums in other orders fall on either side of a tie."""
    gen = torch.Generator().manual_seed(5)
    tables = [torch.randn(v, 8, generator=gen).to(dtype).requires_grad_()
              for v in TINY.n_rows]
    wide = [t.detach().float().requires_grad_() for t in tables]
    idx = _batch()["indices"]
    g = torch.randn(32, 4, 8, generator=gen).to(dtype)
    out = RecFlashSLSGrouped.apply(HOT, idx, None, None, TINY.lookups,
                                   *tables)
    got = torch.autograd.grad(out, tables, g)
    want = torch.autograd.grad(ref_dcn.bags(wide, idx, TINY.lookups), wide,
                               g.float())
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=2**-8, atol=1e-6)
    for a, b, t in zip(got, want, tables, strict=True):
        assert a.dtype == t.dtype and a.shape == t.shape
        torch.testing.assert_close(a.float(), b.to(dtype).float(), **tol)


def test_loss_gradients_equal_autograd_of_the_reference():
    """``dlrm.loss`` on the DCN config: each stored table gets its dense
    gradient (the logical table's, in rank order), and the MLPs' and cross
    layers' gradients are the reference's."""
    params, port, rank_of = _model()
    batch = _batch()
    leaves = port["tables"] + dlrm._dense_tensors(port)
    for t in leaves:
        t.requires_grad_()
    ref_leaves = params["tables"] + dlrm._dense_tensors(params)
    for t in ref_leaves:
        t.requires_grad_()
    got = torch.autograd.grad(dlrm.loss(port, batch, TINY), leaves)
    want_loss = bce_with_logits(ref_dcn.logits(
        params, batch["dense"], batch["indices"], TINY.lookups),
        batch["labels"]).mean()
    want = torch.autograd.grad(want_loss, ref_leaves)
    n = TINY.n_tables
    for t in range(n):
        torch.testing.assert_close(got[t][rank_of[t]], want[t], **TOL)
    for a, b in zip(got[n:], want[n:], strict=True):
        torch.testing.assert_close(a, b, **TOL)


def _no_bias(cross_net):
    def fault(layers, x0):
        return cross_net([{**layer, "b": torch.zeros_like(layer["b"])}
                          for layer in layers], x0)
    return fault


def _swapped(layers, x0):
    x = x0
    for layer in layers:
        x = torch.addcmul(x0, x, torch.addmm(layer["b"], x @ layer["v"],
                                             layer["w"]))
    return x


def _shifted(bags):
    """Table 2's ids read one column to the right (into table 3's)."""
    def fault(params, indices, plain=False, lookups=None):
        idx = indices.clone()
        idx[:, 4:11] = indices[:, 5:12]
        return bags(params, idx, plain, lookups)
    return fault


FAULTS = {"dropped_cross_bias": ("cross_net", _no_bias(dlrm.cross_net)),
          "x0_and_x_swapped": ("cross_net", _swapped),
          "table_columns_shifted": ("bags", _shifted(dlrm.bags))}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_are_caught(fault, monkeypatch):
    params, port, _ = _model()
    batch = _batch()
    want = ref_dcn.logits(params, batch["dense"], batch["indices"],
                          TINY.lookups)
    name, fn = FAULTS[fault]
    monkeypatch.setattr(dlrm, name, fn)
    with torch.no_grad():
        got = dlrm.forward(port, batch, TINY)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **TOL)
    assert (got - want).abs().max() > 1e3 * TOL["atol"]


def test_the_config_has_the_published_widths():
    cfg = dlrm_dcnv2.CONFIG
    assert cfg.n_tables == 26 and cfg.embed_dim == 128 and cfg.n_dense == 13
    assert sum(cfg.n_rows) == 204_184_588 and max(cfg.n_rows) == 40_000_000
    assert cfg.bag_lengths == cfg.lookups and sum(cfg.lookups) == 214
    assert (min(cfg.lookups), max(cfg.lookups)) == (1, 100)
    assert cfg.bot_mlp == (512, 256, 128)
    assert cfg.top_mlp == (1024, 1024, 512, 256)
    assert (cfg.interaction, cfg.dcn_layers, cfg.dcn_rank) == ("dcn", 3, 512)
    assert cfg.top_in == 27 * 128 == 3456
    # not registered: the registry is the reference's
    assert cfg.name not in configs.list_archs()
    p = dlrm.init(0, cfg, dtype=torch.bfloat16, device="meta")
    assert [tuple(t.shape) for t in p["tables"][:2]] == [(40_000_000, 128),
                                                         (39_060, 128)]
    assert [tuple(p["cross"][0][k].shape) for k in "vwb"] == [
        (3456, 512), (512, 3456), (3456,)]
    assert len(p["cross"]) == 3
    assert [tuple(layer["w"].shape) for layer in p["top"]] == [
        (3456, 1024), (1024, 1024), (1024, 512), (512, 256), (256, 1)]
    assert [tuple(layer["w"].shape) for layer in p["bot"]] == [
        (13, 512), (512, 256), (256, 128)]


def test_cross_init_is_torchrecs():
    gen = torch.Generator().manual_seed(0)
    layers = dlrm.cross_init(gen, 3456, 512, 2)
    std = (2.0 / (3456 + 512)) ** 0.5
    for layer in layers:
        assert layer["v"].shape == (3456, 512)
        assert layer["w"].shape == (512, 3456)
        for k in "vw":
            assert abs(float(layer[k].std()) / std - 1) < 0.01
            assert abs(float(layer[k].mean())) < 0.01 * std
        assert not layer["b"].any()
    assert not torch.equal(layers[0]["v"], layers[1]["v"])


def test_configs_are_checked():
    kw = dict(name="x", n_tables=2, n_dense=3, embed_dim=4, n_rows=(5, 6),
              bot_mlp=(4,), top_mlp=(4,))
    with pytest.raises(ValueError, match="DCNConfig"):
        dlrm.DLRMConfig(lookups=2, interaction="dcn", **kw)
    with pytest.raises(ValueError, match="cross layer"):
        dlrm.DCNConfig(lookups=2, **kw)
    with pytest.raises(ValueError, match="bag length"):
        dlrm.DLRMConfig(lookups=(2, 3, 4), **kw)
    with pytest.raises(ValueError, match="bag length"):
        dlrm.DLRMConfig(lookups=(2, 0), **kw)
    cfg = dlrm.DLRMConfig(lookups=[2, 3], **kw)
    assert cfg.lookups == (2, 3) and cfg.n_lookups == 5
    flat = dlrm.DLRMConfig(lookups=2, **kw)
    assert flat.bag_lengths is None and flat.n_lookups == 4
    # the dcn fields are the subclass's: DLRMConfig's stay the reference's
    assert dataclasses.fields(flat)[-1].name == "interaction"


def test_mesh_and_retrieval_refuse_ragged_bags():
    _, port, _ = _model()
    batch = _batch()
    with pytest.raises(ValueError, match="ragged"):
        dlrm.forward(port, batch, TINY, mesh=object())
    with pytest.raises(ValueError, match="ragged"):
        dlrm.retrieval_score(port, {**batch, "candidates": torch.arange(5)},
                             TINY)


def test_flops_per_sample_counts_the_cross_network():
    cfg = dlrm_dcnv2.CONFIG
    cross = 3 * (4 * 3456 * 512 + 3 * 3456)
    flat = dataclasses.replace(TINY, dcn_layers=1)
    assert cfg.interaction_flops() == cross
    assert flat.interaction_flops() == 4 * 40 * 4 + 3 * 40


# ------------------------------------------------------------------ card --


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dcnv2_small(device, rows=4096, dtype=torch.bfloat16, seed=0):
    """DLRM-DCNv2 at its published widths on tables of at most ``rows``
    rows."""
    cfg = dataclasses.replace(dlrm_dcnv2.CONFIG, n_rows=tuple(
        min(v, rows) for v in dlrm_dcnv2.CONFIG.n_rows))
    params, port, _ = _model(cfg, seed, device, dtype)
    return cfg, params, port


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_equals_its_plain_version_bit_for_bit(card, dtype):
    cfg, _, port = _dcnv2_small(card, dtype=dtype)
    tables, hot, rank_of = port["tables"], port["hot_sizes"], port["rank_of"]
    for b in (1, 7, 256):
        idx = _batch(cfg, b, 3, card)["indices"]
        before = recflash_sls_grouped.launches
        got = recflash_sls_grouped(tables, hot, idx, rank_of,
                                   port["sls_desc"], cfg.lookups)
        assert recflash_sls_grouped.launches == before + 1
        assert torch.equal(got, ref.recflash_sls_grouped_ref(
            tables, hot, idx, rank_of, cfg.lookups))
    # a strided view of the ids, and ranks without rank_of
    wide = torch.cat([idx, idx], dim=1)[:, ::2]
    assert torch.equal(recflash_sls_grouped(tables, hot, wide, rank_of,
                                            lookups=cfg.lookups),
                       ref.recflash_sls_grouped_ref(tables, hot, wide,
                                                    rank_of, cfg.lookups))
    assert torch.equal(recflash_sls_grouped(tables, hot, idx.clamp(max=2),
                                            lookups=cfg.lookups),
                       ref.recflash_sls_grouped_ref(tables, hot,
                                                    idx.clamp(max=2),
                                                    lookups=cfg.lookups))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,lk", [(128, 1), (64, 120), (18, 5)])
def test_uniform_launch_equals_a_ragged_one_and_the_plain_version(
        card, dtype, d, lk):
    gen = torch.Generator(device=card).manual_seed(1)
    rows = (700, 50, 3000)
    tables = [torch.randn(v, d, generator=gen, device=card).to(dtype)
              for v in rows]
    rank_of = [torch.randperm(v, generator=gen, device=card).to(torch.int32)
               for v in rows]
    hot = (7, 50, 100)
    idx = torch.randint(0, 50, (33, 3, lk), generator=gen, device=card,
                        dtype=torch.int32)
    flat = recflash_sls_grouped(tables, hot, idx, rank_of)
    assert torch.equal(flat, ref.recflash_sls_grouped_ref(tables, hot, idx,
                                                          rank_of))
    ragged = recflash_sls_grouped(tables, hot, idx.flatten(1), rank_of,
                                  lookups=(lk,) * 3)
    assert torch.equal(flat, ragged)


@pytest.mark.cuda
def test_ragged_function_on_card_equals_the_cpu(card):
    cfg, _, port = _dcnv2_small(card, rows=512, dtype=torch.float32)
    batch = _batch(cfg, 64, 4, card)
    tables = [t.requires_grad_() for t in port["tables"]]
    g = torch.randn(64, 26, 128, device=card)
    out = RecFlashSLSGrouped.apply(port["hot_sizes"], batch["indices"],
                                   port["rank_of"], port["sls_desc"],
                                   cfg.lookups, *tables)
    got = torch.autograd.grad(out, tables, g)
    cpu = [t.detach().cpu().requires_grad_() for t in tables]
    want_out = ref.recflash_sls_grouped_ref(
        cpu, port["hot_sizes"], batch["indices"].cpu(),
        [r.cpu() for r in port["rank_of"]], cfg.lookups)
    want = torch.autograd.grad(want_out, cpu, g.cpu())
    assert torch.equal(out.detach().cpu(), want_out.detach())
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_dcn_graph_replay_equals_its_eager_call_at_64_rows(card):
    cfg, params, port = _dcnv2_small(card)
    eager = {**port, dlrm.GRAPHS: None}
    before = (dlrm.forward.graph_captures, dlrm.forward.graph_replays)
    with torch.inference_mode():
        outs = []
        for seed in (5, 6, 7):
            batch = _batch(cfg, 64, seed, card)
            assert dlrm.eager_reason(port, batch) is None
            got = dlrm.forward(port, batch, cfg)
            want = dlrm.forward(eager, batch, cfg)
            assert torch.equal(got, want)
            outs.append((batch, got))
    assert (dlrm.forward.graph_captures - before[0],
            dlrm.forward.graph_replays - before[1]) == (1, 2)
    for batch, got in outs:
        torch.testing.assert_close(got, ref_dcn.logits(
            params, batch["dense"], batch["indices"], cfg.lookups),
            rtol=1e-4, atol=1e-4)
