"""The DLRM forward's CUDA graph route (``models.dlrm``: ``eager_reason``,
``graph_bucket``, ``GraphCache``).

The CPU tests hold which calls take the route and the buckets it rounds
them to. The tests marked ``cuda`` hold the route against the plain route
on the card and skip elsewhere; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dlrm_graph.py
"""

import pytest
import torch

from repro_torch.configs import dlrm_mlperf
from repro_torch.kernels.dot_interaction import dot_interaction_fused
from repro_torch.kernels.recflash_sls import recflash_sls_grouped
from repro_torch.models import dlrm

# test_torch_cuda.py's forward tolerance: the kernels add in other orders
# than the plain versions, and cuBLAS may pick another algorithm for the
# bucket's rows than for the batch's
TOL = dict(rtol=1e-4, atol=1e-5)
SIZES = list(range(1, 65)) + [65, 100, 1024]


def _model(device="cpu", table_dtype=torch.float32, rows=(300, 200, 500),
           lookups=5, dim=16, seed=0):
    cfg = dlrm.DLRMConfig(name="tiny", n_tables=len(rows), n_dense=7,
                          embed_dim=dim, n_rows=tuple(rows), lookups=lookups,
                          bot_mlp=(32, dim), top_mlp=(32, 16))
    params = dlrm.init(seed, cfg, device=device)
    params["tables"] = [t.to(table_dtype) for t in params["tables"]]
    gen = torch.Generator(device=device).manual_seed(seed)
    rank_of = [torch.randperm(n, generator=gen, device=device).to(torch.int32)
               for n in rows]
    return cfg, dlrm.add_remap(params, rank_of, [max(1, n // 8) for n in rows])


def _batch(cfg, b, device="cpu", seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"dense": torch.randn(b, cfg.n_dense, generator=gen,
                                 device=device),
            "indices": torch.stack(
                [torch.randint(0, v, (b, cfg.lookups), generator=gen,
                               device=device) for v in cfg.n_rows],
                dim=1).to(torch.int32)}


# which calls take the route (CPU)


def _grad_tables(params):
    return {**params, "tables": [t.requires_grad_() for t in params["tables"]]}


def _grad_dense(batch):
    return {**batch, "dense": batch["dense"].requires_grad_()}


def _no_cache(params):
    return {k: v for k, v in params.items() if k != dlrm.GRAPHS}


# (params, batch, mesh, plain, grad mode) edits -> the reason
CASES = {
    "eligible_but_on_the_cpu": (None, None, None, False, True, "device"),
    "mesh": (None, None, object(), False, True, "mesh"),
    "plain": (None, None, None, True, True, "plain"),
    "not_remapped": ("init", None, None, False, True, "descriptors"),
    "no_graph_cache": (_no_cache, None, None, False, True, "descriptors"),
    "above_the_limit": (None, 1025, None, False, True, "rows"),
    "no_rows": (None, 0, None, False, True, "rows"),
    "at_the_limit": (None, 1024, None, False, True, "device"),
    "tables_want_a_gradient": (_grad_tables, None, None, False, True,
                               "gradient"),
    "dense_wants_a_gradient": (None, _grad_dense, None, False, True,
                               "gradient"),
    "gradient_off": (_grad_tables, None, None, False, False, "device"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_reason(case):
    edit_params, edit_batch, mesh, plain, grad, want = CASES[case]
    cfg, params = _model()
    if edit_params == "init":
        params = dlrm.init(0, cfg, device="cpu")
    elif edit_params is not None:
        params = edit_params(params)
    if isinstance(edit_batch, int):
        batch = _batch(cfg, edit_batch)
    else:
        batch = _batch(cfg, 8)
        if edit_batch is not None:
            batch = edit_batch(batch)
    with torch.set_grad_enabled(grad):
        assert dlrm.eager_reason(params, batch, mesh, plain) == want


def test_inference_mode_wants_no_gradient():
    cfg, params = _model()
    params = _grad_tables(params)
    with torch.inference_mode():
        assert dlrm.eager_reason(params, _batch(cfg, 8)) == "device"


@pytest.mark.parametrize("rows,bucket", [
    (1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (33, 64), (52, 64), (64, 64),
    (65, 128), (100, 128), (513, 1024), (1024, 1024)])
def test_graph_bucket(rows, bucket):
    assert dlrm.graph_bucket(rows) == bucket


def test_buckets_are_powers_of_two_up_to_the_limit():
    seen = set()
    for rows in range(1, dlrm.GRAPH_MAX_ROWS + 1):
        b = dlrm.graph_bucket(rows)
        assert b & (b - 1) == 0 and rows <= b < 2 * rows
        assert b <= dlrm.GRAPH_MAX_ROWS
        seen.add(b)
    assert len(seen) == 11                     # 1, 2, 4, ..., 1024
    for rows in (0, -1, dlrm.GRAPH_MAX_ROWS + 1):
        with pytest.raises(ValueError):
            dlrm.graph_bucket(rows)


def test_add_remap_gives_each_dict_a_new_cache():
    cfg, params = _model()
    again = dlrm.add_remap(params, params["rank_of"], params["hot_sizes"])
    assert isinstance(params[dlrm.GRAPHS], dlrm.GraphCache)
    assert again[dlrm.GRAPHS] is not params[dlrm.GRAPHS]
    assert again[dlrm.GRAPHS].graphs == {}


def test_cpu_calls_stay_eager_and_count_nothing():
    cfg, params = _model()
    counts = (dlrm.forward.graph_captures, dlrm.forward.graph_replays)
    with torch.inference_mode():
        got = dlrm.forward(params, _batch(cfg, 8), cfg)
        want = dlrm.forward(params, _batch(cfg, 8), cfg, plain=True)
    torch.testing.assert_close(got, want, **TOL)
    assert (dlrm.forward.graph_captures, dlrm.forward.graph_replays) == counts
    assert params[dlrm.GRAPHS].graphs == {}


def test_registry_attach_leaves_the_cache_out():
    """The registry's serve plan remaps a new dict every call, which no
    graph could be replayed for."""
    cfg, params = _model()
    batch = {**_batch(cfg, 8), "rank_of": params["rank_of"]}
    attached = dlrm_mlperf._attach(dlrm.init(0, cfg, device="cpu"), batch,
                                   None)
    assert attached["sls_desc"] is not None
    assert attached[dlrm.GRAPHS] is None
    assert dlrm.eager_reason(attached, batch) == "descriptors"


def _edit(key, t, fn):
    return lambda p: {**p, key: [fn(x) if i == t else x
                                 for i, x in enumerate(p[key])]}


# params edits after add_remap -> whether the descriptors are stale
STALE_CASES = {
    "unchanged": (lambda p: p, False),
    "table_clone": (_edit("tables", 1, torch.Tensor.clone), True),
    "table_view_fewer_rows": (_edit("tables", 2, lambda t: t[:400]), True),
    "hot_size": (_edit("hot_sizes", 0, lambda h: h + 1), True),
    "rank_of_view": (_edit("rank_of", 0, lambda r: r[:250]), True),
}


@pytest.mark.parametrize("case", sorted(STALE_CASES))
def test_one_staleness_rule(case):
    """``TableDescs.check`` is the one rule: the eager forward raises where
    it raises, and so does the graph route, whose check runs before
    anything touches the card (so it runs here); a view over the same
    storage with fewer rows is stale on both."""
    cfg, params = _model()
    edit, stale = STALE_CASES[case]
    edited = edit(params)
    args = (edited["tables"], edited["hot_sizes"], edited["rank_of"])
    batch = _batch(cfg, 8)
    desc = params["sls_desc"]
    assert edited["sls_desc"] is desc
    if not stale:
        desc.check(*args)
        with torch.inference_mode():
            torch.testing.assert_close(
                dlrm.forward(edited, batch, cfg),
                dlrm.forward(edited, batch, cfg, plain=True), **TOL)
        return
    with pytest.raises(ValueError, match="no longer match"):
        desc.check(*args)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="no longer match"):
            dlrm.forward(edited, batch, cfg)
        with pytest.raises(ValueError, match="no longer match"):
            dlrm._graphed(edited, batch, cfg)
    assert params[dlrm.GRAPHS].desc is None
    assert params[dlrm.GRAPHS].graphs == {}


# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SLS kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return (dlrm.forward.graph_captures, dlrm.forward.graph_replays,
            recflash_sls_grouped.launches, dot_interaction_fused.launches)


def _step(params, batch, cfg):
    with torch.inference_mode():
        return dlrm.forward(params, batch, cfg)


def _plain(params, batch, cfg):
    with torch.inference_mode():
        return dlrm.forward(params, batch, cfg, plain=True)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_graph_route_vs_plain(card, table_dtype):
    """Every size from 1 to 64, and 65, 100 and 1,024: the bucket's first
    call (eager, then the capture) and a replay, both against the plain
    route; one capture a bucket. The kernels' wrappers count the eager
    calls alone: neither the capture's launches nor a replay's runs."""
    cfg, params = _model("cuda", table_dtype, rows=(3000, 2000, 5000),
                         lookups=20, dim=64)
    c0 = _counts()
    calls = 0
    for n in SIZES:
        for seed in (n, n + 1000):
            batch = _batch(cfg, n, "cuda", seed)
            got = _step(params, batch, cfg)
            calls += 1
            assert got.shape == (n,) and got.dtype == torch.float32
            torch.testing.assert_close(got, _plain(params, batch, cfg),
                                       **TOL)
    buckets = len({dlrm.graph_bucket(n) for n in SIZES})
    c1 = _counts()
    assert c1[0] - c0[0] == buckets == 9          # 1, 2, ..., 128, 1024
    assert c1[1] - c0[1] == calls - buckets
    # one eager call a bucket; the plain calls launch no kernel
    assert c1[2] - c0[2] == c1[3] - c0[3] == buckets
    assert len(params[dlrm.GRAPHS].graphs) == buckets


@pytest.mark.cuda
def test_above_the_limit_runs_eagerly(card):
    cfg, params = _model("cuda")
    for n in (1025, 2048):
        batch = _batch(cfg, n, "cuda")
        c0 = _counts()
        got = _step(params, batch, cfg)
        assert _counts() == (c0[0], c0[1], c0[2] + 1, c0[3] + 1)
        torch.testing.assert_close(got, _plain(params, batch, cfg), **TOL)
    assert params[dlrm.GRAPHS].graphs == {}


@pytest.mark.cuda
def test_a_result_survives_the_next_call(card):
    cfg, params = _model("cuda")
    first = _step(params, _batch(cfg, 40, "cuda", 1), cfg)     # captured
    kept = _step(params, _batch(cfg, 40, "cuda", 2), cfg)      # replayed
    copied = kept.clone()
    for seed in (3, 4):
        _step(params, _batch(cfg, 48, "cuda", seed), cfg)       # same bucket
    assert torch.equal(kept, copied) and not torch.equal(first, kept)


@pytest.mark.cuda
def test_replaced_tensors_recapture_and_in_place_writes_are_read(card):
    cfg, params = _model("cuda")
    batch = _batch(cfg, 20, "cuda")
    _step(params, batch, cfg)
    _step(params, batch, cfg)

    def check(captures, replays):
        c0 = _counts()
        torch.testing.assert_close(_step(params, batch, cfg),
                                   _plain(params, batch, cfg), **TOL)
        assert _counts()[:2] == (c0[0] + captures, c0[1] + replays)

    params["top"][0]["w"] = params["top"][0]["w"] * 2       # a new tensor
    check(1, 0)
    check(0, 1)
    with torch.no_grad():
        params["bot"][1]["b"] += 0.5                         # in place
        params["top"][1]["w"].mul_(-1)
    check(0, 1)
    params["bot"][0] = {"w": params["bot"][0]["w"].clone()}  # bias dropped
    check(1, 0)
    check(0, 1)
    params = dlrm.add_remap(params, params["rank_of"], params["hot_sizes"])
    check(1, 0)
    check(0, 1)


@pytest.mark.cuda
def test_a_table_replaced_without_add_remap_raises(card):
    cfg, params = _model("cuda")
    batch = _batch(cfg, 20, "cuda")
    _step(params, batch, cfg)
    _step(params, batch, cfg)
    c0 = _counts()
    params["tables"][1] = params["tables"][1].clone()
    with pytest.raises(ValueError, match="no longer match"):
        _step(params, batch, cfg)
    params["hot_sizes"] = [h + 1 for h in params["hot_sizes"]]
    with pytest.raises(ValueError, match="no longer match"):
        _step(params, batch, cfg)
    # a cache that has captured nothing refuses as well
    _, fresh = _model("cuda")
    fresh["rank_of"][0] = fresh["rank_of"][0].clone()
    with pytest.raises(ValueError, match="no longer match"):
        _step(fresh, batch, cfg)
    assert _counts() == c0


@pytest.mark.cuda
@pytest.mark.parametrize("swap", ["table_data", "rank_of_set",
                                  "table_view"])
def test_storage_swapped_under_a_tensor_raises(card, swap):
    """A table or ``rank_of`` that keeps its identity but gets new storage
    (``.data =``, ``set_``), or a table replaced by a view of fewer rows
    over its storage, after the graphs replayed raises, as the SLS wrapper
    would, until ``add_remap`` describes it again."""
    cfg, params = _model("cuda")
    batch = _batch(cfg, 20, "cuda")
    for _ in range(3):
        _step(params, batch, cfg)
    if swap == "table_data":
        table = params["tables"][2]
        table.data = table.data.clone()
    elif swap == "table_view":
        params["tables"][2] = params["tables"][2][:400]
    else:
        rank_of = params["rank_of"][0]
        rank_of.set_(rank_of.clone())
    c0 = _counts()
    with pytest.raises(ValueError, match="no longer match"):
        _step(params, batch, cfg)
    assert _counts() == c0
    params = dlrm.add_remap(params, params["rank_of"], params["hot_sizes"])
    torch.testing.assert_close(_step(params, batch, cfg),
                               _plain(params, batch, cfg), **TOL)


@pytest.mark.cuda
def test_training_and_grad_mode_stay_eager(card):
    cfg, params = _model("cuda")
    batch = _batch(cfg, 20, "cuda")
    params = {**params, "top": [{k: v.clone().requires_grad_()
                                 for k, v in layer.items()}
                                for layer in params["top"]]}
    c0 = _counts()
    out = dlrm.forward(params, batch, cfg)
    out.sum().backward()
    assert params["top"][0]["w"].grad is not None
    assert _counts() == (c0[0], c0[1], c0[2] + 1, c0[3] + 1)
    assert params[dlrm.GRAPHS].graphs == {}
