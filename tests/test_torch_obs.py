"""The DLRM step's spans (``repro_torch.obs``).

The CPU tests hold the spans under a CPU profiler. The tests marked ``cuda``
hold the spans against the device's activity on the card and skip
elsewhere; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.models import dlrm

NAMES = (obs.FORWARD,) + obs.CHILDREN
# host events that put an operation on the card's stream
LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"}


def _model(device="cpu", dtype=torch.float32, rows=(600, 400, 512),
           lookups=6, dim=16, seed=0):
    cfg = dlrm.DLRMConfig(name="tiny", n_tables=len(rows), n_dense=5,
                          embed_dim=dim, n_rows=tuple(rows), lookups=lookups,
                          bot_mlp=(32, dim), top_mlp=(32, 16))
    params = dlrm.init(seed, cfg, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rank_of = [torch.randperm(n, generator=gen, device=device).to(torch.int32)
               for n in rows]
    hot = [max(1, n // 8) for n in rows]
    return cfg, dlrm.add_remap(params, rank_of, hot)


def _batches(cfg, n=3, b=8, device="cpu", seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [{"dense": torch.randn(b, cfg.n_dense, generator=gen,
                                  device=device),
             "indices": torch.stack(
                 [torch.randint(0, v, (b, cfg.lookups), generator=gen,
                                device=device) for v in cfg.n_rows],
                 dim=1).to(torch.int32)} for _ in range(n)]


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def _spans(prof) -> list:
    return [e for e in _events(prof) if e.name() in NAMES]


def test_off_is_the_shared_no_op_and_records_nothing(monkeypatch):
    assert obs.span(obs.FORWARD) is obs.span(obs.BAGS) is obs._OFF

    def refuse(name):
        raise AssertionError(f"span {name} recorded with no profiler")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    cfg, params = _model()
    with torch.inference_mode():
        for batch in _batches(cfg):
            dlrm.forward(params, batch, cfg)


@pytest.mark.parametrize("plain", [False, True])
def test_five_spans_once_each_as_cpu_ops(plain):
    cfg, params = _model()
    (batch,) = _batches(cfg, n=1)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        dlrm.forward(params, batch, cfg, plain=plain)
    got = _spans(prof)
    assert sorted(e.name() for e in got) == sorted(NAMES)
    for e in got:
        assert not e.is_user_annotation()
        assert e.activity_type() == "cpu_op"
    by = {e.name(): (e.start_ns(), e.end_ns()) for e in got}
    f0, f1 = by[obs.FORWARD]
    last = f0
    for name in obs.CHILDREN:                  # inside it, in this order
        s, e = by[name]
        assert last <= s <= e <= f1
        last = e


def test_spans_on_the_mesh_route(tmp_path):
    import torch.distributed as dist

    from repro_torch.distributed import mesh as M
    store = dist.FileStore(str(tmp_path / "store"), 1)
    M.init("cpu", rank=0, world_size=1, store=store)
    try:
        mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
        cfg, params = _model()
        (batch,) = _batches(cfg, n=1)
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU]) as prof:
            dlrm.forward(params, batch, cfg, mesh)
    finally:
        dist.destroy_process_group()
    assert sorted(e.name() for e in _spans(prof)) == sorted(NAMES)


# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SLS kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rmc2_shaped(table_dtype=torch.float32):
    """rmc2's widths (32 tables, 120 lookups, D=64, its MLPs) over small
    tables stored in ``table_dtype`` (the MLPs float32, as dlrm-mlperf
    runs), and a serving batch of 64."""
    cfg = dlrm.DLRMConfig(name="rmc2-small", n_tables=32, n_dense=256,
                          embed_dim=64, n_rows=(20_000,) * 32, lookups=120,
                          bot_mlp=(128, 64), top_mlp=(128, 64))
    params = dlrm.init(0, cfg, device="cuda")
    params["tables"] = [t.to(table_dtype) for t in params["tables"]]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rank_of = [torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
               for n in cfg.n_rows]
    params = dlrm.add_remap(params, rank_of, [2000] * cfg.n_tables)
    return cfg, params, _batches(cfg, n=3, b=64, device="cuda")


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _events(prof)


def _on_card(events):
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type() == DeviceType.CUDA]


@pytest.mark.cuda
def test_spans_add_no_device_event(card, monkeypatch):
    cfg, params, batches = _rmc2_shaped()
    with torch.inference_mode():
        dlrm.forward(params, batches[0], cfg)            # built and warm
        torch.cuda.synchronize()
        events = _traced(lambda: dlrm.forward(params, batches[1], cfg))
        assert sorted(e.name() for e in events if e.name() in NAMES) \
            == sorted(NAMES)
        assert not [e.name() for e in _on_card(events) if e.name() in NAMES]
        assert not [e.name() for e in _on_card(events)
                    if e.is_user_annotation()]
        monkeypatch.setattr(obs, "span", lambda name: obs._OFF)
        bare = _traced(lambda: dlrm.forward(params, batches[1], cfg))
    assert not [e for e in bare if e.name() in NAMES]
    assert len(_on_card(events)) == len(_on_card(bare))


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_launches_lie_inside_their_spans(card, table_dtype):
    """Every launch of the forward lies inside one child span on the
    trace's clock, and the launches, paired in order with the device's
    operations, put the SLS kernel in ``dlrm.bags`` and the interaction
    kernel (after the cast of bf16 bags) in ``dlrm.interact``."""
    cfg, params, batches = _rmc2_shaped(table_dtype)
    with torch.inference_mode():
        dlrm.forward(params, batches[0], cfg)
        torch.cuda.synchronize()
        events = _traced(lambda: dlrm.forward(params, batches[1], cfg))
    spans = {e.name(): (e.start_ns(), e.end_ns()) for e in events
             if e.name() in NAMES}
    launches = sorted((e.start_ns(), e.end_ns()) for e in events
                      if e.name() in LAUNCHES)
    ops = sorted((e.start_ns(), e.name()) for e in _on_card(events))
    assert launches and len(launches) == len(ops)
    owner = []
    for s, e in launches:
        inside = [n for n in obs.CHILDREN
                  if spans[n][0] <= s and e <= spans[n][1]]
        assert len(inside) == 1, (s, e, spans)
        owner.append(inside[0])
    by_span = {}
    for n, (_, op) in zip(owner, ops, strict=True):
        by_span.setdefault(n, []).append(op)
    (sls,) = by_span[obs.BAGS]
    inter = by_span[obs.INTERACT]                 # f32 bags have no cast
    assert len(inter) == (1 if table_dtype == torch.float32 else 2), inter
    assert "sls_kernel" in sls and "interaction_kernel" in inter[-1]
    assert not any("sls_kernel" in op or "interaction_kernel" in op
                   for n in (obs.BOT_MLP, obs.TOP_MLP) for op in by_span[n])
