"""The span readers (``spans.py`` and the metrics that use it) on
hand-built traces, and in a traced run on the CPU."""

import types

import numpy as np
import pytest

from recbench import harness, spans, tiny
from recbench.devtrace import DeviceTrace
from recbench.spec import Benchmark

# one step: the forward and its four layers, the host's launches in them,
# an aten op around two of them (not a span), a copy launched outside
STEP = [(spans.FORWARD, 100, 1000), (spans.BOT_MLP, 110, 300),
        ("aten::mm", 115, 250), ("cudaLaunchKernel", 120, 130),
        ("cuLaunchKernel", 200, 210), (spans.BAGS, 300, 500),
        ("cudaLaunchKernelExC", 350, 360), (spans.INTERACT, 500, 700),
        ("cudaLaunchKernel", 550, 560), (spans.TOP_MLP, 700, 990),
        ("cudaMemsetAsync", 800, 805), ("cudaLaunchKernel", 810, 820),
        ("cudaMemcpyAsync", 1100, 1110)]
# the device's operations of those launches, listed out of order
OPS = [("gemm_b", 1100, 1200), ("sls", 1200, 1300), ("gemm_a", 1000, 1100),
       ("copy", 1500, 1540), ("gemm_top", 1340, 1420), ("memset", 1330, 1335),
       ("interaction", 1300, 1330)]
OWNER = {"gemm_a": spans.BOT_MLP, "gemm_b": spans.BOT_MLP,
         "sls": spans.BAGS, "interaction": spans.INTERACT,
         "memset": spans.TOP_MLP, "gemm_top": spans.TOP_MLP, "copy": None}


def _trace(host, ops, window_s=1e-6, steps=1):
    return DeviceTrace(window_s, steps, np.ones(1, dtype=np.int64),
                       [n for n, _, _ in ops],
                       np.array([s for _, s, _ in ops], dtype=np.int64),
                       np.array([e for _, _, e in ops], dtype=np.int64),
                       sorted(host, key=lambda h: h[1]))


def _run(trace):
    return types.SimpleNamespace(trace=trace, mode="bulk")


def _read(name, run):
    return Benchmark(tiny.HERE.parent).reader(name)(run)


def test_launches_pair_with_operations_in_order_innermost_span():
    t = _trace(STEP, OPS)
    got = spans.owners(t)
    assert got == [OWNER[n] for n in t.names]
    assert spans.device_s(t, (spans.BOT_MLP, spans.TOP_MLP)) == \
        pytest.approx((100 + 100 + 5 + 80) * 1e-9)
    assert _read("mlp_layer_ms.bulk", _run(t)) == pytest.approx(285e-6)
    assert _read("interact_ms.bulk", _run(t)) == pytest.approx(30e-6)


def test_a_launch_in_the_forward_outside_its_layers_is_the_forwards():
    host = STEP + [("cudaLaunchKernel", 995, 998)]
    t = _trace(host, OPS + [("tail", 1600, 1610)])
    got = dict(zip(t.names, spans.owners(t), strict=True))
    assert got["copy"] == spans.FORWARD and got["tail"] is None


@pytest.mark.parametrize("case", ["extra_launch", "extra_op", "no_ops",
                                  "no_spans"])
def test_nothing_attributed(case):
    host, ops = list(STEP), list(OPS)
    if case == "extra_launch":
        host.append(("cudaLaunchKernel", 900, 901))
    elif case == "extra_op":
        ops.append(("stray", 2000, 2001))
    elif case == "no_ops":                       # as a CPU run
        ops = []
    else:                                        # as a program without spans
        host = [h for h in host if h[0] not in (spans.FORWARD,)
                + spans.CHILDREN]
    t = _trace(host, ops)
    assert spans.owners(t) is None and spans.device_s(t, spans.CHILDREN) \
        is None
    for name in ("mlp_layer_ms.bulk", "interact_ms.bulk"):
        assert _read(name, _run(t)) is None


def test_owners_over_several_steps():
    """Three steps, each shifted in time: each step's operations go to that
    step's spans, and the per-step readers divide by the steps."""
    host, ops = [], []
    for k in range(3):
        dt = 10_000 * k
        host += [(n, s + dt, e + dt) for n, s, e in STEP]
        ops += [(n, s + dt, e + dt) for n, s, e in OPS]
    t = _trace(host, ops, window_s=3e-5, steps=3)
    assert spans.owners(t) == [OWNER[n] for n in t.names]
    assert _read("mlp_layer_ms.bulk", _run(t)) == pytest.approx(285e-6)
    assert _read("interact_ms.bulk", _run(t)) == pytest.approx(30e-6)


def test_traced_cpu_runs(tmp_path, monkeypatch):
    """On the CPU, with no device operations, the span readers read
    nothing and the traced runs stay correct."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.05)
    root = tiny.make_root(tmp_path)
    for cell in ("tiny-bulk", "tiny-online"):
        res = harness.run_cell(root, cell, 2**31 + 11, 0.1, True,
                               device="cpu")
        assert res["correct"]
        assert not {"mlp_layer_ms.bulk", "interact_ms.bulk"} & \
            set(res["metrics"])


def test_span_names_are_the_programs():
    from repro_torch import obs
    assert (spans.FORWARD, spans.CHILDREN) == (obs.FORWARD, obs.CHILDREN)
