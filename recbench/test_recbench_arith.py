"""The yardstick's arithmetic on synthetic inputs: interval unions, idle
share and idle gaps, percentiles, the SLS's bytes and bound, FLOPs."""

from pathlib import Path

import numpy as np
import pytest
import torch

from recbench import arith
from recbench.devtrace import DeviceTrace, union
from recbench.spec import Benchmark

HERE = Path(__file__).resolve().parent


def _trace(ops, window_s, host=()):
    return DeviceTrace(window_s, 4, np.ones(1, dtype=np.int64),
                       [o[0] for o in ops],
                       np.array([o[1] for o in ops], dtype=np.int64),
                       np.array([o[2] for o in ops], dtype=np.int64),
                       sorted(host, key=lambda h: h[1]))


def test_union_merges_overlaps():
    u = union(np.array([50, 0, 10, 100, 120]),
              np.array([60, 20, 30, 130, 125]))
    assert u.tolist() == [[0, 30], [50, 60], [100, 130]]
    assert union(np.array([], dtype=np.int64),
                 np.array([], dtype=np.int64)).shape == (0, 2)


def test_busy_idle_and_gaps():
    ops = [("gemm_a", 0, 1000), ("sls_kernel<float>", 500, 1500),
           ("gemm_a", 3000, 4000)]
    host = [("cudaStreamSynchronize", 1600, 2900), ("aten::mm", 2950, 3100)]
    t = _trace(ops, 5000e-9, host)
    assert t.busy_s == pytest.approx(2500e-9)
    read = Benchmark(HERE.parent).reader("idle_share.bulk")

    class Run:
        trace = t
    assert read(Run) == pytest.approx(50.0)
    assert t.seconds(lambda n: "gemm" in n) == pytest.approx(2000e-9)
    assert t.top_ops(1) == [["gemm_a", pytest.approx(2000e-9)]]
    assert t.idle_gaps() == [["cudaStreamSynchronize",
                              pytest.approx(1500e-9)]]
    # a gap no host event spans is the host's Python
    t2 = _trace(ops, 5000e-9, [("aten::mm", 0, 100)])
    assert t2.idle_gaps() == [["host python", pytest.approx(1500e-9)]]


def test_percentiles_drop_nan():
    v = np.array([5.0, 1.0, np.nan, 3.0, 2.0, 4.0])
    assert arith.percentiles(v, (50.0, 95.0)) == pytest.approx((3.0, 4.8))
    assert np.isnan(arith.percentiles(np.array([np.nan]), (50.0,))[0])


def test_sls_bytes_and_bound():
    idx = torch.tensor([[[1, 1, 2], [0, 0, 0]],
                        [[2, 3, 1], [0, 4, 0]]], dtype=torch.int32)
    tables = [idx[:, 0], idx[:, 1]]
    # ids 12 x 4 B, bags 2 x 2 x 8 x 4 B, unique rows (3 + 2) x (32 + 4)
    assert arith.sls_bytes(tables, 8, 4) == 48 + 128 + 5 * 36
    assert arith.sls_adds(tables, 8) == 96
    # bags of other lengths: table 0 three lookups, table 1 one
    odd = [idx[:, 0], idx[:, 1, :1]]
    assert arith.sls_bytes(odd, 8, 4) == 8 * 4 + 128 + 4 * 36
    assert arith.sls_adds(odd, 8) == 64
    b, by = arith.bound_s(3.35e12, 1.0)
    assert b == pytest.approx(1.0) and by == "bytes"
    b, by = arith.bound_s(1.0, 67e12)
    assert b == pytest.approx(1.0) and by == "ops"


def test_flops_per_sample_counts_the_real_layers():
    # rmc2: bottom 256-128-64, top 592-128-64-1 (592 = 64 + 528 pairs of
    # 33 vectors), 528 dots of 64, 32 x 120 bags of 64 adds
    want = 2 * (256 * 128 + 128 * 64) \
        + 2 * (592 * 128 + 128 * 64 + 64) \
        + 2 * 528 * 64 + 32 * 120 * 64
    bench = Benchmark(HERE.parent)
    assert bench.config("rmc2").flops_per_sample() == want
    # dlrm-mlperf: bottom 13-512-256-128, top 479-1024-1024-512-256-1 (479
    # = 128 + 351 pairs of 27 vectors), 351 dots of 128, 26 one-hot bags
    want = 2 * (13 * 512 + 512 * 256 + 256 * 128) \
        + 2 * (479 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256) \
        + 2 * 351 * 128 + 26 * 128
    assert bench.config("dlrm-mlperf").flops_per_sample() == want
