"""The traffic generator: seeded pools repeat, the K knob's calibrated
exponents hit their unique-access rates, arrivals keep their rate."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from recbench import tiny, traffic
from recbench.spec import Benchmark

HERE = Path(__file__).resolve().parent


def _traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _tiny_model(tmp_path):
    return Benchmark(tiny.make_root(tmp_path)).config("tiny")


def test_seeded_pool_repeats(tmp_path):
    model = _tiny_model(tmp_path)
    tr = tiny.TRAFFIC["tiny-bulk"]
    a = model.make_pool(tr, 2**31 + 5, "cpu")
    b = model.make_pool(tr, 2**31 + 5, "cpu")
    c = model.make_pool(tr, 2**31 + 6, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))
    assert not torch.equal(a[1], c[1])
    # ids in range; the counts profile the tables, not the pool
    for t, v in enumerate(model.vocabs):
        assert 0 <= int(a[1][:, :, t].min()) and int(a[1][:, :, t].max()) < v
        assert a[2][t].sum() == tr["profile_samples"] * model.lookups


@pytest.mark.parametrize("name", ["bulk-k0", "bulk-k2", "online-k0"])
def test_k_knob_hits_its_unique_rate(name):
    ids = _traffic(name)["ids"]
    rate = traffic.K_UNIQUE_RATE[ids["k"]]
    alpha = traffic.calibrate_alpha(ids["calibrated_rows"],
                                    ids["calibrated_draws"], rate)
    assert alpha == pytest.approx(ids["alpha"], abs=1e-9)
    gen = torch.Generator().manual_seed(11)
    cdf = traffic.zipf_cdf(ids["calibrated_rows"], ids["alpha"], "cpu")
    draws = traffic._draw(cdf, ids["calibrated_draws"], gen)
    unique = torch.unique(draws).numel() / ids["calibrated_draws"]
    assert unique == pytest.approx(rate, abs=0.01)


def test_arrivals_keep_their_rate():
    tr = {"rate_rps": 5000.0}
    a = traffic.arrivals_s(tr, 200_000, 3)
    assert np.all(np.diff(a) >= 0)
    assert a.size / a[-1] == pytest.approx(5000.0, rel=0.02)
    assert np.array_equal(a, traffic.arrivals_s(tr, 200_000, 3))


def test_ids_never_reach_padding_rows(tmp_path):
    """Where a table is stored padded beyond its source's vocabulary, its
    ids are drawn over the source's rows alone."""
    model = dataclasses.replace(_tiny_model(tmp_path), id_rows=(3, 400, 40))
    tr = tiny.TRAFFIC["tiny-bulk"]
    _, idx, counts = model.make_pool(tr, 2**31 + 8, "cpu")
    for t, rows in enumerate(model.id_rows):
        assert int(idx[:, :, t].max()) < rows
        assert counts[t].size == model.vocabs[t]
        assert counts[t][rows:].sum() == 0
