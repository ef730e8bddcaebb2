"""A whole run on the CPU, the card's look skipped, with the timed path
broken underneath: ``correct`` must come out false for each fault an
inference cell can have; sound, it must come out true."""

import pytest
import torch

from repro_torch.models import dlrm

from recbench import harness, tiny

SEED = 2**31 + 977


def _alter_answer(forward):
    def broken(params, batch, cfg, *a, **k):
        out = forward(params, batch, cfg, *a, **k).clone()
        out[0] += 0.01 * out.abs().mean()       # one answer a batch
        return out
    return broken


def _half_batch(forward):
    def broken(params, batch, cfg, *a, **k):
        n = batch["dense"].shape[0]
        h = (n + 1) // 2
        half = forward(params, {key: v[:h] for key, v in batch.items()},
                       cfg, *a, **k)
        return torch.cat([half, half])[:n]      # the rest left out
    return broken


def _no_answer(forward):
    def broken(params, batch, cfg, *a, **k):
        out = forward(params, batch, cfg, *a, **k).clone()
        out[-1] = float("nan")                  # an answer that never comes
        return out
    return broken


def _bags_without_remap(bags):
    def broken(params, indices, plain=False):
        # stored (rank-ordered) rows read at logical ids: the remap skipped
        p = {k: v for k, v in params.items()
             if k not in ("rank_of", "sls_desc")}
        p["hot_sizes"] = params["hot_sizes"]
        return bags(p, indices, plain)
    return broken


def _bias_dropped(mlp):
    def broken(params, x, *a, **k):
        # every layer's bias add left out
        return mlp([{"w": layer["w"]} for layer in params], x, *a, **k)
    return broken


FAULTS = {"answer_altered": ("forward", _alter_answer),
          "bias_dropped": ("mlp", _bias_dropped),
          "half_batch": ("forward", _half_batch),
          "no_answer": ("forward", _no_answer),
          "remap_skipped": ("bags", _bags_without_remap)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", list(tiny.TRAFFIC))
def test_sound_run_is_correct(root, cell):
    r = harness.run_cell(root, cell, SEED, 0.2, False, device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["logit_err"]["value"] <= \
        r["checks"]["logit_err"]["limit"]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", list(tiny.TRAFFIC))
def test_fault_is_caught(root, cell, fault, monkeypatch):
    name, make = FAULTS[fault]
    monkeypatch.setattr(dlrm, name, make(getattr(dlrm, name)))
    r = harness.run_cell(root, cell, SEED, 0.2, False, device="cpu")
    assert not r["correct"]
