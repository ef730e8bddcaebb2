"""The harness on the card at toy size: a sound run is correct, a broken
SLS is caught, and the card's own TF32 reads above the check's limit.
Run on the card with ``python -m pytest -q -m cuda recbench``."""

import pytest
import torch

from recbench import harness, tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def root(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return tiny.make_root(tmp_path)


@pytest.mark.parametrize("cell", list(tiny.TRAFFIC))
def test_sound_run_on_the_card(root, cell):
    r = harness.run_cell(root, cell, 2**32 + 9, 0.3, True, device="cuda")
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and r["breakdown"]["device_ops"]


def test_broken_sls_is_caught_on_the_card(root, monkeypatch):
    from repro_torch.models import dlrm
    bags = dlrm.bags

    def broken(params, indices, plain=False):
        out = bags(params, indices, plain).clone()
        out[:, 0] = 0                           # table 0's bags dropped
        return out
    monkeypatch.setattr(dlrm, "bags", broken)
    r = harness.run_cell(root, "tiny-bulk", 2**32 + 9, 0.3, False,
                         device="cuda")
    assert not r["correct"]


def test_card_tf32_fails_the_limit(root):
    from recbench.spec import Benchmark
    model = Benchmark(root).config("tiny")
    dev = torch.device("cuda")
    weights = model.make_weights(3, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    dense = torch.randn((4096, model.n_dense), generator=gen, device=dev)
    idx = torch.randint(0, 400, (4096, model.n_tables, model.lookups),
                        generator=gen, device=dev)
    want = model.reference_logits(weights, 3, dense, idx)
    got = model.reference_logits(weights, 3, dense, idx, "tf32-card")
    err = harness.logit_err(model, weights, 3, [(dense, idx, got)])
    assert err > model.logit_err_limit
    assert harness.logit_err(model, weights, 3, [(dense, idx, want)]) == 0
