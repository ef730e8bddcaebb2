"""The grouped SLS probe's host side (``tools/sls_probe.py``) on the CPU:
the ranks each case draws and the bound it holds a launch to. Timing the
kernel needs a card; these run anywhere, at small sizes."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # tools/ is a repo-root namespace package
    sys.path.insert(0, str(ROOT))

from tools import sls_probe  # noqa: E402

B, L, ROWS, HOT = 16, 12, 5000, 100


def _ranks(case: str, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return sls_probe.case_ranks(case, B, L, ROWS, HOT, gen)


@pytest.mark.parametrize("case", sls_probe.CASES)
def test_every_case_draws_ranks_of_the_table(case):
    r = _ranks(case)
    assert r.shape == (B, L) and r.dtype == torch.int64
    assert 0 <= int(r.min()) and int(r.max()) < ROWS
    assert torch.equal(r, _ranks(case))          # the seed fixes the ids


def test_each_case_lands_in_its_level():
    assert int(_ranks("one").max()) == 0
    assert int(_ranks("head64").max()) < sls_probe.HEAD
    cold = _ranks("cold")
    assert int(cold.min()) >= HOT
    assert torch.unique(cold).numel() == B * L  # every copy a new row


def test_k0_traffic_is_more_skewed_than_k2():
    def head_share(case):
        r = torch.cat([_ranks(case, s) for s in range(8)])
        return float((r < HOT).float().mean())
    k0, k2 = head_share("zipf-k0"), head_share("zipf-k2")
    assert k0 > 0.6 > k2


def test_unknown_case_and_too_few_cold_rows_raise():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="unknown case"):
        sls_probe.case_ranks("warm", B, L, ROWS, HOT, gen)
    with pytest.raises(ValueError, match="distinct cold ranks"):
        sls_probe.case_ranks("cold", B, L, B * L + HOT - 1, HOT, gen)


def test_bound_counts_each_unique_row_once():
    ranks = [torch.zeros(4, 3, dtype=torch.int64),
             torch.tensor([[0, 1, 2]] * 4)]
    ids = torch.zeros(4, 2, 3, dtype=torch.int32)
    ms, by = sls_probe.bound(ranks, ids, 64, 4)
    # 4 unique rows and rank_of entries, 24 ids, 8 bags of 64 f32
    n_bytes = 4 * (256 + 4) + 24 * 4 + 8 * 256
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * n_bytes / sls_probe.HBM_BYTES_PER_S)
