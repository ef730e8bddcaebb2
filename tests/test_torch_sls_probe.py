"""The grouped SLS probe's host side (``tools/sls_probe.py``) on the CPU:
the ranks each case draws and the bound it holds a launch to. Timing the
kernel needs a card; these run anywhere, at small sizes."""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # tools/ is a repo-root namespace package
    sys.path.insert(0, str(ROOT))

from repro_torch.embedding.layout import RemapSpec  # noqa: E402
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


# the shape of ``nvcc -Xptxas -v``'s report (CUDA 12): one entry with
# static shared memory, one without, and a kernel of another name
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110sls_kernelIfLb1ENS_7UniformEEEvPK9TableDescS2_PKilllPT_iiiiT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110sls_kernelIfLb1ENS_7UniformEEEvPK9TableDescS2_PKilllPT_iiiiT1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110sls_kernelI13__nv_bfloat16Lb0ENS_6RaggedEEEvPK9TableDescS3_PKilllPT_iiiiT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110sls_kernelI13__nv_bfloat16Lb0ENS_6RaggedEEEvPK9TableDescS3_PKilllPT_iiiiT1_
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16 bytes smem, 1552 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 8 registers, 352 bytes cmem[0]
"""


def test_ptxas_report_reads_each_sls_instance():
    rep = sls_probe.ptxas_report(PTXAS_LOG)
    assert [r["registers"] for r in rep] == [56, 255]
    assert [r["smem_bytes"] for r in rep] == [0, 16]
    assert rep[1]["stack_bytes"] == 8
    assert (rep[1]["spill_stores"], rep[1]["spill_loads"]) == (4, 12)
    assert all("sls_kernel" in r["kernel"] for r in rep)
    assert sls_probe.ptxas_report("nvcc: nothing compiled") == []


def test_ncu_medians_split_the_launches_by_root():
    head = '"ID","Kernel Name","Metric Name","Metric Unit","Metric Value"'
    lines = ["==PROF== Connected to process 1", head]
    n = sls_probe.REPS + 1
    for i in range(2 * n):
        hit = 90.0 if i < n else 40.0 + i % 3
        lines.append(f'"{i}","sls_kernel","{sls_probe.NCU_METRICS[0]}",'
                     f'"%","{hit}"')
        lines.append(f'"{i}","sls_kernel","{sls_probe.NCU_METRICS[1]}",'
                     f'"","{1000 * (1 + (i >= n)):,}"')
    med = sls_probe.ncu_medians("\n".join(lines),
                                [pathlib.Path("a"), pathlib.Path("b")])
    assert med["a"] == {sls_probe.NCU_METRICS[0]: 90.0,
                        sls_probe.NCU_METRICS[1]: 1000.0}
    assert med["b"][sls_probe.NCU_METRICS[0]] == 41.0
    assert med["b"][sls_probe.NCU_METRICS[1]] == 2000.0



def test_profile_rank_of_is_the_remaps():
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(ROWS, generator=gen)
    state = gen.get_state()
    rank_of = sls_probe.profile_rank_of(perm, 20_000, 1.1, gen)
    gen.set_state(state)
    ids = perm[sls_probe.zipf_ranks(20_000, 1, ROWS, 1.1, gen).view(-1)]
    spec = RemapSpec.from_counts(torch.bincount(ids, minlength=ROWS).numpy())
    assert rank_of.dtype == torch.int32
    assert np.array_equal(rank_of.numpy(), spec.rank_of)
