"""The port's quickstart against the reference's, on the CPU: steps 1-3
(the storage half, numpy in both packages) print the same lines byte for
byte, and step 4 serves the same share of lookups from the hot tier with
no error against its oracle."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(*args: str) -> str:
    r = subprocess.run([sys.executable, *args], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_quickstart_torch_matches_the_reference():
    ref = _run("examples/quickstart.py")
    got = _run("examples/quickstart_torch.py", "--device", "cpu")
    # steps 1-3 end at the blank line before step 4's
    ref_head, ref_sls = ref.rstrip("\n").rsplit("\n\n", 1)
    got_head, got_sls = got.rstrip("\n").rsplit("\n\n", 1)
    assert ref_head.count("\n") == 5      # 1 + blank + 1 + 3 policies
    assert got_head == ref_head
    share = re.compile(r"(\(512, 32\)) bags, ([0-9.]+%) of lookups")
    assert share.search(got_sls).groups() == share.search(ref_sls).groups()
    assert "plain PyTorch (CPU)" in got_sls
    assert got_sls.endswith("max |err| vs oracle = 0.00e+00")


def test_online_adaptive_remap_torch_matches_the_reference():
    """The port's online-remap example (the Criteo day streams, the
    threshold trigger and Algorithm 1 on the port's numpy copies) prints
    the reference's lines byte for byte."""
    ref = _run("examples/online_adaptive_remap.py")
    got = _run("examples/online_adaptive_remap_torch.py")
    assert got == ref
    assert ref.count("adaptive remap:") >= 1 and "cumulative:" in ref


def test_serve_policy_names_alias():
    from repro.launch import serve as jax_serve
    from repro_torch.flashsim.timeline import SERVING_POLICIES
    from repro_torch.launch import serve

    assert serve.POLICY_NAMES is SERVING_POLICIES
    assert serve.POLICY_NAMES == jax_serve.POLICY_NAMES
