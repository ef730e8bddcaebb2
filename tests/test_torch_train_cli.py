"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU, driven as the reference's tests/test_launch.py drives
``repro.launch.train``: a run, then a longer one that resumes from its
checkpoint, for ``--model dlrm`` and ``--model lm``.
"""

import os
import subprocess
import sys

from repro_torch import checkpoint as ckpt

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_cli_trains_and_resumes(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}

    def run(steps):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--model",
             "dlrm", "--steps", str(steps), "--batch", "64",
             "--ckpt-every", "10", "--ckpt-dir", str(tmp_path),
             "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout

    out = run(30)
    assert "final loss" in out and "(improved)" in out
    assert out.count("\nstep ") == 3
    out2 = run(40)          # resumes at step 30: runs 10 steps
    assert "final loss" in out2 and out2.count("\nstep ") == 1
    assert ckpt.latest_step(str(tmp_path)) == 40


def test_lm_cli_trains_and_resumes(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}

    def run(steps):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--model",
             "lm", "--steps", str(steps), "--batch", "2", "--seq-len", "32",
             "--ckpt-every", "1", "--log-every", "1", "--ckpt-dir",
             str(tmp_path), "--device", "cpu"], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout

    out = run(2)
    assert "model=lm params=47.9M" in out and "final loss" in out
    assert out.count("\nstep ") == 2
    out2 = run(3)           # resumes at step 2: runs 1 step
    assert "final loss" in out2 and out2.count("\nstep ") == 1
    assert ckpt.latest_step(str(tmp_path)) == 3
