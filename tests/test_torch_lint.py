"""The repo's linter (``tools/repro_lint``, RL001-RL010: the simulated
clock, RNG discipline, ordering hazards, units, the NaN contract, counter
conservation, config round-trips) over the port's package.

The linter's scopes name the reference's prefixes (``config.py``): its
walk starts at ``src/repro``, ``benchmarks`` and ``examples``, so the
port's numpy copies of ``core/``, ``flashsim/`` and ``serving/`` fall
outside them. Every checker reads its scope from ``config`` when it runs,
so these tests move each ``src/repro`` prefix to ``src/repro_torch`` and
the walk to ``src/repro_torch`` alone (``monkeypatch``), and lint a copy
of the package in a temporary root, where the linter's symbol-graph cache
is written too.
"""

from __future__ import annotations

import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # tools/ is a repo-root namespace package
    sys.path.insert(0, str(ROOT))

from tools.repro_lint import config  # noqa: E402
from tools.repro_lint.checkers import run_checkers  # noqa: E402

REF, PORT = "src/repro", "src/repro_torch"
ENGINE = "core/engine.py"


def _to_port(prefix: str) -> str:
    if prefix == REF or prefix.startswith(REF + "/"):
        return PORT + prefix[len(REF):]
    return prefix


@pytest.fixture
def port_root(monkeypatch, tmp_path) -> pathlib.Path:
    """A temporary root holding a copy of the port's package, with every
    scope of ``config`` moved from the reference to the port."""
    for name in dir(config):
        value = getattr(config, name)
        if name.isupper() and isinstance(value, tuple) \
                and all(isinstance(x, str) for x in value):
            monkeypatch.setattr(config, name,
                                tuple(_to_port(x) for x in value))
    monkeypatch.setattr(config, "SCAN_ROOTS", (PORT,))
    shutil.copytree(ROOT / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "tools" / "repro_lint").mkdir(parents=True)
    return tmp_path


def test_scopes_move_to_the_port(port_root):
    assert config.SCAN_ROOTS == (PORT,)
    assert config.CLOCK_INCLUDE == (f"{PORT}/flashsim", f"{PORT}/core",
                                    f"{PORT}/serving")
    assert config.RNG_INCLUDE == (PORT,)
    assert config.API_CONSTRUCT_EXCLUDE == (f"{PORT}/serving/deployment.py",
                                            f"{PORT}/core/engine.py")


def test_port_has_no_findings(port_root):
    findings = run_checkers(port_root)
    assert findings == [], "\n".join(
        f"{f.path}:{f.line} {f.checker_id} {f.message}" for f in findings)


def test_planted_wall_clock_and_global_rng_are_found(port_root):
    """A ``time.time()`` and an ``np.random.rand`` planted in the port's
    engine give one RL001 (simulated-clock purity) and one RL002 (RNG
    discipline), and nothing else."""
    engine = port_root / PORT / ENGINE
    engine.write_text(engine.read_text() + (
        "\n\ndef _planted(n):\n"
        "    import time\n"
        "    return time.time() + np.random.rand(n)\n"))
    findings = run_checkers(port_root)
    assert sorted((f.path, f.checker_id) for f in findings) == [
        (f"{PORT}/{ENGINE}", "RL001"), (f"{PORT}/{ENGINE}", "RL002")]
