"""The yardstick's inputs and its CPU-readable readings, pinned bit for bit:
the pool, the profile counts, the MLP weights, the reference's logits and
the values of the readers that need no card (``hot_hit_share``, ``mfu``,
``sls_roofline`` over fixed uses and a fixed kernel time), at two seeds,
on the tiny configuration and on rmc2's and dlrm-mlperf's files with their
tables cut to ``ROWS`` rows. Digests are the first 16 hex digits of a
SHA-256 over the bytes."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.embedding.layout import RemapSpec

from recbench import harness, tiny
from recbench.devtrace import DeviceTrace
from recbench.spec import Benchmark

HERE = Path(__file__).resolve().parent
ROWS = 2048
SEEDS = (2**31 + 41, 977)
READERS = ("hot_hit_share", "mfu", "sls_roofline")


def _root(tmp_path, config):
    """The tiny root; for a real configuration, its file with every table
    cut to ``ROWS`` rows (and ids over at most as many) and no registry
    arch, in the tiny configuration's place."""
    root = tiny.make_root(tmp_path)
    if config == "tiny":
        return root
    b = Benchmark(HERE.parent)
    entry = next(c for c in b.data["configs"] if c["name"] == config)
    conf = json.loads((b.root / entry["file"]).read_text())
    conf["arch"] = None
    conf["source_vocabs"] = [min(v, ROWS) for v in
                             conf.get("source_vocabs", conf["vocabs"])]
    conf["vocabs"] = [ROWS] * len(conf["vocabs"])
    (root / "recbench/configs/tiny.json").write_text(json.dumps(conf))
    return root


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().contiguous().view(torch.uint8).numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _reference_logits(cell, weights, seed, dense, indices):
    return cell.model.reference_logits(weights, seed, dense, indices)


def readings(tmp_path, config, workload, seed, monkeypatch) -> dict:
    """What the pins hold, for one configuration, cell and seed."""
    root = _root(tmp_path, config)
    bench = Benchmark(root)
    cell = bench.cell(workload)
    counts = []
    plan = RemapSpec.from_counts

    def record(c, *a, **k):
        counts.append(np.asarray(c))
        return plan(c, *a, **k)
    monkeypatch.setattr(RemapSpec, "from_counts", staticmethod(record))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, weights, dense, indices, run = harness.prepare(cell, seed, "cpu")
        with torch.inference_mode():
            want = _reference_logits(cell, weights, seed,
                                     dense.flatten(0, 1),
                                     indices.flatten(0, 1))
    finally:
        torch.set_num_threads(prev)
    n = dense.shape[0]
    uses = np.arange(n, dtype=np.int64) % 4 + 1
    run.pool_uses = uses
    run.samples = int(uses.sum()) * dense.shape[1]
    run.window_s = 0.5
    run.trace = DeviceTrace(1.0, int(uses.sum()), uses, ["sls_kernel<f>"],
                            np.array([0]), np.array([10**6]), [])
    out = {"dense": _digest(dense), "indices": _digest(indices),
           "counts": _digest(*counts),
           "weights": _digest(*(layer[k] for part in ("bot", "top")
                                for layer in weights[part]
                                for k in ("w", "b"))),
           "logits": _digest(want)}
    for name in READERS:
        v = bench.reader(name)(run)
        out[name] = None if v is None else float(v)
    return out


PINNED = {
    ('tiny', 'tiny-bulk', 2147483689): {
        'dense': '675aa01f3c036518',
        'indices': '0a27b37cedead820',
        'counts': '19b22a3d15ef9eab',
        'weights': 'a61f6b081d33c43d',
        'logits': '72de62726d2fc8ac',
        'hot_hit_share': 18.894675925925927,
        'mfu': 4.9152e-06,
        'sls_roofline': 0.0077496119402985075,
    },
    ('tiny', 'tiny-bulk', 977): {
        'dense': 'cc0d0ff521ac2278',
        'indices': 'c493947ca37add32',
        'counts': 'd4cc7398b20a7b77',
        'weights': '5b1495a154340936',
        'logits': 'fd8a8a90c327c49e',
        'hot_hit_share': 18.14236111111111,
        'mfu': 4.9152e-06,
        'sls_roofline': 0.007713074626865672,
    },
    ('tiny', 'tiny-online', 2147483689): {
        'dense': 'f7ff598afe98d55a',
        'indices': 'c02a501a476d5ddb',
        'counts': '427871c0ffd3d0b5',
        'weights': 'a61f6b081d33c43d',
        'logits': '388352de5cee7d01',
        'hot_hit_share': 19.02777777777778,
        'mfu': None,
        'sls_roofline': None,
    },
    ('tiny', 'tiny-online', 977): {
        'dense': '842539a332131392',
        'indices': '9c4300657b20a75e',
        'counts': 'f93d3ffffd96789d',
        'weights': '5b1495a154340936',
        'logits': '896c8ecc384284f2',
        'hot_hit_share': 19.35185185185185,
        'mfu': None,
        'sls_roofline': None,
    },
    ('rmc2', 'tiny-bulk', 2147483689): {
        'dense': '154f0cefa8ebb9a1',
        'indices': 'be47bfb39f227298',
        'counts': 'd82706340edd1f7f',
        'weights': 'b3bf602f0700aceb',
        'logits': 'b94c5b11544a0918',
        'hot_hit_share': 33.54810926649306,
        'mfu': 0.0006457252298507463,
        'sls_roofline': 1.9399763582089555,
    },
    ('rmc2', 'tiny-bulk', 977): {
        'dense': 'a18aeae78d55bb4e',
        'indices': 'e580b8e9591712bc',
        'counts': 'b46ceb82abec236c',
        'weights': 'ab259c0b44d05682',
        'logits': 'bc7dd911537504e2',
        'hot_hit_share': 33.484090169270836,
        'mfu': 0.0006457252298507463,
        'sls_roofline': 1.9392235223880596,
    },
    ('rmc2', 'tiny-online', 2147483689): {
        'dense': '948304094349ac7a',
        'indices': 'ea45be9a19e25255',
        'counts': '444a280ef71b050e',
        'weights': 'b3bf602f0700aceb',
        'logits': '96d72f676f1f4c92',
        'hot_hit_share': 33.29405381944444,
        'mfu': None,
        'sls_roofline': None,
    },
    ('rmc2', 'tiny-online', 977): {
        'dense': 'c4d232e4676ccf5a',
        'indices': 'd9e5c78c6b925b70',
        'counts': '8eedbd17315bce5e',
        'weights': 'ab259c0b44d05682',
        'logits': '8a400b09b8ef34b8',
        'hot_hit_share': 33.38823784722222,
        'mfu': None,
        'sls_roofline': None,
    },
    ('dlrm-mlperf', 'tiny-bulk', 2147483689): {
        'dense': '9c0a222a5db8be27',
        'indices': '4a4f560a2d93ea83',
        'counts': 'e78e315e60bb8efd',
        'weights': '71b59c4a8051f165',
        'logits': '7c6e17ee355b6733',
        'hot_hit_share': 42.838541666666664,
        'mfu': 0.005529086471641791,
        'sls_roofline': 0.11851343283582089,
    },
    ('dlrm-mlperf', 'tiny-bulk', 977): {
        'dense': '80c1bcc4dc4bc498',
        'indices': 'e9941bf9eedbdb44',
        'counts': '7a74e0329623b801',
        'weights': '222dfc2ec39615cb',
        'logits': 'f02b4c1717c70c0e',
        'hot_hit_share': 42.72836538461539,
        'mfu': 0.005529086471641791,
        'sls_roofline': 0.11780716417910447,
    },
    ('dlrm-mlperf', 'tiny-online', 2147483689): {
        'dense': 'f7d2196e268ee111',
        'indices': 'fde9ed7cb7b0a3e7',
        'counts': '9254161d640891a1',
        'weights': '71b59c4a8051f165',
        'logits': '398be2e471a41029',
        'hot_hit_share': 44.27884615384615,
        'mfu': None,
        'sls_roofline': None,
    },
    ('dlrm-mlperf', 'tiny-online', 977): {
        'dense': '3a8df052bd19a5bb',
        'indices': 'd94b6053d54d3b12',
        'counts': 'a0db461328f1cbe0',
        'weights': '222dfc2ec39615cb',
        'logits': '18a63946d387394b',
        'hot_hit_share': 42.243589743589745,
        'mfu': None,
        'sls_roofline': None,
    },
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", list(tiny.TRAFFIC))
@pytest.mark.parametrize("config", ["tiny", "rmc2", "dlrm-mlperf"])
def test_pinned(config, workload, seed, tmp_path, monkeypatch):
    got = readings(tmp_path, config, workload, seed, monkeypatch)
    assert got == PINNED[(config, workload, seed)]
