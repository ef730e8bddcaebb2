"""Whether the port's float32 DLRM gives the same bits in two checkouts.

Runs a small float32 DLRM of the port on the CPU (3 tables x 500 rows x
16, 4 lookups, batch 16, seeded weights and inputs), with and without the
frequency remap, through both routes (the kernels' wrappers, which run
their plain versions on a CPU tensor, and ``plain=True``), and saves the
logits, the loss, every table's gradient and the retrieval scores of 40
candidates to an ``.npz``. Run it in each checkout, then compare:

    PYTHONPATH=src python tools/dlrm_f32_probe.py a.npz      # checkout A
    PYTHONPATH=src python tools/dlrm_f32_probe.py b.npz      # checkout B
    python tools/dlrm_f32_probe.py --compare a.npz b.npz

``--compare`` prints how many arrays are bit-for-bit equal and exits 1 if
any is not.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

TINY = dict(name="tiny", n_tables=3, n_dense=13, embed_dim=16,
            n_rows=(500,) * 3, lookups=4, bot_mlp=(32, 16), top_mlp=(32,))


def probe(out: str) -> None:
    import torch

    from repro_torch import configs
    from repro_torch.embedding.layout import RemapSpec
    from repro_torch.models import dlrm

    cfg = configs.DLRMConfig(**TINY)
    arrays = []
    for remap in (False, True):
        p = dlrm.init(0, cfg, device="cpu")
        if remap:
            specs = [RemapSpec.from_counts(
                np.random.default_rng(t).integers(0, 30, 500), hot_size=50)
                for t in range(cfg.n_tables)]
            p = dlrm.add_remap(p, [s.rank_of for s in specs],
                               [s.hot_size for s in specs])
        rng = np.random.default_rng(0)
        batch = {"dense": torch.from_numpy(rng.standard_normal(
                     (16, 13)).astype(np.float32)),
                 "indices": torch.from_numpy(rng.integers(
                     0, 500, (16, 3, 4)).astype(np.int32)),
                 "labels": torch.from_numpy(
                     (rng.random(16) > 0.5).astype(np.float32))}
        for plain in (False, True):
            arrays.append(dlrm.forward(p, batch, cfg, plain=plain).numpy())
        tables = [t.detach().requires_grad_() for t in p["tables"]]
        q = {**p, "tables": tables}
        if remap:
            q = dlrm.add_remap(q, p["rank_of"], p["hot_sizes"])
        loss = dlrm.loss(q, batch, cfg)
        arrays.append(loss.detach().numpy().reshape(1))
        arrays += [g.numpy() for g in torch.autograd.grad(loss, tables)]
        user = {"dense": batch["dense"][:1], "indices": batch["indices"][:1],
                "candidates": torch.arange(40, dtype=torch.int32)}
        arrays.append(dlrm.retrieval_score(p, user, cfg).numpy())
    np.savez(out, *arrays)


def compare(a: str, b: str) -> int:
    x, y = np.load(a), np.load(b)
    same = [k for k in x.files if k in y.files
            and x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            and x[k].tobytes() == y[k].tobytes()]
    print(f"{len(same)} of {len(x.files)} arrays bit-for-bit equal "
          f"({len(y.files)} in {b})")
    return 0 if len(same) == len(x.files) == len(y.files) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.paths)
    probe(args.paths[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
