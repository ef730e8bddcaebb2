"""How far one DLRM training step's gradients are from exact, by route.

Trains ``chip_smoke.py``'s train-phase model (dlrm-rm2 at full width, remap
on, batch 4096, its seed and learning rates) for 8 steps, ``--repeats``
times from one initial state (``index_add_``'s atomics make each run's
states differ in the last bits), and at the state after every step takes
one step's gradients four ways on the next batch:

* ``kernel``: through the kernels' ``autograd.Function``s (the training
  path);
* ``plain_sum``: autograd of the plain-routed forward, each bag a
  ``torch.sum`` over its rows;
* ``plain_seq``: the same with each bag summed in lookup order, one row at
  a time (the order of the TPU kernel's ``fori_loop`` and of the CUDA
  kernel), the port's plain version (``kernels.ref.sum_in_order``);
* ``f64``: ``plain_seq`` in float64 at the same (float32) parameters, the
  exact gradient for these purposes.

For each state it prints one JSON line: per route, each gradient tensor's
||g - g_f64|| / ||g_f64||, and the kernel route against each plain route;
and the bags' and the top-MLP input's relative error against float64 per
route. Run on the card from the repo root:

    python tools/train_grad_probe.py --repeats 3 --out build/probe.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402


def torch_sum(rows):
    """Each bag a ``torch.sum`` over its rows (the plain SLS's earlier
    order of addition)."""
    return rows.sum(dim=-2)


# the plain SLS's addition of a bag's rows, per route; plain_seq is the
# port's plain version itself
ROUTES = {"plain_sum": torch_sum, "plain_seq": ref.sum_in_order}


def rel(a, b) -> float:
    return chip_smoke._rel(a, b)


def route(loss_fn, params, batch, plain_sum=None):
    """One step's loss and gradients through one route, and the bags and
    top-MLP input its forward computed (caught at ``dlrm.interact``)."""
    seen = {}
    interact = dlrm.interact

    def catch(x, bags, *a, **k):
        feat = interact(x, bags, *a, **k)
        seen.update(bags=bags.detach(), feat=feat.detach())
        return feat

    leaves = [x.detach().requires_grad_() for x in tree.leaves(params)]
    with mock.patch.object(dlrm, "interact", catch):
        if plain_sum is None:
            loss = loss_fn(tree.unflatten(params, leaves), batch)
        else:
            with mock.patch.object(ref, "sum_in_order", plain_sum):
                loss = loss_fn(tree.unflatten(params, leaves), batch,
                               plain=True)
    grads = list(torch.autograd.grad(loss, leaves))
    return float(loss.detach()), grads, seen["bags"], seen["feat"]


def probe(loss_fn, params, batch) -> dict:
    p64 = tree.tree_map(lambda x: x.double(), params)
    b64 = {**batch, "dense": batch["dense"].double(),
           "labels": batch["labels"].double()}
    loss64, g64, bags64, feat64 = route(loss_fn, p64, b64,
                                        ROUTES["plain_seq"])
    del p64
    out = {"loss_f64": loss64, "grad_vs_f64": {}, "kernel_vs": {},
           "bags_vs_f64": {}, "feat_vs_f64": {}, "bags_max_abs_vs_kernel": {}}
    _, gk, bk, fk = route(loss_fn, params, batch)
    out["grad_vs_f64"]["kernel"] = [rel(a, b) for a, b in zip(gk, g64)]
    out["bags_vs_f64"]["kernel"] = rel(bk, bags64)
    out["feat_vs_f64"]["kernel"] = rel(fk, feat64)
    for name, plain_sum in ROUTES.items():
        _, g, bp, fp = route(loss_fn, params, batch, plain_sum)
        out["grad_vs_f64"][name] = [rel(a, b) for a, b in zip(g, g64)]
        out["kernel_vs"][name] = [rel(a, b) for a, b in zip(gk, g)]
        out["bags_vs_f64"][name] = rel(bp, bags64)
        out["feat_vs_f64"][name] = rel(fp, feat64)
        out["bags_max_abs_vs_kernel"][name] = float((bp - bk).abs().max())
        del g
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=chip_smoke.TRAIN_STEPS)
    ap.add_argument("--out", default="build/train_grad_probe.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_grad_probe: no CUDA card", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    chip_smoke.phase_build()
    cfg = configs.DLRM_RM2
    targs = argparse.Namespace(**chip_smoke.TRAIN)
    params0, opt, loss_fn, batch_fn = train_mod._dlrm_pipeline(
        targs, remap=True, cfg=cfg)
    step_fn = train_mod.make_step(opt, loss_fn)
    batches = [batch_fn(s) for s in range(args.steps + 1)]
    paths = [p for p, _ in tree.flatten_with_path(params0)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for r in range(args.repeats):
            state = (params0, opt.init(params0),
                     torch.zeros((), device="cuda"))
            for s in range(args.steps):
                t0 = time.perf_counter()
                state = step_fn(state, batches[s])
                rec = probe(loss_fn, state[0], batches[s + 1])
                rec.update(repeat=r, step=s + 1, loss=float(state[2]),
                           probe_s=time.perf_counter() - t0)
                f.write(json.dumps(rec) + "\n")
                f.flush()
                g = rec["grad_vs_f64"]
                worst = max(range(len(paths)), key=lambda i: g["kernel"][i])
                print(f"repeat {r} step {s + 1}: loss {rec['loss']:.6f}; "
                      f"largest kernel-route error vs f64 {paths[worst]} "
                      f"kernel {g['kernel'][worst]:.3e} plain_sum "
                      f"{g['plain_sum'][worst]:.3e} plain_seq "
                      f"{g['plain_seq'][worst]:.3e}; kernel vs plain_sum "
                      f"{max(rec['kernel_vs']['plain_sum']):.3e}, vs "
                      f"plain_seq {max(rec['kernel_vs']['plain_seq']):.3e}; "
                      f"bags vs f64 {rec['bags_vs_f64']}; bags max abs vs "
                      f"kernel {rec['bags_max_abs_vs_kernel']}", flush=True)
            del state
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
