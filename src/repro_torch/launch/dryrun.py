"""Production-mesh dry-run: every (arch x shape x mesh) cell's plan, run on
one rank's blocks of meta tensors (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --mesh both --jobs 6 --out /tmp/dryrun.json

The reference lowers and compiles each cell for 256 or 512 placeholder
devices. The port has no compiler to ask: it starts a fake process group
of 256 or 512 ranks in which this process is rank 0 (``distributed.mesh.
init("meta")``: collectives move nothing), builds the production mesh on
it, builds each cell's plan (full-size meta tensors, no memory), cuts each
argument to rank 0's block (``CellPlan.local_specs``, through
``shardings.block_index``) and runs the plan's function once on those
blocks under ``launch.op_stats``. Per cell it records the seconds to build
the plan (``seconds_lower``) and to run it on meta (``seconds_run``), and
the H100 roofline terms of ``launch.roofline`` with the run's peak memory
and ``fits_hbm``. ``--jobs N`` runs N cells at once, each worker process
with a fake group of its own. A cell that fails (a block that does not divide, a
function that refuses its blocks) is a bug in the port: the run exits
nonzero if any non-skipped cell fails.

The per-rank numbers follow the port's layout, which is the reference's
for every cell: the LM's cells hold and compute the reference's blocks
(``configs.lm_common``: Megatron TP, FSDP, the sequence-split caches), the
recsys cells their row blocks of the tables (``configs.recsys_common``:
the DLRMs' masked-psum SLS; DIN's and BERT4Rec's item tables row-sharded
over ``model``, looked up by masked lookups summed over it, BERT4Rec's
tied output on the rank's vocab block), so their collectives are in the
wire bytes.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.distributed import mesh as dmesh
from repro_torch.distributed.shardings import block_index
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_stats import op_stats

MESHES = {False: ((16, 16), "16x16"), True: ((2, 16, 16), "2x16x16")}


def rank_blocks(mesh, args, specs):
    """Meta tensors of this rank's block of each of ``args`` under
    ``specs``."""
    def one(x, spec):
        idx = block_index(mesh.shape, spec, tuple(x.shape), mesh.coord)
        return torch.empty(tuple(s.stop - s.start for s in idx),
                           dtype=x.dtype, device="meta")
    return tree.tree_map(one, args, specs)


def run_cell(bundle, shape: str, mesh, multi_pod: bool) -> dict:
    step = bundle.steps[shape]
    rec = {"arch": bundle.name, "shape": shape,
           "mesh": MESHES[multi_pod][1], "kind": step.kind}
    if step.skip:
        rec.update(status="skip", reason=step.skip)
        return rec
    t0 = time.time()
    plan = step.make_fn(bundle, mesh, multi_pod)
    t1 = time.time()
    blocks = rank_blocks(mesh, plan.args, plan.local_specs())
    stats = op_stats(plan.fn, *blocks, mesh=mesh)
    t2 = time.time()
    n_chips = mesh.axis_size(mesh.axis_names)
    model_flops = (bundle.model_flops or {}).get(shape)
    roof = rl.analyze(stats, n_chips, model_flops)
    rec.update(status="ok", seconds_lower=round(t1 - t0, 2),
               seconds_run=round(t2 - t1, 2), roofline=roof.to_dict())
    return rec


_MESH: dict = {}      # this process's fake group: {multi_pod: mesh}


def _mesh(multi_pod: bool):
    """The production mesh on a fake process group of its ranks (this
    process rank 0), started on first use and when the other mesh is
    asked for."""
    if multi_pod not in _MESH:
        if dist.is_initialized():
            dist.destroy_process_group()
        _MESH.clear()
        shape, _ = MESHES[multi_pod]
        dmesh.init("meta", rank=0, world_size=math.prod(shape))
        _MESH[multi_pod] = make_production_mesh(multi_pod=multi_pod,
                                                device="meta")
    return _MESH[multi_pod]


def _job(name: str, shape: str, multi_pod: bool) -> dict:
    """One cell's record (a failure is a record too)."""
    try:
        return run_cell(get_arch(name), shape, _mesh(multi_pod), multi_pod)
    except Exception as e:                             # noqa: BLE001
        return {"arch": name, "shape": shape, "mesh": MESHES[multi_pod][1],
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="comma list or 'all' (registry names)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--out", default=None, help="JSON output path (merged)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") == "ok"}

    jobs = [(name, shape, multi_pod) for multi_pod in meshes
            for name in archs for shape in get_arch(name).steps
            if (args.shape == "all" or shape in args.shape.split(","))
            and (name, shape, MESHES[multi_pod][1]) not in done]
    # the LM cells first: they take most of the time
    jobs.sort(key=lambda j: get_arch(j[0]).family != "lm")
    n_fail = 0

    def record(rec: dict) -> None:
        nonlocal results, n_fail
        n_fail += rec["status"] == "error"
        _report(rec, f"{rec['arch']} x {rec['shape']} @ {rec['mesh']}",
                args.verbose)
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"])
                   != (rec["arch"], rec["shape"], rec["mesh"])]
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            for fut in as_completed([pool.submit(_job, *j) for j in jobs]):
                record(fut.result())
    else:
        try:
            for j in jobs:
                record(_job(*j))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    print(f"\n{sum(r['status'] == 'ok' for r in results)} ok / "
          f"{sum(r['status'] == 'skip' for r in results)} skip / "
          f"{n_fail} fail")
    return 1 if n_fail else 0


def _report(rec: dict, tag: str, verbose: bool) -> None:
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"[ok]   {tag}: run={rec['seconds_run']}s "
              f"flops/dev={r['flops_per_device']:.3e} "
              f"bytes/dev={r['bytes_per_device']:.3e} "
              f"wire/dev={r['wire_bytes_per_device']:.3e} "
              f"bound={r['bottleneck']} t_bound={r['t_bound']:.3e}s "
              f"peakGB={r['memory']['peak_bytes'] / 1e9:.2f} "
              f"fits={r['memory']['fits_hbm']}", flush=True)
    elif rec["status"] == "skip":
        print(f"[skip] {tag}: {rec['reason'][:80]}", flush=True)
    else:
        print(f"[FAIL] {tag}: {rec['error']}", flush=True)
        if verbose:
            print(rec["traceback"], flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
