"""Training entry point: ``repro.launch.train``'s two pipelines on torch.

``--model dlrm`` (the default) trains the DLRM on synthetic CTR data and
``--model lm`` the decoder-only ``lm-100m`` on synthetic tokens, each with
the fault-tolerant ``TrainLoop`` (atomic checkpoints, resume from the
newest one, straggler hook) on one device: the card by default
(``--device cuda`` raises without one), ``--device cpu`` for the kernels'
plain versions. The DLRM pipeline is the paper's offline
phase and training stage (Fig. 8): a sampled sweep counts row accesses, the
tables are stored in access-frequency order (AF remap), and each step's
forward runs through the port's two kernels (one grouped SLS, one fused
interaction) and its backward through their ``autograd.Function``s. Tables
take row-wise adagrad, the MLPs AdamW. Flags, batches and output lines are
the reference's; the batches are the same numbers for the same seed.

    PYTHONPATH=src python -m repro_torch.launch.train --model dlrm \\
        --steps 200 --batch 256 --ckpt-dir /path/to/ckpt

The LM pipeline is the reference's ``_lm_pipeline``: ``configs.LM_100M``
(8 layers, d 512, vocab 32,000; 47.85M params) with AdamW (weight decay
0.1), on the reference's batches (``np.random.default_rng(step)`` tokens,
whatever the seed), through no kernel of the port (the LM has none).

    PYTHONPATH=src python -m repro_torch.launch.train --model lm \\
        --steps 2 --batch 2 --seq-len 32 --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import optim, tree
from repro_torch.configs import LM_100M, DLRMConfig, small_dlrm
from repro_torch.device import resolve_device
from repro_torch.distributed.shardings import sync_grads
from repro_torch.runtime import LoopConfig, TrainLoop


def remap_tables(params: dict, cfg: DLRMConfig, seed: int):
    """The paper's offline phase (Fig. 8) on ``params``: a sampled sweep of
    512 batches counts row accesses and each table is replaced, one at a
    time, by its copy in access-frequency order (AF remap). Returns the
    per-table ``rank_of`` (int32, on the tables' device) and hot sizes."""
    import repro_torch.models.dlrm as dlrm
    from repro_torch.core.freq import AccessStats
    from repro_torch.data.tracegen import generate_sls_batch
    from repro_torch.embedding.layout import RemapSpec, remap_table

    tb, rows = generate_sls_batch(cfg.n_tables, cfg.n_rows[0], cfg.lookups,
                                  512, k=0.0, seed=seed + 1)
    specs = []
    for t in range(cfg.n_tables):
        counts = AccessStats.from_trace(rows[tb == t], cfg.n_rows[0]).counts
        specs.append(RemapSpec.from_counts(counts))
    tables = params["tables"]
    for t, spec in enumerate(specs):      # one logical copy at a time
        tables[t] = remap_table(tables[t], spec)
    hot_sizes = [s.hot_size for s in specs]
    # checked and made int32 on the device once, here
    rank_ofs = dlrm.add_remap(params, [s.rank_of for s in specs],
                              hot_sizes)["rank_of"]
    return rank_ofs, hot_sizes


def make_batch_fn(cfg: DLRMConfig, batch: int, seed: int,
                  device: torch.device):
    """``batch_fn(step)``: the reference's synthetic CTR batch of ``step``
    (Zipf lookups, normal dense features, clicks that correlate with dense
    feature 0), on ``device``."""
    from repro_torch.data.tracegen import generate_sls_batch

    def batch_fn(step):
        rng = np.random.default_rng(seed * 100_000 + step)
        tb, rows = generate_sls_batch(cfg.n_tables, cfg.n_rows[0],
                                      cfg.lookups, batch, k=0.0, seed=step)
        idx = rows.reshape(batch, cfg.n_tables, cfg.lookups)
        dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
        # synthetic CTR: clicks correlate with dense feature 0
        labels = (dense[:, 0] + rng.normal(scale=0.5, size=batch)
                  > 0.5).astype(np.float32)
        return {"dense": torch.from_numpy(dense).to(device),
                "indices": torch.from_numpy(idx.astype(np.int32)).to(device),
                "labels": torch.from_numpy(labels).to(device)}

    return batch_fn


def _dlrm_pipeline(args, remap: bool, cfg: DLRMConfig | None = None):
    """Returns (params, opt, loss_fn, batch_fn) for DLRM training of ``cfg``
    (default ``small_dlrm()``) on ``args.device``.

    ``loss_fn(p, batch, plain=False)`` attaches the remap to ``p`` on every
    call, since the grouped SLS kernel's table descriptors name the tables'
    storage and the optimizer returns new tables each step; ``plain=True``
    routes the forward through the kernels' plain versions (the oracle).
    """
    import repro_torch.models.dlrm as dlrm

    cfg = small_dlrm() if cfg is None else cfg
    device = resolve_device(args.device)
    params = dlrm.init(args.seed, cfg, device=device)
    rank_ofs = hot_sizes = None
    if remap:
        rank_ofs, hot_sizes = remap_tables(params, cfg, args.seed)

    opt = optim.partitioned(
        lambda ks: "table" if "tables" in ks else "dense",
        {"table": optim.adagrad(args.lr_table, rowwise=True),
         "dense": optim.adamw(args.lr)})

    def loss_fn(p, batch, plain=False):
        pp = dlrm.add_remap(p, rank_ofs, hot_sizes) if remap else p
        return dlrm.loss(pp, batch, cfg, plain=plain)

    return params, opt, loss_fn, make_batch_fn(cfg, args.batch, args.seed,
                                               device)


def make_lm_batch_fn(vocab: int, batch: int, seq_len: int,
                     device: torch.device):
    """``batch_fn(step)``: the reference's synthetic LM batch of ``step``,
    ``(batch, seq_len + 1)`` uniform tokens from ``default_rng(step)``
    split into inputs and next-token targets, on ``device``."""

    def batch_fn(step):
        toks = np.random.default_rng(step).integers(0, vocab,
                                                    (batch, seq_len + 1))
        toks = torch.from_numpy(toks.astype(np.int32)).to(device)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    return batch_fn


def _lm_pipeline(args):
    """Returns (params, opt, loss_fn, batch_fn) for LM training of
    ``lm-100m`` on ``args.device``."""
    from repro_torch.models import lm

    cfg = LM_100M
    device = resolve_device(args.device)
    params = lm.init(args.seed, cfg, device=device)
    opt = optim.adamw(args.lr, weight_decay=0.1)

    def loss_fn(p, batch):
        return lm.train_loss(p, batch, cfg)

    return params, opt, loss_fn, make_lm_batch_fn(cfg.vocab, args.batch,
                                                  args.seq_len, device)


def make_step(opt, loss_fn, mesh=None, param_specs=None):
    """``step(state, batch) -> state`` for state ``(params, opt_state,
    loss)``: the loss and its gradient with respect to every parameter
    (the reference's ``jax.value_and_grad``), then the optimizer update.

    On a mesh (``params`` this rank's blocks of ``param_specs``) each
    gradient is first summed over the mesh axes its parameter is replicated
    on (``shardings.sync_grads``), so that every rank updates its block
    with its block of the global gradient."""

    def step_fn(state, batch):
        params, opt_state, _ = state
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss = loss_fn(tree.unflatten(params, leaves), batch)
        # a leaf the loss does not reach (a router bias that only picks
        # experts) gets a zero gradient, as jax.grad gives it
        grads = tree.unflatten(params, list(torch.autograd.grad(
            loss, leaves, materialize_grads=True)))
        if mesh is not None:
            grads = sync_grads(mesh, grads, param_specs)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step_fn


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", choices=("dlrm", "lm"), default="dlrm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-table", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-remap", action="store_true",
                    help="disable the RecFlash AF table remap (baseline)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.model == "dlrm":
        params, opt, loss_fn, batch_fn = _dlrm_pipeline(
            args, remap=not args.no_remap)
    else:
        params, opt, loss_fn, batch_fn = _lm_pipeline(args)

    n_params = sum(p.numel() for p in tree.leaves(params))
    print(f"model={args.model} params={n_params/1e6:.1f}M devices=1")

    step_fn = make_step(opt, loss_fn)
    losses = []
    t_start = time.time()

    def metrics_hook(step, state):
        losses.append(float(state[2]))
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t_start
            print(f"step {step + 1:5d}  loss {losses[-1]:.4f}  "
                  f"({dt / (step + 1):.3f}s/step)", flush=True)

    loop = TrainLoop(
        cfg=LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every),
        step_fn=step_fn, batch_fn=batch_fn,
        on_straggler=lambda s, dt, med: print(
            f"[straggler] step {s}: {dt:.2f}s vs median {med:.2f}s"))

    device = tree.leaves(params)[0].device
    # the loop gets the only reference to the initial state (popped into the
    # call), so that the initial tables die after the first step instead of
    # staying alive beside every later state
    init = [(params, opt.init(params), torch.zeros((), device=device))]
    del params
    orig_attempt = loop._attempt

    def attempt_and_log(state, batch):
        out = orig_attempt(state, batch)
        metrics_hook(len(losses), out)
        return out

    loop._attempt = attempt_and_log
    state = loop.run(init.pop())
    print(f"final loss {float(state[2]):.4f} after {args.steps} steps "
          f"in {time.time() - t_start:.1f}s")
    if len(losses) > 20:
        first = np.mean(losses[:10])
        last = np.mean(losses[-10:])
        print(f"loss first10={first:.4f} last10={last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
