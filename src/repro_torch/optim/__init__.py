"""Optimizers on torch tensors, functional (port of ``repro.optim``).

``sgd``, ``adamw``, ``adagrad`` (with a **row-wise** mode for embedding
tables: one accumulator per row, the usual memory saving for 10^6..10^9-row
tables), ``adafactor`` (factored second moments) and ``partitioned``.

API: ``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(new_params, new_state)``. Params, grads and state are trees of tensors
(``repro_torch.tree``); ``update`` returns new tensors and changes none of
its arguments, as the reference's pure functions do. The arithmetic is the
reference's, in its order: ``adamw``'s bias corrections are f32 tensors
(``b1 ** t`` with ``t`` an int32 0-d tensor), and ``adagrad`` steps by
``p - lr * g * scale``.

Low-precision params keep float32 state: ``adagrad``'s accumulators are
float32 as in the reference, and so are ``adamw``'s moments, where the
reference keeps them in the params' dtype (``jnp.zeros_like``). Every
update returns each param in its own dtype; the reference's ``adamw``
returns a bf16 param as float32 (its float32 bias corrections promote the
step), which would leave a bf16 model with float32 MLPs after one step.

``Optimizer.state_specs`` (``adafactor``'s) derives the state's
``PartitionSpec``s from the params' (``repro_torch.distributed``).
``Optimizer.on_blocks(mesh, param_specs, state_specs)`` is the update on
this rank's blocks of params, gradients and state under a mesh: the
elementwise updates run on blocks as they are, ``adamw``'s where its
moments' specs shard another dim (ZeRO rules) after the params and
gradients are cut to the moments' blocks, the new params rejoined to their
own, and ``adafactor``'s means (its row and column statistics and the
update's RMS) sum each block over the axes that shard the reduced dims and
divide by the whole size, so that each block equals the reference's update
of the whole array there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.distributed.shardings import P, mentioned


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]
    # optional: the state's PartitionSpecs from the params' (needed where
    # state shapes differ from param shapes, e.g. adafactor's factored
    # moments): (params, param_specs) -> spec tree matching init(params)
    state_specs: Callable[[Any, Any], Any] | None = None
    # optional: (mesh, param_specs, state_specs) -> the update on this
    # rank's blocks, where the blocks as they are do not give it
    # (adafactor's means, adamw's ZeRO moments)
    blocks: Callable[[Any, Any, Any], Callable] | None = None

    def on_blocks(self, mesh, param_specs, state_specs=None) -> Callable:
        """The update on this rank's blocks of the params under
        ``param_specs`` and of the state under ``state_specs`` (None: the
        optimizer's own ``state_specs``, or the params') on ``mesh``."""
        if mesh is None or self.blocks is None:
            return self.update
        return self.blocks(mesh, param_specs, state_specs)


def _step_counter(params) -> torch.Tensor:
    """A 0-d int32 zero on the params' device (the first leaf's)."""
    flat = tree.leaves(params)
    device = flat[0].device if flat else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree.tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        if momentum == 0.0:
            return tree.tree_map(lambda p, g: p - lr * g, params, grads), ()
        vel = tree.tree_map(lambda v, g: momentum * v + g, state, grads)
        return tree.tree_map(lambda p, v: p - lr * v, params, vel), vel

    return Optimizer(init, update)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """Zeros shaped as ``p`` in float32, or float64 for a float64 ``p``."""
    return torch.zeros_like(p, dtype=torch.promote_types(p.dtype,
                                                         torch.float32))


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with float32 moments (module docstring), each param returned
    in its dtype."""

    def init(params):
        return {"m": tree.tree_map(_zeros_f32, params),
                "v": tree.tree_map(_zeros_f32, params),
                "t": _step_counter(params)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g,
                          state["m"], grads)
        v = tree.tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                          state["v"], grads)
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def step(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            return (p - lr * (upd + weight_decay * p)).to(p.dtype)

        return (tree.tree_map(step, params, m, v),
                {"m": m, "v": v, "t": t})

    def blocks(mesh, param_specs, state_specs):
        layout = param_specs if state_specs is None else state_specs["m"]
        if tree.leaves(layout) == tree.leaves(param_specs):
            return update

        def zero(grads, state, params):
            # ZeRO: the moments' blocks of the update, the params rejoined
            with torch.no_grad():
                new, state = update(_respec(mesh, grads, param_specs, layout),
                                    state,
                                    _respec(mesh, params, param_specs, layout))
                return _respec(mesh, new, layout, param_specs), state
        return zero

    return Optimizer(init, update, blocks=blocks)


def _respec(mesh, x, have, want):
    """Each block of ``x`` under ``have`` recut to its block under
    ``want``."""
    from repro_torch.distributed.mesh import respec
    return tree.tree_map(lambda a, h, w: respec(a, mesh, h, w), x, have,
                         want)


def adagrad(lr: float, eps: float = 1e-10,
            rowwise: bool = False) -> Optimizer:
    """DLRM-style adagrad. ``rowwise`` keeps one accumulator per table row
    (mean over the embedding dim), cutting optimizer memory D-fold.

    The update is dense, as the reference's: every row of a table is
    rewritten each step (rows with a zero gradient keep their values). The
    leaves are updated one at a time, so a leaf's temporaries are freed
    before the next leaf's are made.
    """

    def init(params):
        if rowwise:
            return tree.tree_map(
                lambda p: torch.zeros(p.shape[:1] if p.ndim == 2 else p.shape,
                                      dtype=torch.float32, device=p.device),
                params)
        return tree.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def update(grads, state, params):
        new_params, new_state = [], []
        for p, g, a in zip(tree.leaves(params),
                           tree.flatten_up_to(params, grads),
                           tree.flatten_up_to(params, state), strict=True):
            g32 = g.to(torch.float32)
            if rowwise and p.ndim == 2:
                a_new = a + (g32 ** 2).mean(-1)
                scale = torch.rsqrt(a_new + eps)[:, None]
            else:
                a_new = a + g32 ** 2
                scale = torch.rsqrt(a_new + eps)
            del g32
            new_params.append(p - lr * g * scale.to(p.dtype))
            new_state.append(a_new)
        return (tree.unflatten(params, new_params),
                tree.unflatten(params, new_state))

    return Optimizer(init, update)


def adafactor(lr: float, eps: float = 1e-30,
              min_dim_factored: int = 128,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moments for >=2D params (rows+cols accumulators)."""

    def _factored(p):
        return p.ndim >= 2 and min(p.shape[-2:]) >= min_dim_factored

    def init(params):
        def one(p):
            if _factored(p):
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=torch.float32,
                                         device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"s": tree.tree_map(one, params), "t": _step_counter(params)}

    def update(grads, state, params, mesh=None, param_specs=None):
        t = state["t"] + 1
        beta = 1.0 - (t.to(torch.float32) + 1.0) ** -0.8

        def one(p, g, s, spec):
            mean = _mean if mesh is None else _block_mean(mesh, spec, p)
            g32 = g.to(torch.float32)
            g2 = g32 * g32 + eps
            if "r" in s:
                r = beta * s["r"] + (1 - beta) * mean(g2, -1)
                c = beta * s["c"] + (1 - beta) * mean(g2, -2)
                # r's last dim is the param's second-to-last
                r_mean = (r.mean(-1, keepdim=True) if mesh is None
                          else mean(r[..., None], -2))
                denom = r[..., None] * c[..., None, :] \
                    / torch.clamp_min(r_mean, eps)[..., None]
                upd = g32 * torch.rsqrt(denom + eps)
                new_s = {"r": r, "c": c}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                upd = g32 * torch.rsqrt(v + eps)
                new_s = {"v": v}
            rms = torch.sqrt(mean(upd * upd, None) + eps)
            upd = upd / torch.clamp_min(rms / clip_threshold, 1.0)
            return (p - lr * upd).to(p.dtype), new_s

        specs = (tree.flatten_up_to(params, param_specs)
                 if param_specs is not None else [None] * len(
                     tree.leaves(params)))
        outs = [one(p, g, s, spec) for p, g, s, spec in zip(
            tree.leaves(params), tree.flatten_up_to(params, grads),
            tree.flatten_up_to(params, state["s"]), specs, strict=True)]
        return (tree.unflatten(params, [o[0] for o in outs]),
                {"s": tree.unflatten(params, [o[1] for o in outs]), "t": t})

    def state_specs(params, param_specs):
        """Factored stats drop a dim of the param: ``r`` the last entry of
        its spec, ``c`` the second-to-last."""

        def pad(spec, ndim):
            s = tuple(spec)
            return s + (None,) * (ndim - len(s))

        def one(p, spec):
            if _factored(p):
                s = pad(spec, p.ndim)
                return {"r": P(*s[:-1]), "c": P(*(s[:-2] + s[-1:]))}
            return {"v": spec}

        return {"s": _map_specs(params, param_specs, one), "t": P()}

    def blocks(mesh, param_specs, state_specs):
        return lambda grads, state, params: update(grads, state, params,
                                                   mesh, param_specs)

    return Optimizer(init, update, state_specs=state_specs, blocks=blocks)


def _mean(x: torch.Tensor, dim) -> torch.Tensor:
    """``x.mean(dim)`` (all of ``x`` where ``dim`` is None)."""
    return torch.mean(x) if dim is None else x.mean(dim)


def _block_mean(mesh, spec, p: torch.Tensor):
    """``_mean`` of the whole array on this rank's block of it, for a
    tensor laid out as the param block ``p`` under ``spec`` (its dims
    counted from the end): the block's sum over a dim that ``spec`` shards
    is summed over those axes and divided by the whole size there."""
    from repro_torch.distributed.mesh import psum
    entries = tuple(spec) + (None,) * (p.ndim - len(spec))

    def mean(x: torch.Tensor, dim) -> torch.Tensor:
        dims = range(-p.ndim, 0) if dim is None else (dim,)
        axes = tuple(a for d in dims for a in mentioned(P(entries[d])))
        if not axes:
            return _mean(x, dim)
        n = mesh.axis_size(axes)
        total = torch.sum(x) if dim is None else x.sum(dim)
        size = x.numel() if dim is None else x.shape[dim]
        return psum(total, mesh, axes) / (size * n)
    return mean


def _map_specs(params, param_specs, fn):
    """``fn(param, spec)`` over the leaves of ``params`` and the matching
    specs."""
    return tree.unflatten(params, [
        fn(p, s) for p, s in zip(tree.leaves(params),
                                 tree.flatten_up_to(params, param_specs),
                                 strict=True)])


def partitioned(label_fn: Callable[[str], str],
                opts: dict[str, Optimizer]) -> Optimizer:
    """Route each param to an optimizer by path label (e.g. embedding tables
    -> row-wise adagrad, dense weights -> adamw).

    ``label_fn`` receives the leaf's path string (``jax.tree_util.keystr``'s,
    e.g. ``['tables'][0]``) and must return a key of ``opts``. Each group is
    handled as a flat {path: leaf} dict, so any Optimizer composes.
    """

    def _split(t):
        groups: dict[str, dict[str, Any]] = {k: {} for k in opts}
        for path, leaf in tree.flatten_with_path(t):
            groups[label_fn(path)][path] = leaf
        return groups

    def init(params):
        groups = _split(params)
        return {k: opts[k].init(groups[k]) for k in opts}

    def update(grads, state, params):
        pg, gg = _split(params), _split(grads)
        merged: dict[str, Any] = {}
        new_state = {}
        for k, opt in opts.items():
            upd, st = opt.update(gg[k], state[k], pg[k])
            new_state[k] = st
            merged.update(upd)
        return (tree.unflatten(params, [merged[path] for path, _ in
                                        tree.flatten_with_path(params)]),
                new_state)

    return Optimizer(init, update)
