"""Per-rank flops, bytes, collective traffic and peak memory of one call
(the port's counterpart of ``repro.launch.hlo_stats``; the dry-run's
roofline input).

The reference parses a compiled executable's optimized HLO. The port has no
HLO: ``op_stats(fn, *args)`` runs ``fn`` once, eagerly, on its arguments
(meta tensors of one rank's blocks, so that nothing is computed or
allocated) under a ``TorchDispatchMode`` that sees every aten op, the
backward's too, and counts:

* **flops**: matrix products only, as ``hlo_stats`` counts ``dot``s: the
  ops of ``torch.utils.flop_counter``'s registry (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, convolutions, attention), each by its formula
  (2mnk for a product). A loop runs its body as often as it runs, so no
  trip count is needed;
* **bytes**: operand plus output bytes of every aten op, views and
  metadata ops (``empty``, ``detach``, ...) skipped. Eager ops are not
  fused, so this counts each intermediate written and read again, where
  ``hlo_stats`` counts a fusion's operands and outputs once: an upper
  bound on the traffic a fused program would need;
* **wire bytes**: each collective of ``repro_torch.distributed.mesh`` on
  the mesh passed (reported to its ``observers``), by ``hlo_stats``' ring
  factors
  over the ``n`` ranks of its axes: an all-reduce ``2 size (n-1)/n``, an
  all-gather ``size (n-1)/n`` of its result, a reduce-scatter ``operand
  (n-1)/n``. The port issues no all-to-all or collective-permute; their
  rows stay zero;
* **peak bytes**: the arguments' storages, plus the most bytes of storages
  the call created that were alive at once (its outputs among them): each
  new storage counted from the op that made it until the last tensor on
  it is freed.

It returns ``hlo_stats``' keys (``flops``, ``bytes``, ``total``'s
``wire_bytes``, ``per_op``), so that ``launch.roofline`` reads either.
``hlo_stats``' ``promoted_wire_bytes`` and ``entry_upcast_bytes`` are
artefacts of XLA on the CPU (bf16 collectives promoted to f32, hoisted
bf16 upcasts) with nothing to count here, and are left out.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry


aten = torch.ops.aten

# hlo_stats' collective names, and the port's kind of each
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter"}

# ops that move no data: allocation without a write, and metadata
_NO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like,
             aten.new_empty, aten.new_empty_strided, aten.detach,
             aten.lift_fresh, aten._unsafe_view, aten.resize_,
             aten.set_, aten.sym_size, aten.sym_stride, aten.sym_numel,
             aten.sym_storage_offset, aten.is_same_size}


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors in ``tree`` (an op's arguments or outputs: tuples,
    lists and dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its ``StorageImpl``)."""
    return t.untyped_storage()._cdata


def wire_bytes(kind: str, n: int, operand_bytes: int) -> tuple[int, float]:
    """(result bytes, wire bytes) of a ``kind`` collective over ``n``
    ranks whose per-rank operand is ``operand_bytes`` (``hlo_stats``' ring
    factors)."""
    ring = (n - 1) / n
    if kind == "all-reduce":
        return operand_bytes, 2.0 * operand_bytes * ring
    if kind == "all-gather":
        return n * operand_bytes, n * operand_bytes * ring
    if kind == "reduce-scatter":
        return operand_bytes // n, operand_bytes * ring
    raise ValueError(f"no ring factor for {kind!r}")


def _signature(x):
    """A hashable stand-in for an op argument: a tensor's metadata, or the
    value itself (sequences as tuples)."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype,
                x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    return x


class _Counter(TorchDispatchMode):
    """Counts each op's flops and bytes and the live bytes of the storages
    the call creates.

    On meta tensors an op's output depends on its arguments' metadata
    alone, and running the meta kernels (most of them Python
    decompositions) is what a dry-run's time goes to. So an op that makes
    new storages is run once per signature: later calls with the same
    arguments' shapes, strides and dtypes get fresh meta tensors of the
    first call's output metadata. Views, in-place ops and ops whose output
    shares an input's storage always run."""

    def __init__(self, arg_keys: set[int]):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.arg_keys = arg_keys
        self.live: dict[int, int] = {}
        self.cur = 0
        self.peak = 0
        self.cache: dict = {}

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def _run(self, func, args, kwargs, ins: list[torch.Tensor]):
        """``func(*args, **kwargs)``, from the signature cache where it can
        be (class docstring); ``ins`` are the arguments' tensors."""
        cacheable = (func.namespace == "aten" and not func.is_view
                     and not func._schema.is_mutable
                     and all(t.device.type == "meta" for t in ins))
        if not cacheable:
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(kwargs))
            hash(key)
        except TypeError:                     # an unhashable argument
            return func(*args, **kwargs)
        hit = self.cache.get(key)
        if hit is not None:
            spec, metas = hit
            return tree_unflatten([
                torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")
                if isinstance(m, tuple) else m for m in metas], spec)
        out = func(*args, **kwargs)
        leaves, spec = tree_flatten(out)
        in_keys = {_key(t) for t in ins}
        if all(not isinstance(t, torch.Tensor) or (
                t.storage_offset() == 0 and _key(t) not in in_keys)
               for t in leaves):
            self.cache[key] = (spec, [
                (tuple(t.shape), t.stride(), t.dtype)
                if isinstance(t, torch.Tensor) else t for t in leaves])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = self._run(func, args, kwargs, ins)
        packet = func.overloadpacket
        if func.namespace != "aten":
            return out                   # c10d: counted as wire bytes
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        outs = _tensors(out)
        if not func.is_view and packet not in _NO_BYTES:
            self.bytes += sum(t.nbytes for t in ins)
            self.bytes += sum(t.nbytes for t in outs)
        for t in outs:
            key = _key(t)
            if key in self.arg_keys or key in self.live:
                continue
            self.live[key] = t.untyped_storage().nbytes()
            self.cur += self.live[key]
            self.peak = max(self.peak, self.cur)
            # a view keeps its base alive, so the base's end is the
            # storage's
            weakref.finalize(t if t._base is None else t._base,
                             self._free, key)
        return out


def op_stats(fn, *args, mesh=None) -> dict:
    """``fn(*args)`` run once under the counter: ``{"flops", "bytes",
    "per_op", "total", "argument_bytes", "peak_bytes"}`` (module
    docstring). ``per_op`` and ``total`` hold ``count``, ``result_bytes``
    and ``wire_bytes`` per collective on ``mesh``, as ``hlo_stats``' do."""
    per_op = {c: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0}
              for c in COLLECTIVES}

    def observe(kind, mesh, axes, x):
        name = _KIND[kind]
        res, wire = wire_bytes(name, mesh.axis_size(axes), x.nbytes)
        per_op[name]["count"] += 1
        per_op[name]["result_bytes"] += res
        per_op[name]["wire_bytes"] += wire

    storages = {_key(t): t.untyped_storage().nbytes()
                for t in _tensors(args)}
    counter = _Counter(set(storages))
    observers = mesh.observers if mesh is not None else []
    observers.append(observe)
    try:
        with counter:
            out = fn(*args)
        del out
    finally:
        observers.remove(observe)
    arg_bytes = sum(storages.values())
    total = {k: sum(v[k] for v in per_op.values())
             for k in ("count", "result_bytes", "wire_bytes")}
    return {"flops": counter.flops, "bytes": counter.bytes,
            "per_op": per_op, "total": total, "argument_bytes": arg_bytes,
            "peak_bytes": arg_bytes + counter.peak}
