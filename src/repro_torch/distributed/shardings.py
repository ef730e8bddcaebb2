"""Path-rule based PartitionSpec assignment and block cuts (port of
``repro.distributed.shardings``).

``PartitionSpec`` is the port's own: one entry per leading dim of an array,
each an axis name, a tuple of names (the first major) or ``None``
(replicated). DTensor's placements cannot say ``P(("model", "data"))`` on a
``(data, model)`` mesh without a private type, so the port keeps specs as
data and cuts blocks itself: ``block_index`` at a mesh coordinate is the
block ``jax.sharding.NamedSharding.devices_indices_map`` gives the device
at that coordinate, and ``NamedSharding(mesh, spec).shard`` cuts it.

``make_param_specs(params, rules)`` walks the param tree and returns a
matching tree of specs; ``rules`` is an ordered list of (substring, spec)
pairs matched against each leaf's ``keystr`` path (first hit wins, default
replicated), as the reference keeps its sharding rules as data.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree


class PartitionSpec:
    """``jax.sharding.PartitionSpec``: ``P("model", None)``,
    ``P(("model", "data"), None)``, ``P()``. ``tuple(spec)`` gives the
    entries as JAX's does, a one-name tuple as the name and an empty one as
    ``None``. Not a tuple itself, so that the port's tree walker takes a
    spec for a leaf, as ``jax.tree`` does."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        norm = []
        for e in entries:
            names = e if isinstance(e, tuple) else (e,)
            if e is not None and not all(isinstance(n, str) for n in names):
                raise TypeError(f"spec entry {e!r} is not an axis name, a "
                                "tuple of names or None")
            if isinstance(e, tuple) and len(e) < 2:
                e = e[0] if e else None
            norm.append(e)
        self._entries = tuple(norm)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mentioned(spec: PartitionSpec) -> tuple[str, ...]:
    return tuple(a for e in spec for a in _entry_axes(e))


def unmentioned(mesh, spec: PartitionSpec) -> tuple[str, ...]:
    """The mesh axes over which a ``spec`` array is replicated."""
    used = set(mentioned(spec))
    return tuple(a for a in mesh.axis_names if a not in used)


def block_index(mesh_shape: dict, spec: PartitionSpec, shape, coord: dict
                ) -> tuple[slice, ...]:
    """The block of a ``shape`` array at mesh coordinate ``coord``
    (``{axis: index}``) under ``spec``: dim ``i`` splits into as many
    blocks as its entry's axes have ranks, numbered with the first axis
    major. Raises where a dim does not divide, or a spec names an axis the
    mesh lacks or names one twice."""
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than the {len(shape)}-d "
                         "array has dims")
    names = mentioned(spec)
    if len(set(names)) != len(names):
        raise ValueError(f"{spec} names an axis twice")
    out = []
    for i, size in enumerate(shape):
        axes = _entry_axes(spec[i]) if i < len(spec) else ()
        n, pos = 1, 0
        for a in axes:
            if a not in mesh_shape:
                raise ValueError(f"{spec} names {a!r}, which the mesh "
                                 f"{mesh_shape} lacks")
            n *= mesh_shape[a]
            pos = pos * mesh_shape[a] + coord[a]
        if size % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"into the {n} blocks of {spec}")
        step = size // n
        out.append(slice(pos * step, (pos + 1) * step))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec on a mesh."""

    mesh: object
    spec: PartitionSpec

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x``, contiguous, on
        ``x``'s device."""
        return x[block_index(self.mesh.shape, self.spec, tuple(x.shape),
                             self.mesh.coord)].contiguous()

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's ``block`` (each rank calls
        it): an ``all_gather`` along each sharded dim."""
        from repro_torch.distributed.mesh import all_gather
        x = block.contiguous()
        for i, e in enumerate(self.spec):
            if _entry_axes(e):
                x = all_gather(x, self.mesh, _entry_axes(e), dim=i)
        return x


def make_param_specs(params, rules, default=P()):
    """A tree of specs for ``params``: per leaf, the spec of the first rule
    whose substring is in the leaf's ``keystr`` path, else ``default``."""
    specs = []
    for path, _ in tree.flatten_with_path(params):
        for substr, spec in rules:
            if substr in path:
                specs.append(spec)
                break
        else:
            specs.append(default)
    return tree.unflatten(params, specs)


def batch_spec(batch, axes=("pod", "data")):
    """Shard the leading (batch) dim of every batch leaf over ``axes``."""
    def one(x):
        nd = x.ndim if hasattr(x, "ndim") else len(getattr(x, "shape", ()))
        return P(tuple(axes), *([None] * (nd - 1))) if nd else P()
    return tree.tree_map(one, batch)


def shard_batch(mesh, batch, axes=("pod", "data")):
    """This rank's block of every batch leaf (``batch_spec``'s)."""
    specs = batch_spec(batch, axes)
    return tree.tree_map(lambda x, s: NamedSharding(mesh, s).shard(x),
                         batch, specs)


def replicate(params):
    return tree.tree_map(lambda _: P(), params)


def sync_grads(mesh, grads, specs, axes=None):
    """Sum each gradient block over the mesh axes its spec leaves out: the
    rule ``shard_map(check_vma=False)`` applies to an input's cotangent, so
    that a replicated parameter gets the gradient of every rank's work. A
    row-sharded table is summed over ``data``, a replicated MLP weight over
    every axis, a 2D-sharded table over none. ``axes`` narrows the sum to
    those of them it names (the batch axes, where every ``model`` rank
    already holds the whole cotangent, Megatron's way)."""
    from repro_torch.distributed.mesh import psum
    out = []
    for g, spec in zip(tree.leaves(grads), tree.flatten_up_to(grads, specs),
                       strict=True):
        left = tuple(a for a in unmentioned(mesh, spec)
                     if axes is None or a in axes)
        out.append(psum(g, mesh, left) if left else g)
    return tree.unflatten(grads, out)
