"""The port's device mesh and its named-axis collectives (the torch side of
``repro.compat``'s ``make_mesh``, ``shard_map`` and ``axis_size``, the last
``Mesh.axis_size``).

The reference writes its distributed code as the body of ``shard_map``: one
program per device, on the device's block of each array, with collectives
over named mesh axes (``psum``, ``psum_scatter``, ``all_gather``). The port
runs the same body once per ``torch.distributed`` rank. ``Mesh`` wraps a
``DeviceMesh`` from ``init_device_mesh`` and gives each axis name, or tuple
of names, its process group, this rank's coordinate and its size.

A tuple of axes is ordered as JAX orders it: the first name is the major
one, so this rank's position along ``("model", "data")`` is ``model_index *
n_data + data_index``. A process group numbers its members by global rank,
which on a ``(data, model)`` mesh is data-major, so a tiled collective over
a tuple whose order differs from the group's permutes its chunks to put
each one where JAX puts it.

The collectives are differentiable, with the transposes ``jax.grad``
takes: ``psum``'s backward is a ``psum``, ``psum_scatter``'s an
``all_gather`` and ``all_gather``'s a ``psum_scatter``. The reference runs
``shard_map`` with ``check_vma=False``, which at its boundary divides an
output's cotangent by the size of the axes its spec leaves out
(``out_boundary``) and sums an input's cotangent over them
(``shardings.sync_grads``); gradients in the port follow the same rules.

The LM's Megatron tensor parallelism (``models.lm``) keeps its
activations replicated over ``model``, each rank's cotangent of them the
whole one, and uses the pair of collectives that layout needs:
``in_boundary`` at a column-parallel input (the identity, its cotangent
summed over the axes: ``sync_grads``' rule inside the graph) and
``reduce_from`` at a row-parallel output (a ``psum`` whose cotangent goes
through unchanged, the transpose ``jax.grad`` takes of a ``psum`` whose
result every rank then uses alike). ``pmax`` is a detached ``pmax`` with
no gradient, the stable shift of a sharded logsumexp.
``gather_blocks``/``own_block`` rejoin and leave that layout along a dim
(an ``all_gather`` whose cotangent is the rank's own block, and its
transpose), and ``respec`` moves a block from one spec to another (an
``all_gather`` where the old spec shards a dim the new one does not, a
plain cut where the new one shards it).

``init`` starts the process group explicitly: NCCL for ``cuda`` (the
default), gloo only when the caller asks for the CPU, and for ``meta`` the
fake backend of ``torch.testing`` (one process standing for rank ``rank``
of any world size, whose collectives move nothing), on which the dry-run
(``launch.dryrun``) runs a plan's shapes. Nothing falls back.

Every collective is reported to the callables in its mesh's
``observers`` as ``(kind, mesh, axes, operand)``, where
``launch.op_stats`` counts the bytes each puts on the wire.
"""

from __future__ import annotations

import collections
import itertools
import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.shardings import (NamedSharding, PartitionSpec,
                                               unmentioned)

BACKENDS = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}


def init(device: str | torch.device = "cuda", *, rank: int | None = None,
         world_size: int | None = None, init_method: str | None = None,
         store: dist.Store | None = None) -> torch.device:
    """Join the default process group: NCCL on ``cuda``, gloo on ``cpu``.

    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE`` of
    the environment (as ``torchrun`` sets them); pass a ``store`` (e.g. a
    ``FileStore``) or an ``init_method`` such as ``tcp://localhost:<port>``,
    else ``env://`` reads ``MASTER_ADDR`` and ``MASTER_PORT``. On ``cuda``
    each rank takes card ``rank % device_count``. On ``meta`` this process
    is rank ``rank`` of a fake group (a ``FakeStore``, no peers). Returns
    the rank's device.
    """
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if dev.type == "meta" and store is None:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if store is None and init_method is None:
        init_method = "env://"
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                            store=store, rank=rank, world_size=world_size,
                            **kwargs)
    return dev


class Mesh:
    """A named device mesh over the ranks of the default process group.

    ``axis_index``, ``axis_size`` and ``group`` take one axis name or a
    tuple of names. ``calls`` counts the collectives this mesh has issued,
    by kind, backwards included; ``observers`` are told of each.
    """

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape,
                              strict=True))
        self.coord = dict(zip(self.axis_names, device_mesh.get_coordinate(),
                              strict=True))
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_mesh.device_type == "cuda"
                       else torch.device("meta")
                       if dist.get_backend() == BACKENDS["meta"]
                       else torch.device("cpu"))
        self.calls: collections.Counter = collections.Counter()
        # callables told of each collective: (kind, mesh, axes, operand)
        self.observers: list = []
        self._ranks = device_mesh.mesh.numpy().copy()    # coordinate -> rank
        self._groups: dict[frozenset, dist.ProcessGroup] = {}
        self._orders: dict[tuple, tuple] = {}

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` as a tuple of this mesh's names (one name or several)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r}; its axes are "
                                 f"{self.axis_names}")
        if len(set(names)) != len(names):
            raise ValueError(f"axis named twice in {names}")
        return names

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's position along ``axes``, the first name major
        (``jax.lax.axis_index`` of a tuple)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coord[a]
        return i

    def _members(self, names: tuple[str, ...], fixed: dict) -> list[int]:
        """Global ranks at the coordinates ``fixed`` off ``names``, in the
        row-major order of ``names``."""
        out = []
        for pos in itertools.product(*(range(self.shape[a]) for a in names)):
            at = {**fixed, **dict(zip(names, pos, strict=True))}
            out.append(int(self._ranks[tuple(at[a] for a in self.axis_names)]))
        return out

    def group(self, axes) -> tuple[dist.ProcessGroup, list[int] | None]:
        """The process group of this rank's neighbours along ``axes``, and
        the group rank of the member at each position along ``axes`` (None
        where the two orders agree).

        Groups over several axes are made on first use; every rank makes
        all of them, in the same order, as ``new_group`` requires, so every
        rank must ask for the same tuples in the same order (SPMD code
        does).
        """
        names = self.axes(axes)
        if names in self._orders:
            return self._orders[names]
        key = frozenset(names)
        if key not in self._groups:
            if len(names) == 1:
                self._groups[key] = self.device_mesh.get_group(names[0])
            else:
                others = [a for a in self.axis_names if a not in key]
                mine = None
                for pos in itertools.product(*(range(self.shape[a])
                                               for a in others)):
                    fixed = dict(zip(others, pos, strict=True))
                    g = dist.new_group(sorted(self._members(names, fixed)))
                    if all(fixed[a] == self.coord[a] for a in others):
                        mine = g
                self._groups[key] = mine
        members = self._members(names, {a: self.coord[a]
                                        for a in self.axis_names})
        by_rank = sorted(members)
        order = [by_rank.index(r) for r in members]
        self._orders[names] = (self._groups[key],
                               None if order == sorted(order) else order)
        return self._orders[names]


def make_mesh(shape, axes, device: str | torch.device = "cuda") -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the default process group
    (``init`` first): ``init_device_mesh(device_type, shape,
    mesh_dim_names=axes)``, ranks laid out row-major (the last axis
    fastest), as ``jax.make_mesh`` lays out devices. A ``meta`` mesh is a
    CPU device mesh over the fake group; its tensors are meta tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call repro_torch.distributed."
                           "mesh.init first")
    if dist.get_backend() != BACKENDS[dev.type]:
        raise ValueError(f"a {dev.type} mesh needs the "
                         f"{BACKENDS[dev.type]} backend; the process group "
                         f"runs {dist.get_backend()}")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {dist.get_world_size()}")
    return Mesh(init_device_mesh("cpu" if dev.type == "meta" else dev.type,
                                 shape, mesh_dim_names=axes))


# -- collectives ------------------------------------------------------------


def _observe(kind: str, mesh: Mesh, axes, x: torch.Tensor) -> None:
    for fn in mesh.observers:
        fn(kind, mesh, axes, x)


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    group, _ = mesh.group(axes)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    mesh.calls["all_reduce"] += 1
    _observe("all_reduce", mesh, axes, x)
    return out


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter over {axes}: leading dim "
                         f"{x.shape[0]} is not divisible by the {n} ranks")
    group, order = mesh.group(axes)
    parts = list(x.chunk(n))
    if order is not None:       # group rank g receives the chunk JAX gives it
        by_group = [None] * n
        for pos, g in enumerate(order):
            by_group[g] = parts[pos]
        parts = by_group
    src = torch.cat(parts).contiguous()
    out = src.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    mesh.calls["reduce_scatter"] += 1
    _observe("reduce_scatter", mesh, axes, x)
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    n = mesh.axis_size(axes)
    group, order = mesh.group(axes)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    mesh.calls["all_gather"] += 1
    _observe("all_gather", mesh, axes, x)
    if order is not None:
        parts = out.chunk(n)
        out = torch.cat([parts[g] for g in order])
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce_scatter(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_gather(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the ranks along ``axes``, on
    each of them; integer tensors keep their dtype."""
    return _Psum.apply(x, mesh, axes)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=0, tiled=True)``:
    the sum over ``axes``, of which the rank at position ``i`` along
    ``axes`` keeps rows ``[i * n, (i + 1) * n)``. The leading dim must
    divide by the ranks, or it raises."""
    return _PsumScatter.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0
               ) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=dim, tiled=True)``: every rank's
    ``x`` along ``axes``, concatenated along ``dim`` in position order."""
    if dim == 0:
        return _AllGather.apply(x, mesh, axes)
    return _AllGather.apply(x.movedim(dim, 0), mesh, axes).movedim(0, dim)


class _OutBoundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def out_boundary(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """``x`` unchanged, its cotangent divided by the size of the mesh axes
    ``spec`` leaves out: the rule ``shard_map(check_vma=False)`` applies to
    an output that is replicated over those axes, so that summing a
    replicated output's blocks over every rank counts it once."""
    n = mesh.axis_size(unmentioned(mesh, spec))
    return _OutBoundary.apply(x, n) if n > 1 else x


class _InBoundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


def in_boundary(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``x`` unchanged, its cotangent summed over ``axes``: the rule the
    reference's ``shard_map(check_vma=False)`` (``repro/compat.py:43-53``)
    applies to an input that is replicated over ``axes``
    (``shardings.sync_grads``), taken inside the graph, so
    that each rank's share of the region's work reaches the tensor the
    rank holds outside it. No-op where ``axes`` hold one rank."""
    axes = mesh.axes(axes)
    return _InBoundary.apply(x, mesh, axes) if mesh.axis_size(axes) > 1 \
        else x


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_from(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes`` (a row-parallel product's partial
    sums), its cotangent passed through unchanged: every rank uses the sum
    alike and holds its whole cotangent (Megatron's ``g``; ``in_boundary``
    is its ``f``)."""
    return _ReduceFrom.apply(x, mesh, mesh.axes(axes))


def pmax(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``jax.lax.pmax`` of ``x`` detached, with no gradient: the shift that
    keeps a logsumexp over blocks stable, which changes no value."""
    group, _ = mesh.group(axes)
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    mesh.calls["all_reduce"] += 1
    _observe("all_reduce", mesh, axes, x)
    return out


def _chunk(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    n, i = mesh.axis_size(axes), mesh.axis_index(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into the {n} ranks of {axes}")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(x.movedim(dim, 0), mesh, axes).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return (_chunk(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None,
                None, None)


class _OwnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _chunk(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g.movedim(ctx.dim, 0), ctx.mesh, ctx.axes)
                .movedim(0, ctx.dim), None, None, None)


def gather_blocks(x: torch.Tensor, mesh: Mesh, axes, dim: int
                  ) -> torch.Tensor:
    """Every rank's block ``x`` along ``axes``, joined along ``dim`` in
    position order (``all_gather(tiled=True)``), into a tensor that every
    rank along ``axes`` then uses alike: its cotangent, the same on each of
    them, is cut back to the rank's own block, where ``all_gather``'s
    transpose (``psum_scatter``) would add the ``n`` copies. The
    reference's counterpart is the assembly of a ``shard_map`` output
    sharded along ``dim`` (``repro/models/lm.py:182-183``'s out_spec)."""
    return _GatherBlocks.apply(x, mesh, mesh.axes(axes), dim)


def own_block(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` (the same on every rank along ``axes``)
    along ``dim``, by its position along ``axes``: ``gather_blocks``'
    transpose, whose cotangent is every rank's block joined (the cut of a
    ``shard_map`` input sharded along ``dim``, ``repro/models/lm.py:
    171``'s qspec, or ``repro/models/lm.py:281-285``'s sharding
    constraint)."""
    return _OwnBlock.apply(x, mesh, mesh.axes(axes), dim)


def shard_map(f, *, mesh: Mesh, in_specs, out_specs: PartitionSpec):
    """``shard_map`` for global tensors: the returned function cuts each
    argument to this rank's block of its spec, calls ``f`` on the blocks
    and returns ``f``'s rank-local output through ``out_boundary``.

    Callers that hold only blocks (tables too large for one card) call the
    sharded functions on them directly."""

    def fn(*args):
        blocks = [NamedSharding(mesh, s).shard(a)
                  for a, s in zip(args, in_specs, strict=True)]
        return out_boundary(f(*blocks), mesh, out_specs)

    return fn


def respec(x: torch.Tensor, mesh: Mesh, have, want) -> torch.Tensor:
    """The block under spec ``want`` of the array whose block under
    ``have`` is ``x``, dim by dim: an entry of ``have`` that ``want`` lacks
    is gathered (``all_gather``: its cotangent summed over those axes, each
    rank's block of it kept), an entry of ``want`` that ``have`` lacks is
    cut (a slice: its cotangent is zero off the rank's block), the gathers
    first; a dim the two shard over other axes is gathered, then cut."""
    pairs = [(have[i] if i < len(have) else None,
              want[i] if i < len(want) else None) for i in range(x.ndim)]
    for i, (h, w) in enumerate(pairs):
        if h != w and h is not None:
            x = all_gather(x, mesh, h, dim=i)
    for i, (h, w) in enumerate(pairs):
        if h != w and w is not None:
            x = _chunk(x, mesh, w, i)
    return x
