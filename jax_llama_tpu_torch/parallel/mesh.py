"""Device mesh and activation-shape checks (port of
``jax_llama_tpu/parallel/mesh.py``).

The JAX package's mesh is one array of devices under a single controller;
GSPMD turns ``constrain`` calls into collectives.  PyTorch has no GSPMD,
so here a mesh is this PROCESS's view of a group of ranks, one rank per
device, laid out over the same five axes:

    data    data parallel (rows)
    stage   pipeline parallel: each stage holds L / stage layers
            (``pipeline``)
    fsdp    ZeRO-3 parameter sharding in training (a second row axis)
    seq     sequence parallel: ring attention (``ring``)
    tensor  Megatron-style tensor parallel, innermost

Rank r sits at ``np.arange(n).reshape(data, stage, fsdp, seq, tensor)``,
so ``tensor`` is innermost as in the JAX layout.  Each axis of size > 1
owns one ``torch.distributed`` process group (the ranks that differ only
along it), the row axes ``data`` x ``fsdp`` share one more, and a gloo
group over every rank carries host objects and host decisions.  The
collectives the port uses are methods here: ``all_reduce``,
``all_gather``, ``reduce_scatter`` and ``ppermute`` (JAX's
``lax.ppermute`` over a ring) of tensors, ``broadcast_object`` of host
objects, ``gather_object`` of every rank's host object and ``agree``
on a host decision; each call is counted in ``collectives`` by kind and
axis.  ``make_mesh(slices=k)`` lays ``k`` such meshes over consecutive
blocks of the world's ranks (sliced replicas, ``parallel.slices``): a
rank's ``rank`` and ``coords`` are its place in its own slice, and
``offset`` (its slice's first global rank) turns them into the global
ranks torch's collectives name.  ``make_mesh(timeout_s=,
control_timeout_s=)`` bounds how long a
collective of the axis groups, and of the CPU group, waits for a rank
that never joins it: past the bound it raises on the ranks that did
(``parallel.lockstep`` relies on this to stop every rank of a server
whose ranks diverged instead of hanging).

Routes.  gloo takes CUDA tensors only for ``all_reduce``, ``all_gather``
and ``broadcast``: it has no send/recv and no reduce-scatter for them.
So the route of ``ppermute`` and ``reduce_scatter`` is fixed by the
backend and the device when the mesh is built (``Mesh.routes``), never
when a call fails, and is part of the kind they are counted under
(``"ppermute:p2p"``):

    backend, device   ppermute            reduce_scatter
    nccl, cuda        p2p                 reduce_scatter
    gloo, cpu         p2p                 reduce_scatter
    gloo, cuda        all_gather_take     all_reduce_slice

``p2p`` is ``dist.batch_isend_irecv``; ``all_gather_take`` all-gathers
the tensor along the axis and keeps the shard of the rank ``shift``
behind; ``all_reduce_slice`` sums the whole tensor and keeps this
rank's slice.  Both written-out routes give the exact result of the
collective they stand for.

Autograd.  The collectives above are invisible to autograd; training
goes through ``reduce_g`` (an all-reduce whose backward is the
identity: Megatron's *g*, after a row-parallel product), ``copy_f``
(the identity whose backward all-reduces: *f*, in front of a
column-parallel product), ``gather_slice`` (an all-gather whose backward
keeps this rank's slice), ``gather_scatter`` (an all-gather whose
backward reduce-scatters: a ZeRO-3 weight gather) and ``ppermute``
(whose backward sends the gradient the other way round the ring).  Each
takes the plain collective when autograd is off.  Every rank issues the
backward's collectives in the order its graph gives, the same on every
rank.

``constrain`` translates logical names as the JAX one does, but nothing
is resharded implicitly: it checks that a local tensor has the shape the
logical spec implies for the given global shape, and returns it.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import distributed

AXES = ("data", "stage", "fsdp", "seq", "tensor")

# Logical-name -> mesh-axis translation (JAX :37): the batch dimension
# splits over both row axes.
LOGICAL_RULES = {
    "data": ("data", "fsdp"),
    "fsdp": "fsdp",
    "seq": "seq",
    "tensor": "tensor",
    None: None,
}

# The row axes as one group name: rows split over data x fsdp.
ROWS = ("data", "fsdp")

_local = threading.local()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _axes(axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """One rank's view of a ``data x stage x fsdp x seq x tensor`` mesh.

    ``shape`` maps every axis in ``AXES`` to its size, ``devices[i]`` is
    rank i's torch device and ``device`` this rank's, ``coords`` this
    rank's index along each axis.  ``rank`` counts from the mesh's first
    rank, global rank ``offset`` (0 unless the mesh is slice ``slice`` of
    ``make_mesh(slices=)``).  Built by ``make_mesh``."""

    axis_names = AXES

    def __init__(self, shape: Dict[str, int], devices: Sequence[torch.device],
                 rank: int, groups: Dict[Tuple[str, ...], Any],
                 cpu_group: Any, backend: Optional[str] = None,
                 timeout_s: Optional[float] = None,
                 control_timeout_s: Optional[float] = None,
                 offset: int = 0, slice_index: int = 0, slices: int = 1):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.devices = [torch.device(d) for d in devices]
        self.rank = int(rank)
        self.offset = int(offset)
        self.slice = int(slice_index)
        self.slices = int(slices)
        self.device = self.devices[self.rank]
        grid = np.arange(len(self.devices)).reshape(
            [self.shape[a] for a in AXES])
        where = np.argwhere(grid == self.rank)[0]
        self.coords = {a: int(i) for a, i in zip(AXES, where)}
        self._groups = groups
        self.cpu_group = cpu_group
        self.collectives: collections.Counter = collections.Counter()
        self.backend = backend
        self.routes = collective_routes(backend, self.device)
        # The bounds ``make_mesh`` gave the groups (None: torch's
        # default of the backend).
        self.timeout_s = timeout_s
        self.control_timeout_s = control_timeout_s

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def global_rank(self) -> int:
        return self.offset + self.rank

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axis)] or [1]))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (a name or a tuple of names,
        the later name fastest)."""
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis):
        key = tuple(a for a in _axes(axis) if self.shape[a] > 1)
        return self._groups.get(key)

    def __repr__(self) -> str:
        dims = "x".join(str(self.shape[a]) for a in AXES)
        where = (f", slice={self.slice}/{self.slices}" if self.slices > 1
                 else "")
        return f"Mesh({dims}, rank={self.rank}{where}, device={self.device})"

    # -- collectives over one axis (identity where the axis is 1) ----------

    def all_reduce(self, x: torch.Tensor, axis="tensor",
                   op: str = "sum") -> torch.Tensor:
        """Sum (``op="max"``: the maximum of) ``x`` over ``axis`` in
        place; returns it."""
        g = self.group(axis)
        if g is None:
            return x
        kind = "all_reduce" if op == "sum" else f"all_reduce_{op}"
        self.collectives[(kind, _axes(axis))] += 1
        dist.all_reduce(x, op=_OPS[op], group=g)
        return x

    def all_gather(self, x: torch.Tensor, axis="tensor",
                   dim: int = 0) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim``, in the axis'
        rank order."""
        g = self.group(axis)
        if g is None:
            return x
        self.collectives[("all_gather", _axes(axis))] += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, x, group=g)
        return torch.cat(parts, dim=dim)

    def axis_ranks(self, axis) -> List[int]:
        """The global ranks of this rank's group along ``axis``, in the
        axis' rank order."""
        axes = _axes(axis)
        grid = np.arange(self.size).reshape([self.shape[a] for a in AXES])
        index = tuple(slice(None) if a in axes else self.coords[a]
                      for a in AXES)
        return (grid[index].reshape(-1) + self.offset).tolist()

    def reduce_scatter(self, x: torch.Tensor, axis="fsdp",
                       dim: int = 0) -> torch.Tensor:
        """Sum ``x`` over ``axis`` and keep this rank's slice along
        ``dim`` (the axis' size must divide it)."""
        g = self.group(axis)
        if g is None:
            return x
        n, i = self.axis_size(axis), self.axis_index(axis)
        route = self.routes["reduce_scatter"]
        self.collectives[("reduce_scatter:" + route, _axes(axis))] += 1
        if x.shape[dim] % n:
            raise ValueError(
                f"reduce_scatter: {_axes(axis)} of size {n} does not divide "
                f"dimension {dim} of a {tuple(x.shape)} tensor")
        if route == "all_reduce_slice":
            full = x.contiguous().clone()
            dist.all_reduce(full, group=g)
            return full.narrow(dim, i * (x.shape[dim] // n),
                               x.shape[dim] // n).contiguous()
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, src, group=g)
        return out.movedim(0, dim).contiguous()

    def _ppermute(self, x: torch.Tensor, axis="seq",
                  shift: int = 1) -> torch.Tensor:
        """``ppermute`` without autograd."""
        g = self.group(axis)
        if g is None:
            return x
        n, i = self.axis_size(axis), self.axis_index(axis)
        route = self.routes["ppermute"]
        self.collectives[("ppermute:" + route, _axes(axis))] += 1
        x = x.contiguous()
        if route == "all_gather_take":
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=g)
            return parts[(i - shift) % n]
        ranks = self.axis_ranks(axis)
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], g),
               dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], g)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    # -- the differentiable forms (training) --------------------------------

    def reduce_g(self, x: torch.Tensor, axis="tensor") -> torch.Tensor:
        """The sum of ``x`` over ``axis``; its backward is the identity
        (Megatron's *g*).  Without autograd: ``all_reduce`` in place."""
        if self.group(axis) is None:
            return x
        if not _tracked(x):
            return self.all_reduce(x, axis)
        return _ReduceG.apply(x, self, axis)

    def copy_f(self, x: torch.Tensor, axis="tensor") -> torch.Tensor:
        """``x``; its backward all-reduces the gradient over ``axis``
        (Megatron's *f*)."""
        if self.group(axis) is None or not _tracked(x):
            return x
        return _CopyF.apply(x, self, axis)

    def gather_slice(self, x: torch.Tensor, axis="tensor",
                     dim: int = 0) -> torch.Tensor:
        """``all_gather`` along ``dim``; the backward keeps this rank's
        slice of the gradient (every rank of the axis computes the same
        function of the gathered tensor)."""
        if self.group(axis) is None:
            return x
        if not _tracked(x):
            return self.all_gather(x, axis, dim)
        return _GatherSlice.apply(x, self, axis, dim)

    def gather_scatter(self, x: torch.Tensor, axis="fsdp",
                       dim: int = 0) -> torch.Tensor:
        """``all_gather`` along ``dim``; the backward reduce-scatters the
        gradient (the ranks of the axis use the gathered tensor on
        different rows: ZeRO-3)."""
        if self.group(axis) is None:
            return x
        if not _tracked(x):
            return self.all_gather(x, axis, dim)
        return _GatherScatter.apply(x, self, axis, dim)

    def ppermute(self, x: torch.Tensor, axis="seq",
                 shift: int = 1) -> torch.Tensor:
        """JAX's ``lax.ppermute`` over the ring of ``axis``: rank j's
        ``x`` arrives at rank (j + shift) mod n; returns what arrived
        here.  Differentiable: the backward sends the gradient ``-shift``
        round the ring."""
        if self.group(axis) is None:
            return x
        if not _tracked(x):
            return self._ppermute(x, axis, shift)
        return _PPermute.apply(x, self, axis, shift)

    # -- host objects and host decisions (the gloo CPU group) --------------

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if self.size == 1:
            return obj
        self.collectives[("broadcast_object", AXES)] += 1
        box = [obj]
        dist.broadcast_object_list(box, src=self.offset + src,
                                   group=self.cpu_group)
        return box[0]

    def gather_object(self, obj: Any, dst: Optional[int] = None
                      ) -> Optional[List[Any]]:
        """Every rank's picklable ``obj``, in rank order, on every rank;
        with ``dst``, on rank ``dst`` only (None elsewhere)."""
        if self.size == 1:
            return [obj]
        if dst is None:
            self.collectives[("gather_object", AXES)] += 1
            out: List[Any] = [None] * self.size
            dist.all_gather_object(out, obj, group=self.cpu_group)
            return out
        self.collectives[("gather_object_to", AXES)] += 1
        out = [None] * self.size if self.rank == dst else None
        dist.gather_object(obj, out, dst=self.offset + dst,
                           group=self.cpu_group)
        return out

    def agree(self, flag: bool) -> bool:
        """True on every rank iff ``flag`` is true on every rank: a host
        decision that reads a clock or a CUDA event is agreed through
        this before it changes state that must stay identical."""
        if self.size == 1:
            return bool(flag)
        self.collectives[("agree", AXES)] += 1
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.cpu_group)
        return bool(t.item())

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.cpu_group)


def collective_routes(backend: Optional[str],
                      device: torch.device) -> Dict[str, str]:
    """The route of each collective gloo cannot run as such (module
    docstring), from the backend and this rank's device."""
    if backend == "gloo" and torch.device(device).type == "cuda":
        return {"ppermute": "all_gather_take",
                "reduce_scatter": "all_reduce_slice"}
    return {"ppermute": "p2p", "reduce_scatter": "reduce_scatter"}


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _ReduceG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None,
                None, None)


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None,
                None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return mesh._ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._ppermute(g, ctx.axis, -ctx.shift), None, None,
                None)


def _rank_sets(shape: Dict[str, int], axes: Tuple[str, ...]):
    """Every set of ranks that differ only along ``axes``, in a fixed
    order (all ranks must create the same groups in the same order)."""
    grid = np.arange(int(np.prod([shape[a] for a in AXES]))).reshape(
        [shape[a] for a in AXES])
    moving = [AXES.index(a) for a in axes]
    fixed = [i for i in range(len(AXES)) if i not in moving]
    perm = grid.transpose(fixed + moving).reshape(
        -1, int(np.prod([shape[a] for a in axes])))
    return [row.tolist() for row in perm]


def make_mesh(
    data: int = 1,
    stage: int = 1,
    fsdp: int = 1,
    seq: int = 1,
    tensor: int = 1,
    devices: Optional[Sequence[Any]] = None,
    timeout_s: Optional[float] = None,
    control_timeout_s: Optional[float] = None,
    slices: int = 1,
) -> Mesh:
    """Build this rank's view of a 5-axis mesh (JAX :78).  The axis
    product times ``slices`` must equal the number of processes in the
    default group (``distributed.initialize``; 1 without one): with
    ``slices`` > 1 every rank builds the groups of ``slices`` meshes of
    that shape, slice s over global ranks ``[s * n, (s + 1) * n)``, and
    gets its own slice's.  ``devices`` maps global rank i
    to a torch device: by default rank i runs on ``cuda:(i % n_gpus)``,
    and two ranks may share one device (``["cuda:0", "cuda:0"]``), which
    needs the gloo backend; this rank's device becomes its current CUDA
    device.  The CPU is used only when ``devices`` names it.  The routes
    of ``ppermute`` and ``reduce_scatter`` follow from the default
    group's backend and this rank's device (``collective_routes``).
    ``timeout_s`` bounds each collective of the axis groups and
    ``control_timeout_s`` each one of the CPU group (None: the backend's
    default); a rank that waits past it raises."""
    shape = dict(zip(AXES, (data, stage, fsdp, seq, tensor)))
    want = data * stage * fsdp * seq * tensor
    world = distributed.process_count()
    sliced = f" x {slices} slices" if slices > 1 else ""
    if want * slices != world:
        raise ValueError(
            f"mesh {data}x{stage}x{fsdp}x{seq}x{tensor}={want}{sliced} "
            f"!= {world} processes")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. ['cpu'] * n) to build a mesh on the CPU")
        n_gpu = torch.cuda.device_count()
        devices = [f"cuda:{i % n_gpu}" for i in range(world)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(
            f"mesh {data}x{stage}x{fsdp}x{seq}x{tensor}={want}{sliced} "
            f"!= {len(devices)} devices")
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"make_mesh: device {d} asked for, but no CUDA device is "
                "available")
    groups: Dict[Tuple[str, ...], Any] = {}
    cpu_group = None
    me = dist.get_rank() if world > 1 else 0
    offset = me - me % want
    if want > 1:
        if not dist.is_initialized():
            raise RuntimeError(
                "make_mesh: a mesh of more than one rank needs the process "
                "group; call parallel.distributed.initialize() first")
        live = [a for a in AXES if shape[a] > 1]
        # One group per axis, plus the row axes together, for every
        # slice; the same calls in the same order on every rank, the
        # groups of other slices included.
        keys = [(a,) for a in live]
        if shape["data"] > 1 and shape["fsdp"] > 1:
            keys.append(("data", "fsdp"))
        for first in range(0, world, want):
            for key in keys:
                for ranks in _rank_sets(shape, key):
                    ranks = [first + r for r in ranks]
                    g = dist.new_group(ranks, timeout=_delta(timeout_s))
                    if me in ranks:
                        groups[key] = g
            g = dist.new_group(list(range(first, first + want)),
                               backend="gloo",
                               timeout=_delta(control_timeout_s))
            if first == offset:
                cpu_group = g
    devices = devices[offset:offset + want]
    rank = me - offset
    if devices[rank].type == "cuda":
        # The rank's device is its current one: NCCL binds a group's
        # communicator to it.
        torch.cuda.set_device(devices[rank])
    backend = dist.get_backend() if world > 1 else None
    return Mesh(shape, devices, rank, groups, cpu_group, backend,
                timeout_s=timeout_s, control_timeout_s=control_timeout_s,
                offset=offset, slice_index=offset // want, slices=slices)


def _delta(seconds: Optional[float]) -> Optional[datetime.timedelta]:
    return None if seconds is None else datetime.timedelta(seconds=seconds)


def auto_mesh(tensor: Optional[int] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Every process on the tensor axis unless told otherwise (JAX
    :104); the rest go to ``data``."""
    n = distributed.process_count()
    tensor = tensor or n
    return make_mesh(data=n // tensor, tensor=tensor, devices=devices)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Activate a mesh for ``forward``, ``constrain`` and the kernels'
    mesh clauses in this thread."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def current_mesh() -> Optional[Mesh]:
    return getattr(_local, "mesh", None)


def logical_to_spec(*logical) -> Tuple:
    """Translate logical axis names to a spec: a tuple with one entry
    per dimension, each None, an axis name or a tuple of axis names."""
    return tuple(LOGICAL_RULES.get(name, name) for name in logical)


def local_size(mesh: Optional[Mesh], full: int, axis) -> int:
    """The local extent of a dimension of global size ``full`` sharded
    over ``axis``; a dimension the axis does not divide replicates (the
    serving mesh's rule for rows, JAX ``serve_mesh.constraints_apply``)."""
    n = mesh.axis_size(axis) if mesh is not None else 1
    return full // n if full % n == 0 else full


def constrain(x: torch.Tensor, *logical, full: Optional[Sequence] = None
              ) -> torch.Tensor:
    """The JAX ``constrain`` (:132) as a check: with an active mesh and
    ``full`` (the global shape; None entries are not checked), raise
    unless each dimension of ``x`` has the local extent that its logical
    axis implies; return ``x`` unchanged.  No mesh: returns ``x``."""
    mesh = current_mesh()
    if mesh is None or x is None or full is None:
        return x
    spec = logical_to_spec(*logical)
    spec = spec + (None,) * (x.dim() - len(spec))
    for d, (n, axis) in enumerate(zip(full, spec)):
        if n is None:
            continue
        want = local_size(mesh, int(n), axis)
        if x.shape[d] != want:
            raise ValueError(
                f"constrain: dimension {d} of a {tuple(x.shape)} tensor is "
                f"{x.shape[d]}, but a global {int(n)} over {axis!r} on "
                f"{mesh!r} is {want} locally")
    return x


__all__ = [
    "AXES", "LOGICAL_RULES", "ROWS", "Mesh", "make_mesh", "auto_mesh",
    "collective_routes",
    "use_mesh", "current_mesh", "logical_to_spec", "local_size",
    "constrain",
]
