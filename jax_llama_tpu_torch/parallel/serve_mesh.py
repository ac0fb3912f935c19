"""Mesh placement for the serving stack (port of
``jax_llama_tpu/parallel/serve_mesh.py``).

A serving mesh is ``data x tensor`` (``seq``/``stage`` stay 1; ``fsdp``
may ride along as a second row axis).  ``run.py --serve-mesh dp,tp``
parses here.  Every rank runs the same batcher over the same host state
(block tables, free list, radix index, host tier); what differs per rank
is the device state it holds:

* the KV block pool and the draft pool keep this rank's KV-head slice,
  ``[L, KVH/tp, NB, BLK, hd]`` (``pool_pspec``: the head axis over
  ``tensor``); the ``pos`` plane replicates, as do the pools over
  ``data``, exactly as the JAX placement has them;
* the per-slot decode state (``d_*`` twins) replicates on every rank.
  The JAX placement shards these rows over ``data``; here the forward
  splits rows over ``data`` itself (``models.llama``) and all-gathers its
  outputs, so the host state and the state rows stay identical on every
  rank without a gather of their own.

The in-program ``constrain_*`` functions are shape checks: nothing is
resharded implicitly.  A swap-in stages each rank's own head slice
(``staging_shardings``), and the radix index stays host-global: block ids
are global and every shard holds the same block geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, constrain, current_mesh, make_mesh
from .partition import shard_index

# Per-slot state rows split over the batch axes (JAX :62).
ROW_AXES = ("data", "fsdp")


@dataclasses.dataclass(frozen=True)
class ServeMeshSpec:
    """Serving-mesh geometry: ``data``-way row sharding inside one batcher
    x ``tensor``-way model/KV sharding (JAX :67)."""

    data: int = 1
    tensor: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.tensor

    def __post_init__(self):
        if self.data < 1 or self.tensor < 1:
            raise ValueError(
                f"serve mesh axes must be >= 1 (got data={self.data}, "
                f"tensor={self.tensor})"
            )


def parse_serve_mesh(text: str) -> ServeMeshSpec:
    """Parse ``--serve-mesh dp,tp`` (a bare ``tp`` is ``1,tp``)."""
    parts = [p.strip() for p in str(text).split(",") if p.strip()]
    try:
        nums = [int(p) for p in parts]
    except ValueError:
        nums = []
    if len(nums) == 1:
        return ServeMeshSpec(data=1, tensor=nums[0])
    if len(nums) == 2:
        return ServeMeshSpec(data=nums[0], tensor=nums[1])
    raise ValueError(
        f"bad --serve-mesh {text!r}: expected 'dp,tp' (two positive "
        "ints, e.g. '2,4') or a bare 'tp'"
    )


def build_serve_mesh(spec: ServeMeshSpec,
                     devices: Optional[Sequence[Any]] = None,
                     timeout_s: Optional[float] = None,
                     control_timeout_s: Optional[float] = None,
                     slices: int = 1) -> Mesh:
    """The serving mesh over ``spec.n_devices`` ranks (the process
    group's; ``devices`` maps rank i to its device, and the two timeouts
    bound its groups' collectives, as in ``make_mesh``); with ``slices``
    > 1, this rank's slice of ``slices`` such meshes over consecutive
    ranks (sliced replicas, ``parallel.slices``), ``devices`` then
    naming every rank's."""
    if devices is not None and len(devices) != spec.n_devices * slices:
        raise ValueError(
            f"serve mesh {spec.data}x{spec.tensor} needs "
            f"{spec.n_devices * slices} devices, got {len(devices)}"
        )
    return make_mesh(data=spec.data, tensor=spec.tensor, devices=devices,
                     timeout_s=timeout_s,
                     control_timeout_s=control_timeout_s, slices=slices)


def is_serving_mesh(mesh: Optional[Mesh]) -> bool:
    """A mesh the serving placement covers: no seq/stage axes."""
    return (
        mesh is not None
        and mesh.shape.get("seq", 1) == 1
        and mesh.shape.get("stage", 1) == 1
    )


def row_shards(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape.get(a, 1) for a in ROW_AXES]))


def fits(mesh: Optional[Mesh], kv_heads: int, n_rows: int) -> bool:
    """The one mesh envelope of the sharded kernels and of the row split
    (JAX ``constraints_apply``, the kernels' mesh clauses): no mesh, or a
    serving mesh whose ``tensor`` divides ``kv_heads`` and whose row axes
    divide ``n_rows``."""
    if mesh is None:
        return True
    return (is_serving_mesh(mesh)
            and kv_heads % mesh.shape.get("tensor", 1) == 0
            and n_rows % row_shards(mesh) == 0)


def placement_ok(config, mesh: Optional[Mesh], n_slots: int,
                 draft_config=None) -> bool:
    """Whether the canonical placement applies (JAX :142): a serving mesh
    whose tensor axis divides the KV and query heads and whose row axes
    divide ``n_slots``."""
    if mesh is None or not fits(mesh, config.kv_heads, n_slots):
        return False
    tp = mesh.shape.get("tensor", 1)
    if config.n_heads % tp:
        return False
    return draft_config is None or draft_config.kv_heads % tp == 0


def validate_serve_mesh(config, mesh: Mesh, n_slots: int,
                        draft_config=None) -> None:
    """The hard-error form of :func:`placement_ok` (JAX :163, the same
    messages)."""
    if not is_serving_mesh(mesh):
        raise ValueError(
            "serving mesh must not carry seq/stage axes "
            f"(got {dict(mesh.shape)})"
        )
    tp = mesh.shape.get("tensor", 1)
    if config.kv_heads % tp:
        raise ValueError(
            f"serve-mesh tensor={tp} must divide n_kv_heads="
            f"{config.kv_heads} (the KV pool shards head-wise)"
        )
    if config.n_heads % tp:
        raise ValueError(
            f"serve-mesh tensor={tp} must divide n_heads={config.n_heads}"
        )
    if draft_config is not None and draft_config.kv_heads % tp:
        raise ValueError(
            f"serve-mesh tensor={tp} must divide the draft model's "
            f"n_kv_heads={draft_config.kv_heads}"
        )
    rows = row_shards(mesh)
    if n_slots % rows:
        raise ValueError(
            f"serve-mesh row shards (data*fsdp={rows}) must divide "
            f"n_slots={n_slots}"
        )


def mesh_shape(mesh: Optional[Mesh]) -> Dict[str, int]:
    """The mesh's axis sizes as ``/metrics`` and ``/healthz`` report them
    (JAX :198)."""
    if mesh is None:
        return {"data": 1, "tensor": 1, "devices": 1}
    return {
        "data": int(mesh.shape.get("data", 1))
        * int(mesh.shape.get("fsdp", 1)),
        "tensor": int(mesh.shape.get("tensor", 1)),
        "devices": int(np.prod(list(mesh.shape.values()))),
    }


# ---------------------------------------------------------------------------
# Canonical partition specs
# ---------------------------------------------------------------------------

def pool_pspec(name: str, ndim: int) -> Tuple:
    """Spec of one BlockPool leaf (or its staged twin): k/v ``[L, KVH, NB,
    BLK, hd]`` and scales ``[L, KVH, NB, BLK]`` shard the head axis over
    ``tensor``; ``pos`` ``[NB, BLK]`` replicates."""
    if name.endswith("pos"):
        return ()
    return (None, "tensor") + (None,) * (ndim - 2)


def row_pspec(ndim: int) -> Tuple:
    """Spec of one per-slot state leaf ``[B, ...]`` in the JAX placement
    (rows over the batch axes).  The port's batcher keeps these rows
    replicated (the module docstring says why); the spec documents the
    split the forward applies."""
    return (ROW_AXES,) + (None,) * (ndim - 1)


_POOL_LEAVES = ("k", "v", "pos", "k_scale", "v_scale")


def shard_pool(pool, mesh: Mesh):
    """This rank's slice of a full BlockPool: the local KV-head slice of
    every leaf, ``pos`` replicated, on the mesh device.  A batcher on a
    mesh allocates its local pool directly (``serving.init_pool(mesh=)``);
    this is for a pool that exists whole (tests, a handoff)."""
    def take(name):
        arr = getattr(pool, name)
        if arr is None:
            return None
        idx = shard_index(mesh, pool_pspec(name, arr.dim()), arr.shape)
        return arr[idx].to(mesh.device).contiguous()

    return dataclasses.replace(pool, **{n: take(n) for n in _POOL_LEAVES})


def _head_axis(name: str) -> bool:
    """Whether a slab field carries the KV-head axis (dim 1 of k/v
    ``[L, KVH, BLK, hd]`` and scales ``[L, KVH, BLK]``, the draft's
    ``d_`` twins too); ``pos`` ``[BLK]`` does not."""
    return not name.endswith("pos")


def gather_slab_heads(mesh: Mesh, slabs) -> Optional[list]:
    """Every rank's export slabs (its KV-head slice of each block), put
    together on the mesh's first rank as slabs of every head, in the
    tensor axis' order (the ranks at data 0 hold one slice each; the
    pools replicate over ``data``); None on the other ranks.  A
    collective of the mesh's CPU group."""
    parts = mesh.gather_object(list(slabs), dst=0)
    if parts is None:
        return None
    tp = mesh.shape.get("tensor", 1)
    return [{name: torch.cat([parts[t][j][name] for t in range(tp)], dim=1)
             if _head_axis(name) else v for name, v in slab.items()}
            for j, slab in enumerate(parts[0])]


def slab_head_slice(mesh: Optional[Mesh], slabs) -> list:
    """This rank's KV-head slice of slabs of every head (the inverse of
    :func:`gather_slab_heads`): what the rank's ``import_prefix`` lands."""
    tp = 1 if mesh is None else mesh.shape.get("tensor", 1)
    if tp == 1:
        return list(slabs)
    t = mesh.coords["tensor"]

    def part(v):
        n = v.shape[1] // tp
        return v.narrow(1, t * n, n).contiguous()

    return [{name: part(v) if _head_axis(name) else v
             for name, v in slab.items()} for slab in slabs]


def place_rows(mesh: Optional[Mesh], x, device=None) -> torch.Tensor:
    """Upload one per-slot array: on the mesh device, every row (the
    port's rows replicate, see the module docstring); on ``device`` (or
    as it is) without a mesh."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if mesh is not None:
        device = mesh.device
    return t.to(device) if device is not None else t


class StagingSharding(NamedTuple):
    """Where one staged swap-in plane lives: the rank's device, and the
    spec of the pool leaf it lands in (its head axis over ``tensor``)."""

    device: torch.device
    spec: Tuple


def staging_shardings(mesh: Optional[Mesh], slab_names: Sequence[str]
                      ) -> Optional[Dict[str, StagingSharding]]:
    """Placements for ``kvcache.stage_restore``'s staging planes (JAX
    :250): each staged field takes its pool leaf's spec, so each rank
    stages and adopts ITS head slice of the slab, and ``ids``
    replicates.  None without a mesh (default placement)."""
    if mesh is None:
        return None
    out: Dict[str, StagingSharding] = {
        "ids": StagingSharding(mesh.device, ())}
    for name in slab_names:
        # Staged k/v: [L, KVH, nb, BLK(, hd)]; staged pos: [nb, BLK].
        ndim = 2 if name.endswith("pos") else (
            4 if name.endswith("_scale") else 5)
        out[name] = StagingSharding(mesh.device, pool_pspec(name, ndim))
    return out


# ---------------------------------------------------------------------------
# In-program shape checks (no-op without a mesh)
# ---------------------------------------------------------------------------

def constraints_apply(kv_heads: int, n_rows: int) -> bool:
    """Whether the ACTIVE mesh is a serving mesh the canonical placement
    covers (JAX :282): tensor divides the KV heads, the row axes divide
    the row count.  The forward splits rows over ``data`` only then, and
    runs them replicated otherwise."""
    mesh = current_mesh()
    return mesh is not None and fits(mesh, kv_heads, n_rows)


def _check_heads(leaves, axis: int, kv_heads: int) -> None:
    names, full = [None] * (axis + 1), [None] * (axis + 1)
    names[axis], full[axis] = "tensor", kv_heads
    for x in leaves:
        constrain(x, *names, full=full)


def constrain_view(view, kv_heads: int):
    """Check a gathered per-row cache view (k/v ``[L, B, W, KVH, hd]``,
    scales ``[L, B, W, KVH]``) holds this rank's head slice (JAX :295).
    Returns the view."""
    _check_heads((view.k, view.v, view.k_scale, view.v_scale), 3, kv_heads)
    return view


def constrain_pool(pool, kv_heads: int):
    """Check a pool's k/v and scale planes hold this rank's head slice
    (JAX :338).  Returns the pool."""
    _check_heads((pool.k, pool.v, pool.k_scale, pool.v_scale), 1, kv_heads)
    return pool


def constrain_rows(*arrays, n_rows: Optional[int] = None) -> Tuple:
    """Check per-slot state leaves hold every row (``n_rows``; the port's
    rows replicate).  Returns them."""
    if current_mesh() is not None and n_rows is not None:
        for a in arrays:
            if a is not None and a.shape[0] != n_rows:
                raise ValueError(
                    f"constrain_rows: a state leaf holds {a.shape[0]} rows, "
                    f"not the batcher's {n_rows}")
    return arrays


__all__ = [
    "ROW_AXES", "ServeMeshSpec", "parse_serve_mesh", "build_serve_mesh",
    "is_serving_mesh", "row_shards", "fits", "placement_ok",
    "validate_serve_mesh",
    "mesh_shape", "pool_pspec", "row_pspec", "shard_pool",
    "gather_slab_heads", "slab_head_slice", "place_rows",
    "StagingSharding", "staging_shardings", "constraints_apply",
    "constrain_view", "constrain_pool", "constrain_rows",
]
