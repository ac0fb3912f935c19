"""Parallelism over ``torch.distributed`` (port of
``jax_llama_tpu/parallel``): one process per rank, local weight shards,
explicit collectives.  See ``mesh`` for the design, ``ring`` for
sequence parallelism, ``pipeline`` for pipeline stages, ``lockstep``
for the HTTP server and the router over a serving mesh and ``slices``
for sliced replicas, each on ranks of its own."""

from . import distributed, lockstep, serve_mesh, slices
from .mesh import (
    AXES,
    Mesh,
    auto_mesh,
    constrain,
    current_mesh,
    logical_to_spec,
    make_mesh,
    use_mesh,
)
from .partition import (
    param_partition_specs,
    shard_abstract,
    shard_params,
    validate_tp,
)
from .pipeline import pipeline_blocks
from .ring import ring_attention, ring_sdpa

__all__ = [
    "distributed",
    "lockstep",
    "pipeline_blocks",
    "ring_attention",
    "ring_sdpa",
    "serve_mesh",
    "shard_abstract",
    "slices",
    "AXES",
    "Mesh",
    "auto_mesh",
    "constrain",
    "current_mesh",
    "logical_to_spec",
    "make_mesh",
    "use_mesh",
    "param_partition_specs",
    "shard_params",
    "validate_tp",
]
