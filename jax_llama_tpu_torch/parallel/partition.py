"""Parameter partition specs and sharding by slicing (port of
``jax_llama_tpu/parallel/partition.py``).

The spec tree is the JAX package's, written as tuples of axis names (one
entry per dimension: None, an axis name, or a tuple of names):
column-parallel over KV heads on the fused qkv, column-parallel over F on
the fused gate_up and on the LM head, row-parallel on o and down, the
embedding sharded over the vocabulary, the norms replicated.  Each fused
qkv shard holds its KV heads' q slots AND k/v slots, the same per-shard
contents as the separate q/k/v layout.

``shard_params`` does what ``jax.device_put`` with a ``NamedSharding``
does, for ONE rank: it slices this rank's shard out of a full tree and
moves it to the rank's device, so no rank keeps a global weight.  With
``fsdp=True`` each projection's non-tensor-parallel dimension is also
sharded over ``fsdp`` (ZeRO-3: the forward all-gathers a layer's
weights before it uses them), and on a ``stage > 1`` mesh the stacked
layer axis is sharded over ``stage`` (each pipeline stage holds its own
L / stage layers).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..config import LLaMAConfig
from ..ops.quant import QuantizedTensor
from .mesh import Mesh, _axes


def param_partition_specs(
    config: LLaMAConfig, *, fsdp: bool = False, pp: bool = False
) -> Dict[str, Any]:
    """The spec tree mirroring ``init_params``' tree (JAX :34).  Layer
    weights carry the stacked L axis first: sharded over ``stage`` with
    ``pp``, else unsharded.  ``fsdp`` also shards each projection's
    non-tensor-parallel dimension over ``fsdp``."""
    f = "fsdp" if fsdp else None
    s = "stage" if pp else None
    specs: Dict[str, Any] = {
        "embed": {"embedding": (("tensor", f) if f else "tensor", None)},
        "layers": {
            "attn_norm": (s, None),
            # Fused [L, KVH, G+2, D, hd]: column-parallel over KV heads.
            "qkv": (s, "tensor", None, f, None),
            "o": (s, "tensor", None, f),             # row-parallel
            "mlp_norm": (s, None),
            # Fused [L, 2, D, F]: column-parallel over F.
            "gate_up": (s, None, f, "tensor"),
            "down": (s, "tensor", f),                # row-parallel
        },
        "final_norm": (None,),
    }
    if not config.tie_word_embeddings:
        specs["lm_head"] = (f, "tensor")             # column-parallel
    return specs


def validate_tp(config: LLaMAConfig, mesh: Mesh, *, fsdp: bool = False) -> None:
    """Check that the mesh axes divide the dimensions they shard (JAX
    :73, the same messages)."""
    st = mesh.shape.get("stage", 1)
    if config.n_layers % st:
        raise ValueError(
            f"stage={st} must divide n_layers={config.n_layers} "
            "(pipeline stages hold equal layer counts)"
        )
    tp = mesh.shape["tensor"]
    if config.kv_heads % tp:
        raise ValueError(
            f"tensor={tp} must divide n_kv_heads={config.kv_heads} "
            "(GQA KV cache is head-sharded)"
        )
    if config.n_heads % tp:
        raise ValueError(f"tensor={tp} must divide n_heads={config.n_heads}")
    if config.ffn_dim % tp:
        raise ValueError(f"tensor={tp} must divide ffn_dim={config.ffn_dim}")
    if config.vocab_size % tp:
        raise ValueError(f"tensor={tp} must divide vocab={config.vocab_size}")
    if fsdp:
        fs = mesh.shape["fsdp"]
        if config.dim % fs:
            raise ValueError(f"fsdp={fs} must divide dim={config.dim}")
        if config.ffn_dim % fs:
            raise ValueError(f"fsdp={fs} must divide ffn_dim={config.ffn_dim}")
        if config.vocab_size % (tp * fs):
            raise ValueError(
                f"tensor*fsdp={tp * fs} must divide vocab="
                f"{config.vocab_size} (vocab-sharded embedding)"
            )


def mesh_specs(config: LLaMAConfig, mesh: Mesh, fsdp: bool = False
               ) -> Dict[str, Any]:
    """The spec tree a tree sharded for ``mesh`` follows: the pipeline
    variant on a ``stage > 1`` mesh (JAX :121), fsdp when asked."""
    return param_partition_specs(config, fsdp=fsdp,
                                 pp=mesh.shape.get("stage", 1) > 1)


def shard_index(mesh: Mesh, spec: Sequence, shape: Sequence[int]
                ) -> Tuple[slice, ...]:
    """This rank's slice of a tensor of global ``shape`` under ``spec``:
    each sharded dimension splits evenly in the axis' rank order."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    index = []
    for n, axis in zip(shape, spec):
        k = mesh.axis_size(axis)
        if k == 1:
            index.append(slice(None))
            continue
        if n % k:
            raise ValueError(
                f"{_axes(axis)} of size {k} does not divide a dimension of "
                f"{n}")
        i = mesh.axis_index(axis)
        index.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(index)


def local_shape(mesh: Mesh, spec: Sequence, shape: Sequence[int]
                ) -> Tuple[int, ...]:
    return tuple(len(range(*s.indices(n)))
                 for s, n in zip(shard_index(mesh, spec, shape), shape))


def _scale_spec(spec: Sequence, q_ndim: int, scale_shape) -> Tuple:
    """A QuantizedTensor scale's spec (JAX :156): the weight's, minus the
    axes on contracted dims (size 1 in the scale)."""
    full = tuple(spec) + (None,) * (q_ndim - len(tuple(spec)))
    return tuple(ax if dim != 1 else None
                 for ax, dim in zip(full, scale_shape))


def _map_with_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a (possibly quantized) tree zipped with
    its spec tree; a QuantizedTensor's scale takes ``_scale_spec``."""
    if isinstance(tree, dict):
        if set(tree) != set(specs):
            raise ValueError(
                f"param tree keys {sorted(tree)} do not match the spec "
                f"tree's {sorted(specs)}")
        return {k: _map_with_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(
            q=fn(tree.q, specs),
            scale=fn(tree.scale, _scale_spec(specs, tree.q.dim(),
                                             tree.scale.shape)))
    return fn(tree, specs)


def shard_params(
    params: Any,
    mesh: Mesh,
    config: LLaMAConfig,
    *,
    fsdp: bool = False,
    device: Optional[Any] = None,
) -> Any:
    """This rank's shard of a full parameter tree (JAX :112), moved to
    ``device`` (the rank's mesh device by default).  A tree from
    ``init_params``, ``from_jax_params`` or ``load_checkpoint`` feeds in
    unchanged, quantized or not; every leaf comes back contiguous, so the
    full tree can be let go."""
    validate_tp(config, mesh, fsdp=fsdp)
    specs = mesh_specs(config, mesh, fsdp)
    device = torch.device(device) if device is not None else mesh.device

    def take(x, spec):
        return x[shard_index(mesh, spec, x.shape)].to(device).contiguous()

    return _map_with_specs(take, params, specs)


def shard_abstract(
    shapes: Any,
    mesh: Mesh,
    config: LLaMAConfig,
    *,
    fsdp: bool = False,
) -> Any:
    """The local shapes of a tree of global shapes (JAX :136: the form a
    loader needs to read each shard straight to its rank).  Leaves are
    shapes (tuples or ``torch.Size``) or tensors (their shapes are
    taken); a QuantizedTensor's leaves likewise."""
    validate_tp(config, mesh, fsdp=fsdp)
    specs = mesh_specs(config, mesh, fsdp)

    def abstract(x, spec):
        shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
        return local_shape(mesh, spec, shape)

    return _map_with_specs(abstract, shapes, specs)


def sharded_leaf_index(mesh: Mesh, config: LLaMAConfig, path: Sequence[str],
                       shape: Sequence[int], scale_of: Optional[Sequence[int]]
                       = None, fsdp: bool = False) -> Tuple[slice, ...]:
    """This rank's slice of one leaf named by its ``path`` in the tree
    (e.g. ``("layers", "qkv")``), for loaders that read one leaf at a
    time.  ``scale_of`` (the payload's shape) marks the leaf as a
    QuantizedTensor's scale."""
    spec: Any = mesh_specs(config, mesh, fsdp)
    for key in path:
        spec = spec[key]
    if scale_of is not None:
        spec = _scale_spec(spec, len(scale_of), shape)
    return shard_index(mesh, spec, shape)


def gather_params(params: Any, mesh: Mesh, config: LLaMAConfig, *,
                  fsdp: bool = False, device: Optional[Any] = None) -> Any:
    """The full tree from every rank's shard (the inverse of
    ``shard_params``), on every rank: each sharded dimension is
    all-gathered over its axes, the fastest-varying axis first.  Every
    rank calls it, with the shard of the same tree."""
    validate_tp(config, mesh, fsdp=fsdp)
    specs = mesh_specs(config, mesh, fsdp)

    def full(x, spec):
        x = x.detach()
        spec = tuple(spec) + (None,) * (x.dim() - len(tuple(spec)))
        for dim, axis in enumerate(spec):
            for a in reversed(_axes(axis)):
                x = mesh.all_gather(x, a, dim=dim)
        return x.to(device) if device is not None else x.contiguous()

    return _map_with_specs(full, params, specs)


def leaf_specs(config: LLaMAConfig, mesh: Mesh, params: Any,
               fsdp: bool = False) -> Dict[str, Tuple]:
    """Each leaf's spec by its ``train.tree_items`` name ("layers/qkv"),
    for a tree sharded for ``mesh``; a QuantizedTensor's payload and
    scale as "<name>/q" and "<name>/scale"."""
    out: Dict[str, Tuple] = {}

    def walk(tree, spec, prefix):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k], f"{prefix}{k}/")
        elif isinstance(tree, QuantizedTensor):
            out[prefix + "q"] = tuple(spec)
            out[prefix + "scale"] = _scale_spec(spec, tree.q.dim(),
                                                tree.scale.shape)
        else:
            out[prefix[:-1]] = tuple(spec)

    walk(params, mesh_specs(config, mesh, fsdp), "")
    return out


__all__ = [
    "param_partition_specs", "validate_tp", "shard_params",
    "shard_abstract", "shard_index", "local_shape", "sharded_leaf_index",
    "mesh_specs", "leaf_specs", "gather_params",
]
