"""Checkpoint save and load with an integrity manifest (port of
``jax_llama_tpu/convert/checkpoint.py``).

Layout on disk:
    <dir>/params.pt      the parameter dictionary (``torch.save``)
    <dir>/config.json    LLaMAConfig fields, with the JAX package's
                         ``_quantized`` / ``_train_state`` markers
    <dir>/manifest.json  per-file sha256 + size, verified on load

``config.json`` and ``manifest.json`` are the JAX package's formats, so
either package's ``verify_manifest`` and ``load_config`` read the other's
directory.  The params differ: the JAX package writes an Orbax ``params/``
tree, which the port (importing no jax) does not read; a directory that
holds one is refused with a pointer to the Meta converter.  A
``QuantizedTensor`` is stored as a ``{"q": int8, "scale": float32}``
pair of plain tensors, so ``torch.load(weights_only=True)`` restores it
without unpickling a class.

Saves are atomic: the checkpoint is assembled in a temp sibling
directory, hashed, and renamed into place (a pre-existing checkpoint is
swapped aside and removed only after the new tree has landed).  Load
verifies every listed file's size and sha256 first, so a truncated or
flipped shard fails before its weights are used.

On a mesh (``load_checkpoint(..., mesh=)``) every rank maps ``params.pt``
into memory and copies out only its own shard (``parallel.partition``'s
specs; ``fsdp=True`` for the ZeRO-3 layout), so no rank holds the full
tree on its device.  Saving a shard under the mesh it was sharded for
(``use_mesh``: JAX's ``save_checkpoint`` and ``save_train_state`` take
no mesh, its arrays carry theirs) gathers the shards and rank 0 writes
the directory: the same files, and so the same manifest, as an unsharded
save of the same tree.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import torch

from ..config import LLaMAConfig
from ..models.llama import resolve_device
from ..ops.quant import QuantizedTensor, is_quantized
from ..parallel.mesh import current_mesh, use_mesh
from ..parallel.partition import (
    gather_params,
    sharded_leaf_index,
    validate_tp,
)

MANIFEST_NAME = "manifest.json"
PARAMS_NAME = "params.pt"
STATE_NAME = "state.pt"


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_manifest(root: Path) -> None:
    """Record every file under ``root`` (sha256 + byte size), manifest
    excluded, keyed by POSIX-relative path."""
    files: Dict[str, Dict[str, Any]] = {}
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.name != MANIFEST_NAME:
            files[p.relative_to(root).as_posix()] = {
                "sha256": _sha256_file(p),
                "bytes": p.stat().st_size,
            }
    with open(root / MANIFEST_NAME, "w") as f:
        json.dump({"version": 1, "files": files}, f, indent=2)


def verify_manifest(path: str) -> bool:
    """Verify every manifest-listed file's existence, size, and sha256.

    Returns False (nothing to verify) for a directory without a manifest;
    raises ValueError naming every bad file otherwise.  Size is checked
    before hashing, so truncation is reported as truncation.
    """
    root = Path(path).absolute()
    mf = root / MANIFEST_NAME
    if not mf.exists():
        return False
    with open(mf) as f:
        manifest = json.load(f)
    errors = []
    for rel, want in manifest.get("files", {}).items():
        p = root / rel
        if not p.is_file():
            errors.append(f"{rel}: missing")
            continue
        size = p.stat().st_size
        if size != want["bytes"]:
            errors.append(
                f"{rel}: truncated/resized ({size} bytes, "
                f"recorded {want['bytes']})"
            )
            continue
        if _sha256_file(p) != want["sha256"]:
            errors.append(f"{rel}: sha256 mismatch (corrupted shard)")
    if errors:
        raise ValueError(
            f"checkpoint {root} failed integrity verification — "
            "refusing to restore corrupt weights: " + "; ".join(errors)
        )
    return True


def _promote(tmp: Path, path: Path) -> None:
    """Rename the finished tree into place: atomic when ``path`` does not
    exist; otherwise the old checkpoint is swapped aside first and removed
    only after the new tree has landed."""
    if path.exists():
        trash = path.parent / f".{path.name}.trash-{os.getpid()}"
        if trash.exists():
            shutil.rmtree(trash)
        os.rename(path, trash)
        os.rename(tmp, path)
        shutil.rmtree(trash)
    else:
        os.rename(tmp, path)


def _atomic_save(path: Path, write: Callable[[Path], None]) -> None:
    """Assemble a checkpoint with ``write(tmp_dir)``, write its manifest,
    then promote it into ``path``; the temp directory is removed if any
    step fails."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{path.name}.tmp-", dir=path.parent))
    # mkdtemp creates 0700; give the tree umask-default permissions, so a
    # checkpoint saved by one user stays readable by another.
    um = os.umask(0)
    os.umask(um)
    os.chmod(tmp, 0o777 & ~um)
    try:
        write(tmp)
        _write_manifest(tmp)
        _promote(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _plain(tree):
    """The tree as ``torch.save`` should write it: every ``QuantizedTensor``
    as a {"q", "scale"} dict, every tensor detached and compact (a view
    is saved with its whole storage, e.g. all layers of a sliced stack)."""
    if isinstance(tree, QuantizedTensor):
        return {"q": _plain(tree.q), "scale": _plain(tree.scale)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if (not t.is_contiguous() or t.untyped_storage().nbytes()
                != t.numel() * t.element_size()):
            t = t.clone(memory_format=torch.contiguous_format)
        return t
    return tree


def _restore(tree, device: torch.device, quantized: bool):
    """The saved tree copied onto ``device`` (never sharing memory with the
    file), with {"q", "scale"} pairs rebuilt as ``QuantizedTensor``s when
    the checkpoint is quantized."""
    if isinstance(tree, dict):
        if quantized and set(tree) == {"q", "scale"}:
            return QuantizedTensor(q=_restore(tree["q"], device, False),
                                   scale=_restore(tree["scale"], device,
                                                  False))
        return {k: _restore(v, device, quantized) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return tree


def _restore_shard(tree, device: torch.device, quantized: bool, mesh,
                   config: LLaMAConfig, path: Tuple[str, ...] = (),
                   fsdp: bool = False):
    """``_restore`` of this rank's shard only: each leaf of the (memory-
    mapped) saved tree is sliced by its partition spec before the copy."""
    if isinstance(tree, dict):
        if quantized and set(tree) == {"q", "scale"}:
            q = tree["q"]
            return QuantizedTensor(
                q=q[sharded_leaf_index(mesh, config, path, q.shape,
                                       fsdp=fsdp)].to(
                    device, copy=True).contiguous(),
                scale=tree["scale"][sharded_leaf_index(
                    mesh, config, path, tree["scale"].shape,
                    scale_of=q.shape, fsdp=fsdp)].to(
                        device, copy=True).contiguous())
        return {k: _restore_shard(v, device, quantized, mesh, config,
                                  path + (k,), fsdp)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        idx = sharded_leaf_index(mesh, config, path, tree.shape, fsdp=fsdp)
        return tree[idx].to(device, copy=True).contiguous()
    return tree


def _mesh_fsdp(params: Any, config: LLaMAConfig) -> bool:
    """Whether a shard's layers hold D / fsdp of the model dimension."""
    qkv = params["layers"]["qkv"]
    q = qkv.q if isinstance(qkv, QuantizedTensor) else qkv
    return q.shape[-2] != config.dim


def _load_file(path: Path):
    try:
        return torch.load(path, map_location="cpu", mmap=True,
                          weights_only=True)
    except (RuntimeError, TypeError, ValueError):
        return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(path: str, params: Any, config: LLaMAConfig) -> None:
    """Write params + config to ``path``, atomically, with an integrity
    manifest (module docstring).  A quantized tree (``quantize_params``)
    round-trips: config.json's ``_quantized`` marker tells
    ``load_checkpoint`` to rebuild its ``QuantizedTensor``s.

    Under an active mesh (``use_mesh``) ``params`` is this rank's shard
    (any layout ``shard_params`` makes, fsdp included); every rank calls
    this, the shards are gathered and rank 0 writes.  A shard without
    its mesh raises."""
    mesh = current_mesh()
    if mesh is not None and mesh.size > 1:
        full = gather_params(params, mesh, config,
                             fsdp=_mesh_fsdp(params, config))
        if mesh.rank == 0:
            with use_mesh(None):
                save_checkpoint(path, full, config)
        del full
        mesh.barrier()
        return
    layers = params.get("layers", {}) if isinstance(params, dict) else {}
    if "qkv" in layers and (layers["qkv"].shape[-4] != config.kv_heads
                            or layers["qkv"].shape[0] != config.n_layers
                            or _mesh_fsdp(params, config)):
        raise ValueError(
            f"save_checkpoint: the weights are a shard "
            f"({tuple(layers['qkv'].shape)} of qkv); save them under the "
            "mesh they were sharded for (parallel.use_mesh), which gathers "
            "them")
    final = Path(path).absolute()
    meta = dict(dataclasses.asdict(config), _quantized=is_quantized(params))

    def write(tmp: Path) -> None:
        with open(tmp / "config.json", "w") as f:
            json.dump(meta, f, indent=2)
        torch.save(_plain(params), tmp / PARAMS_NAME)

    _atomic_save(final, write)


def load_config(path: str) -> Tuple[LLaMAConfig, bool]:
    """(config, quantized) from a checkpoint directory's config.json."""
    config, quantized, _ = _load_meta(path)
    return config, quantized


def _load_meta(path: str) -> Tuple[LLaMAConfig, bool, bool]:
    with open(Path(path) / "config.json") as f:
        meta = json.load(f)
    quantized = meta.pop("_quantized", False)
    is_train = meta.pop("_train_state", False)
    return LLaMAConfig(**meta), quantized, is_train


def _payload(path: Path, name: str, orbax_item: str) -> Path:
    """The torch.save file of a checkpoint, or a ValueError naming what the
    directory holds instead (an Orbax tree written by the JAX package)."""
    f = path / name
    if f.is_file():
        return f
    if (path / orbax_item).is_dir():
        raise ValueError(
            f"{path} holds an Orbax '{orbax_item}/' tree written by the JAX "
            "package; the port reads no Orbax checkpoint — convert the "
            "Meta files with jax_llama_tpu_torch.convert instead"
        )
    raise FileNotFoundError(f"{f} not found")


def load_checkpoint(
    path: str,
    device=None,
    *,
    verify: bool = True,
    mesh=None,
    fsdp: bool = False,
) -> Tuple[Any, LLaMAConfig]:
    """Restore (params, config) onto ``device`` ("cuda" by default; it
    raises when no GPU is present unless ``device="cpu"``).

    ``verify`` (default True) checks the integrity manifest first, reading
    every byte of the checkpoint to hash it; ``verify=False`` skips that
    where the storage layer already guarantees integrity.  A directory
    without a manifest loads unverified.

    ``mesh``: this rank's shard of the params (``parallel.shard_params``'
    result, ``fsdp=True`` for the ZeRO-3 layout, read leaf by leaf from
    the memory-mapped file) on the mesh device unless ``device`` says
    otherwise.
    """
    if fsdp and mesh is None:
        raise ValueError("load_checkpoint: fsdp=True shards over a mesh; "
                         "pass mesh=")
    if device is None:
        device = mesh.device if mesh is not None else "cuda"
    device = resolve_device(device)
    path = Path(path).absolute()
    if verify:
        verify_manifest(path)
    config, quantized, is_train = _load_meta(path)
    if is_train:
        raise ValueError(
            f"{path} is a training checkpoint (params + optimizer state); "
            "restore it with load_train_state, or save serving weights "
            "with save_checkpoint(state.params, ...)"
        )
    saved = _load_file(_payload(path, PARAMS_NAME, "params"))
    if mesh is not None:
        validate_tp(config, mesh, fsdp=fsdp)
        return _restore_shard(saved, device, quantized, mesh, config,
                              fsdp=fsdp), config
    return _restore(saved, device, quantized), config


# ---------------------------------------------------------------------------
# Training checkpoint / resume
# ---------------------------------------------------------------------------

def save_train_state(path: str, state: Any, config: LLaMAConfig) -> None:
    """Write a ``train.TrainState`` (params, AdamW moments and count, step)
    + config, atomically and with a manifest like ``save_checkpoint``: a
    periodic save that crashes mid-write never destroys the previous
    resume point.  Under an active mesh (``use_mesh``) the state is this
    rank's shards; every rank calls this, params and moments are
    gathered and rank 0 writes."""
    mesh = current_mesh()
    if mesh is not None and mesh.size > 1:
        from ..train import AdamWState, TrainState

        fsdp = _mesh_fsdp(state.params, config)
        opt = state.opt_state
        full = TrainState(
            params=gather_params(state.params, mesh, config, fsdp=fsdp),
            opt_state=AdamWState(
                mu=gather_params(opt.mu, mesh, config, fsdp=fsdp),
                nu=gather_params(opt.nu, mesh, config, fsdp=fsdp),
                count=opt.count),
            step=state.step)
        if mesh.rank == 0:
            with use_mesh(None):
                save_train_state(path, full, config)
        del full
        mesh.barrier()
        return
    final = Path(path).absolute()
    meta = dict(dataclasses.asdict(config), _train_state=True)
    opt = state.opt_state
    tree = {"params": state.params,
            "opt_state": {"mu": opt.mu, "nu": opt.nu, "count": opt.count},
            "step": state.step}

    def write(tmp: Path) -> None:
        with open(tmp / "config.json", "w") as f:
            json.dump(meta, f, indent=2)
        torch.save(_plain(tree), tmp / STATE_NAME)

    _atomic_save(final, write)


def load_train_state(
    path: str,
    device=None,
    *,
    verify: bool = True,
    mesh=None,
    fsdp: bool = False,
) -> Tuple[Any, LLaMAConfig]:
    """Restore (TrainState, config) for training resume on ``device``
    ("cuda" by default): the params as autograd leaves (as
    ``init_train_state`` makes them), the moments and counts as saved.
    JAX's ``load_train_state`` also takes the optimizer, to shape its
    restore target; the port restores the saved tree as it is, so it
    needs none (neither package stores the optimizer's hyperparameters).
    ``verify`` as in ``load_checkpoint``; ``mesh`` (and ``fsdp``) as
    there: params and moments come back as this rank's shards."""
    from ..train import AdamWState, TrainState, tree_leaves

    if device is None:
        device = mesh.device if mesh is not None else "cuda"
    device = resolve_device(device)
    path = Path(path).absolute()
    if verify:
        verify_manifest(path)
    config, _, is_train = _load_meta(path)
    if not is_train:
        raise ValueError(
            f"{path} is a serving checkpoint (params only); restore it "
            "with load_checkpoint"
        )
    raw = _load_file(_payload(path, STATE_NAME, "state"))
    if mesh is not None:
        validate_tp(config, mesh, fsdp=fsdp)
        saved = dict(raw, **{
            "params": _restore_shard(raw["params"], device, False, mesh,
                                     config, fsdp=fsdp),
            "opt_state": dict(raw["opt_state"], **{
                k: _restore_shard(raw["opt_state"][k], device, False, mesh,
                                  config, fsdp=fsdp)
                for k in ("mu", "nu")})})
    else:
        saved = _restore(raw, device, False)
    for p in tree_leaves(saved["params"]):
        p.requires_grad_(True)
    opt = saved["opt_state"]
    return TrainState(
        params=saved["params"],
        opt_state=AdamWState(mu=opt["mu"], nu=opt["nu"],
                             count=int(opt["count"])),
        step=int(saved["step"]),
    ), config
