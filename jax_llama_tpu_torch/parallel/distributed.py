"""Multi-process initialization (port of
``jax_llama_tpu/parallel/distributed.py``).

The JAX package brings up ``jax.distributed`` so that one controller sees
every device, and XLA inserts the collectives.  The port runs ONE PROCESS
PER RANK, each holding its own shards, and writes its collectives by hand
over ``torch.distributed``; this module brings up that process group.

Typical entry (the same program on every rank, e.g. under ``torchrun
--nproc-per-node N``, which sets ``RANK``, ``WORLD_SIZE`` and
``MASTER_ADDR``/``MASTER_PORT``):

    from jax_llama_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize()          # no-op in a single process
    mesh = make_mesh(tensor=distributed.process_count())

The backend is chosen, never fallen back to: ``nccl`` when the ranks run
on CUDA devices, ``gloo`` on the CPU, unless ``backend=`` names one.  Two
ranks that share one GPU cannot form an NCCL communicator (NCCL refuses
duplicate devices), so such a run passes ``backend="gloo"``, which takes
CUDA tensors for ``all_reduce``, ``all_gather`` and ``broadcast``.  A
failed initialization raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_initialized = False


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[str] = None,
) -> None:
    """Bring up the default process group when running multi-process.

    Arguments fall back to the JAX module's environment names
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``), then to torchrun's (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``coordinator_address``
    is ``host:port`` or a ``tcp://`` URL.  A single process (no address
    and no world size above 1) initializes nothing, so calling this is
    always safe.  ``backend`` defaults to ``nccl`` when ``device`` (by
    default "cuda" if a GPU is present) is a CUDA device, else ``gloo``.
    """
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if coordinator_address is None or (num_processes or 1) <= 1:
        return  # single process: nothing to initialize
    if process_id is None:
        raise ValueError(
            "distributed.initialize: a multi-process run needs its rank "
            "(process_id=, JAX_PROCESS_ID or RANK)")
    if backend is None:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend=backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _initialized = True


def shutdown() -> None:
    """Tear the default process group down (the end of a rank's
    program); safe when nothing was initialized."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_initialized() -> bool:
    return _initialized or dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
