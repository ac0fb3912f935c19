"""Meta checkpoint conversion and the port's checkpoint save/load
(CLI: ``python -m jax_llama_tpu_torch.convert``)."""

from .checkpoint import (
    load_checkpoint,
    load_config,
    load_train_state,
    save_checkpoint,
    save_train_state,
    verify_manifest,
)
from .meta import config_from_params_json, convert_meta_checkpoint

__all__ = [
    "convert_meta_checkpoint",
    "config_from_params_json",
    "save_checkpoint",
    "load_checkpoint",
    "load_config",
    "save_train_state",
    "load_train_state",
    "verify_manifest",
]
