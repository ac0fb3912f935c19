"""Meta checkpoint converter: ``consolidated.NN.pth`` shards + ``params.json``
-> the port's parameter dictionary (port of ``jax_llama_tpu/convert/meta.py``,
the same tensor mapping):

  Meta tensor (torch [out, in])        shard axis  ->  the port
  ----------------------------------   ----------      ------------------------
  tok_embeddings.weight  [V, D]        1 or 0          embed.embedding [V, D]
  layers.N.attention.wq  [H*hd, D]     0               layers.qkv[:, :, :G]
  layers.N.attention.wk  [KVH*hd, D]   0               layers.qkv[:, :, G]
  layers.N.attention.wv  [KVH*hd, D]   0               layers.qkv[:, :, G+1]
  layers.N.attention.wo  [D, H*hd]     1               layers.o  [L, H, hd, D]
  layers.N.feed_forward.w1 [F, D]      0               layers.gate_up[:, 0]
  layers.N.feed_forward.w3 [F, D]      0               layers.gate_up[:, 1]
  layers.N.feed_forward.w2 [D, F]      1               layers.down [L, F, D]
  layers.N.attention_norm / ffn_norm   replicated      layers.attn_norm/mlp_norm
  norm.weight                          replicated      final_norm
  output.weight          [V, D]        0               lm_head [D, V]
                                                       (absent: tied embeddings)

Column-parallel weights concatenate along torch axis 0, row-parallel ones
along axis 1, and linear weights transpose from [out, in] to [in, out].
Meta's head order is kept (query head h = kvh*G + g); the q/k head_dim
features move to the half-split RoPE order (``models.llama.rope_permute``).

The JAX converter casts every tensor to float32 numpy first; here each
tensor is popped from its mmap'd shard, cast straight to the target dtype
and moved to ``device``, then laid out there and copied into the stacked
result, which is allocated once.  Host memory stays at one tensor (the
shards are file-backed), and the device holds the result and one layer's
scratch.  Casting before the transposes gives the same bits as casting
after them: the layout steps only move elements.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import LLaMAConfig, torch_dtype
from ..models.llama import resolve_device, rope_permute


def _load_shards(ckpt_dir: str):
    """Every ``*.pth`` shard's state dict, ordered by shard index
    (``consolidated.00.pth`` ...), mmap'd where torch can."""
    paths = sorted(Path(ckpt_dir).glob("*.pth"))
    if not paths:
        raise FileNotFoundError(f"no .pth checkpoint shards in {ckpt_dir}")

    def shard_index(p: Path) -> int:
        # 'consolidated.00.pth' -> 0; a single unnumbered file -> 0.
        for part in p.name.split(".")[1:-1]:
            if part.isdigit():
                return int(part)
        return 0

    shards = []
    for p in sorted(paths, key=shard_index):
        try:
            sd = torch.load(p, map_location="cpu", mmap=True, weights_only=True)
        except (RuntimeError, TypeError, ValueError):
            sd = torch.load(p, map_location="cpu", weights_only=True)
        shards.append(sd)
    return shards


def _take(shards, key: str, concat_axis: Optional[int], dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """Pop ``key`` from every shard, each cast to ``dtype`` on ``device``,
    and concatenate them (or copy shard 0's: ``concat_axis`` None).  The
    result never shares memory with the mmap'd file."""
    tensors = [sd.pop(key) for sd in shards]
    if concat_axis is None:
        return tensors[0].to(device=device, dtype=dtype, copy=True)
    return torch.cat([t.to(device=device, dtype=dtype) for t in tensors],
                     dim=concat_axis)


def config_from_params_json(
    ckpt_dir: str, vocab_size: int, max_seq_len: int = 2048, **overrides
) -> LLaMAConfig:
    """A ``LLaMAConfig`` from Meta's ``params.json``; architecture keys this
    converter does not understand are refused (JAX :97)."""
    with open(Path(ckpt_dir) / "params.json") as f:
        p = json.load(f)
    kw = dict(
        vocab_size=vocab_size,
        dim=p["dim"],
        n_layers=p["n_layers"],
        n_heads=p["n_heads"],
        n_kv_heads=p.get("n_kv_heads"),
        multiple_of=p.get("multiple_of", 256),
        ffn_dim_multiplier=p.get("ffn_dim_multiplier"),
        rms_norm_eps=p.get("norm_eps", 1e-5),
        rope_theta=p.get("rope_theta", 10000.0),
        use_scaled_rope=bool(p.get("use_scaled_rope", False)),
        max_seq_len=max_seq_len,
    )
    consumed = {
        "dim", "n_layers", "n_heads", "n_kv_heads", "multiple_of",
        "ffn_dim_multiplier", "norm_eps", "rope_theta", "use_scaled_rope",
        "vocab_size", "max_seq_len", "max_batch_size",
    }
    unknown = set(p) - consumed
    if unknown:
        raise ValueError(
            f"params.json has architecture keys this converter does not "
            f"understand: {sorted(unknown)} — refusing to convert a model "
            "that would be silently wrong"
        )
    kw.update(overrides)
    return LLaMAConfig(**kw)


def convert_meta_checkpoint(
    ckpt_dir: str,
    tokenizer: Any = None,
    *,
    vocab_size: Optional[int] = None,
    max_seq_len: int = 2048,
    dtype: str = "bfloat16",
    device="cuda",
) -> Tuple[Dict[str, Any], LLaMAConfig]:
    """Convert a Meta checkpoint directory into (params, config).

    Args:
      ckpt_dir: directory with ``consolidated.*.pth`` + ``params.json``.
      tokenizer: anything with ``__len__``, for the vocabulary size; or
        pass ``vocab_size``.
      max_seq_len: context length to configure.
      dtype: storage dtype of the params ("bfloat16", "float32" or
        "float16"); compute follows it, except that float16 params compute
        in bfloat16, as in the JAX package.
      device: where the params are built ("cuda" by default; it raises
        when no GPU is present unless ``device="cpu"``).
    """
    device = resolve_device(device)
    if vocab_size is None:
        if tokenizer is None:
            raise ValueError("pass a tokenizer or an explicit vocab_size")
        vocab_size = len(tokenizer)
    compute = "bfloat16" if dtype in ("bfloat16", "float16") else dtype
    config = config_from_params_json(
        ckpt_dir, vocab_size, max_seq_len, dtype=compute, param_dtype=dtype
    )
    config.validate()
    D, H, KVH, hd = config.dim, config.n_heads, config.kv_heads, config.head_dim
    L, F, G = config.n_layers, config.ffn_dim, H // KVH
    od = torch_dtype(dtype)

    shards = _load_shards(ckpt_dir)

    def take(key, axis=None):
        return _take(shards, key, axis, od, device)

    def col(key):  # [out, D] shards -> [D, out]
        return take(key, 0).T

    def row(key):  # [D, out] shards -> [out, D]
        return take(key, 1).T

    def empty(*shape):
        return torch.empty(shape, dtype=od, device=device)

    lp = {"attn_norm": empty(L, D), "qkv": empty(L, KVH, G + 2, D, hd),
          "o": empty(L, H, hd, D), "mlp_norm": empty(L, D),
          "gate_up": empty(L, 2, D, F), "down": empty(L, F, D)}
    for i in range(L):
        pre = f"layers.{i}."
        lp["attn_norm"][i] = take(pre + "attention_norm.weight")
        # Per KV head, slots [q_0..q_{G-1}, k, v], q/k features in the
        # half-split order, D second from last (models.llama.fuse_qkv).
        qkv = lp["qkv"][i]
        qkv[:, :G] = torch.movedim(rope_permute(
            col(pre + "attention.wq.weight").reshape(D, H, hd)
        ).reshape(D, KVH, G, hd), 0, 2)
        qkv[:, G] = rope_permute(
            col(pre + "attention.wk.weight").reshape(D, KVH, hd)
        ).transpose(0, 1)
        qkv[:, G + 1] = col(
            pre + "attention.wv.weight").reshape(D, KVH, hd).transpose(0, 1)
        lp["o"][i] = row(pre + "attention.wo.weight").reshape(H, hd, D)
        lp["mlp_norm"][i] = take(pre + "ffn_norm.weight")
        lp["gate_up"][i, 0] = col(pre + "feed_forward.w1.weight")
        lp["gate_up"][i, 1] = col(pre + "feed_forward.w3.weight")
        lp["down"][i] = row(pre + "feed_forward.w2.weight")

    # Llama-2 splits the embedding's model dim across shards
    # (ParallelEmbedding, concat axis 1), Llama-3 its vocabulary
    # (VocabParallelEmbedding, concat axis 0): told apart by the shard's
    # row count (JAX :227).
    emb_shard_rows = shards[0]["tok_embeddings.weight"].shape[0]
    emb_axis = 1 if emb_shard_rows == vocab_size else 0
    params: Dict[str, Any] = {
        "embed": {"embedding": take("tok_embeddings.weight", emb_axis)},
        "layers": lp,
        "final_norm": take("norm.weight"),
    }
    if "output.weight" not in shards[0]:
        config = config.replace(tie_word_embeddings=True)
    else:
        params["lm_head"] = col("output.weight").contiguous()

    assert params["embed"]["embedding"].shape[0] == vocab_size, (
        params["embed"]["embedding"].shape, vocab_size
    )
    return params, config
