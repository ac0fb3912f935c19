"""Autoregressive decode engine (port of ``jax_llama_tpu/engine.py``).

Prompts arrive left-padded to a common length P with a boolean mask.  The
engine prefills them (in one forward, or in ``prefill_chunk``-sized
chunks whose non-final chunks skip the LM head), then decodes one token
per step.  The JAX ``lax.while_loop`` is a Python loop with the same
exit: after ``max_new_tokens`` steps, or as soon as every row has emitted
a stop token.  A stop token is written to the buffer, then the row emits
``pad_id``.  As in the JAX engine, the last step's forward runs even
though its token is discarded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .config import LLaMAConfig
from .models.llama import _params_device, forward, init_cache, resolve_device
from .ops.sampling import sample


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Sampling and stopping policy; temperature == 0.0 is greedy."""

    max_new_tokens: int = 256
    temperature: float = 0.8
    top_p: Optional[float] = 0.95
    top_k: Optional[int] = None
    stop_tokens: Tuple[int, ...] = ()
    pad_id: int = 0
    # Prefill in chunks of this many tokens (None = one forward).
    prefill_chunk: Optional[int] = None


def next_pow2(n: int) -> int:
    """Length bucket: a power of two >= n, at least 2."""
    return 1 << max(n - 1, 1).bit_length()


def prompt_positions(prompt_mask: torch.Tensor) -> torch.Tensor:
    """Left-padded prompt mask [B, P] (bool) -> positions [B, P] int32,
    -1 on padding."""
    pos = torch.cumsum(prompt_mask.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    return torch.where(prompt_mask, pos, torch.full_like(pos, -1))


def _is_stop(tokens: torch.Tensor, stop_tokens: Tuple[int, ...]) -> torch.Tensor:
    if not stop_tokens:
        return torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    stops = torch.tensor(stop_tokens, dtype=tokens.dtype, device=tokens.device)
    return torch.any(tokens[..., None] == stops, dim=-1)


@torch.inference_mode()
def generate(
    params,
    prompt_tokens: torch.Tensor,
    prompt_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    config: LLaMAConfig,
    gen_config: GenerationConfig,
    device="cuda",
) -> torch.Tensor:
    """Generate up to ``max_new_tokens`` per row.

    Args:
      params: model params on ``device``.
      prompt_tokens: [B, P] integer, left-padded.
      prompt_mask: [B, P] bool, False on padding.
      generator: torch.Generator on ``device``; required unless greedy.
      device: where the model runs; "cuda" (the default) raises when no
        GPU is present.
    Returns:
      [B, P + max_new_tokens] int32 on ``device``: the prompt (padding
      kept) then the generated tokens; pad_id after a row's stop token.
    """
    device = resolve_device(device)
    if _params_device(params).type != device.type:
        raise ValueError(
            f"params live on {_params_device(params)}, generate was asked "
            f"to run on {device}"
        )
    gc = gen_config
    if gc.temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature != 0) needs a generator")
    prompt_tokens = prompt_tokens.to(device=device, dtype=torch.int32)
    prompt_mask = prompt_mask.to(device=device, dtype=torch.bool)
    B, P = prompt_tokens.shape
    total = P + gc.max_new_tokens
    positions = prompt_positions(prompt_mask)
    prompt_lens = prompt_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)

    cache = init_cache(config, B, max_len=total, device=device)
    chunk = gc.prefill_chunk
    if chunk is not None and chunk < P:
        for start in range(0, P, chunk):
            end = min(start + chunk, P)
            logits, cache = forward(
                params, prompt_tokens[:, start:end], positions[:, start:end],
                config, cache=cache, attn_mask=prompt_mask[:, start:end],
                compute_logits=end >= P,
            )
    else:
        logits, cache = forward(
            params, prompt_tokens, positions, config, cache=cache,
            attn_mask=prompt_mask,
        )
    next_tok = sample(generator, logits[:, -1], gc.temperature, gc.top_p, gc.top_k)

    buf = torch.full((B, total), gc.pad_id, dtype=torch.int32, device=device)
    buf[:, :P] = prompt_tokens
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    ones = torch.ones((B, 1), dtype=torch.bool, device=device)
    pad = torch.full_like(next_tok, gc.pad_id)
    step = 0
    while step < gc.max_new_tokens and not bool(done.all()):
        tok = torch.where(done, pad, next_tok)
        buf[:, P + step] = tok
        done = done | _is_stop(next_tok, gc.stop_tokens)
        pos = (prompt_lens + step)[:, None]
        logits, cache = forward(
            params, tok[:, None], pos, config, cache=cache, attn_mask=ones,
        )
        next_tok = sample(
            generator, logits[:, -1], gc.temperature, gc.top_p, gc.top_k
        )
        step += 1
    return buf
