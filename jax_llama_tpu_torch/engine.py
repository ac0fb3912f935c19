"""Autoregressive decode engine (port of ``jax_llama_tpu/engine.py``).

Prompts arrive left-padded to a common length P with a boolean mask.  The
engine prefills them (in one forward, or in ``prefill_chunk``-sized
chunks whose non-final chunks skip the LM head), then decodes one token
per step.  A stop token is written to the buffer, then the row emits
``pad_id``.  As in the JAX engine, the last step's forward runs even
though its token is discarded.

JAX jits ``generate`` as one program whose decode loop is a
``lax.while_loop`` on the device.  The port runs it as two programs
(``utils.programs``): ``generate`` (JAX's name and key: the prefill and
the first sample) and ``_generate_step`` (the loop's body: the buffer
write at the cache's device write index ``P + step``, the stop test, the
T = 1 forward and the sample), and a host loop that calls the step at
most ``max_new_tokens`` times.  The host reads whether every row is done
once every ``DONE_EVERY`` steps, not once a step: a row that is done
emits ``pad_id``, so the steps past the last stop change nothing in the
buffer, which is the eager loop's and JAX's.  On the card each call owns
a ``GraphStore``: both programs are captured as CUDA graphs (a key this
process has run before is captured and replayed at once) and the step
is replayed, so a step costs one graph launch instead of some thousand
kernel launches; the store is closed when the call returns.  A call on a
mesh whose collectives go through the host (``mesh.backend == "gloo"``)
runs the same programs eagerly.  ``score`` is one program, ``score``, and
one graph on the card.

``score`` gives per-token log-probabilities of given sequences, and
``window_positions`` the positions of one window of a chunked prefill
(the serving batcher's fused prefill lane).

``generate`` and ``score`` take ``mesh=`` (a ``parallel.Mesh``): every
rank passes the same global prompts with its own weight shard and gets
the same global result.  An ambient ``parallel.use_mesh`` without
``mesh=`` is refused, as in the JAX package, so that a call never runs on
a mesh it was not given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .config import LLaMAConfig
from .models.llama import _params_device, forward, init_cache, resolve_device
from .ops.sampling import sample
from .parallel.mesh import current_mesh, use_mesh
from .utils.programs import GraphStore, program, use_graphs

# Decode steps between two host reads of ``done`` in ``generate``.
DONE_EVERY = 8


def _mesh_scope(fn_name: str, mesh):
    """``use_mesh(mesh)``, refusing an ambient mesh that the call was not
    given (JAX ``engine.py:79-83``, ``:193-201``)."""
    if mesh is None and current_mesh() is not None:
        raise ValueError(
            f"{fn_name}: pass mesh= explicitly; an ambient use_mesh(...) "
            "context is not taken as the call's mesh")
    return use_mesh(mesh)


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


def window_positions(base, offset, width: int, length, device=None):
    """Positions and mask of one window of a chunked prefill (JAX
    :122), the fused prefill-decode scheduler's walk: tokens ``[offset,
    offset + width)`` of a ``length``-token suffix whose row KV begins at
    absolute position ``base`` (non-zero for a prefix-cache hit, which
    starts its walk at fill0).  ``base``, ``offset`` and ``length`` are
    ints or int32 scalars; with ints the result is made on ``device``
    (no host copy).  Returns ([1, width] int32 positions, -1 on
    padding; [1, width] bool mask), the ``prompt_positions`` contract for
    a window of a longer right-padded prompt."""
    if isinstance(base, torch.Tensor):
        device = base.device
    elif isinstance(offset, torch.Tensor):
        device = offset.device
    j = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    real = (offset + j) < length
    pos = torch.where(real, base + offset + j, -1).to(torch.int32)
    return pos, real


def _call_graphs(device: torch.device, mesh) -> Optional[GraphStore]:
    """The graph store one ``generate``/``score`` call owns: on the card,
    unless ``mesh``'s collectives go through the host (gloo), which no
    graph can hold (decided from ``mesh.backend``, never by catching an
    error); None runs the programs eagerly."""
    if device.type != "cuda" or (mesh is not None
                                 and mesh.backend == "gloo"):
        return None
    return GraphStore(device, capture_first=True)


@torch.inference_mode()
def score(params, tokens: torch.Tensor,
          attn_mask: Optional[torch.Tensor] = None, *,
          config: LLaMAConfig, mesh=None) -> torch.Tensor:
    """Per-token log-probabilities of given sequences (evals, perplexity;
    JAX :60).

    Args:
      params: model params; the forward runs where they live.
      tokens: [B, T] integer; position t is scored against tokens[t+1].
      attn_mask: optional [B, T] bool, False on (left) padding.
    Returns:
      [B, T-1] float32: logp[b, t] = log p(tokens[b, t+1] | tokens[b,
      :t+1]) from a float32 log-softmax of the forward's logits; 0 where
      the query or the target is padding.  The forward resolves
      ``config.attn_impl`` as any forward does ("auto": the flash kernel
      at T > 8).  On the card the program runs as one CUDA graph of this
      call's own."""
    with _mesh_scope("score", mesh):
        device = _params_device(params)
        tokens = tokens.to(device=device, dtype=torch.int32)
        if attn_mask is not None:
            attn_mask = attn_mask.to(device=device, dtype=torch.bool)
        store = _call_graphs(device, mesh)
        try:
            with use_graphs(store):
                # audit: trace-domain(keyed by the caller's config and
                # shapes, as JAX's jit keys score)
                out = _score(params, tokens, attn_mask, config=config)
            # The graph's output goes with the store: keep a copy.
            return out if store is None else out.clone()
        finally:
            if store is not None:
                store.close()


@program("score", static=("config",), graph=True)
@torch.inference_mode()
def _score(params, tokens, attn_mask, *, config):
    """``score``'s program (JAX's ``score``, keyed by ``config`` and the
    shapes): ``tokens`` [B, T] int32 and ``attn_mask`` ([B, T] bool or
    None) on the params' device."""
    B, T = tokens.shape
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    positions = prompt_positions(attn_mask)
    logits, _ = forward(params, tokens, positions, config,
                        attn_mask=attn_mask)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    out = torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    valid = attn_mask[:, :-1] & attn_mask[:, 1:]
    return torch.where(valid, out, 0.0)


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
    mesh=None,
) -> torch.Tensor:
    """Generate up to ``max_new_tokens`` per row.

    Args:
      params: model params on ``device``.
      prompt_tokens: [B, P] integer, left-padded.
      prompt_mask: [B, P] bool, False on padding.
      generator: torch.Generator on ``device``; required unless greedy.
        The prefill's sample and each step's draw from it as the eager
        loop did (a graph registers it and advances it on replay).
      device: where the model runs; "cuda" (the default) raises when no
        GPU is present.
      mesh: a ``parallel.Mesh`` when ``params`` is this rank's shard
        (``parallel.shard_params``); every rank passes the same prompts
        and generator seed and gets the same tokens.
    Returns:
      [B, P + max_new_tokens] int32 on ``device``: the prompt (padding
      kept) then the generated tokens; pad_id after a row's stop token.
    """
    with _mesh_scope("generate", mesh):
        return _generate(params, prompt_tokens, prompt_mask, generator,
                         config, gen_config, device, mesh)


def _generate(params, prompt_tokens, prompt_mask, generator, config,
              gen_config, device, mesh):
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
    # The decode state, made here and updated in place by the programs
    # (so that no graph's output is held across another's replay): the
    # cache with its device write index, the buffer, the pending token,
    # the done flags, the prompt lengths and the stop tokens.
    cache = init_cache(config, B, max_len=total, device=device)
    cache.index = torch.zeros((), dtype=torch.int32, device=device)
    buf = torch.full((B, total), gc.pad_id, dtype=torch.int32, device=device)
    next_tok = torch.zeros((B,), dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    prompt_lens = prompt_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    stops = (torch.tensor(gc.stop_tokens, dtype=torch.int32, device=device)
             if gc.stop_tokens else None)
    store = _call_graphs(device, mesh)
    try:
        with use_graphs(store):
            # audit: trace-domain(keyed by the caller's config, gen_config
            # and shapes, as JAX's jit keys generate)
            _generate_prefill(params, prompt_tokens, prompt_mask, generator,
                              cache, buf, next_tok, config=config,
                              gen_config=gc)
            for step in range(gc.max_new_tokens):
                # audit: host-fetch(whether every row is done, read once
                # every DONE_EVERY steps: the loop's early exit)
                if step and step % DONE_EVERY == 0 and bool(done.all()):
                    break
                # audit: trace-domain(keyed as generate is)
                _generate_step(params, cache, buf, next_tok, done,
                               prompt_lens, stops, generator, config=config,
                               gen_config=gc)
    finally:
        if store is not None:
            store.close()
    return buf


@program("generate", static=("config", "gen_config"),
         donate=("cache", "buf", "next_tok"), graph=True)
@torch.inference_mode()
def _generate_prefill(params, prompt_tokens, prompt_mask, generator, cache,
                      buf, next_tok, *, config, gen_config):
    """``generate``'s first program (JAX's ``generate``, keyed as JAX
    keys it: ``config``, ``gen_config`` and the shapes): the prompt into
    ``buf``, the prefill into ``cache`` from its device index (0), the
    first token into ``next_tok``; all in place.  ``prompt_tokens`` [B,
    P] int32 and ``prompt_mask`` [B, P] bool on the params' device."""
    gc = gen_config
    P = prompt_tokens.shape[1]
    buf[:, :P] = prompt_tokens
    positions = prompt_positions(prompt_mask)
    view = dataclasses.replace(cache)
    chunk = gc.prefill_chunk
    if chunk is not None and chunk < P:
        for start in range(0, P, chunk):
            end = min(start + chunk, P)
            logits, view = forward(
                params, prompt_tokens[:, start:end], positions[:, start:end],
                config, cache=view, attn_mask=prompt_mask[:, start:end],
                compute_logits=end >= P,
            )
    else:
        logits, view = forward(
            params, prompt_tokens, positions, config, cache=view,
            attn_mask=prompt_mask,
        )
    cache.index.copy_(view.index)
    next_tok.copy_(sample(generator, logits[:, -1], gc.temperature, gc.top_p,
                          gc.top_k))


@program("_generate_step", static=("config", "gen_config"),
         donate=("cache", "buf", "next_tok", "done"), graph=True)
@torch.inference_mode()
def _generate_step(params, cache, buf, next_tok, done, prompt_lens, stops,
                   generator, *, config, gen_config):
    """One iteration of ``generate``'s decode loop (the body of JAX's
    ``lax.while_loop``, :278), in place: emit the pending token (``pad_id``
    for a row already done) into column ``cache.index`` = P + step of
    ``buf``, fold stop tokens into ``done``, run the T = 1 forward at the
    cache's device index (which advances by one) and sample the next
    token.  Nothing is read on the host.  ``stops`` is the stop tokens'
    int32 vector (None without any)."""
    gc = gen_config
    B = buf.shape[0]
    P = buf.shape[1] - gc.max_new_tokens
    col = cache.index.long().view(1)
    tok = torch.where(done, gc.pad_id, next_tok).to(torch.int32)
    buf.index_copy_(1, col, tok[:, None])
    if stops is not None:
        done |= torch.any(next_tok[:, None] == stops, dim=-1)
    pos = (prompt_lens + (cache.index - P))[:, None]
    view = dataclasses.replace(cache)
    logits, view = forward(
        params, tok[:, None], pos, config, cache=view,
        attn_mask=torch.ones((B, 1), dtype=torch.bool, device=buf.device),
    )
    cache.index.copy_(view.index)
    next_tok.copy_(sample(generator, logits[:, -1], gc.temperature, gc.top_p,
                          gc.top_k))
