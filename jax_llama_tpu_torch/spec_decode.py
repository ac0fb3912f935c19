"""Speculative decoding: a draft model proposes, the target verifies the
whole block in one forward (port of ``jax_llama_tpu/spec_decode.py``).

Greedy verification (temperature 0) is exact: the emitted sequence equals
plain greedy decode of the target token for token, whatever the draft;
the draft only sets the acceptance rate.  Sampled verification is
Leviathan-style rejection sampling and draws from exactly the target's
warped distribution.

As in the JAX package, masking is positional: rejected draft slots are
marked ``pos = -1`` after verification, never rolled back.  The JAX
``lax.while_loop`` is a Python loop with the same exit.

Randomness: one ``torch.Generator`` per call (the JAX package splits a
threefry key).  Each round draws, in this order, the n_draft draft tokens,
the n_draft acceptance uniforms and the one replacement/bonus token; the
serving batcher draws a sampled row's tokens from its own generator in the
same order, so a batcher row emits what a B=1 ``generate_speculative``
seeded alike emits.  The draws differ from JAX's; the distribution they
are drawn from is the same.

The shared rules (``draft_categorical``, ``leviathan_verify``,
``place_extra``, ``accepted_emit_counts``) serve both this engine and
``serving._spec_round_core``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import LLaMAConfig
from .engine import GenerationConfig, _is_stop, prompt_positions
from .models.llama import _params_device, forward, init_cache, resolve_device
from .ops.sampling import categorical, greedy, sample, warped_probs


def draft_categorical(
    generator: Optional[torch.Generator], probs: torch.Tensor
) -> torch.Tensor:
    """One categorical draw per row from post-warp probabilities [..., V]
    (the draft proposal and the replacement/bonus draw).  Warped-out
    tokens (probability 0) are never drawn.  A row that is not a
    distribution (non-finite, or no mass: its logits were NaN/Inf, and
    the non-finite guard fails it) draws from the uniform instead of
    raising, so one bad row cannot stop the batch."""
    flat = probs.reshape(-1, probs.shape[-1]).float()
    ok = (torch.isfinite(flat).all(dim=-1, keepdim=True)
          & (flat.sum(dim=-1, keepdim=True) > 0))
    flat = torch.where(ok, flat, 1.0)
    out = categorical(flat, generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)


def leviathan_verify(
    pprobs: torch.Tensor, qprobs: torch.Tensor, drafts: torch.Tensor,
    u: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Leviathan-style rejection of a drafted block (JAX :159).

    pprobs: [B, G+1, V] post-warp target distributions (position j is the
      one draft j+1 is checked against; position G is the bonus).
    qprobs: [B, G, V] post-warp draft distributions.
    drafts: [B, G] proposed tokens.  u: [B, G] uniforms.

    Draft ``d ~ q`` is accepted iff ``u * q(d) < p(d)``; ``acc`` is the
    length of the accepted prefix.  Returns (acc [B] int32, dist [B, V]):
    the residual ``relu(p - q)`` (unnormalized) at the first rejection,
    or the bonus ``p_G`` on full acceptance; a residual with no mass
    (p <= q everywhere, reachable only by rounding) falls back to p."""
    G = drafts.shape[1]
    d = drafts.long()[..., None]
    p_d = torch.gather(pprobs[:, :G], -1, d)[..., 0]
    q_d = torch.gather(qprobs, -1, d)[..., 0]
    accept = u * q_d < p_d
    acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    resid = (pprobs[:, :G] - qprobs).clamp(min=0.0)
    cand = torch.cat([resid, pprobs[:, G:]], dim=1)
    at = acc.long()[:, None, None].expand(-1, 1, pprobs.shape[-1])
    dist = torch.gather(cand, 1, at)[:, 0]
    p_at = torch.gather(pprobs, 1, at)[:, 0]
    dist = torch.where(dist.sum(dim=-1, keepdim=True) > 1e-12, dist, p_at)
    return acc.to(torch.int32), dist


def place_extra(
    drafts: torch.Tensor, acc: torch.Tensor, extra: torch.Tensor
) -> torch.Tensor:
    """Emitted block [B, G+1]: accepted drafts at offsets j < acc, the
    replacement/bonus token at offset acc (later offsets are dead)."""
    B = drafts.shape[0]
    outs = torch.cat([drafts.to(torch.int32),
                      torch.zeros((B, 1), dtype=torch.int32,
                                  device=drafts.device)], dim=1)
    outs[torch.arange(B, device=drafts.device), acc.long()] = extra.to(
        torch.int32)
    return outs


def accepted_emit_counts(
    acc: torch.Tensor, stop_hits: torch.Tensor, remaining: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """How many of a round's accepted tokens the host's emit scan would
    deliver (JAX :203), so the fused R-round chunk can finish a slot
    mid-chunk on the device.

    acc: [B] accepted-prefix lengths (>= 0); stop_hits: [B, G] stop-set
    membership of the round's ``outs[:, :G]``; remaining: [B] budget after
    the round's pending-token emit.  Returns (e [B], done [B]): tokens
    ``outs[0..e-1]`` are emitted (``e == acc``, or ``first + 1`` when token
    ``first`` hits a stop or spends the budget) and ``done`` marks rows
    whose request finished inside the prefix."""
    G = stop_hits.shape[1]
    i = torch.arange(G, device=acc.device, dtype=torch.int32)[None, :]
    cand = i < acc[:, None]
    done_at = cand & (stop_hits | ((i + 1) >= remaining[:, None]))
    done = done_at.any(dim=1)
    first = done_at.to(torch.int32).argmax(dim=1).to(torch.int32)
    return torch.where(done, first + 1, acc.to(torch.int32)), done


@torch.inference_mode()
def generate_speculative(
    target_params,
    draft_params,
    prompt_tokens: torch.Tensor,
    prompt_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    target_config: LLaMAConfig,
    draft_config: LLaMAConfig,
    gen_config: GenerationConfig,
    n_draft: int = 4,
    device="cuda",
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative decode, greedy or sampled verification (JAX :64).

    temperature == 0.0: the output equals plain greedy decode of the
    target.  temperature > 0: draft ``d ~ q`` is accepted with probability
    ``min(1, p(d)/q(d))``; a rejection draws from ``norm(relu(p - q))``; a
    fully accepted round draws a bonus token from ``p``.  p and q carry
    the same temperature/top-p/top-k warp as ``ops.sampling.sample``.

    Each round drafts with T = 1 steps over the draft's contiguous cache,
    lands the last draft's KV with one more step, and verifies with one
    T = n_draft + 1 forward over the target's cache (``attn_impl="auto"``
    takes the plain ``sdpa_cached`` there up to T = 8).

    Args:
      target_params / draft_params: models sharing the vocabulary.
      prompt_tokens: [B, P] integer, left-padded; prompt_mask [B, P] bool.
      generator: torch.Generator on ``device``; required when sampling.
      n_draft: draft tokens proposed per round (>= 1).
      device: where the models run; "cuda" (the default) raises when no
        GPU is present.
      mesh: a ``parallel.Mesh`` when both trees are this rank's shards
        (``engine.generate``'s contract; an ambient mesh without
        ``mesh=`` is refused, JAX :111-124).
    Returns:
      (tokens [B, P + max_new_tokens] int32, the prompt then the generated
       tokens, pad_id after a row's stop token; accept_counts [B] int32,
       accepted draft tokens per row).
    """
    device = resolve_device(device)
    for name, p in (("target_params", target_params),
                    ("draft_params", draft_params)):
        if _params_device(p).type != device.type:
            raise ValueError(f"{name} live on {_params_device(p)}, "
                             f"generate_speculative was asked to run on "
                             f"{device}")
    gc = gen_config
    if gc.temperature != 0.0 and generator is None:
        raise ValueError(
            "generate_speculative: a generator is required when "
            "temperature > 0")
    if n_draft < 1:
        raise ValueError("n_draft must be >= 1")
    if target_config.vocab_size != draft_config.vocab_size:
        raise ValueError("target and draft must share a vocabulary")
    from .engine import _mesh_scope

    with _mesh_scope("generate_speculative", mesh):
        return _spec_impl(
            target_params, draft_params,
            prompt_tokens.to(device=device, dtype=torch.int32),
            prompt_mask.to(device=device, dtype=torch.bool), generator,
            target_config, draft_config, gc, n_draft)


def _spec_impl(tp, dp, prompt_tokens, prompt_mask, generator, tc, dc, gc, G):
    """The round loop of ``generate_speculative`` (JAX ``_spec_impl``)."""
    B, P = prompt_tokens.shape
    N = gc.max_new_tokens
    total = P + N
    dev = prompt_tokens.device
    positions = prompt_positions(prompt_mask)
    prompt_lens = prompt_mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    # Worst case: every round accepts nothing, N rounds of G+1 slots.
    t_cache = init_cache(tc, B, max_len=P + N * (G + 1), device=dev)
    d_cache = init_cache(dc, B, max_len=P + N * (G + 1), device=dev)
    sampled = gc.temperature != 0.0
    t_logits, t_cache = forward(tp, prompt_tokens, positions, tc,
                                cache=t_cache, attn_mask=prompt_mask)
    forward(dp, prompt_tokens, positions, dc, cache=d_cache,
            attn_mask=prompt_mask, compute_logits=False)
    tau = sample(generator, t_logits[:, -1], gc.temperature, gc.top_p,
                 gc.top_k)

    # One spare column past the end takes the writes a row does not emit.
    buf = torch.full((B, total + 1), gc.pad_id, dtype=torch.int32,
                     device=dev)
    buf[:, :P] = prompt_tokens
    buf[:, P] = torch.where(prompt_lens > 0, tau, gc.pad_id)
    done = _is_stop(tau, gc.stop_tokens)
    count = torch.ones((B,), dtype=torch.int32, device=dev)
    accepted_total = torch.zeros((B,), dtype=torch.int32, device=dev)
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    j = torch.arange(G + 1, dtype=torch.int32, device=dev)[None, :]

    rnd = 0
    while rnd < N and not bool((done | (count >= N)).all()):
        p = prompt_lens + count - 1  # tau's position per row

        # 1. the draft proposes G tokens, one T=1 step each
        tok, drafts, qprobs = tau, [], []
        for i in range(G):
            lg, _ = forward(dp, tok[:, None], (p + i)[:, None], dc,
                            cache=d_cache, attn_mask=ones)
            if sampled:
                q = warped_probs(lg[:, -1], gc.temperature, gc.top_p,
                                 gc.top_k)
                tok = draft_categorical(generator, q)
                qprobs.append(q)
            else:
                tok = greedy(lg[:, -1])
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)  # [B, G]
        # Land d_G's KV too: on a fully accepted round the next tau is the
        # bonus token at p+G+1, and p+G must not stay a hole.
        forward(dp, tok[:, None], (p + G)[:, None], dc, cache=d_cache,
                attn_mask=ones, compute_logits=False)

        # 2. one target pass over [tau, d_1 .. d_G]
        block = torch.cat([tau[:, None], drafts], dim=1)
        block_pos = p[:, None] + j
        t_idx = t_cache.index
        t_logits, _ = forward(tp, block, block_pos, tc, cache=t_cache,
                              attn_mask=ones.expand(B, G + 1))

        # 3. verification
        if sampled:
            pprobs = warped_probs(t_logits, gc.temperature, gc.top_p,
                                  gc.top_k)
            u = torch.rand((B, G), generator=generator, device=dev)
            acc, dist = leviathan_verify(pprobs, torch.stack(qprobs, 1),
                                         drafts, u)
            outs = place_extra(drafts, acc, draft_categorical(generator,
                                                              dist))
        else:
            outs = greedy(t_logits)  # outs[:, j] follows block[:, j]
            acc = torch.cumprod((drafts == outs[:, :G]).to(torch.int32),
                                dim=1).sum(dim=1, dtype=torch.int32)

        # 4. emit outs[:, :acc+1] up to a stop token or the budget
        stop = _is_stop(outs, gc.stop_tokens).to(torch.int32)
        stopped_before = (torch.cumsum(stop, dim=1) - stop) > 0
        emit = ((j <= acc[:, None]) & ~stopped_before & ~done[:, None]
                & ((count[:, None] + j) < N))
        cols = torch.where(emit, P + count[:, None] + j, total)
        buf.scatter_(1, cols.long(), torch.where(emit, outs, gc.pad_id))
        n_emit = emit.sum(dim=1, dtype=torch.int32)
        last = (n_emit - 1).clamp(min=0).long()[:, None]
        tau = torch.where(n_emit > 0, torch.gather(outs, 1, last)[:, 0], tau)
        count = count + n_emit
        done = done | (stop.bool() & emit).any(dim=1) | (count >= N)
        accepted_total += torch.minimum(acc, (n_emit - 1).clamp(min=0))

        # 5. invalidate rejected slots (positional masking, no rollback):
        # slot j of the target's G+1 (tau, d_1..d_G) and of the draft's
        # (tau, d_1..d_G at p..p+G) stays valid iff j <= acc.
        valid = j <= acc[:, None]
        t_cache.pos[:, t_idx:t_idx + G + 1] = torch.where(valid, block_pos,
                                                          -1)
        d_idx = d_cache.index - (G + 1)
        d_cache.pos[:, d_idx:d_idx + G + 1] = torch.where(
            valid, p[:, None] + j, -1)
        rnd += 1
    return buf[:, :total], accepted_total
