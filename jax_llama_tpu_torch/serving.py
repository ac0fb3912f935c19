"""Continuous batching over a paged (block-table) KV cache (port of
``jax_llama_tpu/serving.py`` at its greedy/sampled core and its
speculative path).

Requests enter and leave a fixed set of ``n_slots`` rows independently.
KV lives in a pool of fixed-size blocks, ``[L, KVH, n_blocks, block_size,
hd]``; each row holds a block table.  Admission reserves the blocks a
request can ever need (``ceil((padded prompt + max_new) / block_size)``),
completion frees them, and a request whose reservation does not fit waits
in the queue.

* Admission (``_paged_insert``): a burst of queued requests prefills as one
  right-padded ``[k', P]`` forward (``attn_impl="auto"`` runs the flash
  kernel) into a fresh scalar-index ``KVCache``, whose blocks are then
  copied into each row's reserved pool blocks.  The first token is sampled
  from each row's last real token.  With a draft model the draft pool is
  prefilled over the same blocks (its sampled tokens are discarded).
* Decode (``_chunk_scan``): up to ``decode_chunk`` iterations per
  ``step()``, a Python loop over device tensors.  Each iteration emits the
  pending token, detects stop tokens and spent budgets on the device, then
  runs one ``[n_slots, 1]`` forward over the pool: ``paged_forward``, whose
  attention is the hand-written paged kernel at any block size, or, only
  when asked for with ``use_pallas_kernel=False`` /
  ``decode_kernel="gathered"``, the gathered view (``_gather_cache`` +
  ``_scatter_back``).  The host fetches the ``[B, K]`` token block once
  per step.
* Speculative decode (``draft_params``; ``_spec_round_core``): each round
  the draft proposes ``n_draft`` tokens by replaying the growing block
  through one ``[n_slots, n_draft + 1]`` forward per token over its pool,
  one more pass lands the block's draft KV, and the target verifies the
  block in one forward; every one of these runs the paged kernel at
  T = n_draft + 1.  Greedy rows accept the matching prefix, sampled rows
  run Leviathan rejection sampling (``spec_decode``).  ``spec_rounds`` > 1
  runs up to that many rounds per ``step()`` with one packed fetch
  (``_spec_rounds_chunk``), token-identical to ``spec_rounds=1``.
* Per-row decode state (table, n_alloc, fill, pos, active, remaining, stop
  sets, sampling policies) lives on the device.  Admission, frees and
  cancels mark rows dirty, and one packed upload syncs those rows before
  the next step, so a steady-state step uploads nothing and fetches once.
* Sampling: each sampled request owns a ``torch.Generator`` on the
  batcher's device, seeded with its ``seed`` or ``default_seed(rid)``, and
  emits what ``engine.generate`` at B=1 with that generator emits; under
  speculation, what ``spec_decode.generate_speculative`` at B=1 emits.

* int8 (``config.kv_cache_dtype == "int8"``, target and draft alike):
  the pool holds int8 K/V with float32 per-slot-per-head scale planes,
  which the inserts fill (``flash_attention_quantized`` in the prefill)
  and the paged kernel and the gathered view fold; quantized weights
  (``quantize_params``) need nothing of the batcher.
* The paged kernel holds up to ``MAX_GROUP`` query heads per KV head; a
  target or draft with more decodes through the gathered view, decided
  at construction (the JAX ``_spec_kernel_ok``).
* Kernel selection (``ops.kernels``): ``prefill_kernel`` and
  ``decode_kernel`` (constructor arguments over the config's fields)
  resolve once, at construction, and the resolved names are baked into
  ``self.config`` and ``self.draft_config``.  ``"splash"`` runs the
  splash kernel on every insert chunk that ``splash_eligible`` accepts
  (the insert passes its chunk offset); ``"stock-paged"`` runs the
  stock-paged kernel on every T = 1 decode step over a full-precision
  pool (a speculative round's forwards are T = n_draft + 1, so they keep
  the paged kernel); ``"gathered"`` is the gathered view.

* The serving layers (``server.LLMServer`` reads them): every batcher
  owns an ``obs.Observability`` sink (built here unless one is passed,
  and handed on through ``rebuild()``), which records each request's
  spans and each dispatch (kind, K, occupancy, wall and fetch ms, and
  with ``cost_models=True`` its ``obs.CostModel`` FLOPs and bytes; an
  insert on the card, which no fetch ends, is timed between CUDA events
  and recorded after the next fetch).  A
  ``faults.FaultInjector`` fires its sites just before the operation
  they name (``_fault``); ``last_dispatch_features`` names the
  degradable features (``degrade.FEATURES``) the most recent dispatch
  runs, so the server can attribute a failure, and
  ``last_step_features`` the union over one ``step()``.  A request whose
  logits come back non-finite is failed alone through ``pop_failed``;
  an armed ``nan`` fault poisons the first active row the same way.

Not in this slice; each raises ``NotImplementedError`` at construction,
naming its ROADMAP item: meshes (A14), logprobs (A17), fused
prefill-decode (A9), the prefix cache and host tier (A11).  Because the
prefix cache is out, the port's defaults are ``prefix_cache=False`` and
``prefix_index="off"``; the JAX package's are ``True`` and ``"radix"``.
``stats()`` reports those features' counters at the values the JAX
package reports with them off.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import obs as _obs_mod
from .config import LLaMAConfig
from .engine import prompt_positions
from .faults import FaultInjector
from .models.llama import (
    FLASH_MIN_SEQ,
    KVCache,
    PagedKVCache,
    _cache_write,
    _params_device,
    forward,
    init_cache,
    lm_head_logits,
    paged_forward,
    paged_pool_write,
    paged_write_indices,
    resolve_device,
)
from .ops.attention import NEG_INF
from .obs import CostModel, Observability
from .ops.kernels import (
    DECODE_KERNELS,
    PREFILL_KERNELS,
    KernelSpec,
    resolve_decode_kernel,
    resolve_prefill_kernel,
    splash_eligible,
)
from .ops.paged_attention import MAX_GROUP
from .ops.sampling import greedy, stop_token_hits
from .spec_decode import (
    accepted_emit_counts,
    draft_categorical,
    leviathan_verify,
    place_extra,
)

# "No token emitted this chunk column" marker in the [B, K] token block
# (the row was already inactive).  Distinct from the -1 non-finite
# sentinel: real tokens are never negative.
_CHUNK_PAD = -2


# The serving mesh's shape as the JAX package reports an unsharded batcher
# (``parallel.serve_mesh.mesh_shape(None)``); the port has no mesh until
# ROADMAP A14.
SERVE_MESH = {"data": 1, "tensor": 1, "devices": 1}


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockPool:
    """Paged KV storage shared by all slots.

    k, v: [L, KVH, n_blocks, block_size, hd] in the activation dtype (or
          int8), KV-head-major (the paged kernel's layout).
    pos:  [n_blocks, block_size] int32 absolute position per slot; -1
          marks a slot that holds nothing (free block / unwritten).
    k_scale, v_scale: [L, KVH, n_blocks, block_size] float32 (int8 pool
          only).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def n_blocks(self) -> int:
        return self.k.shape[2]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def paged(self, table: torch.Tensor, fill: torch.Tensor) -> PagedKVCache:
        """The pool as ``paged_forward`` reads it, under a block table."""
        return PagedKVCache(self.k, self.v, self.pos, table, fill,
                            self.k_scale, self.v_scale)


def init_pool(
    config: LLaMAConfig, n_blocks: int, block_size: int, device="cuda"
) -> BlockPool:
    """An empty pool: int8 payload and zero scale planes when
    ``config.kv_cache_dtype == "int8"`` (JAX :263-284)."""
    config.validate()
    device = resolve_device(device)
    int8_kv = config.kv_cache_dtype == "int8"
    shape = (config.n_layers, config.kv_heads, n_blocks, block_size,
             config.head_dim)
    dtype = torch.int8 if int8_kv else config.activation_dtype

    def scales():
        return (torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                if int8_kv else None)

    return BlockPool(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((n_blocks, block_size), -1, dtype=torch.int32,
                       device=device),
        k_scale=scales(), v_scale=scales(),
    )


def _gather_cache(
    pool: BlockPool,
    table: torch.Tensor,     # [B, MB] int32 physical block ids (NB = unused)
    n_alloc: torch.Tensor,   # [B] int32 allocated blocks per row
    fill: torch.Tensor,      # [B] int32 per-row write offset (tokens)
) -> KVCache:
    """Materialize the per-row virtually-contiguous cache view (a copy),
    with the scale planes of an int8 pool.  Sentinel table entries gather
    block NB-1; their positions are forced to -1 through n_alloc, so that
    data is never attended."""
    L, KVH, NB, BLK = pool.k.shape[:4]
    B, MB = table.shape
    blk = table.long().clamp(0, NB - 1)

    def g(a):  # [L, KVH, NB, BLK, ...] -> [L, B, MB*BLK, KVH, ...]
        out = a[:, :, blk].reshape(L, KVH, B, MB * BLK, *a.shape[4:])
        return out.movedim(1, 3).contiguous()

    valid = torch.arange(MB, device=table.device)[None, :] < n_alloc[:, None]
    posg = torch.where(valid[:, :, None], pool.pos[blk], -1)
    return KVCache(k=g(pool.k), v=g(pool.v), pos=posg.reshape(B, MB * BLK),
                   index=fill,
                   k_scale=g(pool.k_scale) if pool.quantized else None,
                   v_scale=g(pool.v_scale) if pool.quantized else None)


def _scatter_back(
    pool: BlockPool,
    view: KVCache,
    table: torch.Tensor,
    fill: torch.Tensor,
    active: torch.Tensor,
    T: int,
) -> None:
    """Write the T new entries per row of the gathered view back into their
    physical blocks, in place.  Inactive rows and out-of-reservation
    columns resolve to the sentinel block id and are dropped."""
    NB, BLK = pool.pos.shape
    rows = torch.arange(table.shape[0], device=table.device)[:, None]
    blk, off, cols = paged_write_indices(table, fill, active, T, NB, BLK)
    # view slices are [L, B, T, KVH, ...]; the pool wants KVH-major.
    planes = [(pool.k, view.k), (pool.v, view.v)]
    if pool.quantized:
        planes += [(pool.k_scale, view.k_scale), (pool.v_scale, view.v_scale)]
    for plane, vplane in planes:
        paged_pool_write(plane, vplane[:, rows, cols].movedim(3, 1), blk, off)
    paged_pool_write(pool.pos, view.pos[rows, cols], blk, off)


# ---------------------------------------------------------------------------
# Per-row sampling (per-row policies)
# ---------------------------------------------------------------------------

def _warp_rows(
    logits: torch.Tensor,       # [B, V] or [B, T, V]
    temperature: torch.Tensor,  # [B] float32 (> 0 rows meaningful)
    top_p: torch.Tensor,        # [B] float32; 1.0 = off
    top_k: torch.Tensor,        # [B] int32; 0 (or V) = off
) -> torch.Tensor:
    """Per-row warped logits: scale by temperature, threshold at the k-th
    largest, nucleus threshold; row-wise the same as ``ops.sampling``'s
    static filters."""
    V = logits.shape[-1]
    lg = logits.float()
    bshape = (logits.shape[0],) + (1,) * (lg.dim() - 1)
    t = temperature.float().clamp(min=1e-6).reshape(bshape)
    scaled = lg / t
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, V, top_k).clamp(1, V).reshape(bshape)
    kth = torch.gather(
        sorted_desc, -1, (k - 1).long().expand(lg.shape[:-1] + (1,)))
    scaled = torch.where(scaled >= kth, scaled, NEG_INF)
    sorted2 = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted2, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    p = top_p.float().reshape(bshape)
    keep = (cum - probs) < p
    thr = torch.where(keep, sorted2, float("inf")).amin(dim=-1, keepdim=True)
    thr = torch.minimum(thr, scaled.amax(dim=-1, keepdim=True))
    nucleus = torch.where(p < 1.0, thr, float("-inf"))
    return torch.where(scaled >= nucleus, scaled, NEG_INF)


def warped_probs_rows(
    logits: torch.Tensor,       # [B, V] or [B, T, V]
    temperature: torch.Tensor,  # [B] float32 (> 0 rows meaningful)
    top_p: torch.Tensor,        # [B] float32; 1.0 = off
    top_k: torch.Tensor,        # [B] int32; 0 (or V) = off
) -> torch.Tensor:
    """Per-row ``ops.sampling.warped_probs`` with per-row policies (JAX
    :456): the same warp as ``sample_rows``, returning the whole post-warp
    distribution, the p and q of speculative accept/resample."""
    return torch.softmax(_warp_rows(logits, temperature, top_p, top_k),
                         dim=-1)


def sample_rows(
    generators: Sequence[Optional[torch.Generator]],
    logits: torch.Tensor,       # [B, V]
    temperature: torch.Tensor,  # [B] float32; 0 = greedy
    top_p: torch.Tensor,        # [B] float32
    top_k: torch.Tensor,        # [B] int32
) -> torch.Tensor:
    """Next token per row: argmax for greedy rows, else one draw from the
    row's warped distribution with the row's own generator (rows without
    one take the argmax).  A row draws exactly as ``ops.sampling.sample``
    on its [1, V] logits would with that generator."""
    greedy_tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    rows = [b for b, g in enumerate(generators) if g is not None]
    if not rows:
        return greedy_tok
    probs = torch.softmax(_warp_rows(logits, temperature, top_p, top_k),
                          dim=-1)
    tok = greedy_tok.clone()
    for b in rows:
        tok[b] = torch.multinomial(probs[b:b + 1], 1,
                                   generator=generators[b])[0, 0]
    return torch.where(temperature <= 0.0, greedy_tok, tok)


def _finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B] bool, True where every logit is finite."""
    return torch.isfinite(logits).all(dim=-1)


# ---------------------------------------------------------------------------
# Step programs
# ---------------------------------------------------------------------------

def _decode_step_core(
    params, pool, table, n_alloc, fill, tau, pos, active, generators,
    temperature, top_p, top_k, *, config, use_kernel,
):
    """One [n_slots, 1] decode iteration over the paged pool, updating the
    pool in place.  Returns the next token [B], -1 for a row whose logits
    are not finite."""
    positions = torch.where(active, pos, -1)[:, None]
    if use_kernel:
        cache = pool.paged(table, fill)
        logits, _ = forward(params, tau[:, None], positions, config,
                            cache=cache, attn_mask=active[:, None])
    else:
        view = _gather_cache(pool, table, n_alloc, fill)
        logits, view = forward(params, tau[:, None], positions, config,
                               cache=view, attn_mask=active[:, None])
        _scatter_back(pool, view, table, fill, active, T=1)
    last = logits[:, -1]
    nxt = sample_rows(generators, last, temperature, top_p, top_k)
    return torch.where(_finite_rows(last), nxt, -1)


def _chunk_scan(
    params, pool, table, n_alloc, fill, tau, pos, active, remaining, stops,
    generators, temperature, top_p, top_k, *, config, n_iter, use_kernel,
):
    """``n_iter`` decode iterations (JAX ``_chunk_scan``, a Python loop over
    device tensors here).  Each iteration replays the host's one-token
    contract on the device:

      1. emit the pending token ``tau`` into column i of the token block
         (-1 for the non-finite sentinel, ``_CHUNK_PAD`` for rows already
         inactive);
      2. a row whose emitted token is one of its stops, whose budget is
         spent, or whose token is the sentinel leaves ``active``: it stops
         attending and writing for the rest of the chunk;
      3. one ``_decode_step_core`` iteration for the remaining rows, then
         fill/pos advance.

    Returns (tokens [B, n_iter] int32, tau, fill, pos, active, remaining).
    """
    toks = []
    for _ in range(n_iter):
        nonfinite = tau < 0
        toks.append(torch.where(
            active, torch.where(nonfinite, -1, tau), _CHUNK_PAD))
        done = active & (nonfinite | stop_token_hits(tau, stops)
                         | (remaining <= 1))
        remaining = remaining - active.to(torch.int32)
        active = active & ~done
        nxt = _decode_step_core(
            params, pool, table, n_alloc, fill, tau, pos, active,
            generators, temperature, top_p, top_k, config=config,
            use_kernel=use_kernel,
        )
        tau = torch.where(active, nxt, tau)
        fill = fill + active.to(torch.int32)
        pos = pos + active.to(torch.int32)
    return (torch.stack(toks, dim=1).to(torch.int32), tau, fill, pos, active,
            remaining)


def _paged_insert(
    params, pool, block_ids, prompt_tokens, prompt_mask, generators,
    temperature, top_p, top_k, *, config, prefill_chunk=None,
):
    """Prefill a batch of admitted requests and land their KV in their
    reserved blocks (in place).

    prompt_tokens/prompt_mask: [k, P] on the device, RIGHT-padded to the
    group's block-multiple length P.  block_ids: [k, P // block_size]
    numpy int32, the physical blocks of each row's prompt span; entries
    equal to n_blocks (past a shorter row's span, or a padding row) are
    dropped.  Logits are taken at each row's last real token.  Returns the
    sampled first tokens [k] int32 (-1 where the logits are not finite).
    """
    k_rows, P = prompt_tokens.shape
    L, KVH, NB, BLK = pool.k.shape[:4]
    device = pool.k.device
    sub = init_cache(config, k_rows, max_len=P, device=device)
    positions = prompt_positions(prompt_mask)
    plen = prompt_mask.to(torch.int32).sum(dim=-1)
    rows = torch.arange(k_rows, device=device)
    chunk = prefill_chunk if prefill_chunk and prefill_chunk < P else P
    h_last = None
    for start in range(0, P, chunk):
        end = min(start + chunk, P)
        _, sub, aux = forward(
            params, prompt_tokens[:, start:end], positions[:, start:end],
            config, cache=sub, attn_mask=prompt_mask[:, start:end],
            compute_logits=False, output_last_hidden=True,
            # a static int: the splash kernel's causal offset
            chunk_offset=start,
        )
        idx = plen - 1 - start  # [k] last-token offset in this chunk
        in_chunk = (idx >= 0) & (idx < end - start)
        g = aux.last_hidden_state[rows, idx.clamp(0, end - start - 1)]
        h_last = g if h_last is None else torch.where(
            in_chunk[:, None], g, h_last)
    logits_last = lm_head_logits(params, h_last[:, None], config,
                                 normed=True)[:, 0]
    tau = sample_rows(generators, logits_last, temperature, top_p, top_k)
    tau = torch.where(_finite_rows(logits_last), tau, -1)

    r, j = np.nonzero(block_ids < NB)
    if r.size:
        idx = torch.from_numpy(
            np.stack([r, j, block_ids[r, j]]).astype(np.int64)).to(device)
        r_t, j_t, b_t = idx.unbind(0)
        # [L, k, P, KVH, hd] -> [L, k, nb, BLK, KVH, hd], then the chosen
        # (row, block) pairs -> [L, KVH, n, BLK, hd]
        span = (L, k_rows, P // BLK, BLK, KVH)
        planes = [(pool.k, sub.k), (pool.v, sub.v)]
        if pool.quantized:  # the scale planes too (JAX :1023-1031)
            planes += [(pool.k_scale, sub.k_scale),
                       (pool.v_scale, sub.v_scale)]
        for plane, new in planes:
            plane[:, :, b_t] = new.reshape(span + new.shape[4:])[
                :, r_t, j_t].movedim(3, 1)
        pool.pos[b_t] = sub.pos.reshape(k_rows, P // BLK, BLK)[r_t, j_t]
    return tau


def _spec_round_core(
    t_params, d_params, t_pool, d_pool, table, n_alloc, fill, tau, pos,
    active, generators, temperature, top_p, top_k, *, t_config, d_config,
    n_draft, use_kernel,
):
    """One speculative round for every active slot (JAX :1146), greedy or
    sampled verification per row, both pools updated in place.

    1. Draft chain: each of the n_draft steps replays the growing block
       ``[tau, d_1..d_j, 0..]`` through ONE [B, n_draft+1] draft forward
       over the base pool, which it does not write; token j's logits are
       row j of the result (rows past j are causally masked from it).  In
       self-draft every chain step is then the same function of the same
       bytes as the verify below, so greedy acceptance is exact (JAX
       :1217-1245).
    2. One more draft pass lands the block's KV in the draft pool; one
       target pass over the same block verifies it and lands its KV.
    3. Greedy rows accept the matching prefix; sampled rows (a generator
       and temperature > 0) run ``leviathan_verify``, drawing from their
       own generator the n_draft draft tokens (in step 1), then n_draft
       uniforms, then the replacement/bonus token.  A row whose target
       logits hold NaN/Inf anywhere in the block gets acc = -1.
    4. Commit: slot j of the block (tau, then d_j) stays valid iff
       j <= acc; the rest are marked pos -1 in both pools (no rollback;
       the host advances fill by acc+1, so they are reused).

    With ``use_kernel`` every forward is ``paged_forward`` (the paged
    kernel at T = n_draft+1); otherwise both pools go through gathered
    views (the tests' oracle).  Returns (outs [B, G+1] int32: the host
    emits ``outs[:acc]`` and keeps ``outs[acc]`` as the next pending
    token; acc [B] int32)."""
    G = n_draft
    B = tau.shape[0]
    dev = tau.device
    NB, BLK = t_pool.pos.shape
    jj = torch.arange(G + 1, device=dev, dtype=torch.int32)[None, :]
    block_pos = torch.where(active[:, None], pos[:, None] + jj, -1)
    mask = active[:, None].expand(B, G + 1)
    block = torch.cat(
        [tau[:, None], torch.zeros((B, G), dtype=torch.int32, device=dev)],
        dim=1)
    drawing = [b for b, g in enumerate(generators) if g is not None]
    if use_kernel:
        t_cache = t_pool.paged(table, fill)
        d_cache = d_pool.paged(table, fill)
    else:
        t_cache = _gather_cache(t_pool, table, n_alloc, fill)
        d_cache = _gather_cache(d_pool, table, n_alloc, fill)

    def run(params, config, cache, **kw):
        if use_kernel:
            return paged_forward(params, block, block_pos, config, cache,
                                 attn_mask=mask, **kw)[0]
        return forward(params, block, block_pos, config, cache=cache,
                       attn_mask=mask, **kw)[0]

    qprobs = []
    for j in range(G):
        if use_kernel:
            lg = run(d_params, d_config, d_cache, write_back=False)
        else:
            # The view is a copy: this step's K/V land in slots that the
            # view's own position plane (untouched: the step writes a
            # clone) keeps masked, and the landing pass rewrites them.
            scratch = dataclasses.replace(d_cache, pos=d_cache.pos.clone())
            lg = run(d_params, d_config, scratch)
        lg = lg[:, j]
        nxt = greedy(lg)
        if drawing:
            q = warped_probs_rows(lg, temperature, top_p, top_k)
            drawn = nxt.clone()
            for b in drawing:
                drawn[b] = draft_categorical(generators[b], q[b:b + 1])[0]
            nxt = torch.where(temperature <= 0.0, nxt, drawn)
            qprobs.append(q)
        block[:, j + 1] = nxt
    drafts = block[:, 1:]
    run(d_params, d_config, d_cache, compute_logits=False)
    t_logits = run(t_params, t_config, t_cache)

    outs = greedy(t_logits)  # [B, G+1]
    acc = torch.cumprod((drafts == outs[:, :G]).to(torch.int32), dim=1
                        ).sum(dim=1, dtype=torch.int32)
    if drawing:
        pprobs = warped_probs_rows(t_logits, temperature, top_p, top_k)
        u = torch.zeros((B, G), dtype=torch.float32, device=dev)
        for b in drawing:
            u[b] = torch.rand((1, G), generator=generators[b], device=dev)[0]
        acc_s, dist = leviathan_verify(pprobs, torch.stack(qprobs, dim=1),
                                       drafts, u)
        extra = torch.zeros((B,), dtype=torch.int32, device=dev)
        for b in drawing:
            extra[b] = draft_categorical(generators[b], dist[b:b + 1])[0]
        is_greedy = temperature <= 0.0
        outs = torch.where(is_greedy[:, None], outs,
                           place_extra(drafts, acc_s, extra))
        acc = torch.where(is_greedy, acc, acc_s)
    acc = torch.where(torch.isfinite(t_logits).all(dim=-1).all(dim=-1),
                      acc, -1)

    patched = torch.where(jj <= acc[:, None], block_pos, -1)
    if use_kernel:
        blk, off, _ = paged_write_indices(table, fill, active, G + 1, NB,
                                          BLK)
        paged_pool_write(t_pool.pos, patched, blk, off)
        paged_pool_write(d_pool.pos, patched, blk, off)
    else:
        for pool, view in ((t_pool, t_cache), (d_pool, d_cache)):
            _cache_write(view.pos[..., None, None], patched[..., None, None],
                         fill)
            _scatter_back(pool, view, table, fill, active, T=G + 1)
    return outs, acc


def _spec_rounds_chunk(
    t_params, d_params, t_pool, d_pool, table, n_alloc, fill, tau, pos,
    active, remaining, stops, generators, temperature, top_p, top_k, *,
    t_config, d_config, n_draft, n_rounds, use_kernel,
):
    """``n_rounds`` speculative rounds with one packed result (JAX :1434,
    a Python loop over device tensors here).  Each round replays the
    host's per-round contract (``_step_spec`` + ``_spec_tail``) on the
    device:

      1. emit the pending token ``tau`` (-1 for the non-finite sentinel,
         ``_CHUNK_PAD`` for rows already inactive); a row whose token hits
         its stops or spends its budget folds out before the round;
      2. one ``_spec_round_core`` for the remaining rows;
      3. the accepted-prefix emit (``accepted_emit_counts``): ``outs[:acc]``
         until a stop token or the budget, fill/pos advance by acc+1 for
         rows that go on, ``outs[acc]`` becomes the pending token, and a
         finished or non-finite row folds out for the rest of the chunk.

    Returns (packed [B, R, G+2] int32: each round's G+1 token columns and
    its acceptance count (-1 non-finite, ``_CHUNK_PAD`` inactive); tau,
    fill, pos, active, remaining)."""
    G = n_draft
    i = torch.arange(G, device=tau.device, dtype=torch.int32)[None, :]
    rounds = []
    for _ in range(n_rounds):
        nonfinite = tau < 0
        out0 = torch.where(active, torch.where(nonfinite, -1, tau),
                           _CHUNK_PAD)
        done0 = active & (nonfinite | stop_token_hits(tau, stops)
                          | (remaining <= 1))
        remaining = remaining - active.to(torch.int32)
        active = active & ~done0
        outs, acc = _spec_round_core(
            t_params, d_params, t_pool, d_pool, table, n_alloc, fill, tau,
            pos, active, generators, temperature, top_p, top_k,
            t_config=t_config, d_config=d_config, n_draft=G,
            use_kernel=use_kernel,
        )
        verify_nan = active & (acc < 0)
        acc_c = acc.clamp(0, G)
        e, any_done = accepted_emit_counts(
            acc_c, stop_token_hits(outs[:, :G], stops), remaining)
        emit = (i < e[:, None]) & (active & ~verify_nan)[:, None]
        out_rest = torch.where(emit, outs[:, :G], _CHUNK_PAD)
        acc_out = torch.where(active, torch.where(verify_nan, -1, acc_c),
                              _CHUNK_PAD)
        cont = active & ~verify_nan & ~any_done
        adv = torch.where(cont, acc_c + 1, 0)
        fill = fill + adv
        pos = pos + adv
        remaining = remaining - torch.where(active & ~verify_nan, e, 0)
        new_tau = torch.gather(outs, 1, acc_c.long()[:, None])[:, 0]
        tau = torch.where(cont, new_tau, tau)
        active = cont
        rounds.append(torch.cat([out0[:, None], out_rest, acc_out[:, None]],
                                dim=1))
    packed = torch.stack(rounds, dim=1).to(torch.int32)  # [B, R, G+2]
    return packed, tau, fill, pos, active, remaining


# ---------------------------------------------------------------------------
# Host-side batcher
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Slot:
    request_id: int
    emitted: List[int]
    max_new: int
    stop_tokens: frozenset
    blocks: List[int]


@dataclasses.dataclass
class _Request:
    rid: int
    tokens: List[int]
    max_new: int
    stops: frozenset
    temperature: float
    top_p: float
    top_k: int
    seed: Optional[int]

    def blocks_needed(self, block_size: int) -> int:
        padded = _round_up(len(self.tokens), block_size)
        return -(-(padded + self.max_new) // block_size)


class ContinuousBatcher:
    """Host-side slot manager around the step programs.

    Usage:
        cb = ContinuousBatcher(params, config, n_slots=8, max_len=2048)
        rid = cb.submit([1, 5, 9, ...], max_new_tokens=128)
        while cb.pending():
            for request_id, token, done in cb.step():
                ...

    The signature is the JAX package's, plus ``device`` (default "cuda";
    the pool is placed where the params are, and a disagreeing ``device``
    raises).  One difference: the prefix cache is not ported, so
    ``prefix_cache`` defaults to False and ``prefix_index`` to "off";
    asking for it raises NotImplementedError (ROADMAP A11).  The other
    arguments outside this slice raise as the module docstring lists.

    ``draft_params`` (with ``draft_config``, sharing the vocabulary)
    turns on speculative decoding: each step drafts ``n_draft`` tokens
    per slot and verifies them in one target forward, up to
    ``spec_rounds`` rounds per step with one fetch (``decode_chunk`` is
    not used then).  Greedy output is the plain batcher's; a draft the
    target accepts whole (the target itself) gives
    ``acceptance_rate() == 1.0``.

    ``n_blocks`` sizes the KV pool; the default matches contiguous
    capacity (n_slots × max_len).  A smaller pool overcommits: admission
    reserves ceil((padded prompt + max_new) / block_size) blocks and
    requests queue until their reservation fits.  ``decode_chunk`` runs up
    to that many decode iterations per ``step()`` with one host fetch;
    output is token-identical to ``decode_chunk=1``.
    """

    # Chunk clamp while the queue is capacity-blocked (JAX :2765).
    _QUEUED_CHUNK_CAP = 4
    _NONFINITE_MSG = (
        "non-finite logits: the model produced NaN/Inf for "
        "this request; it was aborted (server healthy)"
    )

    def __init__(
        self,
        params,
        config: LLaMAConfig,
        n_slots: int = 8,
        max_len: Optional[int] = None,
        stop_tokens: Tuple[int, ...] = (),
        temperature: float = 0.0,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        seed: int = 0,
        block_size: Optional[int] = None,
        n_blocks: Optional[int] = None,
        draft_params=None,
        draft_config: Optional[LLaMAConfig] = None,
        n_draft: int = 4,
        mesh=None,
        use_pallas_kernel: bool = True,
        logprobs: bool = False,
        prefix_cache: bool = False,
        fault_injector: Optional[FaultInjector] = None,
        decode_chunk: int = 1,
        spec_rounds: int = 1,
        prefill_budget: int = 0,
        prefix_index: str = "off",
        host_kv_blocks: int = 0,
        obs: Optional[Observability] = None,
        cost_models: bool = False,
        prefill_kernel: Optional[str] = None,
        decode_kernel: Optional[str] = None,
        device="cuda",
    ):
        # The raw construction arguments, captured before any derivation
        # so ``rebuild()`` (crash recovery) reproduces this batcher: a
        # fresh pool and host state, the same geometry and policies.  The
        # injector and the obs sink are shared across rebuilds, so call
        # counters index the process's dispatches and the trace stays one.
        self._ctor_kwargs = dict(
            n_slots=n_slots, max_len=max_len, stop_tokens=stop_tokens,
            temperature=temperature, top_p=top_p, top_k=top_k,
            prefill_chunk=prefill_chunk, seed=seed, block_size=block_size,
            n_blocks=n_blocks, draft_params=draft_params,
            draft_config=draft_config, n_draft=n_draft, mesh=mesh,
            use_pallas_kernel=use_pallas_kernel, logprobs=logprobs,
            prefix_cache=prefix_cache, fault_injector=fault_injector,
            decode_chunk=decode_chunk, spec_rounds=spec_rounds,
            prefill_budget=prefill_budget, prefix_index=prefix_index,
            host_kv_blocks=host_kv_blocks, obs=obs,
            cost_models=cost_models, prefill_kernel=prefill_kernel,
            decode_kernel=decode_kernel, device=device,
        )
        if prefix_index not in ("radix", "exact", "off"):
            raise ValueError(
                f"unknown prefix_index {prefix_index!r}; "
                "have ('radix', 'exact', 'off')"
            )
        spec = draft_params is not None
        if spec:
            if draft_config is None:
                raise ValueError("draft_params requires draft_config")
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError("target and draft must share a vocabulary")
            if n_draft < 1:
                raise ValueError("n_draft must be >= 1")
        # Kernel selection (JAX :1903-1923): constructor arguments over the
        # config's fields; "auto" resolves here, once, and the resolved
        # names are baked into the configs.  "gathered" is the gathered
        # view of the paged path.
        if decode_kernel == "gathered":
            use_pallas_kernel = False
            decode_kernel = "paged"
        config = config.replace(
            prefill_kernel=resolve_prefill_kernel(
                prefill_kernel or config.prefill_kernel, config),
            decode_kernel=resolve_decode_kernel(
                decode_kernel or config.decode_kernel, config),
        )
        if draft_config is not None:
            draft_config = draft_config.replace(
                prefill_kernel=resolve_prefill_kernel(
                    prefill_kernel or draft_config.prefill_kernel,
                    draft_config),
                decode_kernel=resolve_decode_kernel(
                    decode_kernel or draft_config.decode_kernel,
                    draft_config),
            )
        unported = (
            (mesh is not None, "mesh (serving-mesh sharding)", "A14"),
            (logprobs, "logprobs=True", "A17"),
            (prefill_budget > 0,
             "prefill_budget > 0 (fused prefill-decode)", "A9"),
            (host_kv_blocks > 0, "host_kv_blocks > 0 (host KV tier)", "A11"),
            (prefix_cache and prefix_index != "off",
             f"the prefix cache (prefix_index={prefix_index!r})", "A11"),
        )
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"ContinuousBatcher: {what} is not ported "
                    f"(ROADMAP {item})")
        for c in (config, draft_config) if spec else (config,):
            if c.attn_impl not in ("xla", "auto"):
                raise ValueError(
                    "continuous batching requires attn_impl 'xla' or 'auto' "
                    "(per-row cache offsets run on the xla path)"
                )
            c.validate()
        device = resolve_device(device)
        pdev = _params_device(params)
        if device.type != pdev.type or (
                device.index is not None and device.index != pdev.index):
            raise ValueError(
                f"params live on {pdev}, the batcher was asked to run on "
                f"{device}")
        self.device = pdev
        # Kernel builds during a dispatch are booked onto the program that
        # triggered them (obs.attribute_compiles); always on, two
        # thread-local writes per dispatch.
        _obs_mod.install_compile_listener()
        self.obs = obs if obs is not None else Observability()
        self._ctor_kwargs["obs"] = self.obs
        self.fault_injector = fault_injector
        if fault_injector is not None and fault_injector.trace_sink is None:
            # Injections land in the trace's annotation ring, next to the
            # dispatch spans they killed.
            fault_injector.trace_sink = self.obs.annotate
        self.cost_models = bool(cost_models)
        if spec and _params_device(draft_params) != pdev:
            raise ValueError(
                f"draft_params live on {_params_device(draft_params)}, the "
                f"target's on {pdev}")
        if not all(
                c.n_heads // c.kv_heads <= MAX_GROUP
                for c in ((config, draft_config) if spec else (config,))):
            # More query heads per KV head than the paged kernel holds:
            # the gathered view, decided here, never mid-stream.
            use_pallas_kernel = False
        self.params = params
        self.config = config
        self.spec = spec
        self.draft_params = draft_params
        self.draft_config = draft_config
        self.n_draft = n_draft
        self.spec_rounds = max(1, int(spec_rounds))
        self.use_pallas_kernel = use_pallas_kernel
        self.n_slots = n_slots
        self.max_len = max_len or config.max_seq_len
        if block_size is None:
            # JAX :1946-1961: 128-and-down below 8k, 512 at >= 8k.
            if self.max_len >= 8192:
                block_size = 512
            else:
                block_size = min(128, max(16, self.max_len // 16))
        self.block_size = block_size
        self.blocks_per_slot = -(-self.max_len // self.block_size)
        self.n_blocks = n_blocks or n_slots * self.blocks_per_slot
        self.default_stop = frozenset(int(s) for s in stop_tokens)
        self.temperature = float(temperature)
        self.top_p = 1.0 if top_p is None else float(top_p)
        self.top_k = 0 if top_k is None else int(top_k)
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        self.decode_chunk = max(1, int(decode_chunk))
        self.pool = init_pool(config, self.n_blocks, self.block_size,
                              device=self.device)
        self.draft_pool = (
            init_pool(draft_config, self.n_blocks, self.block_size,
                      device=self.device) if spec else None)
        # Bytes one pool block occupies (k, v, pos and an int8 pool's
        # scales; the draft pool's too).
        self.block_bytes = sum(
            t.nbytes // self.n_blocks
            for pl in (self.pool, self.draft_pool) if pl is not None
            for t in (pl.k, pl.v, pl.pos, pl.k_scale, pl.v_scale)
            if t is not None)
        # Features of the ctor whose ROADMAP item is not ported, at the
        # values the constructor admits (anything else raised above).
        self.logprobs = False
        self.prefill_budget = 0
        self.prefix_index = "off"
        self.host_kv_blocks = 0
        self._cost = CostModel(config, params) if self.cost_models else None
        self._draft_cost = (CostModel(draft_config, draft_params)
                            if self.cost_models and spec else None)
        self.free_blocks: List[int] = list(range(self.n_blocks))
        self.failed: List[Tuple[int, str]] = []
        # The degradable features (degrade.FEATURES) the most recent
        # dispatch runs, and the union over the current step(): the
        # server attributes a dispatch exception by the former and
        # credits probe successes by the latter.
        self.last_dispatch_features: Tuple[str, ...] = ()
        self.last_step_features: set = set()
        # Inserts timed on the card and not yet recorded: (record, start
        # ms on the obs clock, CUDA events around it).
        self._unsettled: List[tuple] = []

        # Host mirrors of the per-slot decode state: the authoritative copy
        # for host bookkeeping.  The device twins (d_*) are written only for
        # dirty rows (_sync_device_rows) and advanced on the device by
        # _chunk_scan.
        B, MB = n_slots, self.blocks_per_slot
        self.table = np.full((B, MB), self.n_blocks, np.int32)
        self.n_alloc = np.zeros((B,), np.int32)
        self.fill = np.zeros((B,), np.int32)
        self.pos = np.zeros((B,), np.int32)
        self.active = np.zeros((B,), bool)
        self.temp_arr = np.zeros((B,), np.float32)
        self.top_p_arr = np.ones((B,), np.float32)
        self.top_k_arr = np.zeros((B,), np.int32)
        self.remaining = np.zeros((B,), np.int32)
        self.stop_tab = np.full((B, pow2_bucket(len(self.default_stop))),
                                -1, np.int32)
        dev = self.device

        def twin(a):
            return torch.from_numpy(a.copy()).to(dev)

        self.d_table = twin(self.table)
        self.d_n_alloc = twin(self.n_alloc)
        self.d_fill = twin(self.fill)
        self.d_pos = twin(self.pos)
        self.d_active = twin(self.active)
        self.d_temps = twin(self.temp_arr)
        self.d_top_ps = twin(self.top_p_arr)
        self.d_top_ks = twin(self.top_k_arr)
        self.d_remaining = twin(self.remaining)
        self.d_stops = twin(self.stop_tab)
        self.tau = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.generators: List[Optional[torch.Generator]] = [None] * B
        self._dirty_rows: set = set()

        # Counters, under the JAX package's names.
        self.emitted_total = 0
        self.steps_total = 0
        self.decode_dispatches_total = 0
        self.decode_chunk_last = 0
        self.host_syncs_total = 0
        self.state_uploads_total = 0
        self.nonfinite_rows_total = 0
        self.prompt_tokens_total = 0
        self._admit_dispatches = 0
        self._admits_at_last_chunk = 0
        # Speculative counters (zero without a draft model).
        self.drafts_proposed = 0
        self.drafts_accepted = 0
        self.spec_rounds_last = 0
        self.spec_dispatches_total = 0
        self.spec_host_syncs_total = 0
        self.spec_emitted_total = 0
        self._accept_window: collections.deque = collections.deque(
            maxlen=64)

        self.slots: Dict[int, Optional[_Slot]] = {
            b: None for b in range(n_slots)
        }
        self.queue: List[_Request] = []
        self._next_id = 0

    # -- public API ---------------------------------------------------------

    def rebuild(self) -> "ContinuousBatcher":
        """A fresh batcher with this one's construction: a new KV pool and
        host state over the same params (JAX :2241).  The crash-recovery
        path: after a dispatch exception the old instance's device state
        is suspect; callers resubmit every in-flight request (prompt +
        delivered tokens) against the new one and drop this one.
        ``LLMServer`` rebuilds through here when the degrade state is the
        one this batcher was built for; a quarantine or a probe rebuilds
        from the server's copy of the original construction instead
        (``LLMServer._build_batcher``)."""
        return ContinuousBatcher(self.params, self.config,
                                 **self._ctor_kwargs)

    def default_seed(self, rid: int) -> int:
        """The seed of a request without an explicit one (JAX :2256)."""
        return (self.seed * 1000003 + rid) & 0x7FFFFFFF

    def _fault(self, site: str) -> None:
        """Named fault-injection hook (no-op without an injector)."""
        if self.fault_injector is not None:
            self.fault_injector.fire(site)

    def _open_dispatch(self, site: str, kernels: Sequence[KernelSpec],
                       extra: Sequence[str] = ()) -> None:
        """Name the degradable features the NEXT dispatch runs (``extra``,
        then each kernel's ``KernelSpec.feature``), then fire its fault
        sites: the generic ``site``, ``extra`` (each is its own site), and
        each kernel's ``fault_site``.  Named before the sites fire, so an
        exception out of a site or the dispatch is attributable."""
        feats = (*extra, *(k.feature for k in kernels))
        self.last_dispatch_features = feats
        self.last_step_features.update(feats)
        self._fault(site)
        for f in extra:
            self._fault(f)
        for k in kernels:
            self._fault(k.fault_site)

    def _settle_inserts(self, wait: bool) -> None:
        """Record the inserts timed on the card whose end event has
        passed (``wait``: all of them, right after a fetch, which passed
        them, or after a failed step), with their device time between
        the events as ``wall_ms``."""
        while self._unsettled:
            rec, start, ev0, ev1 = self._unsettled[0]
            if not (wait or ev1.query()):
                return
            ev1.synchronize()
            del self._unsettled[0]
            self.obs.record_dispatch(wall_ms=ev0.elapsed_time(ev1),
                                     start_ms=start, **rec)

    def _dispatch_cost(self, program: str, count
                       ) -> Tuple[Optional[float], Optional[float]]:
        """Per-dispatch attribution, right before ``program`` runs: name it
        as this thread's build attribution, and with cost models on return
        ``count()``'s (FLOPs, bytes) (``obs.CostModel``; host arithmetic,
        no device work)."""
        _obs_mod.attribute_compiles(self.obs, program)
        if not self.cost_models:
            return None, None
        return count()

    def _take_nan(self) -> bool:
        """Consume an armed ``nan`` fault (no-op without an injector)."""
        return (self.fault_injector is not None
                and self.fault_injector.take_nan())

    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int = 256,
        stop_tokens: Optional[Tuple[int, ...]] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        top_k: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> int:
        """Queue a request; returns its id.  Tokens only: tokenize first.
        Admission happens at the next ``step()``."""
        if not prompt_tokens:
            raise ValueError("empty prompt")
        padded = _round_up(len(prompt_tokens), self.block_size)
        if padded + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt_tokens)} tokens, padded to {padded} "
                f"= a multiple of block_size={self.block_size}) + "
                f"max_new ({max_new_tokens}) exceeds per-request capacity "
                f"{self.max_len}"
                + (
                    "; the unpadded request fits - construct the batcher "
                    "with a smaller block_size to admit it"
                    if len(prompt_tokens) + max_new_tokens <= self.max_len
                    else ""
                )
            )
        rid = self._next_id
        self._next_id += 1
        req = _Request(
            rid=rid,
            tokens=[int(t) for t in prompt_tokens],
            max_new=max_new_tokens,
            stops=(self.default_stop if stop_tokens is None
                   else frozenset(int(s) for s in stop_tokens)),
            temperature=(self.temperature if temperature is None
                         else float(temperature)),
            top_p=self.top_p if top_p is None else float(top_p),
            top_k=self.top_k if top_k is None else int(top_k),
            seed=seed,
        )
        if req.blocks_needed(self.block_size) > self.n_blocks:
            raise ValueError(
                f"request needs {req.blocks_needed(self.block_size)} "
                f"blocks; the pool has {self.n_blocks} total"
            )
        self.queue.append(req)
        self.obs.request_queued(rid, len(req.tokens))
        return rid

    def pending(self) -> bool:
        return bool(self.queue) or any(
            s is not None for s in self.slots.values())

    def cancel(self, request_id: int, outcome: str = "cancelled",
               error: Optional[str] = None) -> bool:
        """Dequeue a request, or free its slot and blocks mid-generation.
        Returns False if the id is unknown (finished or never submitted).
        ``outcome`` is the terminal state its timeline records:
        "cancelled" (a client disconnect, an explicit cancel) or "failed"
        (the server's deadline reaper).  Called from the thread that owns
        the batcher (the serving loop) only."""
        for i, req in enumerate(self.queue):
            if req.rid == request_id:
                del self.queue[i]
                self.obs.request_end(request_id, outcome, error)
                return True
        for b, slot in self.slots.items():
            if slot is not None and slot.request_id == request_id:
                self._free_slot(b)
                self.obs.request_end(request_id, outcome, error)
                return True
        return False

    def pop_failed(self) -> List[Tuple[int, str]]:
        """Drain (request_id, message) for requests failed by the
        non-finite guard since the last call."""
        out, self.failed = self.failed, []
        return out

    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens accepted (speculative mode)."""
        if not self.drafts_proposed:
            return 0.0
        return self.drafts_accepted / self.drafts_proposed

    def _window_acceptance(self) -> float:
        """Acceptance over the recent spec-dispatch window (the last 64
        dispatches that proposed drafts); an atomic ``list()`` snapshot,
        since /metrics reads it while the loop appends."""
        window = list(self._accept_window)
        proposed = sum(p for p, _ in window)
        if not proposed:
            return 0.0
        return sum(a for _, a in window) / proposed

    def describe(self) -> Dict[str, Any]:
        """Construction-time configuration (the ``config`` section of the
        server's ``/debug/bundle``), JAX :2467; safe from any thread."""
        kw = self._ctor_kwargs
        return {
            "n_slots": self.n_slots,
            "max_len": self.max_len,
            "block_size": self.block_size,
            "n_blocks": self.n_blocks,
            "block_bytes": self.block_bytes,
            "decode_chunk": int(kw["decode_chunk"]),
            "spec_rounds": int(kw["spec_rounds"]),
            "speculative": self.spec,
            "n_draft": self.n_draft if self.spec else 0,
            "prefill_budget": int(kw["prefill_budget"]),
            "prefix_index": self.prefix_index,
            "host_kv_blocks": self.host_kv_blocks,
            "logprobs": self.logprobs,
            "use_pallas_kernel": bool(kw["use_pallas_kernel"]),
            "cost_models": self.cost_models,
            "serve_mesh": dict(SERVE_MESH),
        }

    def stats(self) -> Dict[str, float]:
        """Counters, under the JAX package's ``stats()`` names
        (``insert_dispatches_total`` is the port's: prefill dispatches,
        one per admitted burst).  The prefix cache and host tier (A11),
        fused prefill (A9) and the serving mesh (A14) report the values
        the JAX package reports with them off.  Read by HTTP handler
        threads while the serving loop owns the batcher: each value is a
        point-in-time read of single-writer host state, never a device
        read."""
        out: Dict[str, float] = {} if self.fault_injector is None else (
            dict(self.fault_injector.stats()))
        out.update({
            "emitted_tokens_total": self.emitted_total,
            "decode_steps_total": self.steps_total,
            "active_slots": sum(s is not None for s in self.slots.values()),
            "queued_requests": len(self.queue),
            "free_blocks": len(self.free_blocks),
            "total_blocks": self.n_blocks,
            "drafts_proposed_total": self.drafts_proposed,
            "drafts_accepted_total": self.drafts_accepted,
            "draft_acceptance_rate": self.acceptance_rate(),
            # A11: the prefix cache, its chain digest and the host tier.
            "prefix_cached_blocks": 0,
            "prefix_requests_hit_total": 0,
            "prefix_blocks_reused_total": 0,
            "radix_nodes_total": 0,
            "prefix_hit_tokens_ratio": 0.0,
            "host_kv_blocks": self.host_kv_blocks,
            "host_tier_blocks": 0,
            "swap_queue_depth": 0,
            "swap_ins_total": 0,
            "swap_in_blocks_total": 0,
            "swap_out_blocks_total": 0,
            "swap_in_ms_total": 0.0,
            "swap_failures_total": 0,
            "kv_digest_version": 0,
            "kv_digest_loss_version": 0,
            "kv_publish_events_total": 0,
            "kv_evict_events_total": 0,
            "kv_demote_events_total": 0,
            "kv_restore_events_total": 0,
            "kv_host_evict_events_total": 0,
            "kv_block_bytes": self.block_bytes,
            "kv_export_blocks_total": 0,
            "kv_import_blocks_total": 0,
            "kv_export_events_total": 0,
            "kv_import_events_total": 0,
            "kv_handoff_aborted_total": 0,
            "kv_export_demoted_blocks_total": 0,
            # A14: no serving mesh.
            "serve_mesh_data": 1,
            "serve_mesh_tensor": 1,
            "nonfinite_rows_total": self.nonfinite_rows_total,
            "decode_chunk_size": self.decode_chunk_last,
            "decode_dispatches_total": self.decode_dispatches_total,
            "insert_dispatches_total": self._admit_dispatches,
            "host_syncs_total": self.host_syncs_total,
            "state_uploads_total": self.state_uploads_total,
            "host_syncs_per_token": (
                self.host_syncs_total / max(1, self.emitted_total)),
            "spec_rounds_per_dispatch": self.spec_rounds_last,
            "spec_dispatches_total": self.spec_dispatches_total,
            "spec_host_syncs_per_token": (
                self.spec_host_syncs_total
                / max(1, self.spec_emitted_total)),
            "spec_window_acceptance_rate": self._window_acceptance(),
            # A9: fused prefill-decode scheduling.
            "prefill_budget": self.prefill_budget,
            "prefill_tokens_inflight": 0,
            "prefill_chunks_total": 0,
            "fused_admissions_total": 0,
            "decode_stall_ms_total": 0.0,
        })
        return out

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int, bool]]:
        """Admit what fits, then one chunk of up to K decode iterations for
        every active slot.  Returns [(request_id, token, done)] for the
        tokens emitted this call; finished slots free their blocks and
        queued requests are admitted for the next call."""
        self.last_step_features = set()
        try:
            self._settle_inserts(wait=False)
            self._admit()
            if not any(s is not None for s in self.slots.values()):
                return []
            if self.spec:
                return self._step_spec()
            return self._step_chunked()
        except BaseException:
            # The inserts enqueued before the failure ran (a fault site
            # fires before its own dispatch enqueues anything): record
            # them before the caller drops this batcher.
            self._settle_inserts(wait=True)
            raise

    def run_to_completion(self) -> Dict[int, List[int]]:
        """Drain everything; returns {request_id: emitted tokens}."""
        results: Dict[int, List[int]] = {}
        while self.pending():
            for rid, tok, _ in self.step():
                results.setdefault(rid, []).append(tok)
        return results

    # -- internals ----------------------------------------------------------

    def _pick_chunk(self, admitted: bool, cap: Optional[int] = None) -> int:
        """K for the next chunk (JAX :2767): 1 right after an admission,
        at most _QUEUED_CHUNK_CAP while requests wait, else the largest
        power of two <= min(cap, the largest remaining budget).  ``cap``
        defaults to ``decode_chunk``; the speculative path passes
        ``spec_rounds`` (a round emits at least one token)."""
        cap = self.decode_chunk if cap is None else cap
        if cap <= 1 or admitted:
            return 1
        rem = max(s.max_new - len(s.emitted)
                  for s in self.slots.values() if s is not None)
        k = max(1, min(cap, rem))
        if self.queue:
            k = min(k, self._QUEUED_CHUNK_CAP)
        return 1 << (k.bit_length() - 1)

    def _sync_device_rows(self) -> None:
        """Flush the dirty rows' host state to the device twins: one packed
        int32 upload (float policies ride bit-cast), scattered on the
        device.  No dirty rows (the steady state): no upload."""
        if not self._dirty_rows:
            return
        if self.d_stops.shape != self.stop_tab.shape:
            # The stop table widened: grow the twin on the device.
            grown = torch.full(self.stop_tab.shape, -1, dtype=torch.int32,
                               device=self.device)
            grown[:, :self.d_stops.shape[1]] = self.d_stops
            self.d_stops = grown
        rows = np.asarray(sorted(self._dirty_rows))
        self._dirty_rows.clear()
        packed = np.concatenate([
            rows[:, None], self.table[rows],
            np.stack([self.n_alloc[rows], self.fill[rows], self.pos[rows],
                      self.active[rows], self.top_k_arr[rows],
                      self.remaining[rows],
                      self.temp_arr[rows].view(np.int32),
                      self.top_p_arr[rows].view(np.int32)], axis=1),
            self.stop_tab[rows],
        ], axis=1).astype(np.int32)
        up = torch.from_numpy(packed).to(self.device)
        self.state_uploads_total += 1
        idx = up[:, 0].long()
        MB = self.table.shape[1]
        self.d_table[idx] = up[:, 1:1 + MB]
        (n_alloc, fill, pos, active, top_k, remaining, temps,
         top_ps) = up[:, 1 + MB:9 + MB].unbind(1)
        self.d_n_alloc[idx] = n_alloc
        self.d_fill[idx] = fill
        self.d_pos[idx] = pos
        self.d_active[idx] = active.bool()
        self.d_top_ks[idx] = top_k
        self.d_remaining[idx] = remaining
        self.d_temps[idx] = temps.view(torch.float32)
        self.d_top_ps[idx] = top_ps.view(torch.float32)
        self.d_stops[idx] = up[:, 9 + MB:]

    def _step_chunked(self) -> List[Tuple[int, int, bool]]:
        """One chunk dispatch, one packed fetch, then the host replays the
        token block to advance its mirrors and emit events (JAX :2851,
        without the fused-prefill branch)."""
        admitted = self._admit_dispatches > self._admits_at_last_chunk
        self._admits_at_last_chunk = self._admit_dispatches
        K = self._pick_chunk(admitted)
        self._sync_device_rows()
        # The fault sites fire once per chunk dispatch, before it: an
        # exception reaches the caller with nothing emitted, so recovery
        # replays from the tokens the caller was given.  The stock kernel
        # serves the chunk's T = 1 steps over a full-precision pool; its
        # quarantine falls back to the paged kernel.
        kernels: List[KernelSpec] = []
        if self.use_pallas_kernel:
            kernels.append(DECODE_KERNELS["paged"])
            if (self.config.decode_kernel == "stock-paged"
                    and not self.pool.quantized):
                kernels.append(DECODE_KERNELS["stock-paged"])
        self._open_dispatch("step", kernels)
        stock = len(kernels) == 2
        self.steps_total += K
        self.decode_dispatches_total += 1
        self.decode_chunk_last = K
        live = [(b, s) for b, s in self.slots.items() if s is not None]
        obs_rids = [s.request_id for _, s in live]
        cost_fl, cost_by = self._dispatch_cost(
            "_chunk_scan", lambda: self._cost.decode(
                [(int(self.pos[b]), min(K, s.max_new - len(s.emitted)))
                 for b, s in live]))
        t0_obs = time.monotonic()
        (toks, self.tau, self.d_fill, self.d_pos, self.d_active,
         self.d_remaining) = _chunk_scan(
            self.params, self.pool, self.d_table, self.d_n_alloc,
            self.d_fill, self.tau, self.d_pos, self.d_active,
            self.d_remaining, self.d_stops, self._generators_for_round(),
            self.d_temps, self.d_top_ps, self.d_top_ks, config=self.config,
            n_iter=K,
            use_kernel=self.use_pallas_kernel,
        )
        # The one device->host sync of the chunk.
        tf_obs = time.monotonic()
        toks = toks.cpu().numpy()
        self.host_syncs_total += 1
        now_obs = time.monotonic()
        self._settle_inserts(wait=True)
        self.obs.record_dispatch(
            kind="decode:stock-paged" if stock else "decode",
            k=K, occupancy=len(obs_rids),
            wall_ms=(now_obs - t0_obs) * 1000.0,
            fetch_ms=(now_obs - tf_obs) * 1000.0, rids=obs_rids,
            program="_chunk_scan", flops=cost_fl, bytes_accessed=cost_by,
        )

        out: List[Tuple[int, int, bool]] = []
        forced_nan = self._take_nan()
        for b, slot in self.slots.items():
            if slot is None:
                continue
            if forced_nan:
                # An armed ``nan`` fault poisons the first active row: its
                # chunk tokens are dropped and the request fails through
                # the non-finite guard.
                forced_nan = False
                self._fail_slot(b)
                continue
            advanced = 0
            ended = False
            for i in range(toks.shape[1]):
                tok = int(toks[b, i])
                if tok == _CHUNK_PAD:
                    break
                if tok < 0:
                    # The device already folded the row out; fail just this
                    # request (tokens before the sentinel were emitted).
                    self._fail_slot(b, device_done=True)
                    ended = True
                    break
                slot.emitted.append(tok)
                self.emitted_total += 1
                done = (tok in slot.stop_tokens
                        or len(slot.emitted) >= slot.max_new)
                out.append((slot.request_id, tok, done))
                if done:
                    # The device made the same call mid-chunk, so the row is
                    # already inactive there: no deactivation upload owed.
                    self.obs.request_end(slot.request_id, "finished")
                    self._free_slot(b, device_done=True)
                    ended = True
                    break
                advanced += 1
            if not ended:
                self.fill[b] += advanced
                self.pos[b] += advanced
                self.remaining[b] = slot.max_new - len(slot.emitted)
        self._admit()
        return out

    def _generators_for_round(self) -> List[Optional[torch.Generator]]:
        """Each slot's generator where its request samples, else None (the
        rows a decode iteration or speculative round draws for)."""
        return [self.generators[b] if s is not None and self.temp_arr[b] > 0
                else None for b, s in self.slots.items()]

    def _emit(self, b: int, tok: int, out: List[Tuple[int, int, bool]]
              ) -> bool:
        """Deliver one token of slot ``b`` on a speculative step; True when
        its request is done (a stop token or the budget spent)."""
        slot = self.slots[b]
        slot.emitted.append(tok)
        self.emitted_total += 1
        self.spec_emitted_total += 1
        done = tok in slot.stop_tokens or len(slot.emitted) >= slot.max_new
        out.append((slot.request_id, tok, done))
        if done:
            self.obs.request_end(slot.request_id, "finished")
        return done

    def _spec_dispatch(self) -> None:
        """Record the features of a speculative dispatch and fire its
        sites (JAX :3196-3213): ``spec_decode``, and ``paged_kernel`` when
        its forwards run the paged kernel (every forward of a round is
        T = n_draft + 1, so the stock kernel never serves one)."""
        self._open_dispatch(
            "step", [DECODE_KERNELS["paged"]] if self.use_pallas_kernel
            else [], extra=("spec_decode",))

    def _spec_cost(self, rounds: int
                   ) -> Tuple[Optional[float], Optional[float]]:
        program = ("_spec_rounds_chunk" if self.spec_rounds > 1
                   else "_spec_round_core")
        return self._dispatch_cost(program, lambda: self._cost.spec(
            [int(self.pos[b]) for b, s in self.slots.items()
             if s is not None], self.n_draft, rounds, self._draft_cost))

    def _step_spec(self) -> List[Tuple[int, int, bool]]:
        """Speculative step (JAX :3135).  ``spec_rounds`` > 1 takes the
        chunked path; ``spec_rounds=1`` is the per-round loop, the oracle
        the chunked path is held to: emit each slot's pending token, free
        finished slots before the round (a finishing request does not pay
        for a draft and a verify whose output it would drop), then one
        round (``_spec_tail``)."""
        if self.spec_rounds > 1:
            return self._step_spec_chunked()
        out: List[Tuple[int, int, bool]] = []
        taus = self.tau.cpu().numpy()
        self.host_syncs_total += 1
        self.spec_host_syncs_total += 1
        forced_nan = self._take_nan()
        for b, slot in self.slots.items():
            if slot is None:
                continue
            tok = int(taus[b])
            if tok < 0 or forced_nan:
                forced_nan = False
                self._fail_slot(b)
                continue
            if self._emit(b, tok, out):
                self._free_slot(b)
        if any(s is not None for s in self.slots.values()):
            # The sites fire after the emit scan, where a real round's
            # failure lands: this step's tokens are in slot.emitted but
            # never returned, so recovery replays from what the caller
            # was given.
            self._spec_dispatch()
            self.steps_total += 1
            self.decode_dispatches_total += 1
            self.spec_dispatches_total += 1
            self.decode_chunk_last = self.spec_rounds_last = 1
            self._spec_tail(out)
        self._admit()
        return out

    def _spec_tail(self, out: List[Tuple[int, int, bool]]) -> None:
        """One round of the per-round loop (JAX :3451): upload the host
        mirrors (one packed copy), draft and verify, fetch outs and acc
        (one packed copy), emit the accepted prefix, advance fill/pos by
        acc+1, and keep ``outs[acc]`` as the next pending token."""
        G = self.n_draft
        B = self.n_slots
        MB = self.table.shape[1]
        packed = np.concatenate([
            self.table,
            np.stack([self.n_alloc, self.fill, self.pos, self.active,
                      self.top_k_arr, self.temp_arr.view(np.int32),
                      self.top_p_arr.view(np.int32)], axis=1),
        ], axis=1).astype(np.int32)
        live = [s.request_id for s in self.slots.values() if s is not None]
        cost_fl, cost_by = self._spec_cost(1)
        t0_obs = time.monotonic()
        up = torch.from_numpy(packed).to(self.device)
        self.state_uploads_total += 1
        n_alloc, fill, pos, active, top_k, temps, top_ps = up[:, MB:].unbind(1)
        outs, acc = _spec_round_core(
            self.params, self.draft_params, self.pool, self.draft_pool,
            up[:, :MB].contiguous(), n_alloc, fill, self.tau, pos,
            active.bool(),
            self._generators_for_round(), temps.view(torch.float32),
            top_ps.view(torch.float32), top_k, t_config=self.config,
            d_config=self.draft_config, n_draft=G,
            use_kernel=self.use_pallas_kernel,
        )
        tf_obs = time.monotonic()
        arr = torch.cat([outs, acc[:, None]], dim=1).cpu().numpy()
        self.host_syncs_total += 1
        self.spec_host_syncs_total += 1
        now_obs = time.monotonic()
        self._settle_inserts(wait=True)
        self.obs.record_dispatch(
            kind="spec", k=1, occupancy=len(live),
            wall_ms=(now_obs - t0_obs) * 1000.0,
            fetch_ms=(now_obs - tf_obs) * 1000.0, rids=live,
            program="_spec_round_core", flops=cost_fl,
            bytes_accessed=cost_by,
        )
        round_proposed = round_accepted = 0
        new_tau = np.zeros((B,), np.int32)
        for b, slot in self.slots.items():
            if slot is None:
                continue
            a = int(arr[b, G + 1])
            if a < 0:
                # The verify's non-finite sentinel: the round was not
                # committed (its slots were invalidated); fail the request.
                self._fail_slot(b)
                continue
            self.drafts_proposed += G
            self.drafts_accepted += a
            round_proposed += G
            round_accepted += a
            done = False
            for i in range(a):
                done = self._emit(b, int(arr[b, i]), out)
                if done:
                    break
            if done:
                self._free_slot(b)
            else:
                new_tau[b] = arr[b, a]
                self.fill[b] += a + 1
                self.pos[b] += a + 1
                self.remaining[b] = slot.max_new - len(slot.emitted)
        if round_proposed:
            self._accept_window.append((round_proposed, round_accepted))
        self.tau = torch.from_numpy(new_tau).to(self.device)

    def _step_spec_chunked(self) -> List[Tuple[int, int, bool]]:
        """Speculative step, fused (JAX :3221): ONE ``_spec_rounds_chunk``
        runs R rounds with the pending-token emit, the accepted-prefix
        emit, stop/budget/non-finite folding and the fill advance on the
        device; the host fetches the packed [B, R, G+2] block once and
        replays it to advance its mirrors and produce the events, token
        for token (and acceptance for acceptance) what the per-round loop
        produces.  State lives in the device twins, synced for dirty rows
        only, as in ``_step_chunked``."""
        admitted = self._admit_dispatches > self._admits_at_last_chunk
        self._admits_at_last_chunk = self._admit_dispatches
        R = self._pick_chunk(admitted, cap=self.spec_rounds)
        self._sync_device_rows()
        self._spec_dispatch()
        self.steps_total += R
        self.decode_dispatches_total += 1
        self.spec_dispatches_total += 1
        self.decode_chunk_last = self.spec_rounds_last = R
        G = self.n_draft
        live = [s.request_id for s in self.slots.values() if s is not None]
        cost_fl, cost_by = self._spec_cost(R)
        t0_obs = time.monotonic()
        (packed, self.tau, self.d_fill, self.d_pos, self.d_active,
         self.d_remaining) = _spec_rounds_chunk(
            self.params, self.draft_params, self.pool, self.draft_pool,
            self.d_table, self.d_n_alloc, self.d_fill, self.tau, self.d_pos,
            self.d_active, self.d_remaining, self.d_stops,
            self._generators_for_round(), self.d_temps, self.d_top_ps,
            self.d_top_ks, t_config=self.config, d_config=self.draft_config,
            n_draft=G, n_rounds=R, use_kernel=self.use_pallas_kernel,
        )
        # The one device->host sync of the chunk.
        tf_obs = time.monotonic()
        arr = packed.cpu().numpy()
        self.host_syncs_total += 1
        self.spec_host_syncs_total += 1
        now_obs = time.monotonic()
        self._settle_inserts(wait=True)
        self.obs.record_dispatch(
            kind="spec", k=R, occupancy=len(live),
            wall_ms=(now_obs - t0_obs) * 1000.0,
            fetch_ms=(now_obs - tf_obs) * 1000.0, rids=live,
            program="_spec_rounds_chunk", flops=cost_fl,
            bytes_accessed=cost_by,
        )

        out: List[Tuple[int, int, bool]] = []
        round_proposed = round_accepted = 0
        forced_nan = self._take_nan()
        for b, slot in self.slots.items():
            if slot is None:
                continue
            if forced_nan:
                # An armed ``nan`` fault poisons the first active row, as
                # in the per-round loop; its chunk tokens are dropped.
                forced_nan = False
                self._fail_slot(b)
                continue
            fill_adv = 0
            ended = False
            for r in range(R):
                tok0 = int(arr[b, r, 0])
                if tok0 == _CHUNK_PAD:
                    break  # folded out before this round
                if tok0 < 0:
                    self._fail_slot(b, device_done=True)
                    ended = True
                    break
                if self._emit(b, tok0, out):
                    # The device made the same call before the round.
                    self._free_slot(b, device_done=True)
                    ended = True
                    break
                a = int(arr[b, r, G + 1])
                assert a >= -1, (b, r, a)
                if a < 0:
                    # The verify's non-finite sentinel: nothing committed.
                    self._fail_slot(b, device_done=True)
                    ended = True
                    break
                self.drafts_proposed += G
                self.drafts_accepted += a
                round_proposed += G
                round_accepted += a
                for i in range(a):
                    tok = int(arr[b, r, 1 + i])
                    if tok == _CHUNK_PAD:
                        break
                    if self._emit(b, tok, out):
                        self._free_slot(b, device_done=True)
                        ended = True
                        break
                if ended:
                    break
                fill_adv += a + 1
            if not ended:
                self.fill[b] += fill_adv
                self.pos[b] += fill_adv
                self.remaining[b] = slot.max_new - len(slot.emitted)
        if round_proposed:
            self._accept_window.append((round_proposed, round_accepted))
        self._admit()
        return out

    def _fail_slot(self, b: int, device_done: bool = False) -> None:
        """Fail slot ``b``'s request with the non-finite message and free
        the slot."""
        rid = self.slots[b].request_id
        self.failed.append((rid, self._NONFINITE_MSG))
        self.nonfinite_rows_total += 1
        self.obs.request_end(rid, "failed", self._NONFINITE_MSG)
        self._free_slot(b, device_done=device_done)

    def _alloc_blocks(self, n: int) -> List[int]:
        self._fault("alloc")
        assert n <= len(self.free_blocks), "allocation past capacity"
        out, self.free_blocks = self.free_blocks[:n], self.free_blocks[n:]
        return out

    def _free_slot(self, b: int, device_done: bool = False) -> None:
        """Free slot ``b``: its blocks return to the free list with their
        pool positions invalidated (a stale pos >= 0 past a later prompt
        would be attended).  ``device_done``: the chunk already folded the
        row out on the device, so no deactivation upload is owed; a
        host-initiated free (cancel) marks the row dirty."""
        slot = self.slots[b]
        assert slot is not None
        if slot.blocks:
            ids = torch.as_tensor(slot.blocks, device=self.device)
            self.pool.pos[ids] = -1
            if self.spec:
                self.draft_pool.pos[ids] = -1
            self.free_blocks.extend(slot.blocks)
        self.slots[b] = None
        self.generators[b] = None
        self.table[b] = self.n_blocks
        self.n_alloc[b] = 0
        self.fill[b] = 0
        self.active[b] = False
        self.remaining[b] = 0
        self.stop_tab[b, :] = -1
        if not device_done:
            self._dirty_rows.add(b)

    def _set_stop_row(self, b: int, stops: frozenset) -> None:
        """Write slot ``b``'s stop set into the stop table's host mirror,
        widening the table (pow2 width) when needed."""
        n = max(1, len(stops))
        if n > self.stop_tab.shape[1]:
            tab = np.full((self.n_slots, pow2_bucket(n)), -1, np.int32)
            tab[:, :self.stop_tab.shape[1]] = self.stop_tab
            self.stop_tab = tab
        self.stop_tab[b, :] = -1
        if stops:
            self.stop_tab[b, :len(stops)] = sorted(stops)

    def _generator(self, req: _Request) -> Optional[torch.Generator]:
        """The request's own generator (None for a greedy request)."""
        if req.temperature <= 0.0:
            return None
        seed = req.seed if req.seed is not None else self.default_seed(
            req.rid)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _admit(self) -> None:
        """Admit queued requests into free slots (JAX
        ``_admit_classic_impl`` without prefix hits or restores).  A burst
        of admissible requests shares ONE [k', P] prefill dispatch (k' = k
        rounded up to a power of two, P = the group's longest block-padded
        prompt, its block count rounded up to a power of two); FIFO
        head-of-line blocking on block reservations."""
        BLK = self.block_size
        while True:
            free_slots = [b for b, s in self.slots.items() if s is None]
            if not free_slots or not self.queue:
                return
            picked: List[_Request] = []
            budget = len(self.free_blocks)
            for req in self.queue:
                if len(picked) >= len(free_slots):
                    break
                need = req.blocks_needed(BLK)
                if need > budget:
                    break  # head-of-line blocking: wait for capacity
                budget -= need
                picked.append(req)
            if not picked:
                return
            del self.queue[:len(picked)]
            k = len(picked)
            kb = pow2_bucket(k)
            nb = min(pow2_bucket(max(_round_up(len(r.tokens), BLK)
                                     for r in picked) // BLK),
                     self.blocks_per_slot)
            P = nb * BLK
            pt = np.zeros((kb, P), np.int32)
            pm = np.zeros((kb, P), np.int32)
            bid = np.full((kb, nb), self.n_blocks, np.int32)
            pol = np.zeros((kb, 3), np.float32)  # temperature, top_p, top_k
            pol[:, 1] = 1.0
            generators: List[Optional[torch.Generator]] = [None] * kb
            row_blocks = []
            for i, req in enumerate(picked):
                blocks = self._alloc_blocks(req.blocks_needed(BLK))
                row_blocks.append(blocks)
                n = len(req.tokens)
                self.prompt_tokens_total += n
                pt[i, :n] = req.tokens
                pm[i, :n] = 1
                span = _round_up(n, BLK) // BLK
                bid[i, :span] = blocks[:span]
                pol[i] = (req.temperature, req.top_p, req.top_k)
                generators[i] = self._generator(req)
            # One upload for the admission: prompts, masks and policies.
            up = torch.from_numpy(np.concatenate(
                [pt, pm, pol.view(np.int32)], axis=1)).to(self.device)
            temps = up[:, 2 * P].view(torch.float32)
            top_ps = up[:, 2 * P + 1].view(torch.float32)
            top_ks = up[:, 2 * P + 2].view(torch.float32).to(torch.int32)
            # Host mirror of the insert's attention choice (the model's
            # "auto" rule per chunk, and splash_eligible over the chunk
            # geometry): the features and sites of this dispatch.
            chunk = (self.prefill_chunk if self.prefill_chunk
                     and self.prefill_chunk < P else P)
            impl = self.config.attn_impl
            flash = impl == "flash" or (impl == "auto"
                                        and chunk > FLASH_MIN_SEQ)
            splash_used = flash and splash_eligible(
                self.config, batch=kb, q_len=chunk, kv_len=P,
                chunk_offset=0, quantized=self.pool.quantized)
            kernels = [PREFILL_KERNELS["flash"]] if flash else []
            if splash_used:
                kernels.append(PREFILL_KERNELS["splash"])
            for req in picked:
                self.obs.begin_span(req.rid, "prefilling")
            cost_fl, cost_by = self._dispatch_cost(
                "_paged_insert", lambda: self._cost.insert(
                    [len(r.tokens) for r in picked], self.prefill_chunk))
            t0_obs = time.monotonic()
            start_obs = self.obs.now_ms()
            self._open_dispatch("insert", kernels)
            self._admit_dispatches += 1
            timed = self.device.type == "cuda"
            if timed:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record()
            taus = _paged_insert(
                self.params, self.pool, bid, up[:, :P], up[:, P:2 * P].bool(),
                generators, temps, top_ps, top_ks, config=self.config,
                prefill_chunk=self.prefill_chunk,
            )
            if self.spec:
                # The draft pool over the same blocks; its greedy first
                # tokens are dropped (the target picks tau, and a sampled
                # request's generator is drawn by the target insert only).
                _paged_insert(
                    self.draft_params, self.draft_pool, bid, up[:, :P],
                    up[:, P:2 * P].bool(), [None] * kb,
                    torch.zeros_like(temps), torch.ones_like(top_ps),
                    torch.zeros_like(top_ks), config=self.draft_config,
                    prefill_chunk=self.prefill_chunk,
                )
            slot_ids = free_slots[:k]
            self.tau[torch.as_tensor(slot_ids, device=self.device)] = taus[:k]
            # No fetch ends the insert (JAX fetches its prompt lengths
            # here): its first tokens stay on the device for the next
            # chunk, whose launches the host enqueues while the insert
            # runs.  So on the card the insert is timed between CUDA
            # events and recorded once the next fetch has passed it
            # (_settle_inserts); on the CPU it ran as it was called.  A
            # launch error is raised by the launch itself, while
            # ``last_dispatch_features`` names the insert.
            rec = dict(
                kind="insert:splash" if splash_used else "insert", k=k,
                occupancy=sum(s is not None for s in self.slots.values()),
                prefill_tokens=sum(len(r.tokens) for r in picked),
                rids=[r.rid for r in picked], program="_paged_insert",
                flops=cost_fl, bytes_accessed=cost_by,
            )
            if timed:
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record()
                self._unsettled.append((rec, start_obs, ev0, ev1))
            else:
                self.obs.record_dispatch(
                    wall_ms=(time.monotonic() - t0_obs) * 1000.0, **rec)
            for i, req in enumerate(picked):
                b = slot_ids[i]
                blocks = row_blocks[i]
                self.pos[b] = len(req.tokens)
                self.fill[b] = _round_up(len(req.tokens), BLK)
                self.active[b] = True
                self.table[b] = self.n_blocks
                self.table[b, :len(blocks)] = blocks
                self.n_alloc[b] = len(blocks)
                self.temp_arr[b] = req.temperature
                self.top_p_arr[b] = req.top_p
                self.top_k_arr[b] = req.top_k
                self.remaining[b] = req.max_new
                self._set_stop_row(b, req.stops)
                self._dirty_rows.add(b)
                self.generators[b] = generators[i]
                self.slots[b] = _Slot(
                    request_id=req.rid, emitted=[], max_new=req.max_new,
                    stop_tokens=req.stops, blocks=blocks,
                )
                self.obs.begin_span(req.rid, "decoding")
