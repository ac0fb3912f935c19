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

* The prefix cache and the host tier (``kvcache.py``; ``prefix_index``
  "radix" by default, "exact", "off" = ``prefix_cache=False``): full
  prompt blocks are keyed by ``kvcache.chain_keys``; an admission claims
  the longest cached chain prefix (refcounted blocks) and prefills only
  its suffix (``_paged_suffix_insert``, through the rows' gathered
  views at per-row ``fill0``: per-row cache offsets run the xla
  attention path, as in the JAX package, so a hit's suffix launches no
  attention kernel), and finished requests retain their keyed blocks in
  the store's idle LRU until allocation pressure evicts them.  With
  ``host_kv_blocks`` > 0 cold blocks demote into a bounded host tier of
  pinned slabs (one D2H sweep, one host sync per sweep, counted in
  ``swap_out_blocks_total`` and never in ``host_syncs_total``); a
  request whose matched prefix was demoted parks in ``restoring`` while
  its slabs copy to staging tensors on a side CUDA stream, decode chunks
  dispatching meanwhile, and one scatter adopts them into the pool when
  the copy's event has passed.  ``export_prefix`` / ``import_prefix``
  move a chain's blocks between batchers through the same primitives.

* Fused prefill-decode scheduling (``prefill_budget`` > 0, JAX
  :89-116): while any row decodes, an admission moves queued ->
  prefilling(offset) -> decoding.  The queue head's blocks are reserved
  and its suffix uploaded once (``_setup_fused_prefill``); each later
  chunk dispatch is ``_fused_chunk``: up to ``_pf_chunk`` prompt tokens
  through the row's gathered view at a scalar write index (the flash
  kernel over a chunk of more than 8 tokens; a prefix hit walks from
  fill0), then the unchanged decode scan, with one fetch.  The dispatch
  that lands the last chunk samples the first token with the row's own
  generator and folds the row into the decode state on the device, so
  that dispatch emits it.  One admission at a time; a cold pool and a
  speculative batcher admit classically, and a classic admission made
  while a row decodes books its insert time in
  ``decode_stall_ms_total``.
* Logprobs (``logprobs=True``, JAX :907): every dispatch carries each
  emitted token's float32 log-probability under the raw logits beside
  the token (``_token_logprob``), bit-cast into the same packed fetch,
  and ``step()`` yields it as a 4th element.
* Profiler labels: each host dispatch runs inside one
  ``torch.profiler.record_function`` range named after the JAX package's
  program (``utils.profiling.PROGRAMS``; JAX :1606-1620), never one per
  layer, so that ``utils.profiling.summarize_trace`` splits device and
  host time by program as JAX's ``summarize_xplane`` does.  The port's
  decode scan ``_chunk_scan`` is labelled ``_paged_decode_chunk``;
  ``_fused_chunk``, ``_spec_rounds_chunk`` and one round of the
  per-round loop (``_spec_round``) keep their names; the cold insert is
  ``_paged_insert`` and the prefix-hit insert ``_paged_suffix_insert``;
  the dirty-row upload is ``_scatter_rows``, the invalidation of
  re-purposed blocks' positions ``_release_blocks``, and a swap-in's or
  an import's adoption scatter ``_adopt_jit``.  With no profiler
  session a range records nothing.

* The serving mesh (``mesh=``, a ``data x tensor`` ``parallel.Mesh``;
  ``parallel.serve_mesh``): every rank builds the same batcher over its
  own weight shard and calls the same methods with the same requests.
  The host state (block tables, the free list, the radix index, the host
  tier) stays identical on every rank, because every decision reads the
  same fetched tokens, and the ones that read a CUDA event (a swap-in's
  readiness, an import's deadline) are agreed over the mesh's CPU group
  first.  The pools hold this rank's KV-head slice (``init_pool`` under
  the mesh); the per-slot device twins replicate.  Each dispatch runs
  under ``use_mesh``, so the forward splits heads over ``tensor`` and
  rows over ``data`` and returns global outputs; every data rank lands
  every row's K/V, so a prefix hit reads blocks another data rank
  computed.  A mesh the kernels cannot cover is refused when the batcher
  is built (``serve_mesh.validate_serve_mesh``).  Under the HTTP server
  the ranks' calls come from one ordered log that rank 0 publishes
  (``parallel.lockstep``); ``host_state()`` is what the ranks compare.
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
from .engine import prompt_positions, window_positions
from .faults import FaultInjector, InjectedFault
from .kvcache import (
    MatchResult,
    SlabArena,
    Staged,
    adopt_into_pool,
    chain_keys,
    fetch_slab,
    make_prefix_store,
    pool_block_bytes,
    pow2_bucket,
    restore_ready,
    stage_restore,
    wait_restore,
)
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
from .parallel import serve_mesh as _smesh
from .parallel.mesh import current_mesh, local_size, use_mesh
from .ops.kernels import (
    DECODE_KERNELS,
    PREFILL_KERNELS,
    KernelSpec,
    resolve_decode_kernel,
    resolve_prefill_kernel,
    splash_eligible,
)
from .ops.paged_attention import MAX_GROUP
from .ops.sampling import categorical, greedy, stop_token_hits
from .utils import programs as _programs
from .utils.programs import GraphStore, program, use_graphs
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


def build_batcher(base, overrides: Optional[Dict[str, Any]] = None
                  ) -> "ContinuousBatcher":
    """A batcher of the construction ``base`` (``construction()``) with
    ``overrides`` over its keyword arguments; an ``attn_impl`` among them
    replaces the config's.  The server's quarantine and probe rebuilds,
    and a follower rank's replay of them (``parallel.lockstep``)."""
    params, config, kwargs = base
    kw = dict(kwargs, **(overrides or {}))
    attn_impl = kw.pop("attn_impl", None)
    if attn_impl is not None and config.attn_impl != attn_impl:
        config = config.replace(attn_impl=attn_impl)
    return ContinuousBatcher(params, config, **kw)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _timing_event() -> "torch.cuda.Event":
    """A CUDA event that records time (around an insert on the card, and
    before a fetch that waits for one)."""
    return torch.cuda.Event(enable_timing=True)


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
    config: LLaMAConfig, n_blocks: int, block_size: int, device="cuda",
    mesh=None,
) -> BlockPool:
    """An empty pool: int8 payload and zero scale planes when
    ``config.kv_cache_dtype == "int8"`` (JAX :263-284).  Under ``mesh``
    (or the active one) it holds this rank's KV-head slice, the
    placement ``serve_mesh.shard_pool`` gives a whole pool."""
    config.validate()
    device = resolve_device(device)
    int8_kv = config.kv_cache_dtype == "int8"
    kvh = local_size(mesh if mesh is not None else current_mesh(),
                     config.kv_heads, "tensor")
    shape = (config.n_layers, kvh, n_blocks, block_size, config.head_dim)
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
    all_greedy: bool = False,
) -> torch.Tensor:
    """Next token per row: argmax for greedy rows, else one draw from the
    row's warped distribution with the row's own generator (rows without
    one take the argmax; ``all_greedy``, JAX's static flag: every row, and
    no generator advances).  Each row with a generator draws once, whether
    or not its temperature samples, so a slot's generator advances once a
    call; a sampled row draws exactly as ``ops.sampling.sample`` on its
    [1, V] logits would with that generator."""
    greedy_tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    rows = [] if all_greedy else [
        b for b, g in enumerate(generators) if g is not None]
    if not rows:
        return greedy_tok
    probs = torch.softmax(_warp_rows(logits, temperature, top_p, top_k),
                          dim=-1)
    tok = greedy_tok.clone()
    for b in rows:
        tok[b] = categorical(probs[b:b + 1], generators[b])[0]
    return torch.where(temperature <= 0.0, greedy_tok, tok)


def _finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B] bool, True where every logit is finite."""
    return torch.isfinite(logits).all(dim=-1)


def _token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Model log-probability of ``tok`` under a float32 log-softmax of
    the RAW logits (JAX :907): independent of temperature, top-p and
    top-k, and what ``engine.score`` reports for the same position.
    logits [B, V], tok [B] -> [B] float32."""
    lg = logits.float()
    picked = torch.gather(lg, 1, tok.long().clamp(min=0)[:, None])[:, 0]
    return picked - torch.logsumexp(lg, dim=-1)


def _pack_logprobs(toks: torch.Tensor, lps: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """[1 or 2, ...] int32: the token block, and under logprobs the float32
    logprobs bit-cast to int32 beside it (JAX :744-760), so that a chunk
    still pays ONE device->host fetch."""
    toks = toks.to(torch.int32)
    if lps is None:
        return toks[None]
    return torch.stack([toks, lps.float().contiguous().view(torch.int32)])


# ---------------------------------------------------------------------------
# Step programs
# ---------------------------------------------------------------------------

@program("_paged_decode_step",
         static=("config", "use_kernel", "all_greedy", "with_logprobs"),
         donate=("pool",), returns=("next", "logprob"), graph=True)
def _decode_step_core(
    params, pool, table, n_alloc, fill, tau, pos, active, generators,
    temperature, top_p, top_k, *, config, use_kernel, all_greedy=False,
    with_logprobs=False,
):
    """One [n_slots, 1] decode iteration over the paged pool, updating the
    pool in place.  Returns (the next token [B], -1 for a row whose logits
    are not finite; its logprob [B] under ``with_logprobs``, else
    None)."""
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
    nxt = sample_rows(generators, last, temperature, top_p, top_k,
                      all_greedy=all_greedy)
    lp = _token_logprob(last, nxt) if with_logprobs else None
    return torch.where(_finite_rows(last), nxt, -1), lp


_CHUNK_DONATED = ("pool", "fill", "tau", "tau_lp", "pos", "active",
                  "remaining", "generators")
_CHUNK_RETURNS = ("packed", "tau", "tau_lp", "fill", "pos", "active",
                  "remaining")


@program("_paged_decode_chunk",
         static=("config", "n_iter", "use_kernel", "all_greedy",
                 "with_logprobs"),
         donate=_CHUNK_DONATED, returns=_CHUNK_RETURNS, graph=True)
def _chunk_scan(
    params, pool, table, n_alloc, fill, tau, tau_lp, pos, active, remaining,
    stops, generators, temperature, top_p, top_k, *, config, n_iter,
    use_kernel, all_greedy=False, with_logprobs=False,
):
    """``n_iter`` decode iterations (JAX ``_chunk_scan``, a Python loop over
    device tensors here).  Each iteration replays the host's one-token
    contract on the device:

      1. emit the pending token ``tau`` into column i of the token block
         (-1 for the non-finite sentinel, ``_CHUNK_PAD`` for rows already
         inactive), and its logprob ``tau_lp`` beside it;
      2. a row whose emitted token is one of its stops, whose budget is
         spent, or whose token is the sentinel leaves ``active``: it stops
         attending and writing for the rest of the chunk;
      3. one ``_decode_step_core`` iteration for the remaining rows, then
         fill/pos advance.

    Returns (packed [1 or 2, B, n_iter] int32: the token block, and under
    ``with_logprobs`` the float32 logprobs bit-cast beside it; tau,
    tau_lp, fill, pos, active, remaining).  The decode half of
    ``_fused_chunk`` too.
    """
    toks, lps = [], []
    for _ in range(n_iter):
        nonfinite = tau < 0
        toks.append(torch.where(
            active, torch.where(nonfinite, -1, tau), _CHUNK_PAD))
        lps.append(tau_lp)
        done = active & (nonfinite | stop_token_hits(tau, stops)
                         | (remaining <= 1))
        remaining = remaining - active.to(torch.int32)
        active = active & ~done
        nxt, lp = _decode_step_core(
            params, pool, table, n_alloc, fill, tau, pos, active,
            generators, temperature, top_p, top_k, config=config,
            use_kernel=use_kernel, all_greedy=all_greedy,
            with_logprobs=with_logprobs,
        )
        tau = torch.where(active, nxt, tau)
        if with_logprobs:
            tau_lp = torch.where(active, lp, tau_lp)
        fill = fill + active.to(torch.int32)
        pos = pos + active.to(torch.int32)
    packed = _pack_logprobs(torch.stack(toks, dim=1),
                            torch.stack(lps, dim=1) if with_logprobs
                            else None)
    return packed, tau, tau_lp, fill, pos, active, remaining


@program("_fused_chunk",
         static=("config", "n_iter", "pf_chunk", "use_kernel", "all_greedy",
                 "with_logprobs"),
         donate=_CHUNK_DONATED + ("pf_off",),
         returns=_CHUNK_RETURNS + ("pf_off",), graph=True)
def _fused_chunk(
    params, pool, table, n_alloc, fill, tau, tau_lp, pos, active, remaining,
    stops, generators, temperature, top_p, top_k, pf_row, pf_toks, pf_len,
    pf_base, pf_off, pf_gen, *, config, n_iter, pf_chunk, use_kernel,
    all_greedy=False, with_logprobs=False,
):
    """The fused prefill-decode dispatch (JAX :770): one bounded prefill
    chunk of the single in-flight admission, then the unchanged
    ``_chunk_scan``, so admissions never stall the decoding rows.

    ``pf_row``, ``pf_len``, ``pf_base`` and ``pf_off`` are 0-d int32
    tensors on the device, read there only (JAX traces them; its key is
    ``pf_chunk`` and shapes, and so is this one): ``pf_off`` is the
    prefill's carry, advanced by ``pf_chunk`` in place (donated).

    Prefill half: row ``pf_row``'s gathered view (``_gather_cache`` of
    its table row) with the 0-d device write index ``pf_base + pf_off``,
    so the forward's "auto" rule runs the flash kernel over a chunk of
    more than ``FLASH_MIN_SEQ`` tokens (a per-row index would force the
    xla path); a prefix-hit row starts its walk at ``pf_base`` = fill0 and
    attends the reused KV through the same view.  ``pf_toks`` is the
    suffix, uploaded once at admission and sliced here at ``pf_off``; the
    window's positions are made on the device (``window_positions``), so
    no chunk copies anything to the card.  Only the chunk's own window is
    written back (``_scatter_back(T=C)``); the host's ``_pf_chunk`` clamp
    keeps ``pf_base + pf_off + C`` inside the view.

    The last prompt token's logits are sampled every dispatch with the
    row's own policy from ``pf_gen`` (JAX's ``pf_key``), under the
    non-finite guard, and folded into the decode state (active, tau,
    tau_lp, fill, pos) under the device mask ``pf_off + C >= pf_len``, as
    JAX computes it: the scan below emits the row's first token from the
    dispatch that lands the last chunk.  The host seeds ``pf_gen`` from
    the request's seed before that dispatch (its first draw is then the
    classic insert's) and moves the row's slot generator one draw past
    the same seed, so that the scan's draws continue the request's
    sequence; a non-final chunk's draw is discarded.  The prefilling row
    rides the scan masked until then.

    Returns ``_chunk_scan``'s tuple, then ``pf_off``."""
    C = pf_chunk
    B = tau.shape[0]
    dev = tau.device
    BLK = pool.block_size
    row = pf_row.long().view(1)
    table_r = table.index_select(0, row)
    write_at = (pf_base + pf_off).to(torch.int32)
    view = _gather_cache(pool, table_r, n_alloc.index_select(0, row),
                         write_at.view(1))
    view.index = write_at
    start = pf_off.long().clamp(0, pf_toks.shape[0] - C)
    toks = pf_toks.index_select(0, start + torch.arange(C, device=dev))
    positions, real = window_positions(pf_base, pf_off, C, pf_len)
    _, view, aux = forward(
        params, toks[None], positions, config, cache=view, attn_mask=real,
        compute_logits=False, output_last_hidden=True,
    )
    _scatter_back(pool, view, table_r, write_at.view(1),
                  torch.ones((1,), dtype=torch.bool, device=dev), T=C)
    idx = (pf_len - 1 - pf_off).long().clamp(0, C - 1).view(1)
    logits = lm_head_logits(
        params, aux.last_hidden_state.index_select(1, idx), config,
        normed=True)[:, 0]
    first = sample_rows([pf_gen], logits, temperature.index_select(0, row),
                        top_p.index_select(0, row),
                        top_k.index_select(0, row), all_greedy=all_greedy)
    fold = ((torch.arange(B, device=dev) == pf_row)
            & (pf_off + C >= pf_len))
    if with_logprobs:
        tau_lp = torch.where(fold, _token_logprob(logits, first)[0], tau_lp)
    first = torch.where(_finite_rows(logits), first, -1)
    active = active | fold
    tau = torch.where(fold, first[0], tau)
    fill = torch.where(fold, pf_base + (pf_len + BLK - 1) // BLK * BLK,
                       fill)
    pos = torch.where(fold, pf_base + pf_len, pos)
    return _chunk_scan(
        params, pool, table, n_alloc, fill, tau, tau_lp, pos, active,
        remaining, stops, generators, temperature, top_p, top_k,
        config=config, n_iter=n_iter, use_kernel=use_kernel,
        all_greedy=all_greedy, with_logprobs=with_logprobs,
    ) + (pf_off + C,)


def _drop_scatter(plane: torch.Tensor, dim: int, ids: torch.Tensor,
                  new: torch.Tensor) -> None:
    """``plane.index_copy_(dim, ids, new)`` in place, where an id outside
    [0, plane.shape[dim]) drops its entry (JAX's ``.at[ids].set(mode=
    "drop")``), with no host read: a dropped entry repeats the first live
    one (the same target, the same value: ``index_copy_`` leaves the
    winner of duplicate targets unspecified); with none live every entry
    rewrites its clamped target's own value."""
    n, NB = ids.numel(), plane.shape[dim]
    live = (ids >= 0) & (ids < NB)
    any_live = live.any()
    every = torch.arange(n, device=ids.device)
    src = torch.where(live | ~any_live, every, live.int().argmax())
    dst = ids[src].clamp(0, NB - 1)
    vals = torch.where(any_live, new.index_select(dim, src).to(plane.dtype),
                       plane.index_select(dim, dst))
    plane.index_copy_(dim, dst, vals)


@program("_paged_insert",
         static=("config", "prefill_chunk", "with_logprobs"),
         donate=("pool",), returns=("first", "logprob"), graph=True)
def _paged_insert(
    params, pool, block_ids, prompt_tokens, prompt_mask, generators,
    temperature, top_p, top_k, *, config, prefill_chunk=None,
    with_logprobs=False,
):
    """Prefill a batch of admitted requests and land their KV in their
    reserved blocks (in place).

    prompt_tokens/prompt_mask: [k, P] on the device, RIGHT-padded to the
    group's block-multiple length P.  block_ids: [k, P // block_size]
    int32 on the device, the physical blocks of each row's prompt span;
    entries equal to n_blocks (past a shorter row's span, or a padding
    row) are dropped on the device (``_drop_scatter``, JAX's
    ``mode="drop"``).  Logits are taken at each row's last real token.
    Returns (the sampled first tokens [k] int32, -1 where the logits are
    not finite; their logprobs [k] under ``with_logprobs``, else None).
    """
    k_rows, P = prompt_tokens.shape
    L, KVH, _, BLK = pool.k.shape[:4]
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
    lp = _token_logprob(logits_last, tau) if with_logprobs else None
    tau = torch.where(_finite_rows(logits_last), tau, -1)

    nb = P // BLK
    ids = block_ids.reshape(-1).long()

    def to_blocks(a):  # [L, k, P, KVH, ...] -> [L, KVH, k * nb, BLK, ...]
        a = a.reshape((L, k_rows, nb, BLK, KVH) + a.shape[4:]).movedim(4, 1)
        return a.reshape((L, KVH, k_rows * nb, BLK) + a.shape[5:])

    planes = [(pool.k, sub.k), (pool.v, sub.v)]
    if pool.quantized:  # the scale planes too (JAX :1023-1031)
        planes += [(pool.k_scale, sub.k_scale), (pool.v_scale, sub.v_scale)]
    for plane, new in planes:
        _drop_scatter(plane, 2, ids, to_blocks(new))
    _drop_scatter(pool.pos, 0, ids, sub.pos.reshape(k_rows * nb, BLK))
    return tau, lp


@program("_paged_suffix_insert",
         static=("config", "prefill_chunk", "with_logprobs"),
         donate=("pool",), returns=("first", "logprob"), graph=True)
def _paged_suffix_insert(
    params, pool, table_rows, n_alloc_rows, fill0, suffix_tokens,
    suffix_mask, generators, temperature, top_p, top_k, *, config,
    prefill_chunk=None, with_logprobs=False,
):
    """Prefill k requests' prompt SUFFIXES over the paged pool (JAX
    :1050), in place: the prefix-cache admission path.  The leading
    ``fill0[i]`` positions of each row's table already hold a reused
    cached prefix, so only the suffixes run through the model, attending
    the prefix KV through the rows' gathered views; the view's per-row
    index runs the xla attention path (``forward``'s per-row rule, the
    JAX package's must-xla), so no attention kernel is launched.  The
    new entries land back in the rows' own blocks (``_scatter_back``:
    columns past a row's reservation resolve to the sentinel and drop;
    ``fill0`` is block-aligned, so no reused block is written).

    table_rows: [k, MB] int32; n_alloc_rows, fill0: [k] int32 (fill0 =
    the shared prefix length in tokens, a block multiple);
    suffix_tokens/mask: [k, T] right-padded to a block multiple.
    Returns ``_paged_insert``'s (first tokens, logprobs or None)."""
    k_rows, T = suffix_tokens.shape
    device = suffix_tokens.device
    view = _gather_cache(pool, table_rows, n_alloc_rows, fill0)
    mask_i = suffix_mask.to(torch.int32)
    slen = mask_i.sum(dim=1)
    positions = torch.where(
        suffix_mask, fill0[:, None] + torch.cumsum(mask_i, dim=1) - 1, -1
    ).to(torch.int32)
    rows = torch.arange(k_rows, device=device)
    chunk = prefill_chunk if prefill_chunk and prefill_chunk < T else T
    h_last = None
    for start in range(0, T, chunk):
        end = min(start + chunk, T)
        _, view, aux = forward(
            params, suffix_tokens[:, start:end], positions[:, start:end],
            config, cache=view, attn_mask=suffix_mask[:, start:end],
            compute_logits=False, output_last_hidden=True,
        )
        idx = slen - 1 - start
        in_chunk = (idx >= 0) & (idx < end - start)
        g = aux.last_hidden_state[rows, idx.clamp(0, end - start - 1)]
        h_last = g if h_last is None else torch.where(
            in_chunk[:, None], g, h_last)
    logits_last = lm_head_logits(params, h_last[:, None], config,
                                 normed=True)[:, 0]
    _scatter_back(pool, view, table_rows, fill0,
                  torch.ones((k_rows,), dtype=torch.bool, device=device), T)
    tau = sample_rows(generators, logits_last, temperature, top_p, top_k)
    lp = _token_logprob(logits_last, tau) if with_logprobs else None
    return torch.where(_finite_rows(logits_last), tau, -1), lp


@program("_spec_round",
         static=("t_config", "d_config", "n_draft", "use_kernel",
                 "all_greedy", "with_logprobs"),
         donate=("t_pool", "d_pool"), returns=("outs", "acc", "logprobs"),
         graph=True)
def _spec_round_core(
    t_params, d_params, t_pool, d_pool, table, n_alloc, fill, tau, pos,
    active, generators, temperature, top_p, top_k, *, t_config, d_config,
    n_draft, use_kernel, all_greedy=False, with_logprobs=False,
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
       uniforms, then the replacement/bonus token.  Unless ``all_greedy``
       (JAX's static flag), every row with a generator draws so, sampled
       or not, so that each slot's generator advances alike every round.
       A row whose target logits hold NaN/Inf anywhere in the block gets
       acc = -1.
    4. Commit: slot j of the block (tau, then d_j) stays valid iff
       j <= acc; the rest are marked pos -1 in both pools (no rollback;
       the host advances fill by acc+1, so they are reused).

    With ``use_kernel`` every forward is ``paged_forward`` (the paged
    kernel at T = n_draft+1); otherwise both pools go through gathered
    views (the tests' oracle).  Returns (outs [B, G+1] int32: the host
    emits ``outs[:acc]`` and keeps ``outs[acc]`` as the next pending
    token; acc [B] int32; under ``with_logprobs`` the target's logprob of
    ``outs[:, j]`` at each offset j [B, G+1] float32 (JAX :1345-1350),
    else None)."""
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
    drawing = [] if all_greedy else [
        b for b, g in enumerate(generators) if g is not None]
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
    lps = None
    if with_logprobs:
        # t_logits[:, j] is the raw distribution the token emitted at
        # offset j was drawn or verified from.
        V = t_logits.shape[-1]
        lps = _token_logprob(t_logits.reshape(B * (G + 1), V),
                             outs.reshape(-1)).reshape(B, G + 1)

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
    return outs, acc, lps


@program("_spec_rounds_chunk",
         static=("t_config", "d_config", "n_draft", "n_rounds",
                 "use_kernel", "all_greedy", "with_logprobs"),
         donate=("t_pool", "d_pool") + _CHUNK_DONATED[1:],
         returns=_CHUNK_RETURNS, graph=True)
def _spec_rounds_chunk(
    t_params, d_params, t_pool, d_pool, table, n_alloc, fill, tau, tau_lp,
    pos, active, remaining, stops, generators, temperature, top_p, top_k,
    *, t_config, d_config, n_draft, n_rounds, use_kernel, all_greedy=False,
    with_logprobs=False,
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
    its acceptance count (-1 non-finite, ``_CHUNK_PAD`` inactive), and
    under ``with_logprobs`` the G+1 columns' float32 logprobs bit-cast
    after them ([B, R, 2G+3], JAX :1576-1580); tau, tau_lp, fill, pos,
    active, remaining)."""
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
        out0_lp = tau_lp
        outs, acc, lps_r = _spec_round_core(
            t_params, d_params, t_pool, d_pool, table, n_alloc, fill, tau,
            pos, active, generators, temperature, top_p, top_k,
            t_config=t_config, d_config=d_config, n_draft=G,
            use_kernel=use_kernel, all_greedy=all_greedy,
            with_logprobs=with_logprobs,
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
        cols = [out0[:, None], out_rest, acc_out[:, None]]
        if with_logprobs:
            new_lp = torch.gather(lps_r, 1, acc_c.long()[:, None])[:, 0]
            tau_lp = torch.where(cont, new_lp, tau_lp)
            cols.append(torch.cat([out0_lp[:, None], lps_r[:, :G]], dim=1
                                  ).float().contiguous().view(torch.int32))
        rounds.append(torch.cat([c.to(torch.int32) for c in cols], dim=1))
    # [B, R, G+2], or [B, R, 2G+3] with the logprobs' bits.
    packed = torch.stack(rounds, dim=1)
    return packed, tau, tau_lp, fill, pos, active, remaining


@program("_scatter_rows", donate=("state",), graph=True)
def _scatter_rows(state, idx, rows):
    """The dirty-row upload's scatter (JAX :895): row ``idx[i]`` of each
    per-slot twin in ``state`` takes ``rows[j][i]``, in place.  The
    host pads ``idx`` to a power of two by repeating its first row (the
    same value written twice), so that the key holds a pow2 row count,
    as JAX's does."""
    for twin, new in zip(state, rows):
        twin[idx] = new


@program("_release_blocks", donate=("pos",), graph=True)
def _release_blocks(pos, block_ids):
    """Invalidate re-purposed blocks' positions in the pool's position
    plane (JAX :1125), in place.  ``block_ids`` [MB] int32 is padded with
    the sentinel n_blocks, which drops: a pad rewrites the first id's
    row, as ``paged_pool_write`` repeats a live pair."""
    ids = block_ids.long()
    ids = torch.where(ids < pos.shape[0], ids, ids[0])
    pos.index_fill_(0, ids, -1)


def jit_cache_entries() -> Dict[str, int]:
    """Cache keys per registered program (JAX :1622): each program's
    keys seen in this process (``utils.programs``), the source of the
    ``llm_jit_cache_entries`` gauge."""
    return _programs.jit_cache_entries()


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
    # Leading blocks[:shared] were REUSED prefix-cache hits (KV written by
    # earlier healthy dispatches); blocks[shared:] are this request's own
    # writes, the ones the non-finite guard unpublishes.
    shared: int = 0


@dataclasses.dataclass
class _Prefill:
    """Host view of the single in-flight fused admission (queued ->
    prefilling(off) -> decoding; JAX :1667).  The suffix tokens are
    uploaded once, at admission (``d_toks``), with the lane's device
    scalars (the batcher's ``_pf_dev``: row, suffix length, fill0 and
    the carry ``off``, which ``_fused_chunk`` advances on the device);
    the host advances its own ``off`` by ``chunk`` per fused dispatch,
    so it knows without a fetch which dispatch lands the last chunk."""

    slot: int
    req: "_Request"
    chain: List[bytes]
    n_share: int          # leading prefix-cache-hit blocks
    base: int             # fill0 in tokens (a block multiple)
    suffix_len: int       # real suffix tokens to prefill
    chunk: int            # C: prompt tokens advanced per dispatch
    d_toks: Any = None    # [pow2(n_chunks) * C] int32 on the device
    off: int = 0          # suffix tokens already dispatched

    @property
    def remaining_tokens(self) -> int:
        return max(0, self.suffix_len - self.off)

    @property
    def flash(self) -> bool:
        """Host mirror of the prefill half's "auto" rule: the chunk runs
        the flash kernel iff it is longer than ``FLASH_MIN_SEQ`` tokens
        (the view's write index is a 0-d device scalar, shared, so the
        per-row rule never forces the xla path here)."""
        return self.chunk > FLASH_MIN_SEQ


@dataclasses.dataclass
class _Restore:
    """Host view of one in-flight swap-in (the ``restoring`` admission
    state; JAX :1707): the request left the queue, its matched path's
    resident blocks are claimed, its demoted nodes are pinned in the host
    tier, fresh pool blocks are allocated and claimed, and the slabs are
    copying into ``staged`` on the side stream.  ``_poll_restores``
    adopts the blocks once the copy's event has passed and hands the
    request on to ``_restored_ready``; decode chunks keep dispatching the
    whole time."""

    req: "_Request"
    chain: List[bytes]
    path: List[Any]          # kvcache.RadixNode path (resident + demoted)
    restore: List[Any]       # the demoted nodes being swapped in
    resident: List[int]      # the path's resident blocks, claimed at
    #                          begin, by id (a concurrent non-finite
    #                          subtree drop may null node.block)
    fresh: List[int]         # their freshly allocated pool blocks
    staged: Staged           # kvcache.stage_restore's copies in flight
    t0: float
    polls: int = 0


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

    The signature and defaults are the JAX package's, plus ``device``
    (default "cuda"; the pool is placed where the params are, and a
    disagreeing ``device`` raises).  The arguments outside this slice
    raise as the module docstring lists.

    ``prefix_index`` picks the prefix cache's index: "radix" (default)
    shares partial prefixes across all cached chains, "exact" keeps the
    flat chain map as the oracle, "off" is ``prefix_cache=False``.
    ``host_kv_blocks`` > 0 (radix only) attaches the host tier: cold
    blocks demote into it instead of being freed, and admissions whose
    matched prefix was demoted swap it back in asynchronously through the
    ``restoring`` state.  ``swap_poll_min`` (an attribute, 0) holds a
    ready swap-in for that many polls, so drills can see the window.

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

    ``prefill_budget`` > 0 turns on fused prefill-decode scheduling
    (JAX :89-116): while any row decodes, the queue head is prefilled in
    chunks of at most that many prompt tokens (``_pf_chunk``) inside the
    decode dispatches (``_fused_chunk``), one admission at a time, so no
    decoding row stalls; a cold pool, and a speculative batcher, admit
    classically.  ``logprobs=True`` makes every ``step()`` event a 4-tuple
    whose last element is the token's float32 log-probability under the
    raw logits (``engine.score``'s value for that position), carried in
    the same one fetch per chunk.
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
        prefix_cache: bool = True,
        fault_injector: Optional[FaultInjector] = None,
        decode_chunk: int = 1,
        spec_rounds: int = 1,
        prefill_budget: int = 0,
        prefix_index: str = "radix",
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
        if mesh is not None:
            _smesh.validate_serve_mesh(config, mesh, n_slots,
                                       draft_config=draft_config)
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
        if mesh is not None and (mesh.device.type != pdev.type or (
                mesh.device.index is not None
                and mesh.device.index != pdev.index)):
            raise ValueError(
                f"params live on {pdev}, the mesh places this rank on "
                f"{mesh.device}")
        self.device = pdev
        self.mesh = mesh
        # The canonical placement holds (validated above): pools on this
        # rank's head slice, state rows replicated.
        self._mesh_placed = mesh is not None
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
        self.pool = _smesh.constrain_pool(
            init_pool(config, self.n_blocks, self.block_size,
                      device=self.device, mesh=mesh), config.kv_heads)
        self.draft_pool = (
            init_pool(draft_config, self.n_blocks, self.block_size,
                      device=self.device, mesh=mesh) if spec else None)
        self.logprobs = bool(logprobs)
        # Fused prefill-decode scheduling (JAX :1926-1932): the live
        # budget, which the server's brownout rung shrinks in place.
        self.prefill_budget = max(0, int(prefill_budget))
        # The single in-flight fused admission (None: none).
        self._pf: Optional[_Prefill] = None
        # Set while _admit_classic runs with a row decoding: the inserts
        # recorded meanwhile stalled decode (``decode_stall_ms_total``).
        self._stalling = False
        # The prefix cache (JAX :2034-2072): the index behind it lives in
        # kvcache.py; ``host_kv_blocks`` > 0 attaches the host tier
        # (radix only, inert elsewhere: the prefix-cache quarantine
        # rebuilds with the cache off and must not trip over the flag).
        if not prefix_cache:
            prefix_index = "off"
        self.prefix_index = prefix_index
        self.host_kv_blocks = max(0, int(host_kv_blocks))
        self.prefix_cache_enabled = prefix_index != "off"
        self._store = make_prefix_store(
            prefix_index, host_blocks=self.host_kv_blocks,
            on_event=self.obs.annotate)
        # The store's chain digest: its own lock makes it the one piece of
        # KV state that HTTP handler threads read (/debug/kv, /healthz).
        self.kv_digest = self._store.digest
        # Bytes one pool block occupies (k, v, pos and an int8 pool's
        # scales; the draft pool's too).
        self.block_bytes = pool_block_bytes(self.pool) + (
            pool_block_bytes(self.draft_pool) if spec else 0)
        self._block_refs: Dict[int, int] = {}   # block -> active users
        # The host tier's slabs, allocated once (pinned on the card) and
        # reused; one slot more than the tier holds covers the demotion
        # that lands before put() evicts its victim.
        self._arena = (
            SlabArena([("", self.pool)]
                      + ([("d_", self.draft_pool)] if spec else []),
                      self.host_kv_blocks + 1,
                      pin=self.device.type == "cuda")
            if getattr(self._store, "tier", None) is not None else None)
        # In-flight swap-ins and completed ones awaiting a slot; the side
        # stream their copies run on is made on first use, by the thread
        # that owns the batcher.  ``swap_poll_min`` holds a READY swap-in
        # for at least that many polls (a drill's lever; 0 = adopt as
        # soon as the copy has landed).
        self._restoring: List[_Restore] = []
        self._restored_ready: List[Tuple[_Request, List[bytes],
                                         List[int]]] = []
        self.swap_poll_min = 0
        self._swap_stream = None
        # Demotion copies enqueued since the last sweep's sync.
        self._demotions_unsynced = False
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
            return _smesh.place_rows(mesh, a.copy(), dev)

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
        # The model logprob of each row's pending tau (logprobs=True).
        self.d_tau_lp = torch.zeros((B,), dtype=torch.float32, device=dev)
        # One generator per slot for the batcher's life (JAX's ``keys``
        # rows): the decode programs' graphs hold these.  An admission
        # draws a request's first token from a generator of its own lane
        # (one per insert row, and the fused lane's ``_pf_gen``: the
        # prefill programs' graphs hold those), seeded from the request's
        # seed; the slot's generator then takes the lane's state, one draw
        # past the seed (``_seed_lane``, ``_hand_lanes``).
        self.generators: List[torch.Generator] = [
            torch.Generator(device=dev) for _ in range(B)]
        self._lane_gens: List[torch.Generator] = [
            torch.Generator(device=dev) for _ in range(B)]
        self._pf_gen = torch.Generator(device=dev)
        # The fused lane's device scalars (row, suffix length, fill0, the
        # carry off), one tensor for the batcher's life, so that its
        # graphs hold it (``_setup_fused_prefill`` uploads them).
        self._pf_dev = torch.zeros((4,), dtype=torch.int32, device=dev)
        self._dirty_rows: set = set()
        # The programs' CUDA graphs (utils.programs), decided here, once
        # (from ``mesh.backend``): on the card, unless a mesh's
        # collectives go through the host (gloo), which no graph can hold;
        # None runs every program eagerly.
        self._graphs: Optional[GraphStore] = (
            GraphStore(dev) if dev.type == "cuda" and (
                mesh is None or mesh.backend != "gloo") else None)

        # Counters, under the JAX package's names.
        self.emitted_total = 0
        self.steps_total = 0
        self.decode_dispatches_total = 0
        self.decode_chunk_last = 0
        self.host_syncs_total = 0
        self.state_uploads_total = 0
        self.nonfinite_rows_total = 0
        self.prompt_tokens_total = 0
        # The prefix cache's and the host tier's counters (JAX
        # :2091-2118): hits, prompt tokens served from cached blocks, the
        # swap ledger and the export/import handoff ledger.
        self.prefix_requests_hit = 0
        self.prefix_blocks_reused = 0
        self.prefix_hit_tokens_total = 0
        self.swap_out_blocks_total = 0
        self.swap_in_blocks_total = 0
        self.swap_ins_total = 0
        self.swap_in_ms_total = 0.0
        self.swap_failures_total = 0
        self.kv_export_blocks_total = 0
        self.kv_import_blocks_total = 0
        self.kv_export_events_total = 0
        self.kv_import_events_total = 0
        self.kv_handoff_aborted_total = 0
        self.kv_export_demoted_blocks_total = 0
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
        # Fused prefill-decode counters (JAX :2119-2123).
        self.prefill_chunks_total = 0
        self.fused_admissions_total = 0
        self.decode_stall_ms_total = 0.0

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
        (``LLMServer._build_batcher``).  Swap-ins still copying are waited
        for first: their staging memory must outlive the copies."""
        self._quiesce_restores()
        return ContinuousBatcher(self.params, self.config,
                                 **self._ctor_kwargs)

    def close(self) -> None:
        """Free this batcher's CUDA graphs and their memory pool (a
        retired replica, a drained or replaced batcher); a later step
        runs its programs eagerly."""
        if self._graphs is not None:
            self._graphs.close()
            self._graphs = None

    def host_state(self) -> Dict[str, Any]:
        """The host state every rank of a serving mesh must share: the
        block tables, the free list, the prefix store's digest (its
        per-store random epoch left out), the queued request ids, each
        slot's request and the next request id.  Through the lockstep log
        every rank computes it at the same point and the ranks compare
        it (``parallel.lockstep``)."""
        digest = self.kv_digest.summary()
        digest.pop("epoch", None)
        return dict(table=self.table.tolist(),
                    free=sorted(int(b) for b in self.free_blocks),
                    digest=digest, queue=[r.rid for r in self.queue],
                    slots=[None if s is None else s.request_id
                           for _, s in sorted(self.slots.items())],
                    next_id=self._next_id)

    def construction(self):
        """``(params, config, kwargs)``: this batcher's construction, as
        ``rebuild()`` and ``build_batcher`` take it."""
        return self.params, self.config, dict(self._ctor_kwargs)

    def _quiesce_restores(self) -> None:
        """Wait for every swap-in copy in flight, so that this batcher's
        staging and pinned memory may be let go (a rebuild, a quarantine
        rebuild that drops this batcher)."""
        for r in self._restoring:
            wait_restore(r.staged)

    def default_seed(self, rid: int) -> int:
        """The seed of a request without an explicit one (JAX :2256)."""
        return (self.seed * 1000003 + rid) & 0x7FFFFFFF

    def _fault(self, site: str) -> None:
        """Named fault-injection hook (no-op without an injector)."""
        if self.fault_injector is not None:
            self.fault_injector.fire(site)

    def _open_dispatch(self, site: str, kernels: Sequence[KernelSpec],
                       extra: Sequence[str] = (),
                       sites: Sequence[str] = ()) -> None:
        """Name the degradable features the NEXT dispatch runs (``extra``,
        then each kernel's ``KernelSpec.feature``), then fire its fault
        sites: the generic ``site``, ``extra`` (each is its own site),
        ``sites`` (sites that name no feature), and each kernel's
        ``fault_site``.  Named before the sites fire, so an exception out
        of a site or the dispatch is attributable."""
        feats = (*extra, *(k.feature for k in kernels))
        self.last_dispatch_features = feats
        self.last_step_features.update(feats)
        self._fault(site)
        for f in (*extra, *sites):
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
            # audit: host-fetch(a no-op wait: the insert's end event has
            # passed, since the fetch before this waited for it or the
            # event's query said so; not counted in host_syncs_total)
            ev1.synchronize()
            del self._unsettled[0]
            ms = ev0.elapsed_time(ev1)
            if rec.pop("stalled", False):
                self.decode_stall_ms_total += ms
            self.obs.record_dispatch(wall_ms=ms, start_ms=start, **rec)

    def _fetch_mark(self):
        """A CUDA event recorded right before a fetch that waits for the
        inserts still unsettled (None off the card, or with no classic
        insert since the last fetch)."""
        if not self._unsettled or self.device.type != "cuda":
            return None
        ev = _timing_event()
        ev.record()
        return ev

    def _wall_past_inserts(self, wall_ms: float, fetched) -> float:
        """The wall of a dispatch whose fetch just returned, started no
        earlier than the end of the inserts enqueued before it.  Unlike
        JAX's, the port's insert fetches nothing, so this fetch waited for
        the inserts still unsettled, whose device time their own records
        carry (``_settle_inserts``).  The host and device clocks share no
        epoch, so the record is measured on the device: from the last
        insert's end event to ``fetched`` (``_fetch_mark``, before the
        fetch; both have passed once it returned).  The host wall stays
        when it is shorter (the insert ended before this dispatch
        began)."""
        if fetched is None:
            return wall_ms
        return min(wall_ms, self._unsettled[-1][3].elapsed_time(fetched))

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
        return (bool(self.queue) or bool(self._restoring)
                or bool(self._restored_ready)
                or any(s is not None for s in self.slots.values()))

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
        for r in self._restoring:
            if r.req.rid == request_id:
                # Mid-swap cancel: nothing was scattered into the pool
                # yet; the claims are released and the nodes fall back to
                # host residency (the slabs were read, not moved).
                self._restoring.remove(r)
                self._abort_restore(r)
                self.obs.request_end(request_id, outcome, error)
                return True
        for i, (req, chain, hits) in enumerate(self._restored_ready):
            if req.rid == request_id:
                # Restored but not admitted: the adopted blocks are
                # claimed; unclaim them back into the idle LRU.
                del self._restored_ready[i]
                self._unclaim_blocks(hits)
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
        # audit: racy-read(atomic list() snapshot of the single-writer
        # window; a scrape may miss the newest dispatch, never crash)
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
            # The live budget: a brownout rung shrinks it in place.
            "prefill_budget": int(self.prefill_budget),
            "prefix_index": self.prefix_index,
            "host_kv_blocks": self.host_kv_blocks,
            "logprobs": self.logprobs,
            "use_pallas_kernel": bool(kw["use_pallas_kernel"]),
            "cost_models": self.cost_models,
            "serve_mesh": _smesh.mesh_shape(self.mesh),
        }

    def stats(self) -> Dict[str, float]:
        """Counters, under the JAX package's ``stats()`` names and values
        (``insert_dispatches_total`` is the port's: prefill dispatches,
        full and suffix; a fused prefill chunk is not one). Read by
        HTTP handler threads while the serving loop owns the batcher:
        each value is a point-in-time read of single-writer host state
        (the digest under its own lock; ``_pf`` snapshotted first, the
        loop may null it, and ``_graphs``), never a device read."""
        # audit: racy-read(point-in-time /metrics snapshot of
        # single-writer loop state; stale by <= 1 step, never torn)
        pf = self._pf
        graphs = self._graphs   # close() may null it
        shape = _smesh.mesh_shape(self.mesh)
        dg = self.kv_digest.summary()
        out: Dict[str, float] = {} if self.fault_injector is None else (
            dict(self.fault_injector.stats()))
        # audit: racy-read(point-in-time /metrics snapshot of
        # single-writer loop state; stale by <= 1 step, never torn)
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
            # The prefix cache (kvcache.py): the store's idle resident
            # blocks, hits, the radix index's size, the share of admitted
            # prompt tokens served from cached blocks, the host tier's
            # swap ledger and the chain digest's event ledger.
            "prefix_cached_blocks": self._store.cached_blocks(),
            "prefix_requests_hit_total": self.prefix_requests_hit,
            "prefix_blocks_reused_total": self.prefix_blocks_reused,
            "radix_nodes_total": self._store.nodes_total(),
            "prefix_hit_tokens_ratio": (
                self.prefix_hit_tokens_total
                / max(1, self.prompt_tokens_total)),
            "host_kv_blocks": self.host_kv_blocks,
            "host_tier_blocks": self._store.host_blocks(),
            "swap_queue_depth": len(self._restoring),
            "swap_ins_total": self.swap_ins_total,
            "swap_in_blocks_total": self.swap_in_blocks_total,
            "swap_out_blocks_total": self.swap_out_blocks_total,
            "swap_in_ms_total": round(self.swap_in_ms_total, 3),
            "swap_failures_total": self.swap_failures_total,
            "kv_digest_version": dg["version"],
            "kv_digest_loss_version": dg["loss_version"],
            "kv_publish_events_total": dg["publishes_total"],
            "kv_evict_events_total": dg["evictions_total"],
            "kv_demote_events_total": dg["demotions_total"],
            "kv_restore_events_total": dg["restores_total"],
            "kv_host_evict_events_total": dg["host_evictions_total"],
            "kv_block_bytes": self.block_bytes,
            "kv_export_blocks_total": self.kv_export_blocks_total,
            "kv_import_blocks_total": self.kv_import_blocks_total,
            "kv_export_events_total": self.kv_export_events_total,
            "kv_import_events_total": self.kv_import_events_total,
            "kv_handoff_aborted_total": self.kv_handoff_aborted_total,
            "kv_export_demoted_blocks_total": (
                self.kv_export_demoted_blocks_total),
            "serve_mesh_data": shape["data"],
            "serve_mesh_tensor": shape["tensor"],
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
            # Fused prefill-decode scheduling: prompt tokens of the
            # in-flight admission still to prefill, dispatches that
            # carried a prefill chunk, admissions through the fused lane,
            # and the decode stall that classic admissions cost.
            "prefill_budget": self.prefill_budget,
            "prefill_tokens_inflight": (
                pf.remaining_tokens if pf is not None else 0),
            "prefill_chunks_total": self.prefill_chunks_total,
            "fused_admissions_total": self.fused_admissions_total,
            "decode_stall_ms_total": round(self.decode_stall_ms_total, 3),
            # The program layer (utils.programs): whether the decode
            # programs run as CUDA graphs here, graphs captured, replays.
            "programs_captured": int(graphs is not None),
            "graph_captures_total": 0 if graphs is None else graphs.captures,
            "graph_replays_total": 0 if graphs is None else graphs.replays,
        })
        return out

    def kv_debug_json(self, depth: Optional[int] = None,
                      max_nodes: int = 2048,
                      since: Optional[int] = None) -> Dict[str, Any]:
        """The ``GET /debug/kv[?since=V]`` payload (JAX :2640): the chain
        digest's bounded tree walk plus its summary with this batcher's
        cache geometry; with ``since``, the digest's journaled events past
        version V, or the full walk tagged ``"resync": true`` when the
        journal cannot prove completeness.  Safe from HTTP handler
        threads: it reads the lock-guarded digest, construction-time
        geometry and two single-writer token counters."""
        if since is not None:
            got = self.kv_digest.events_since(since)
            if got is not None:
                events, version = got
                return {"version": version, "since": since,
                        "events": events, "summary": self._kv_summary()}
        out = self.kv_digest.nodes_json(depth=depth, max_nodes=max_nodes)
        if since is not None:
            out["resync"] = True
        out["summary"] = self._kv_summary()
        return out

    def _kv_summary(self) -> Dict[str, Any]:
        """The /debug/kv ``summary`` section: the digest's aggregates plus
        the cache geometry (JAX :2674)."""
        summary = self.kv_digest.summary()
        summary.update({
            "prefix_index": self.prefix_index,
            "block_size": self.block_size,
            "block_bytes": self.block_bytes,
            "total_blocks": self.n_blocks,
            "host_kv_blocks": self.host_kv_blocks,
            # audit: racy-read(point-in-time snapshot of single-writer
            # hit counters; stale by <= 1 admission, never torn -- the
            # fleet view's hit-ratio numerator and denominator)
            "prefix_hit_tokens_total": self.prefix_hit_tokens_total,
            "prompt_tokens_total": self.prompt_tokens_total,
        })
        return summary

    @torch.no_grad()
    def step(self) -> List[Tuple]:
        """Admit what fits, then one chunk of up to K decode iterations for
        every active slot (with a fused prefill chunk riding along while
        an admission is in flight).  Returns [(request_id, token, done)]
        for the tokens emitted this call, each with a 4th element, the
        token's logprob, when ``logprobs=True`` (JAX :2693-2700);
        finished slots free their blocks and queued requests are admitted
        for the next call."""
        self.last_step_features = set()
        try:
            with use_mesh(self.mesh), use_graphs(self._graphs):
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
            for rid, tok, *_ in self.step():
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
        device (``_scatter_rows``, the row count padded to a power of two
        by repeating the first row).  No dirty rows (the steady state): no
        upload."""
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
        rows = np.concatenate([rows, np.full(
            (pow2_bucket(len(rows)) - len(rows),), rows[0], rows.dtype)])
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
        MB = self.table.shape[1]
        (n_alloc, fill, pos, active, top_k, remaining, temps,
         top_ps) = up[:, 1 + MB:9 + MB].unbind(1)
        _scatter_rows(
            (self.d_table, self.d_n_alloc, self.d_fill, self.d_pos,
             self.d_active, self.d_top_ks, self.d_remaining, self.d_temps,
             self.d_top_ps, self.d_stops),
            up[:, 0].long(),
            (up[:, 1:1 + MB], n_alloc, fill, pos, active.bool(), top_k,
             remaining, temps.view(torch.float32),
             top_ps.view(torch.float32), up[:, 9 + MB:]))

    def _step_chunked(self) -> List[Tuple]:
        """One chunk dispatch, one packed fetch, then the host replays the
        token block to advance its mirrors and emit events (JAX :2851).
        While an admission is mid-prefill (``self._pf``) the dispatch is
        ``_fused_chunk``: the same K decode iterations plus one bounded
        prefill chunk and the same one fetch, so the decoding rows keep
        emitting while the prompt lands, and K does not collapse to 1 (a
        fused admission is no insert dispatch)."""
        admitted = self._admit_dispatches > self._admits_at_last_chunk
        self._admits_at_last_chunk = self._admit_dispatches
        pf = self._pf
        if pf is not None and not bool(np.any(self.active)):
            # Nothing decodes: keep the masked scan minimal while the
            # prefill advances.
            K = 1
        else:
            K = self._pick_chunk(admitted)
        self._sync_device_rows()
        # The fault sites fire once per chunk dispatch, before it: an
        # exception reaches the caller with nothing emitted, so recovery
        # replays from the tokens the caller was given (a mid-prefill
        # request from its prompt and delivered tokens, like any other).
        # ``prefill_chunk`` counts prefill-carrying dispatches only; the
        # flash site fires when the chunk runs the flash kernel.  The
        # stock kernel serves the chunk's T = 1 steps over a
        # full-precision pool; its quarantine falls back to the paged
        # kernel.
        kernels: List[KernelSpec] = []
        if pf is not None and pf.flash and self.config.attn_impl in (
                "auto", "flash"):
            kernels.append(PREFILL_KERNELS["flash"])
        if self.use_pallas_kernel:
            kernels.append(DECODE_KERNELS["paged"])
            if (self.config.decode_kernel == "stock-paged"
                    and not self.pool.quantized):
                kernels.append(DECODE_KERNELS["stock-paged"])
        self._open_dispatch("step", kernels,
                            sites=("prefill_chunk",) if pf else ())
        stock = DECODE_KERNELS["stock-paged"] in kernels
        self.steps_total += K
        self.decode_dispatches_total += 1
        self.decode_chunk_last = K
        live = [(b, s) for b, s in self.slots.items() if s is not None]
        obs_rids = [s.request_id for _, s in live]
        pf_adv = 0 if pf is None else min(pf.chunk, pf.remaining_tokens)
        final = pf is not None and pf.off + pf.chunk >= pf.suffix_len
        decoding = [(int(self.pos[b]), min(K, s.max_new - len(s.emitted)))
                    for b, s in live if self.active[b]]
        if final:
            decoding.append((len(pf.req.tokens), min(K, pf.req.max_new)))

        def cost():
            fl, by = self._cost.decode(decoding)
            if pf is not None:
                f2, b2 = self._cost.forward(
                    [(pf.base + pf.off, pf_adv)], 1 if final else 0)
                fl, by = fl + f2, by + b2
            return fl, by

        prog = "_chunk_scan" if pf is None else "_fused_chunk"
        cost_fl, cost_by = self._dispatch_cost(prog, cost)
        all_greedy = self._all_greedy()
        pf_done_rid: Optional[int] = None
        t0_obs = time.monotonic()
        state = (self.params, self.pool, self.d_table, self.d_n_alloc,
                 self.d_fill, self.tau, self.d_tau_lp, self.d_pos,
                 self.d_active, self.d_remaining, self.d_stops,
                 self._generators_for_round(), self.d_temps, self.d_top_ps,
                 self.d_top_ks)
        if pf is None:
            out = _chunk_scan(
                *state, config=self.config, n_iter=K,
                use_kernel=self.use_pallas_kernel, all_greedy=all_greedy,
                with_logprobs=self.logprobs)
        else:
            b = pf.slot
            # The prefilling row's first token is its request's first draw
            # (the classic insert's): the fused lane's generator starts
            # from the request's seed at the dispatch that lands the last
            # chunk, whatever the dispatches before drew on it, and the
            # slot's generator one draw past it, where the scan's draws
            # go on.
            all_greedy = all_greedy and pf.req.temperature <= 0.0
            if final:
                self._seed_lane(self._pf_gen, pf.req, slot=b)
            pf_row, pf_len, pf_base, pf_off = self._pf_dev.unbind(0)
            out = _fused_chunk(
                *state, pf_row, pf.d_toks, pf_len, pf_base, pf_off,
                self._pf_gen, config=self.config, n_iter=K,
                pf_chunk=pf.chunk, use_kernel=self.use_pallas_kernel,
                all_greedy=all_greedy, with_logprobs=self.logprobs)[:-1]
            pf.off += pf.chunk
            self.prefill_chunks_total += 1
            if final:
                # The device folded the row into the decode state and
                # the scan emitted its first token: catch the host
                # mirrors up (no dirty marking) and publish the full
                # chain, whose blocks hold all of its KV only now.
                self.fill[b] = _round_up(len(pf.req.tokens), self.block_size)
                self.pos[b] = len(pf.req.tokens)
                self.active[b] = True
                self._register_chain(self.slots[b].blocks[:len(pf.chain)],
                                     pf.chain)
                pf_done_rid = pf.req.rid
                self._pf = None
        (packed, self.tau, self.d_tau_lp, self.d_fill, self.d_pos,
         self.d_active, self.d_remaining) = out
        # The one device->host sync of the chunk: the tokens and, bit-cast
        # beside them, their logprobs.
        tf_obs = time.monotonic()
        # A decode chunk's record starts where the classic inserts before
        # it ended (their own records carry their time).
        fetched = self._fetch_mark() if pf_adv == 0 else None
        # audit: host-fetch(the one packed fetch of a chunk dispatch,
        # counted in host_syncs_total)
        arr = packed.cpu().numpy()
        self.host_syncs_total += 1
        now_obs = time.monotonic()
        wall_ms = self._wall_past_inserts((now_obs - t0_obs) * 1000.0,
                                          fetched)
        self._settle_inserts(wait=True)
        self.obs.record_dispatch(
            # A fused chunk keeps one kind: its work mixes prefill and
            # decode.  Its wall time runs to its own fetch, which is what
            # the prefill_chunk_ms histogram books.
            kind=(("decode:stock-paged" if stock else "decode")
                  if pf_adv == 0 else "fused"),
            k=K, occupancy=len(obs_rids), prefill_tokens=pf_adv,
            wall_ms=wall_ms,
            fetch_ms=(now_obs - tf_obs) * 1000.0,
            swap_inflight=len(self._restoring), rids=obs_rids,
            program=prog, flops=cost_fl, bytes_accessed=cost_by,
        )
        if pf_done_rid is not None:
            # The first token the last chunk sampled opens the decoding
            # span.
            self.obs.begin_span(pf_done_rid, "decoding")
        toks = arr[0]
        lps = arr[1].view(np.float32) if self.logprobs else None

        out_ev: List[Tuple] = []
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
                out_ev.append(
                    (slot.request_id, tok, done, float(lps[b, i]))
                    if self.logprobs else (slot.request_id, tok, done))
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
        return out_ev

    def _generators_for_round(self) -> List[torch.Generator]:
        """Every slot's generator, in slot order: a decode program draws
        once an iteration from each of them (a speculative round its
        draws) unless every active row is greedy (``_all_greedy``)."""
        return list(self.generators)

    def _all_greedy(self) -> bool:
        """JAX's static ``all_greedy``: every active row is greedy, so a
        program draws nothing (its own key; JAX :2942)."""
        return bool(np.all(self.temp_arr[self.active] <= 0.0))

    def _emit(self, b: int, tok: int, out: List[Tuple], lp=None) -> bool:
        """Deliver one token of slot ``b`` on a speculative step (with its
        logprob ``lp`` under logprobs=True); True when its request is done
        (a stop token or the budget spent)."""
        slot = self.slots[b]
        slot.emitted.append(tok)
        self.emitted_total += 1
        self.spec_emitted_total += 1
        done = tok in slot.stop_tokens or len(slot.emitted) >= slot.max_new
        out.append((slot.request_id, tok, done, float(lp))
                   if self.logprobs else (slot.request_id, tok, done))
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

    def _step_spec(self) -> List[Tuple]:
        """Speculative step (JAX :3135).  ``spec_rounds`` > 1 takes the
        chunked path; ``spec_rounds=1`` is the per-round loop, the oracle
        the chunked path is held to: emit each slot's pending token, free
        finished slots before the round (a finishing request does not pay
        for a draft and a verify whose output it would drop), then one
        round (``_spec_tail``)."""
        if self.spec_rounds > 1:
            return self._step_spec_chunked()
        out: List[Tuple] = []
        # The pending tokens and, bit-cast beside them, their logprobs:
        # one fetch.
        # audit: host-fetch(the one packed fetch of a speculative round,
        # counted in host_syncs_total and spec_host_syncs_total)
        got = _pack_logprobs(self.tau, self.d_tau_lp if self.logprobs
                             else None).cpu().numpy()
        taus = got[0]
        tau_lps = got[1].view(np.float32) if self.logprobs else None
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
            if self._emit(b, tok, out,
                          tau_lps[b] if self.logprobs else None):
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

    def _spec_tail(self, out: List[Tuple]) -> None:
        """One round of the per-round loop (JAX :3451): upload the host
        mirrors (one packed copy), draft and verify, fetch outs, acc and
        under logprobs the target's logprobs (one packed copy), emit the
        accepted prefix, advance fill/pos by acc+1, and keep ``outs[acc]``
        (and its logprob) as the next pending token."""
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
        outs, acc, lps = _spec_round_core(
            self.params, self.draft_params, self.pool, self.draft_pool,
            up[:, :MB].contiguous(), n_alloc, fill, self.tau, pos,
            active.bool(),
            self._generators_for_round(), temps.view(torch.float32),
            top_ps.view(torch.float32), top_k, t_config=self.config,
            d_config=self.draft_config, n_draft=G,
            use_kernel=self.use_pallas_kernel,
            all_greedy=self._all_greedy(), with_logprobs=self.logprobs,
        )
        tf_obs = time.monotonic()
        cols = [outs, acc[:, None]]
        if self.logprobs:
            cols.append(lps.float().contiguous().view(torch.int32))
        cols = torch.cat(cols, dim=1)
        fetched = self._fetch_mark()
        # audit: host-fetch(the one packed fetch of a speculative round's
        # verify, counted in host_syncs_total and spec_host_syncs_total)
        arr = cols.cpu().numpy()
        lps = arr[:, G + 2:].view(np.float32) if self.logprobs else None
        self.host_syncs_total += 1
        self.spec_host_syncs_total += 1
        now_obs = time.monotonic()
        wall_ms = self._wall_past_inserts((now_obs - t0_obs) * 1000.0,
                                          fetched)
        self._settle_inserts(wait=True)
        self.obs.record_dispatch(
            kind="spec", k=1, occupancy=len(live),
            wall_ms=wall_ms,
            fetch_ms=(now_obs - tf_obs) * 1000.0,
            swap_inflight=len(self._restoring), rids=live,
            program="_spec_round_core", flops=cost_fl,
            bytes_accessed=cost_by,
        )
        round_proposed = round_accepted = 0
        new_tau = np.zeros((B,), np.int32)
        new_lp = np.zeros((B,), np.float32)
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
                done = self._emit(b, int(arr[b, i]), out,
                                  lps[b, i] if self.logprobs else None)
                if done:
                    break
            if done:
                self._free_slot(b)
            else:
                new_tau[b] = arr[b, a]
                if self.logprobs:
                    # The pending token's logprob travels with it.
                    new_lp[b] = lps[b, a]
                self.fill[b] += a + 1
                self.pos[b] += a + 1
                self.remaining[b] = slot.max_new - len(slot.emitted)
        if round_proposed:
            self._accept_window.append((round_proposed, round_accepted))
        if self.logprobs:
            up = torch.from_numpy(np.stack([new_tau, new_lp.view(np.int32)])
                                  ).to(self.device)
            self.tau, self.d_tau_lp = up[0], up[1].view(torch.float32)
        else:
            self.tau = torch.from_numpy(new_tau).to(self.device)

    def _step_spec_chunked(self) -> List[Tuple]:
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
        (packed, self.tau, self.d_tau_lp, self.d_fill, self.d_pos,
         self.d_active, self.d_remaining) = _spec_rounds_chunk(
            self.params, self.draft_params, self.pool, self.draft_pool,
            self.d_table, self.d_n_alloc, self.d_fill, self.tau,
            self.d_tau_lp, self.d_pos, self.d_active, self.d_remaining,
            self.d_stops, self._generators_for_round(), self.d_temps,
            self.d_top_ps, self.d_top_ks, t_config=self.config,
            d_config=self.draft_config, n_draft=G, n_rounds=R,
            use_kernel=self.use_pallas_kernel,
            all_greedy=self._all_greedy(), with_logprobs=self.logprobs,
        )
        # The one device->host sync of the chunk.
        tf_obs = time.monotonic()
        fetched = self._fetch_mark()
        # audit: host-fetch(the one packed fetch of a chunk of speculative
        # rounds, counted in host_syncs_total and spec_host_syncs_total)
        arr = packed.cpu().numpy()
        self.host_syncs_total += 1
        self.spec_host_syncs_total += 1
        now_obs = time.monotonic()
        wall_ms = self._wall_past_inserts((now_obs - t0_obs) * 1000.0,
                                          fetched)
        self._settle_inserts(wait=True)
        self.obs.record_dispatch(
            kind="spec", k=R, occupancy=len(live),
            wall_ms=wall_ms,
            fetch_ms=(now_obs - tf_obs) * 1000.0,
            swap_inflight=len(self._restoring), rids=live,
            program="_spec_rounds_chunk", flops=cost_fl,
            bytes_accessed=cost_by,
        )

        lps = arr[:, :, G + 2:].view(np.float32) if self.logprobs else None
        out: List[Tuple] = []
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
                if self._emit(b, tok0, out,
                              lps[b, r, 0] if self.logprobs else None):
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
                    if self._emit(b, tok, out, lps[b, r, 1 + i]
                                  if self.logprobs else None):
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
        the slot.  The request's own prompt blocks are UNPUBLISHED first
        (JAX :2311): KV written by a dispatch whose logits came back
        non-finite must never be hit.  Reused hit blocks (the leading
        ``slot.shared``) hold earlier healthy dispatches' KV and stay
        published."""
        slot = self.slots[b]
        stranded: List[int] = []
        for blk in slot.blocks[slot.shared:]:
            stranded.extend(self._store.unpublish(blk))
        # A radix unpublish drops the node's subtree too; idle retained
        # blocks stranded by that go back to the free list.
        self._invalidate_and_free(stranded)
        self.failed.append((slot.request_id, self._NONFINITE_MSG))
        self.nonfinite_rows_total += 1
        self.obs.request_end(slot.request_id, "failed", self._NONFINITE_MSG)
        self._free_slot(b, device_done=device_done)

    # -- block allocation, retention and the host tier ----------------------

    def _capacity(self) -> int:
        """Allocatable blocks: truly free + evictable cached prefixes."""
        return len(self.free_blocks) + self._store.evictable()

    def _demote_block(self, blk: int) -> Dict[str, torch.Tensor]:
        """Host-tier demotion: copy block ``blk``'s KV (and the draft
        pool's twin) into an arena slab BEFORE the allocator invalidates
        its positions (stream order keeps the copy first).  The sweep's
        one host sync follows (``_sync_demotions``)."""
        slab = self._arena.take()
        fetch_slab(self.pool, blk, into=slab)
        if self.spec:
            fetch_slab(self.draft_pool, blk, prefix="d_", into=slab)
        self.swap_out_blocks_total += 1
        self._demotions_unsynced = True
        return slab

    def _sync_demotions(self) -> None:
        """The one host sync of a demotion sweep: the slabs' copies have
        landed before a swap-in on the side stream (or anyone) reads
        them.  Counted in ``swap_out_blocks_total`` (per block), never in
        ``host_syncs_total`` (the decode loop's contract)."""
        if self._demotions_unsynced and self.device.type == "cuda":
            # audit: host-fetch(the one sync of a demotion sweep, off the
            # decode loop; counted in swap_out_blocks_total per block)
            torch.cuda.current_stream(self.device).synchronize()
        self._demotions_unsynced = False

    def _alloc_blocks(self, n: int) -> List[int]:
        """Pop n blocks, evicting LRU cached-prefix blocks when the free
        list runs dry (JAX :3601): into the host tier when one is
        attached (the block's KV demotes and its radix node stays
        matchable), dropped outright otherwise.  Evicted blocks' positions
        are invalidated here, after any demotion copy: a block re-purposed
        for a decode reservation is overwritten only up to the prompt
        span, and a stale pos >= 0 past it would be attended."""
        self._fault("alloc")
        out: List[int] = []
        evicted: List[int] = []
        for _ in range(n):
            if self.free_blocks:
                out.append(self.free_blocks.pop(0))
                continue
            blk, extra = self._store.pop_evictable(self._demote_block)
            assert blk is not None, "allocation past capacity"
            evicted.append(blk)
            out.append(blk)
            if extra:
                # A forced subtree drop (host-LRU victim, stranded
                # suffix) orphaned more idle blocks: back to the free
                # list, positions invalidated.
                self._invalidate_and_free(extra)
        if evicted:
            self._invalidate_evicted(evicted)
        self._sync_demotions()
        return out

    def _invalidate_evicted(self, evicted: List[int]) -> None:
        """Invalidate re-purposed blocks' pool positions (and the draft
        pool's), after any demotion copy, which needs them live: one
        ``_release_blocks`` write per ``blocks_per_slot`` ids, padded to
        that fixed width with the sentinel (JAX :3868)."""
        MB = self.blocks_per_slot
        ids = np.full((-(-len(evicted) // MB), MB), self.n_blocks, np.int32)
        ids.reshape(-1)[:len(evicted)] = evicted
        d_ids = torch.from_numpy(ids).to(self.device)
        for row in d_ids:
            _release_blocks(self.pool.pos, row)
            if self.spec:
                _release_blocks(self.draft_pool.pos, row)

    def demote_idle(self, n: int) -> int:
        """Demote up to ``n`` idle cached-prefix blocks into the host tier,
        freeing pool blocks without dropping cache content (JAX :3664):
        the pressure path does the same lazily in ``_alloc_blocks``; this
        is the operational lever (the brownout rung's sweep) and the
        deterministic one for drills.  No-op without a tier; returns the
        number of blocks demoted."""
        if self.host_kv_blocks <= 0 or self._store.kind != "radix":
            return 0
        count = 0
        drained: List[int] = []
        for _ in range(n):
            if not self._store.evictable():
                break
            blk, extra = self._store.pop_evictable(self._demote_block)
            if blk is None:
                break
            drained.append(blk)
            drained.extend(extra)
            count += 1
        # One invalidation and one sync for the whole sweep.
        self._invalidate_and_free(drained)
        self._sync_demotions()
        return count

    def _invalidate_and_free(self, blocks: List[int]) -> None:
        """Return blocks to the free list with their pool positions
        invalidated."""
        if not blocks:
            return
        self._invalidate_evicted(blocks)
        self.free_blocks.extend(blocks)

    # -- prefix export / import ---------------------------------------------

    def resident_chain_keys(self) -> List[List[bytes]]:
        """Every maximal pool-resident cached chain, as ordered key lists
        in the ``chain_keys`` schema (JAX :3701): what a drain exports.
        Host bookkeeping only, on the thread that owns the batcher."""
        if not self.prefix_cache_enabled:
            return []
        return self._store.resident_chains()

    def export_prefix(
        self, tokens: Optional[Sequence[int]] = None,
        request_id: Optional[str] = None,
        *,
        keys: Optional[Sequence[bytes]] = None,
        max_bytes: Optional[int] = None,
        demote_after_export: bool = False,
    ) -> Tuple[List[bytes], List[Dict[str, torch.Tensor]]]:
        """The longest pool-resident cached chain prefix of ``tokens`` (or
        of the chain ``keys``) as host slabs (JAX :3713; the draft pool's
        twins ride along under speculation), for another batcher's
        ``import_prefix``.  ``max_bytes`` truncates block-aligned from the
        root; ``demote_after_export`` demotes the exported chain's idle
        blocks (``demote_exported``).  Returns ``(chain keys, slabs)``,
        empty with the prefix cache off or nothing resident.  A blocking
        copy, on the thread that owns the batcher."""
        if not self.prefix_cache_enabled:
            return [], []
        if keys is None:
            assert tokens is not None, "export_prefix needs tokens or keys"
            keys = self._chain_keys(tokens, self.block_size)
        else:
            keys = list(keys)
        blocks = self._match_prefix(keys).blocks
        if max_bytes is not None and self.block_bytes > 0:
            blocks = blocks[: max(0, max_bytes // self.block_bytes)]
        slabs: List[Dict[str, torch.Tensor]] = []
        for blk in blocks:
            slab = fetch_slab(self.pool, blk)
            if self.spec:
                slab.update(fetch_slab(self.draft_pool, blk, prefix="d_"))
            slabs.append(slab)
        self.kv_export_blocks_total += len(slabs)
        if slabs:
            self.kv_export_events_total += 1
        if demote_after_export and slabs:
            self.demote_exported(keys[: len(slabs)], slabs,
                                 request_id=request_id)
        self.obs.annotate("prefix_export", blocks=len(slabs),
                          request_id=request_id)
        return list(keys[: len(slabs)]), slabs

    def demote_exported(
        self, keys: Sequence[bytes],
        slabs: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
        request_id: Optional[str] = None,
    ) -> int:
        """Demote an exported chain's IDLE blocks to the host tier (or
        drop idle leaf blocks with no tier) so that a handoff does not
        leave a second copy in this pool (JAX :3780).  ``slabs``, the
        export's copies, go into the tier instead of a second copy of the
        same blocks.  Radix only; claimed blocks never move.  Returns the
        number of blocks that left the pool."""
        if not self.prefix_cache_enabled or self._store.kind != "radix":
            return 0
        keys = list(keys)
        slab_by_key = dict(zip(keys, slabs)) if slabs else {}

        def fetch(blk: int) -> Dict[str, torch.Tensor]:
            node = self._store._by_block.get(blk)
            slab = slab_by_key.get(node.key) if node is not None else None
            if slab is not None:
                self.swap_out_blocks_total += 1
                return slab
            return self._demote_block(blk)

        freed = self._store.demote_keys(
            keys, fetch if self.host_kv_blocks > 0 else None)
        self.kv_export_demoted_blocks_total += len(freed)
        self._invalidate_and_free(freed)
        self._sync_demotions()
        if freed:
            self.obs.annotate("prefix_demote_after_export",
                              blocks=len(freed), request_id=request_id)
        return len(freed)

    def import_prefix(
        self, keys: Sequence[bytes],
        slabs: Sequence[Dict[str, torch.Tensor]],
        request_id: Optional[str] = None,
        *,
        max_bytes: Optional[int] = None,
        timeout_s: Optional[float] = None,
    ) -> int:
        """Land exported slabs in this batcher's pool and publish the
        chain, so the next admission of those tokens is a prefix hit (JAX
        :3825): alloc, ``stage_restore`` on the side stream,
        ``adopt_into_pool``.  Blocks already resident are skipped; the
        landing truncates to capacity (and ``max_bytes``), block-aligned
        from the root.  Synchronous; returns the number of blocks landed.
        Past ``timeout_s`` on the staged copies the import unwinds (fresh
        blocks freed, nothing published), counts
        ``kv_handoff_aborted_total`` and raises TimeoutError."""
        if not self.prefix_cache_enabled or not slabs:
            return 0
        keys = list(keys)[: len(slabs)]
        have = self._store.match(keys).blocks
        todo = list(slabs)[len(have):len(keys)]
        if max_bytes is not None and self.block_bytes > 0:
            todo = todo[: max(0, max_bytes // self.block_bytes)]
        if not todo:
            return 0
        # Claim the matched resident blocks BEFORE allocating: idle
        # matched blocks are what _alloc_blocks evicts first, and an
        # evicted-then-republished id would bind the old key to another
        # chain's KV.
        self._claim_blocks(have)
        try:
            cap = self._capacity()
            if len(todo) > cap:
                todo = todo[:cap]
            if not todo:
                return 0
            fresh = self._alloc_blocks(len(todo))
            staged = stage_restore(todo, fresh, self.n_blocks,
                                   device=self.device,
                                   stream=self._side_stream(),
                                   shardings=self._staging(todo[0]))
            if timeout_s is not None:
                deadline = time.monotonic() + timeout_s
                while not self._agree(restore_ready(staged)):
                    # Any rank past the deadline aborts on every rank.
                    if not self._agree(time.monotonic() < deadline):
                        # The staging tensors belong to the side stream:
                        # the allocator hands their memory only to later
                        # work on that stream, behind these copies.
                        self.kv_handoff_aborted_total += 1
                        self._invalidate_and_free(fresh)
                        self.obs.annotate(
                            "prefix_import_aborted", blocks=len(todo),
                            request_id=request_id, timeout_s=timeout_s)
                        raise TimeoutError(
                            f"prefix import: staged transfer of "
                            f"{len(todo)} block(s) not ready within "
                            f"{timeout_s}s (unwound cleanly)")
                    time.sleep(0.001)
            wait_restore(staged)
            adopt_into_pool(self.pool, staged)
            if self.spec:
                adopt_into_pool(self.draft_pool, staged, prefix="d_")
            self._store.publish(keys[: len(have) + len(todo)], have + fresh)
            # A node mid-swap-in refuses the published copy: its fresh
            # block stays unkeyed, so free it instead of leaking it.
            adopted = [b for b in fresh if self._store.is_keyed(b)]
            self._store.retain(adopted)
            self._invalidate_and_free([b for b in fresh if b not in adopted])
            self.kv_import_blocks_total += len(adopted)
            if adopted:
                self.kv_import_events_total += 1
            self.obs.annotate("prefix_import", blocks=len(adopted),
                              request_id=request_id)
            return len(adopted)
        finally:
            # The matched blocks return to the idle LRU: the claim only
            # protected them from this call's own allocation.
            self._unclaim_blocks(have)

    # -- the prefix index's refcount boundary -------------------------------

    # Chain hash per full prompt block, the shared key schema.
    _chain_keys = staticmethod(chain_keys)

    def _match_prefix(self, keys: List[bytes]) -> MatchResult:
        """Longest cached chain prefix across all cached chains:
        ``.blocks`` are the resident hits, a nonempty ``.restore`` names
        demoted nodes a swap-in could bring back."""
        return self._store.match(keys)

    def _claim_blocks(self, blocks: List[int]) -> None:
        self._store.on_claim(blocks)
        for blk in blocks:
            self._block_refs[blk] = self._block_refs.get(blk, 0) + 1

    def _unclaim_blocks(self, blocks: List[int]) -> None:
        """Reverse of ``_claim_blocks`` (a freed slot, an aborted or
        cancelled swap-in): drop one reference from each block; keyed
        blocks whose last user this was are retained in the idle LRU (in
        chain order: the store reverses, so chains evict leaves first),
        the rest return to the free list with their positions
        invalidated."""
        retained: List[int] = []
        plain: List[int] = []
        for blk in blocks:
            refs = self._block_refs.get(blk, 1) - 1
            if refs > 0:
                self._block_refs[blk] = refs
                continue
            self._block_refs.pop(blk, None)
            if self.prefix_cache_enabled and self._store.is_keyed(blk):
                retained.append(blk)
            else:
                plain.append(blk)
        self._store.retain(retained)
        self._invalidate_and_free(plain)

    def _register_chain(self, blocks: List[int], keys: List[bytes]) -> None:
        """Publish a request's freshly prefilled full prompt blocks into
        the prefix index (radix: duplicates keep the existing node's
        block; exact: a duplicate supersedes, and the old idle blocks are
        freed here in one batch)."""
        if not self.prefix_cache_enabled:
            return
        self._invalidate_and_free(self._store.publish(keys, blocks))

    def _free_slot(self, b: int, device_done: bool = False) -> None:
        """Free slot ``b``: keyed blocks with no remaining users are
        RETAINED for future hits (their positions stay valid), the rest
        return to the free list with their positions invalidated (a stale
        pos >= 0 past a later prompt would be attended).  ``device_done``:
        the chunk already folded the row out on the device, so no
        deactivation upload is owed; a host-initiated free (cancel) marks
        the row dirty."""
        slot = self.slots[b]
        assert slot is not None
        if self._pf is not None and self._pf.slot == b:
            # Mid-prefill free (cancel, a failed row): drop the in-flight
            # admission (JAX :4004-4012).  No later dispatch names it, and
            # stream order lands its enqueued chunk writes before any
            # reuse of its blocks; its chain was never published.
            self._pf = None
        self._unclaim_blocks(slot.blocks)
        # Session KV footprint at teardown.
        self.obs.observe_kv(session_blocks=len(slot.blocks))
        self.slots[b] = None
        self.table[b] = self.n_blocks
        self.n_alloc[b] = 0
        self.fill[b] = 0
        self.active[b] = False
        self.remaining[b] = 0
        self.stop_tab[b, :] = -1
        if not device_done:
            self._dirty_rows.add(b)

    def _suffix_pad(self, n_suffix_tokens: int, n_share: int) -> int:
        """Padded suffix length for the grouped suffix insert (JAX
        :4043): round to a block multiple, then bucket the block count to
        a power of two.  The padding is masked compute, and pool write
        columns past a row's reservation drop.  The hard bound is the
        gathered VIEW: its width is blocks_per_slot x block_size and the
        in-forward cache write starts at fill0 = n_share blocks, so the
        bucket is clamped to the columns the row has (admissibility
        guarantees the un-bucketed count fits)."""
        nb = max(1, -(-n_suffix_tokens // self.block_size))
        nb_b = pow2_bucket(nb)
        cap = self.blocks_per_slot - n_share
        return (min(nb_b, cap) if cap >= nb else nb) * self.block_size

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

    def _seed_lane(self, lane: torch.Generator, req: _Request,
                   slot: Optional[int] = None) -> None:
        """Seed an admission lane's generator from a sampled request's
        seed (its own, or ``default_seed``): the request's first token is
        then the first draw from that seed, as a fresh generator's would
        be.  With ``slot`` (the fused lane, whose dispatch goes on to draw
        the row's next tokens from the slot's generator) the slot's
        generator is also set one draw past the same seed, where the
        lane's draw leaves a generator.  A greedy request leaves both as
        they are."""
        if req.temperature <= 0.0:
            return
        seed = req.seed if req.seed is not None else self.default_seed(
            req.rid)
        lane.manual_seed(seed)
        if slot is not None:
            g = self.generators[slot].manual_seed(seed)
            # One draw of the first token's shape, as ``categorical``'s.
            torch.empty((1, self.config.vocab_size), dtype=torch.float32,
                        device=self.device).exponential_(1, generator=g)

    def _hand_lanes(self, reqs: Sequence[_Request],
                    slots: Sequence[int]) -> None:
        """After an insert: each sampled request's slot generator takes
        its insert lane's state (one draw past the request's seed), so
        the decode programs' draws go on from there."""
        for i, (req, b) in enumerate(zip(reqs, slots)):
            if req.temperature > 0.0:
                self.generators[b].set_state(self._lane_gens[i].get_state())

    def _side_stream(self):
        """The CUDA stream swap-in copies run on (None on the CPU), made
        on first use by the thread that owns the batcher."""
        if self.device.type != "cuda":
            return None
        if self._swap_stream is None:
            self._swap_stream = torch.cuda.Stream(device=self.device)
        return self._swap_stream

    def _start_timer(self):
        """(host clock, obs clock, start event on the card or None) of a
        dispatch that no fetch ends (an insert, a suffix insert, an
        adopt)."""
        ev0 = None
        if self.device.type == "cuda":
            ev0 = _timing_event()
            ev0.record()
        return time.monotonic(), self.obs.now_ms(), ev0

    def _record_timed(self, timer, rec: Dict[str, Any]) -> None:
        """Record a dispatch started under ``timer``: on the card its
        device time between CUDA events, once the next fetch has passed
        them (``_settle_inserts``); on the CPU, where it ran as it was
        called, its wall time now.  A classic admission's dispatch made
        while a row decodes (``_stalling``) adds that time to
        ``decode_stall_ms_total`` (JAX :4651-4668 clocks the host around
        the admission, which there blocks on the insert; here the insert
        is asynchronous, so its own time is the stall)."""
        t0, start, ev0 = timer
        if ev0 is None:
            ms = (time.monotonic() - t0) * 1000.0
            if self._stalling:
                self.decode_stall_ms_total += ms
            self.obs.record_dispatch(wall_ms=ms, **rec)
            return
        ev1 = _timing_event()
        ev1.record()
        self._unsettled.append(
            (dict(rec, stalled=self._stalling), start, ev0, ev1))

    def _install_row(self, b: int, req: _Request, blocks: List[int],
                     shared: int = 0) -> None:
        """Slot ``b``'s host mirrors for an admitted request (its prompt
        prefilled, its first token pending on the device)."""
        self.pos[b] = len(req.tokens)
        self.fill[b] = _round_up(len(req.tokens), self.block_size)
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
        self.slots[b] = _Slot(
            request_id=req.rid, emitted=[], max_new=req.max_new,
            stop_tokens=req.stops, blocks=blocks, shared=shared,
        )

    def _fused_scheduling(self) -> bool:
        """Fused prefill-decode scheduling is in force (JAX :4296): a
        budget, and no draft model (a speculative round has no prefill
        lane)."""
        return self.prefill_budget > 0 and not self.spec

    def _admit(self) -> None:
        """Admit queued requests (JAX :4303).  In-flight swap-ins are
        polled (never blocking while a row decodes) and completed ones
        admitted first, FIFO.  Under fused scheduling while a row decodes,
        the queue head moves to ``prefilling`` (``_begin_fused_prefill``)
        and its prompt advances inside the next chunk dispatches, one
        admission at a time; otherwise (budget 0, a draft model, a cold
        pool) the classic admission of the queue."""
        self._poll_restores()
        self._admit_restored_ready()
        if self._fused_scheduling():
            if self._pf is not None:
                return  # one in-flight admission at a time
            if bool(np.any(self.active)):
                if self.queue:
                    self._begin_fused_prefill()
                return
            # A cold pool: nobody to stall, classic batched admission.
        self._admit_classic()

    def _admit_classic(self) -> None:
        """The classic admission with the decode-stall clock around it
        (JAX :4651): inserts dispatched while a row decodes stall it, and
        their time adds to ``decode_stall_ms_total`` (``_record_timed``)."""
        self._stalling = bool(np.any(self.active))
        try:
            self._admit_classic_impl()
        finally:
            self._stalling = False

    def _admit_classic_impl(self) -> None:
        """Admit queued requests into free slots (JAX
        ``_admit_classic_impl``).  A burst of admissible requests without
        a prefix hit shares ONE [k', P] prefill dispatch
        (``_insert_batch``); requests whose leading full blocks hit the
        prefix cache are admitted through ``_paged_suffix_insert``, grouped
        by padded suffix length, one dispatch a group.  A queue HEAD whose
        matched prefix includes host-tier blocks parks in ``restoring``
        instead, while later entries keep admitting.  FIFO head-of-line
        blocking on block reservations (the budget is the full
        reservation, hits included)."""
        BLK = self.block_size
        while True:
            free_slots = [b for b, s in self.slots.items() if s is None]
            if not free_slots or not self.queue:
                return
            # Only a radix store with a tier can report demoted hits; the
            # head's (chain, hits) carries into the pick loop.
            head_match = None
            if self.host_kv_blocks > 0 and self._store.kind == "radix":
                while self.queue:
                    req = self.queue[0]
                    chain0 = (self._chain_keys(req.tokens, BLK)
                              if self.prefix_cache_enabled else [])
                    m0 = self._match_prefix(chain0)
                    if not m0.restore:
                        head_match = (req.rid, chain0, m0.blocks)
                        break
                    if req.blocks_needed(BLK) > self._capacity():
                        return  # FIFO: wait for capacity
                    del self.queue[0]
                    self._begin_restore(req, chain0, m0)
            picked: List[Tuple[_Request, List[bytes], List[int]]] = []
            budget = self._capacity()
            for req in self.queue:
                if len(picked) >= len(free_slots):
                    break
                need = req.blocks_needed(BLK)
                if need > budget:
                    break  # head-of-line blocking: wait for capacity
                budget -= need
                if head_match is not None and head_match[0] == req.rid:
                    chain, hits = head_match[1], head_match[2]
                else:
                    chain = (self._chain_keys(req.tokens, BLK)
                             if self.prefix_cache_enabled else [])
                    hits = self._match_prefix(chain).blocks
                # Claim hits at selection: a later allocation of this
                # round must not evict them.
                self._claim_blocks(hits)
                picked.append((req, chain, hits))
            if not picked:
                return
            del self.queue[:len(picked)]
            slot_iter = iter(free_slots)
            groups: Dict[int, List[Tuple[_Request, List[bytes],
                                         List[int]]]] = {}
            for req, chain, hits in picked:
                if hits:
                    T = self._suffix_pad(len(req.tokens) - len(hits) * BLK,
                                         len(hits))
                    groups.setdefault(T, []).append((req, chain, hits))
            for grp in groups.values():
                self._admit_shared_group(grp, [next(slot_iter) for _ in grp])
            batch = [(r, c) for r, c, h in picked if not h]
            if batch:
                self._insert_batch(batch, [next(slot_iter) for _ in batch])

    def _insert_batch(self, batch: List[Tuple[_Request, List[bytes]]],
                      slot_ids: List[int]) -> None:
        """One cold [k', P] prefill for requests without a prefix hit (k'
        = k rounded up to a power of two, P = the group's longest
        block-padded prompt, its block count rounded up to a power of
        two); their full prompt blocks join the prefix index."""
        BLK = self.block_size
        k = len(batch)
        kb = pow2_bucket(k)
        nb = min(pow2_bucket(max(_round_up(len(r.tokens), BLK)
                                 for r, _ in batch) // BLK),
                 self.blocks_per_slot)
        P = nb * BLK
        pt = np.zeros((kb, P), np.int32)
        pm = np.zeros((kb, P), np.int32)
        bid = np.full((kb, nb), self.n_blocks, np.int32)
        pol = np.zeros((kb, 3), np.float32)  # temperature, top_p, top_k
        pol[:, 1] = 1.0
        # Every row draws from its lane's generator (the same objects at
        # every call, which the insert's graphs hold); a greedy or padding
        # row's draw is discarded.
        generators = self._lane_gens[:kb]
        row_blocks = []
        for i, (req, _) in enumerate(batch):
            need = req.blocks_needed(BLK)
            blocks = self._alloc_blocks(need)
            row_blocks.append(blocks)
            n = len(req.tokens)
            self.prompt_tokens_total += n
            self.obs.request_kv(req.rid, blocks_held=need,
                                prefix_hit_tokens=0)
            self.obs.observe_kv(hit_depth_tokens=0)
            pt[i, :n] = req.tokens
            pm[i, :n] = 1
            span = _round_up(n, BLK) // BLK
            bid[i, :span] = blocks[:span]
            pol[i] = (req.temperature, req.top_p, req.top_k)
            self._seed_lane(generators[i], req)
        # One upload for the admission: prompts, masks, policies and the
        # rows' destination blocks.
        up = torch.from_numpy(np.concatenate(
            [pt, pm, pol.view(np.int32), bid], axis=1)).to(self.device)
        temps = up[:, 2 * P].view(torch.float32)
        top_ps = up[:, 2 * P + 1].view(torch.float32)
        top_ks = up[:, 2 * P + 2].view(torch.float32).to(torch.int32)
        d_bid = up[:, 2 * P + 3:]
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
        for req, _ in batch:
            self.obs.begin_span(req.rid, "prefilling")
        cost_fl, cost_by = self._dispatch_cost(
            "_paged_insert", lambda: self._cost.insert(
                [len(r.tokens) for r, _ in batch], self.prefill_chunk))
        timer = self._start_timer()
        self._open_dispatch("insert", kernels)
        self._admit_dispatches += 1
        taus, lps = _paged_insert(
            self.params, self.pool, d_bid, up[:, :P],
            up[:, P:2 * P].bool(), generators, temps, top_ps, top_ks,
            config=self.config,
            prefill_chunk=self.prefill_chunk, with_logprobs=self.logprobs,
        )
        self._hand_lanes([r for r, _ in batch], slot_ids)
        if self.spec:
            # The draft pool over the same blocks; its greedy first
            # tokens are dropped (the target picks tau, and a sampled
            # request's generator is drawn by the target insert only).
            _paged_insert(
                self.draft_params, self.draft_pool, d_bid, up[:, :P],
                up[:, P:2 * P].bool(), [None] * kb,
                torch.zeros_like(temps), torch.ones_like(top_ps),
                torch.zeros_like(top_ks), config=self.draft_config,
                prefill_chunk=self.prefill_chunk,
            )
        idx = torch.as_tensor(slot_ids, device=self.device)
        self.tau[idx] = taus[:k]
        if self.logprobs:
            self.d_tau_lp[idx] = lps[:k]
        # No fetch ends the insert (JAX fetches its prompt lengths here):
        # its first tokens stay on the device for the next chunk, whose
        # launches the host enqueues while the insert runs.  A launch
        # error is raised by the launch itself, while
        # ``last_dispatch_features`` names the insert.
        self._record_timed(timer, dict(
            kind="insert:splash" if splash_used else "insert", k=k,
            occupancy=sum(s is not None for s in self.slots.values()),
            prefill_tokens=sum(len(r.tokens) for r, _ in batch),
            swap_inflight=len(self._restoring),
            rids=[r.rid for r, _ in batch], program="_paged_insert",
            flops=cost_fl, bytes_accessed=cost_by,
        ))
        for i, (req, chain) in enumerate(batch):
            b = slot_ids[i]
            blocks = row_blocks[i]
            self._install_row(b, req, blocks)
            # Every block now has a user; the freshly prefilled full
            # prompt blocks join the prefix index.
            self._claim_blocks(blocks)
            self._register_chain(blocks[:len(chain)], chain)
            self.obs.begin_span(req.rid, "decoding")

    def _admit_shared_group(
        self,
        grp: List[Tuple[_Request, List[bytes], List[int]]],
        slots: List[int],
    ) -> None:
        """Admit a group of prefix-cache-hit requests sharing one padded
        suffix length (JAX :4126): reuse the cached blocks (claimed by
        the caller) and prefill only the suffixes, one dispatch for the
        group (per-row ``fill0`` offsets differ freely).  Each request's
        own full prompt blocks extend the published chain, so a follow-up
        with a longer shared prefix hits deeper."""
        bs = self.block_size
        k = len(grp)
        kb = pow2_bucket(k)
        T = self._suffix_pad(len(grp[0][0].tokens) - len(grp[0][2]) * bs,
                             len(grp[0][2]))
        st = np.zeros((kb, T), np.int32)
        sm = np.zeros((kb, T), np.int32)
        table_rows = np.full((kb, self.blocks_per_slot), self.n_blocks,
                             np.int32)
        n_alloc_arr = np.zeros((kb,), np.int32)
        fill0s = np.zeros((kb,), np.int32)
        pol = np.zeros((kb, 3), np.float32)  # temperature, top_p, top_k
        pol[:, 1] = 1.0
        generators = self._lane_gens[:kb]   # as in _insert_batch
        row_blocks: List[List[int]] = []
        row_fresh: List[List[int]] = []
        for i, (req, chain, hits) in enumerate(grp):
            n_share = len(hits)
            L0 = n_share * bs
            fresh = self._alloc_blocks(req.blocks_needed(bs) - n_share)
            blocks = hits + fresh
            row_blocks.append(blocks)
            row_fresh.append(fresh)
            suffix = req.tokens[L0:]
            st[i, :len(suffix)] = suffix
            sm[i, :len(suffix)] = 1
            table_rows[i, :len(blocks)] = blocks
            n_alloc_arr[i] = len(blocks)
            fill0s[i] = L0
            pol[i] = (req.temperature, req.top_p, req.top_k)
            self._seed_lane(generators[i], req)
        # One upload: the suffixes, masks, tables, offsets and policies.
        MB = self.blocks_per_slot
        up = torch.from_numpy(np.concatenate(
            [st, sm, table_rows, n_alloc_arr[:, None], fill0s[:, None],
             pol.view(np.int32)], axis=1)).to(self.device)
        o = 2 * T + MB
        tables, n_alloc_t, fill0_t = up[:, 2 * T:o], up[:, o], up[:, o + 1]
        temps = up[:, o + 2].view(torch.float32)
        top_ps = up[:, o + 3].view(torch.float32)
        top_ks = up[:, o + 4].view(torch.float32).to(torch.int32)
        # No attention kernel here whatever T is: the gathered view
        # carries PER-ROW cache offsets, which runs forward()'s xla path
        # (JAX :4167).  Claiming flash would fire the wrong fault site
        # and credit a probing kernel with a success it never ran.
        for req, _, _ in grp:
            self.obs.begin_span(req.rid, "prefilling")
        cost_fl, cost_by = self._dispatch_cost(
            "_paged_suffix_insert", lambda: self._cost.forward(
                [(len(h) * bs, len(r.tokens) - len(h) * bs)
                 for r, _, h in grp], k))
        timer = self._start_timer()
        self.last_dispatch_features = ("prefix_cache",)
        self.last_step_features.add("prefix_cache")
        self._fault("suffix_insert")
        self._admit_dispatches += 1
        suffix, mask = up[:, :T], up[:, T:2 * T].bool()
        taus, lps = _paged_suffix_insert(
            self.params, self.pool, tables, n_alloc_t, fill0_t, suffix, mask,
            generators, temps, top_ps, top_ks, config=self.config,
            prefill_chunk=self.prefill_chunk, with_logprobs=self.logprobs,
        )
        self._hand_lanes([r for r, _, _ in grp], slots)
        if self.spec:
            # The draft pool: the shared blocks hold the DRAFT model's KV
            # for the same tokens, so only the suffixes run here too; its
            # sampled tokens are dropped.
            _paged_suffix_insert(
                self.draft_params, self.draft_pool, tables, n_alloc_t,
                fill0_t, suffix, mask, [None] * kb, torch.zeros_like(temps),
                torch.ones_like(top_ps), torch.zeros_like(top_ks),
                config=self.draft_config, prefill_chunk=self.prefill_chunk,
            )
        idx = torch.as_tensor(slots, device=self.device)
        self.tau[idx] = taus[:k]
        if self.logprobs:
            self.d_tau_lp[idx] = lps[:k]
        self._record_timed(timer, dict(
            kind="suffix_insert", k=k,
            occupancy=sum(s is not None for s in self.slots.values()),
            prefill_tokens=sum(len(r.tokens) - len(h) * bs
                               for r, _, h in grp),
            swap_inflight=len(self._restoring),
            rids=[r.rid for r, _, _ in grp],
            program="_paged_suffix_insert", flops=cost_fl,
            bytes_accessed=cost_by,
        ))
        for i, (req, chain, hits) in enumerate(grp):
            b = slots[i]
            blocks = row_blocks[i]
            n_share = len(hits)
            self._install_row(b, req, blocks, shared=n_share)
            self._claim_blocks(row_fresh[i])
            # Publish the FULL chain: the hit prefix re-publishes as a
            # no-op and parents the fresh nodes correctly.
            self._register_chain(blocks[:len(chain)], chain)
            self.prefix_requests_hit += 1
            self.prefix_blocks_reused += n_share
            self.prompt_tokens_total += len(req.tokens)
            self.prefix_hit_tokens_total += n_share * bs
            self.obs.begin_span(req.rid, "decoding")
            self.obs.request_kv(req.rid, blocks_held=len(blocks),
                                prefix_hit_tokens=n_share * bs)
            self.obs.observe_kv(hit_depth_tokens=n_share * bs)

    # -- host-tier swap-ins (the ``restoring`` admission state) -------------

    def _begin_restore(self, req: _Request, chain: List[bytes],
                       match: MatchResult) -> bool:
        """Start an async swap-in for a request whose matched prefix
        includes demoted blocks (JAX :4336): claim the path's resident
        blocks, pin the demoted nodes, allocate their fresh pool blocks,
        and copy the slabs into staging tensors on the side stream; park
        the request in ``restoring``.  Nothing touches the pool here, so
        decode chunks dispatched while the copies fly never wait on them.

        Fault site ``kv_swap`` fires before the copy; an injected fault
        (or injected allocation OOM) fails ONLY this request (claims
        released, fresh blocks returned, nodes unpinned and host-resident
        again) and returns False."""
        resident = [n.block for n in match.path if n.block is not None]
        self._claim_blocks(resident)
        self._store.pin_restoring(match.restore)
        fresh: List[int] = []
        try:
            self._fault("kv_swap")
            fresh = self._alloc_blocks(len(match.restore))
            staged = stage_restore(
                [n.host for n in match.restore], fresh, self.n_blocks,
                device=self.device, stream=self._side_stream(),
                shardings=self._staging(match.restore[0].host))
        except InjectedFault as e:
            self._store.unpin_restoring(match.restore)
            self._unclaim_blocks(resident)
            if fresh:
                self._invalidate_and_free(fresh)
            msg = (f"kv swap-in failed: {e} (request aborted; host-tier "
                   f"blocks unpinned, server healthy)")
            self.failed.append((req.rid, msg))
            self.swap_failures_total += 1
            self.obs.request_end(req.rid, "failed", msg)
            return False
        self._claim_blocks(fresh)
        self._restoring.append(_Restore(
            req=req, chain=chain, path=match.path, restore=match.restore,
            resident=resident, fresh=fresh, staged=staged,
            t0=time.monotonic(),
        ))
        self.swap_ins_total += 1
        self.obs.begin_span(req.rid, "restoring")
        self.obs.request_kv(req.rid, evictions_suffered=len(match.restore))
        return True

    def _abort_restore(self, r: _Restore) -> None:
        """Unwind an in-flight swap-in (cancel, broken path): wait for its
        copies (their staging and pinned memory must outlive them), then
        release every claim (the resident hits and the fresh blocks), and
        the nodes fall back to host residency; nothing reached the
        pool."""
        wait_restore(r.staged)
        self._store.unpin_restoring(r.restore)
        self._unclaim_blocks(r.resident)
        self._unclaim_blocks(r.fresh)

    def _poll_restores(self) -> None:
        """Advance in-flight swap-ins without stalling decode (JAX
        :4408): readiness is the copy event's non-blocking query; only
        when no row is decoding (nobody to stall) does the poll wait for
        the copy.  A ready swap-in pays ONE adoption scatter on the main
        stream (both pools under speculation) and moves the request to
        ``_restored_ready``."""
        if not self._restoring:
            return
        # Nobody to stall: no row decoding and no prefill in flight.
        idle = not bool(np.any(self.active)) and self._pf is None
        for r in list(self._restoring):
            r.polls += 1
            # A concurrent non-finite subtree drop may have severed the
            # matched path while the copies flew: its KV is suspect.
            # Unwind and requeue the request at the head: it re-admits
            # through a clean cold prefill.
            broken = any(
                (not n.restoring) if n in r.restore else (n.block is None)
                for n in r.path)
            if broken:
                self._restoring.remove(r)
                self._abort_restore(r)
                self.queue.insert(0, r.req)
                self.obs.begin_span(r.req.rid, "queued", note="swap aborted")
                continue
            ready = self._agree(restore_ready(r.staged))
            if not ready and idle:
                wait_restore(r.staged)
                ready = True
            if not ready or r.polls <= self.swap_poll_min:
                continue
            # A device-to-device scatter: it reads the staging tensors and
            # writes as many bytes into the pool.
            cost_fl, cost_by = self._dispatch_cost(
                "_adopt", lambda: (0.0, 2.0 * r.staged.nbytes))
            timer = self._start_timer()
            adopt_into_pool(self.pool, r.staged)
            if self.spec:
                adopt_into_pool(self.draft_pool, r.staged, prefix="d_")
            self._store.complete_restore(r.restore, r.fresh)
            self.swap_in_blocks_total += len(r.fresh)
            swap_ms = (time.monotonic() - r.t0) * 1000.0
            self.swap_in_ms_total += swap_ms
            self._restoring.remove(r)
            self._restored_ready.append(
                (r.req, r.chain, [n.block for n in r.path]))
            self.obs.record_swap_in(swap_ms, len(r.fresh))
            self.obs.request_kv(r.req.rid, swap_in_bytes=r.staged.nbytes)
            self._record_timed(timer, dict(
                kind="adopt", k=len(r.fresh),
                occupancy=sum(s is not None for s in self.slots.values()),
                swap_inflight=len(self._restoring), rids=[r.req.rid],
                program="_adopt",
                flops=cost_fl, bytes_accessed=cost_by,
            ))
            self.obs.begin_span(r.req.rid, "queued", note="restored")

    def _staging(self, slab) -> Optional[Dict[str, Any]]:
        """Placements of a swap-in's staging planes under the mesh (each
        rank stages its own head slice; None off-mesh)."""
        return _smesh.staging_shardings(self.mesh, list(slab))

    def _agree(self, flag: bool) -> bool:
        """A host decision read from a clock or a CUDA event, made the
        same on every rank of the mesh (true iff true everywhere), so the
        host state stays identical; itself without a mesh."""
        if self.mesh is None:
            return bool(flag)
        return self.mesh.agree(flag)

    def _admit_restored_ready(self) -> None:
        """Admit completed swap-ins as plain prefix hits (their path
        blocks are already claimed; JAX :4496): through the fused prefill
        lane while rows decode (the walk starts at the matched depth), one
        suffix-insert dispatch each otherwise; FIFO, and each still needs
        a free slot and capacity for the rest of its reservation."""
        while self._restored_ready:
            req, chain, hits = self._restored_ready[0]
            free = [b for b, s in self.slots.items() if s is None]
            if not free:
                return
            if (req.blocks_needed(self.block_size) - len(hits)
                    > self._capacity()):
                return
            if self._fused_scheduling() and bool(np.any(self.active)):
                if self._pf is not None:
                    return
                self._restored_ready.pop(0)
                self._setup_fused_prefill(req, chain, hits, claimed=True)
            else:
                self._restored_ready.pop(0)
                self._admit_shared_group([(req, chain, hits)], [free[0]])

    # -- fused prefill-decode admission --------------------------------------

    def _pf_chunk(self, suffix_len: int, n_share: int) -> int:
        """Prompt tokens per fused dispatch (JAX :4522): the budget rounded
        DOWN to a power-of-two block count (the budget stays an upper
        bound; one block at least), clamped to the suffix's own pow2
        bucket, then halved until the last chunk's window fits the row's
        remaining view columns.  Without that clamp a prefix-hit row's
        last window would run past its view (``forward`` raises on a cache
        overflow).  At one block, admissibility guarantees the fit."""
        bs = self.block_size
        nbb = max(1, self.prefill_budget // bs)
        nbb = 1 << (nbb.bit_length() - 1)
        nbs = pow2_bucket(max(1, -(-suffix_len // bs)))
        c_blocks = min(nbb, nbs)
        view_blocks = self.blocks_per_slot - n_share
        while c_blocks > 1 and (
                -(-suffix_len // (c_blocks * bs)) * c_blocks > view_blocks):
            c_blocks //= 2
        return c_blocks * bs

    def _begin_fused_prefill(self) -> None:
        """Move the queue head into ``prefilling`` (JAX :4547): reserve
        its blocks (claiming prefix hits, whose walk starts at fill0),
        set its row up visible but inactive, and upload its suffix once
        (``_setup_fused_prefill``); no model dispatch here.  A head whose
        matched prefix includes host-tier blocks moves to ``restoring``
        instead, and the next head gets the lane."""
        if not any(s is None for s in self.slots.values()):
            return
        while self.queue:
            req = self.queue[0]
            if req.blocks_needed(self.block_size) > self._capacity():
                return  # head-of-line blocking (FIFO): wait
            chain = (self._chain_keys(req.tokens, self.block_size)
                     if self.prefix_cache_enabled else [])
            m = self._match_prefix(chain)
            del self.queue[0]
            if m.restore:
                # Restoring (or failed cleanly on an injected swap fault):
                # the lane is still open for the next head.
                self._begin_restore(req, chain, m)
                continue
            self._setup_fused_prefill(req, chain, m.blocks, claimed=False)
            return

    def _setup_fused_prefill(self, req: _Request, chain: List[bytes],
                             hits: List[int], claimed: bool) -> None:
        """The ``prefilling`` setup of a fresh admission or a completed
        swap-in (``claimed``: its hits were claimed when the restore
        began; JAX :4583).  The row's host mirrors hold its whole
        reservation with the row inactive; the next dirty-row sync is the
        one state upload the prefill pays, beside the suffix's upload
        here."""
        if not claimed:
            self._claim_blocks(hits)
        b = next(b for b, s in self.slots.items() if s is None)
        n_share = len(hits)
        base = n_share * self.block_size
        fresh = self._alloc_blocks(req.blocks_needed(self.block_size)
                                   - n_share)
        self._claim_blocks(fresh)
        blocks = hits + fresh
        suffix = req.tokens[base:]
        C = self._pf_chunk(len(suffix), n_share)
        # Whole chunks, their count bucketed to a power of two (JAX
        # :4605; the buffer's width keys _fused_chunk); trailing zeros are
        # masked and never dispatched.
        toks = np.zeros((pow2_bucket(-(-len(suffix) // C)) * C,), np.int32)
        toks[:len(suffix)] = suffix
        self._install_row(b, req, blocks, shared=n_share)
        self.fill[b] = 0
        self.pos[b] = 0
        self.active[b] = False
        # One upload: the lane's scalars (row, suffix length, fill0, off
        # = 0) into ``_pf_dev``, and the suffix.
        up = torch.from_numpy(np.concatenate(
            [np.asarray([b, len(suffix), base, 0], np.int32), toks])
        ).to(self.device)
        self._pf_dev.copy_(up[:4])
        self._pf = _Prefill(
            slot=b, req=req, chain=chain, n_share=n_share, base=base,
            suffix_len=len(suffix), chunk=C, d_toks=up[4:])
        self.fused_admissions_total += 1
        self.prompt_tokens_total += len(req.tokens)
        self.obs.begin_span(req.rid, "prefilling")
        if n_share:
            self.prefix_requests_hit += 1
            self.prefix_blocks_reused += n_share
            self.prefix_hit_tokens_total += base
        self.obs.request_kv(req.rid, blocks_held=len(blocks),
                            prefix_hit_tokens=base)
        self.obs.observe_kv(hit_depth_tokens=base)
