"""Declarative contracts for the serving stack's programs (port of
``jax_llama_tpu/analysis/contracts.py``).

Every program the ``ContinuousBatcher`` dispatches is a
``utils.programs.program`` (the port's counterpart of ``jax.jit``: keyed
calls, donated arguments, CUDA graphs on the card), and declares here,
under its JAX name:

  * ``donated``      -- the arguments the decorator must donate (a
                        dropped entry copies the pool or the state twins
                        and loses the graph's in-place carry);
  * ``max_live_outputs`` / ``max_fetch_bytes_per_row``
                     -- the host-fetch surface: how many outputs are NOT
                        aliased onto donated inputs, and how many bytes
                        per batch row they may total at the example shape
                        (the "1 packed fetch" contract);
  * ``forbid_pool_shapes``
                     -- no copy-class aten op (cat, index, gather, clone,
                        _to_copy, a broadcast, a pad, ...) may produce a
                        full-pool-sized or one-plane-sized tensor;
  * ``build``        -- example arguments at a tiny geometry, so that the
                        auditor (``lowering``) runs the program on the CPU
                        in seconds under a recording dispatch mode (the
                        port's counterpart of the jaxpr);
  * ``max_cache_keys`` -- the keys one serving configuration may create
                        (``retrace``);
  * ``comms``        -- the collectives one call may issue on the comms
                        pass's two-rank serving mesh (``comms``).

The budgets are JAX's; a JAX ``keys`` argument is the port's
``generators`` (the slots' generators), ``pool_arrays`` the port's
``pool`` and ``_fused_chunk``'s ``pf_key`` the fused lane's generator
``pf_gen``.  ``engine.generate`` (two programs, ``generate`` and its
decode loop's body ``_generate_step``) and ``score`` are the port's own
entries (:data:`PORT_ONLY`; JAX jits them outside its registry).  New
programs MUST join this registry: the auditor's coverage check fails on
any ``program``-decorated module-level function in serving.py /
kvcache.py / ops/kernels.py / engine.py without a contract.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

# Example geometry (JAX :40-41): small enough that every program runs on
# the CPU in seconds, real enough that every shape class (pool, plane,
# state row, packed fetch) is present.
_DIM, _LAYERS, _HEADS, _KVH = 64, 2, 4, 2
_VOCAB, _MAXLEN, _BLOCK, _SLOTS = 128, 64, 16, 2


@dataclasses.dataclass(frozen=True)
class CommsBudget:
    """Per-program collective budget, declared at the comms pass's
    example geometry (tensor = 2 over two ranks, ``comms.EXAMPLE_CONFIG``)
    and checked per call of the program against the collectives rank 0
    issued in it.

      * ``max_count``: counted kind (``Mesh.collectives``' first key:
        ``all_reduce``, ``all_gather``, ``agree`` ...) -> the most one
        call may issue (a kind absent from the dict allows ZERO).  A
        program's per-layer collectives scale with the layers and the
        chunk's iterations, which the example fixes.
      * ``max_bytes``: result bytes of the largest single collective.
        The per-layer tensor-axis reductions are activation-sized; a
        pool-sized one is orders larger at any geometry.

    Full-pool / one-plane shaped collective RESULTS are a hard finding
    whatever the budget (not declarable here on purpose)."""

    max_count: Dict[str, int]
    max_bytes: int


@dataclasses.dataclass(frozen=True)
class ProgramContract:
    name: str                         # the program's (JAX) name
    module: str                       # import path of the owning module
    donated: Tuple[str, ...]          # argument names
    max_live_outputs: int             # outputs not aliased to donations
    max_fetch_bytes_per_row: int      # live-output bytes / batch rows
    forbid_pool_shapes: bool = True
    build: Optional[Callable[[], Tuple[Tuple[str, ...], tuple, dict]]] = None
    # build() -> (positional argnames, positional args, static kwargs)
    # Forbidden-shape derivation: default scans the example args for
    # BlockPool-shaped leaves (pool_shapes); a program whose pool state
    # arrives in another form declares its own, so that a new pool
    # carrier cannot derive an empty shape set and pass vacuously.
    forbidden_shapes: Optional[Callable[[tuple], List[Tuple[int, ...]]]] = None
    # The keys one serving configuration may create for this program
    # across its admission surface (retrace.py); REQUIRED.
    max_cache_keys: Optional[int] = None
    # Collective budget on the comms pass's serving mesh (comms.py).
    comms: Optional[CommsBudget] = None
    # The port's function name where it is not the program's.
    function: Optional[str] = None


# -- example-argument factories ---------------------------------------------

_CACHE: Dict[str, Any] = {}


def _tiny_config_params():
    if "cfg" not in _CACHE:
        from ..config import get_config
        from ..models import init_params

        cfg = get_config(
            "tiny", dim=_DIM, n_layers=_LAYERS, n_heads=_HEADS,
            n_kv_heads=_KVH, vocab_size=_VOCAB, max_seq_len=_MAXLEN,
            multiple_of=16,
        )
        _CACHE["cfg"] = cfg
        _CACHE["params"] = init_params(cfg, seed=0, device="cpu")
    return _CACHE["cfg"], _CACHE["params"]


def _batcher(**kw):
    from ..serving import ContinuousBatcher

    cfg, params = _tiny_config_params()
    return ContinuousBatcher(params, cfg, n_slots=_SLOTS, max_len=_MAXLEN,
                             block_size=_BLOCK, device="cpu", **kw)


def _plain_batcher():
    if "plain" not in _CACHE:
        import numpy as np

        cb = _batcher(decode_chunk=2)
        rng = np.random.RandomState(0)
        for _ in range(_SLOTS):
            cb.submit(list(rng.randint(1, _VOCAB, 20)), max_new_tokens=4)
        cb.step()
        _CACHE["plain"] = cb
    return _CACHE["plain"]


def _fused_batcher():
    if "fused" not in _CACHE:
        import numpy as np

        cb = _batcher(decode_chunk=2, prefill_budget=_BLOCK)
        rng = np.random.RandomState(1)
        cb.submit(list(rng.randint(1, _VOCAB, 20)), max_new_tokens=8)
        cb.step()  # cold classic admission
        cb.step()
        cb.submit(list(rng.randint(1, _VOCAB, 40)), max_new_tokens=8)
        cb.step()  # fused prefill starts (40-token suffix > one chunk)
        if cb._pf is None:
            raise RuntimeError("fused example failed to enter prefill")
        _CACHE["fused"] = cb
    return _CACHE["fused"]


def _spec_batcher():
    if "spec" not in _CACHE:
        import numpy as np

        cfg, params = _tiny_config_params()
        cb = _batcher(spec_rounds=2, draft_params=params, draft_config=cfg,
                      n_draft=2)
        rng = np.random.RandomState(2)
        for _ in range(_SLOTS):
            cb.submit(list(rng.randint(1, _VOCAB, 20)), max_new_tokens=8)
        cb.step()
        _CACHE["spec"] = cb
    return _CACHE["spec"]


def clear_examples() -> None:
    """Drop the cached example batchers (tests)."""
    _CACHE.clear()


def _fresh(x):
    """A copy of ``x`` with every tensor cloned and every generator's
    state copied: the auditor runs each program for real, and the cached
    example batchers must stay as they were."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, torch.Generator):
        g = torch.Generator(device=x.device)
        g.set_state(x.get_state())
        return g
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _fresh(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _fresh(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_fresh(v) for v in x)
    return x


def _host(a, dtype):
    import numpy as np
    import torch

    return torch.from_numpy(np.asarray(a, dtype))


_STATE_NAMES = (
    "table", "n_alloc", "fill", "tau", "tau_lp", "pos", "active",
    "remaining", "stops", "generators", "temperature", "top_p", "top_k",
)


def _chunk_state(cb) -> tuple:
    return _fresh((
        cb.d_table, cb.d_n_alloc, cb.d_fill, cb.tau, cb.d_tau_lp,
        cb.d_pos, cb.d_active, cb.d_remaining, cb.d_stops,
        list(cb.generators), cb.d_temps, cb.d_top_ps, cb.d_top_ks,
    ))


def _build_paged_decode_step():
    import numpy as np

    cb = _plain_batcher()
    names = ("params", "pool", "table", "n_alloc", "fill", "tau",
             "pos", "active", "generators", "temperature", "top_p",
             "top_k")
    args = (
        cb.params, _fresh(cb.pool), _host(cb.table, np.int32),
        _host(cb.n_alloc, np.int32), _host(cb.fill, np.int32),
        _fresh(cb.tau), _host(cb.pos, np.int32), _host(cb.active, bool),
        _fresh(list(cb.generators)), _host(cb.temp_arr, np.float32),
        _host(cb.top_p_arr, np.float32), _host(cb.top_k_arr, np.int32),
    )
    kwargs = dict(config=cb.config, use_kernel=True, all_greedy=True,
                  with_logprobs=False)
    return names, args, kwargs


def _build_paged_decode_chunk():
    cb = _plain_batcher()
    names = ("params", "pool") + _STATE_NAMES
    args = (cb.params, _fresh(cb.pool)) + _chunk_state(cb)
    kwargs = dict(config=cb.config, n_iter=2, use_kernel=True,
                  all_greedy=True, with_logprobs=False)
    return names, args, kwargs


def _build_fused_chunk():
    cb = _fused_batcher()
    pf = cb._pf
    names = ("params", "pool") + _STATE_NAMES + (
        "pf_row", "pf_toks", "pf_len", "pf_base", "pf_off", "pf_gen",
    )
    # The batcher's four lane scalars are views of one tensor; each is its
    # own here, so that only pf_off's writes count as pf_off's.
    row, n, base, off = (_fresh(t) for t in cb._pf_dev.unbind(0))
    args = (cb.params, _fresh(cb.pool)) + _chunk_state(cb) + (
        row, _fresh(pf.d_toks), n, base, off, _fresh(cb._pf_gen))
    kwargs = dict(config=cb.config, n_iter=2, pf_chunk=pf.chunk,
                  use_kernel=True, all_greedy=True, with_logprobs=False)
    return names, args, kwargs


def _build_spec_round():
    import numpy as np

    cb = _spec_batcher()
    names = ("t_params", "d_params", "t_pool", "d_pool", "table",
             "n_alloc", "fill", "tau", "pos", "active", "generators",
             "temperature", "top_p", "top_k")
    args = (
        cb.params, cb.draft_params, _fresh(cb.pool), _fresh(cb.draft_pool),
        _host(cb.table, np.int32), _host(cb.n_alloc, np.int32),
        _host(cb.fill, np.int32), _fresh(cb.tau), _host(cb.pos, np.int32),
        _host(cb.active, bool), _fresh(list(cb.generators)),
        _host(cb.temp_arr, np.float32), _host(cb.top_p_arr, np.float32),
        _host(cb.top_k_arr, np.int32),
    )
    kwargs = dict(t_config=cb.config, d_config=cb.draft_config,
                  n_draft=cb.n_draft, use_kernel=True, all_greedy=True,
                  with_logprobs=False)
    return names, args, kwargs


def _build_spec_rounds_chunk():
    cb = _spec_batcher()
    names = ("t_params", "d_params", "t_pool", "d_pool") + _STATE_NAMES
    args = (cb.params, cb.draft_params, _fresh(cb.pool),
            _fresh(cb.draft_pool)) + _chunk_state(cb)
    kwargs = dict(t_config=cb.config, d_config=cb.draft_config,
                  n_draft=cb.n_draft, n_rounds=2, use_kernel=True,
                  all_greedy=True, with_logprobs=False)
    return names, args, kwargs


def _build_paged_insert():
    import numpy as np

    cb = _plain_batcher()
    k, P = 2, 2 * _BLOCK
    rng = np.random.RandomState(3)
    names = ("params", "pool", "block_ids", "prompt_tokens",
             "prompt_mask", "generators", "temperature", "top_p", "top_k")
    # Real destination blocks (the example's pool is a copy), so that the
    # insert lands KV: an all-sentinel table would write nothing.
    args = (
        cb.params, _fresh(cb.pool),
        _host(np.arange(k * P // _BLOCK).reshape(k, P // _BLOCK), np.int32),
        _host(rng.randint(1, _VOCAB, (k, P)), np.int32),
        _host(np.ones((k, P)), bool),
        [None] * k,
        _host(np.zeros((k,)), np.float32),
        _host(np.ones((k,)), np.float32),
        _host(np.zeros((k,)), np.int32),
    )
    kwargs = dict(config=cb.config, prefill_chunk=None, with_logprobs=False)
    return names, args, kwargs


def _build_paged_suffix_insert():
    import numpy as np

    cb = _plain_batcher()
    k, T = 2, _BLOCK
    rng = np.random.RandomState(4)
    names = ("params", "pool", "table_rows", "n_alloc_rows", "fill0",
             "suffix_tokens", "suffix_mask", "generators", "temperature",
             "top_p", "top_k")
    table = np.full((k, cb.blocks_per_slot), cb.n_blocks)
    table[:, :2] = np.arange(2 * k).reshape(k, 2)
    args = (
        cb.params, _fresh(cb.pool), _host(table, np.int32),
        _host(np.full((k,), 2), np.int32),
        _host(np.full((k,), _BLOCK), np.int32),
        _host(rng.randint(1, _VOCAB, (k, T)), np.int32),
        _host(np.ones((k, T)), bool),
        [None] * k,
        _host(np.zeros((k,)), np.float32),
        _host(np.ones((k,)), np.float32),
        _host(np.zeros((k,)), np.int32),
    )
    kwargs = dict(config=cb.config, prefill_chunk=None, with_logprobs=False)
    return names, args, kwargs


def _build_scatter_rows():
    import torch

    cb = _plain_batcher()
    state = _fresh((cb.d_table, cb.d_n_alloc, cb.d_fill, cb.d_pos,
                    cb.d_active, cb.d_top_ks, cb.d_remaining, cb.d_temps,
                    cb.d_top_ps, cb.d_stops))
    rows = tuple(torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype)
                 for a in state)
    idx = torch.zeros((1,), dtype=torch.int64)
    return ("state", "idx", "rows"), (state, idx, rows), {}


def _build_release_blocks():
    import numpy as np

    cb = _plain_batcher()
    ids = np.full((cb.blocks_per_slot,), cb.n_blocks)
    ids[:2] = (0, 1)
    return (("pos", "block_ids"),
            (_fresh(cb.pool.pos), _host(ids, np.int32)), {})


def _build_splash_prefill():
    import torch

    # Splash's own lane geometry, not the tiny model's: the kernel takes
    # head_dim / q_len / kv_len % 128 == 0 (splash_eligible gates real
    # dispatches the same way), so the example is the smallest legal
    # splash shape; on CPU tensors it runs the plain version, the
    # kernel's arithmetic.
    g = torch.Generator().manual_seed(5)
    B, T, S, H, KVH, D = 1, 128, 128, 2, 1, 128
    names = ("q", "k", "v")
    args = (torch.randn(B, T, H, D, generator=g),
            torch.randn(B, S, KVH, D, generator=g),
            torch.randn(B, S, KVH, D, generator=g))
    return names, args, dict(chunk_offset=0)


def _build_stock_paged_decode():
    import numpy as np
    import torch

    # Tiny-pool geometry (the registry's example scale).
    g = torch.Generator().manual_seed(6)
    B, H, KVH, D = 2, 4, 2, 16
    L, NB, BLK = _LAYERS, 8, _BLOCK
    names = ("q", "k_new", "v_new", "k_pool", "v_pool", "table", "q_pos")
    args = (
        torch.randn(B, 1, H, D, generator=g),
        torch.randn(B, 1, KVH, D, generator=g),
        torch.randn(B, 1, KVH, D, generator=g),
        torch.randn(L, KVH, NB, BLK, D, generator=g),
        torch.randn(L, KVH, NB, BLK, D, generator=g),
        _host([[0, 1, NB, NB], [2, NB, NB, NB]], np.int32),
        _host([17, 9], np.int32),
    )
    return names, args, dict(layer=1)


# ``engine.generate``'s two programs and ``score`` at the tiny model: B =
# 2 rows, a left-padded prompt of P = 8, 4 new tokens, greedy.
_GEN_B, _GEN_P, _GEN_NEW = 2, 8, 4


def _gen_example():
    import numpy as np
    import torch

    from ..engine import GenerationConfig
    from ..models import init_cache

    cfg, params = _tiny_config_params()
    gc = GenerationConfig(max_new_tokens=_GEN_NEW, temperature=0.0,
                          stop_tokens=(3,))
    rng = np.random.RandomState(8)
    toks = _host(rng.randint(1, _VOCAB, (_GEN_B, _GEN_P)), np.int32)
    mask = _host(np.arange(_GEN_P)[None, :]
                 >= np.array([[0], [3]]), bool)
    cache = init_cache(cfg, _GEN_B, max_len=_GEN_P + _GEN_NEW, device="cpu")
    cache.index = torch.zeros((), dtype=torch.int32)
    buf = torch.zeros((_GEN_B, _GEN_P + _GEN_NEW), dtype=torch.int32)
    return cfg, params, gc, toks, mask, cache, buf


def _build_generate():
    import torch

    cfg, params, gc, toks, mask, cache, buf = _gen_example()
    names = ("params", "prompt_tokens", "prompt_mask", "generator",
             "cache", "buf", "next_tok")
    args = (params, toks, mask, None, cache, buf,
            torch.zeros((_GEN_B,), dtype=torch.int32))
    return names, args, dict(config=cfg, gen_config=gc)


def _build_generate_step():
    import torch

    cfg, params, gc, toks, mask, cache, buf = _gen_example()
    cache.index = torch.tensor(_GEN_P, dtype=torch.int32)
    cache.pos[:, :_GEN_P] = torch.arange(_GEN_P, dtype=torch.int32)
    names = ("params", "cache", "buf", "next_tok", "done", "prompt_lens",
             "stops", "generator")
    args = (params, cache, buf, torch.ones((_GEN_B,), dtype=torch.int32),
            torch.zeros((_GEN_B,), dtype=torch.bool),
            mask.to(torch.int32).sum(dim=1, dtype=torch.int32),
            torch.tensor(gc.stop_tokens, dtype=torch.int32), None)
    return names, args, dict(config=cfg, gen_config=gc)


def _build_score():
    cfg, params, _, toks, mask, _, _ = _gen_example()
    return (("params", "tokens", "attn_mask"), (params, toks, mask),
            dict(config=cfg))


def _cache_shapes(args):
    """The KV cache of a generate example (its ``cache`` argument): the
    shapes no copy-class op may produce."""
    cache = next(a for a in args if hasattr(a, "max_len"))
    return [tuple(cache.k.shape), tuple(cache.k.shape[1:])]


def _build_adopt_jit():
    import torch

    from ..kvcache import _pool_names, stage_restore

    cb = _plain_batcher()
    pool = _fresh(cb.pool)
    slab = {
        n: (torch.zeros((pool.pos.shape[1],), dtype=torch.int32)
            if n == "pos" else torch.zeros(
                (pool.k.shape[0], pool.k.shape[1], pool.k.shape[3],
                 pool.k.shape[4]), dtype=pool.k.dtype))
        for n in _pool_names(pool)
    }
    staged = stage_restore([slab], [0], cb.n_blocks)
    planes = {n: staged.planes[n] for n in _pool_names(pool)}
    return ("pool", "ids", "planes"), (pool, staged.ids, planes), {}


# -- the registry ------------------------------------------------------------

_CHUNK_DONATED = (
    "pool", "fill", "tau", "tau_lp", "pos", "active", "remaining",
    "generators",
)

# Measured at the comms example (2 layers, decode_chunk 4, tensor = 2): a
# decode iteration reduces the embedding, each layer's o and down
# products (row-parallel) and gathers the vocab-sharded logits, so a
# 4-iteration chunk issues 4 x (1 + 2 x 2) all-reduces and 4 gathers; an
# insert is one such forward.  The host decisions between dispatches
# agree nothing on a one-replica serving mesh.
_DECODE_CHUNK_COMMS = CommsBudget(
    max_count={"all_reduce": 20, "all_gather": 4}, max_bytes=4096)
_INSERT_COMMS = CommsBudget(
    max_count={"all_reduce": 5, "all_gather": 1}, max_bytes=16384)

REGISTRY: Dict[str, ProgramContract] = {
    c.name: c for c in (
        ProgramContract(
            name="_paged_decode_step",
            module="jax_llama_tpu_torch.serving",
            donated=("pool",), max_live_outputs=2,
            max_fetch_bytes_per_row=16,
            build=_build_paged_decode_step,
            # all_greedy (bool); config/use_kernel/with_logprobs are
            # ctor-stable per batcher.
            max_cache_keys=4, function="_decode_step_core",
        ),
        ProgramContract(
            name="_paged_decode_chunk",
            module="jax_llama_tpu_torch.serving",
            donated=_CHUNK_DONATED, max_live_outputs=1,
            max_fetch_bytes_per_row=16,
            build=_build_paged_decode_chunk,
            # n_iter pow2 <= decode_chunk (log2 K + 1 <= 6) x all_greedy
            # (2) x stop-table width pow2 regrowth (O(log max stops)).
            max_cache_keys=24, comms=_DECODE_CHUNK_COMMS,
            function="_chunk_scan",
        ),
        ProgramContract(
            name="_fused_chunk", module="jax_llama_tpu_torch.serving",
            donated=_CHUNK_DONATED + ("pf_off",), max_live_outputs=1,
            max_fetch_bytes_per_row=16,
            build=_build_fused_chunk,
            # n_iter pow2 (<= 6) x pf_chunk pow2-down from the budget
            # (<= 5) x pf_toks buffer in pow2 chunk counts (<= 5) x
            # all_greedy (2): the admission sweep touches a sparse corner
            # of that product, and every axis is O(log).
            max_cache_keys=48,
        ),
        ProgramContract(
            name="_spec_round", module="jax_llama_tpu_torch.serving",
            donated=("t_pool", "d_pool"), max_live_outputs=4,
            max_fetch_bytes_per_row=64,
            build=_build_spec_round,
            # all_greedy (2) x use_kernel (2).
            max_cache_keys=6, function="_spec_round_core",
        ),
        ProgramContract(
            name="_spec_rounds_chunk",
            module="jax_llama_tpu_torch.serving",
            donated=("t_pool", "d_pool") + _CHUNK_DONATED[1:],
            max_live_outputs=1, max_fetch_bytes_per_row=64,
            build=_build_spec_rounds_chunk,
            # n_rounds pow2 <= spec_rounds (<= 5) x all_greedy (2) x
            # use_kernel (2) x stop-width regrowth.
            max_cache_keys=24,
        ),
        ProgramContract(
            name="_paged_insert", module="jax_llama_tpu_torch.serving",
            donated=("pool",), max_live_outputs=4,
            max_fetch_bytes_per_row=32,
            build=_build_paged_insert,
            # row count kb pow2 (log2 n_slots + 1) x group width P in
            # pow2 block counts (log2 blocks_per_slot + 1).
            max_cache_keys=32, comms=_INSERT_COMMS,
        ),
        ProgramContract(
            name="_paged_suffix_insert",
            module="jax_llama_tpu_torch.serving",
            donated=("pool",), max_live_outputs=3,
            max_fetch_bytes_per_row=32,
            build=_build_paged_suffix_insert,
            # row count kb pow2 x suffix width T in pow2 block counts
            # (_suffix_pad).
            max_cache_keys=32,
        ),
        ProgramContract(
            name="_scatter_rows", module="jax_llama_tpu_torch.serving",
            donated=("state",), max_live_outputs=0,
            max_fetch_bytes_per_row=0,
            build=_build_scatter_rows,
            # No pool rides this program: it scatters the small per-slot
            # state twins; its whole contract is the donation and the
            # zero live outputs.
            forbid_pool_shapes=False,
            # dirty-row count Rb pow2 (log2 n_slots + 1) x stop-table
            # width pow2 regrowth.
            max_cache_keys=16,
        ),
        ProgramContract(
            name="_release_blocks", module="jax_llama_tpu_torch.serving",
            donated=("pos",), max_live_outputs=0,
            max_fetch_bytes_per_row=0,
            build=_build_release_blocks,
            # Only the pool's [NB, BLK] pos plane rides along: that is
            # the shape no copy-class op may produce.
            forbidden_shapes=lambda args: [tuple(args[0].shape)],
            # id batches are padded to the FIXED blocks_per_slot width
            # (_invalidate_evicted): one key per batcher geometry.
            max_cache_keys=2,
        ),
        ProgramContract(
            name="splash_prefill",
            module="jax_llama_tpu_torch.ops.kernels",
            donated=(), max_live_outputs=1,
            # NOT a host-fetch surface: an attention primitive called
            # INSIDE the serving programs (inline there); the one live
            # output is the chunk's activation.  Budget = the example
            # output [1, 128, 2, 128] float32 exactly, so any second
            # escaping output still trips the check.
            max_fetch_bytes_per_row=131072,
            build=_build_splash_prefill,
            # No pool rides this program (gathered activations only).
            forbid_pool_shapes=False,
            # chunk_offset: multiples of the fixed prefill chunk inside
            # the pow2-bucketed group width x q_len x kv_len pow2.
            max_cache_keys=64,
        ),
        ProgramContract(
            name="stock_paged_decode",
            module="jax_llama_tpu_torch.ops.kernels",
            donated=(), max_live_outputs=1,
            # The step's [B, 1, H, d] activation (512 B at the example),
            # consumed by the calling decode program, not the host.
            max_fetch_bytes_per_row=512,
            build=_build_stock_paged_decode,
            # The pool arrives as bare [L, KVH, NB, BLK, d] planes.
            forbidden_shapes=lambda args: [
                tuple(args[3].shape), tuple(args[3].shape[1:]),
            ],
            # Every shape is ctor-stable per batcher; inside the decode
            # programs it runs inline and adds no key.  The port passes
            # ``layer`` to the C entry point as a host int (static), so a
            # direct call per layer keys per layer: only the kernel
            # checks make those.
            max_cache_keys=8,
        ),
        ProgramContract(
            name="generate", module="jax_llama_tpu_torch.engine",
            donated=("cache", "buf", "next_tok"), max_live_outputs=0,
            max_fetch_bytes_per_row=0,
            build=_build_generate,
            # The decode state is written in place; the caller reads the
            # buffer after the loop.  The cache the call owns is its
            # "pool": no copy-class op may make a cache-sized tensor.
            forbidden_shapes=_cache_shapes,
            # config x gen_config x (B, P) as the caller picks them, as
            # JAX keys generate: one per shape a serving CLI or an eval
            # loop uses.
            max_cache_keys=8, function="_generate_prefill",
        ),
        ProgramContract(
            name="_generate_step", module="jax_llama_tpu_torch.engine",
            donated=("cache", "buf", "next_tok", "done"),
            max_live_outputs=0, max_fetch_bytes_per_row=0,
            build=_build_generate_step,
            forbidden_shapes=_cache_shapes,
            # Keyed as generate is (one step program per generate key).
            max_cache_keys=8,
        ),
        ProgramContract(
            name="score", module="jax_llama_tpu_torch.engine",
            donated=(), max_live_outputs=1,
            # [B, T - 1] float32 log-probabilities: 28 bytes a row at T = 8.
            max_fetch_bytes_per_row=4 * (_GEN_P - 1),
            build=_build_score,
            # No cache: the forward is cache-free.
            forbid_pool_shapes=False,
            # config x (B, T), as JAX keys score.
            max_cache_keys=8, function="_score",
        ),
        ProgramContract(
            name="_adopt_jit", module="jax_llama_tpu_torch.kvcache",
            donated=("pool",), max_live_outputs=0,
            max_fetch_bytes_per_row=0,
            build=_build_adopt_jit,
            # staged block count pow2-bucketed (kvcache.stage_restore):
            # log2 n_blocks + 1 buckets.
            max_cache_keys=12,
        ),
    )
}

# program-decorated module-level functions that the batcher never
# dispatches and which therefore need no contract (none: every program
# in serving.py / kvcache.py / ops/kernels.py is on a dispatch path).
NON_DISPATCHED: frozenset = frozenset()

# Modules whose programs must be registered.
CONTRACT_MODULES = ("serving", "kvcache", "kernels", "engine")

# The port's programs that JAX's registry does not hold: JAX's
# ``engine.generate`` and ``score`` (jitted there, outside its serving
# registry) and the body of ``generate``'s decode loop.
PORT_ONLY = frozenset({"generate", "_generate_step", "score"})

# JAX argument names -> the port's, where they differ.
JAX_ARG_NAMES = {"keys": "generators", "pool_arrays": "pool",
                 "pf_key": "pf_gen"}


def pool_shapes(pool) -> List[Tuple[int, ...]]:
    """Full-pool and one-plane shapes of a BlockPool example: the shapes
    no copy-class op may produce."""
    shapes: List[Tuple[int, ...]] = []
    for arr in (pool.k, pool.v, pool.k_scale, pool.v_scale):
        if arr is None:
            continue
        shapes.append(tuple(arr.shape))        # [L, KVH, NB, BLK, ...]
        shapes.append(tuple(arr.shape[1:]))    # one-layer plane
    return shapes
