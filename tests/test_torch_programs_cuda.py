"""The batcher's programs as CUDA graphs on the card (``utils.programs``).
Marked ``cuda``: each test skips on a host without a GPU.  Like
tests/test_torch_cuda.py, this file imports neither jax nor the JAX
package:

    python -m pytest tests/test_torch_programs_cuda.py -m cuda --noconftest -q

In float32 (matmuls without TF32) a batcher that replays its programs'
graphs (the decode programs, and the prefill side: inserts, fused
chunks, the state scatters, swap-in adoptions) emits exactly the tokens
of one that runs them eagerly (``close()`` drops a batcher's graphs),
greedy and sampled, with slots reused across admissions; every replay
adds the launches its capture recorded, so the wrappers' counts are an
eager run's.  ``engine.generate`` and ``score`` through a call's own
graphs give the tokens and scores of their eager runs.
"""

import importlib

import numpy as np
import pytest
import torch

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import serving
from jax_llama_tpu_torch.ops.sampling import categorical

pa = importlib.import_module("jax_llama_tpu_torch.ops.paged_attention")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _model():
    cfg = ptl.get_config("tiny", vocab_size=256, dim=128, n_layers=2,
                         n_heads=2, n_kv_heads=1, multiple_of=32,
                         max_seq_len=256, attn_impl="auto")
    return ptl.init_params(cfg, seed=0, device="cuda"), cfg


def _requests():
    rng = np.random.RandomState(0)
    out = []
    for i in range(7):
        sampled = i % 2 == 1
        out.append(dict(
            prompt_tokens=rng.randint(1, 256, rng.randint(5, 60)).tolist(),
            max_new_tokens=int(rng.randint(6, 20)),
            temperature=0.9 if sampled else 0.0,
            top_k=20 if sampled else None,
            seed=100 + i if sampled else None))
    return out


def _serve(params, cfg, graphs, **kw):
    """Tokens per request of a batcher (its graphs closed first when not
    ``graphs``), with the paged wrapper's launches and the stats."""
    cb = serving.ContinuousBatcher(params, cfg, n_slots=3, max_len=256,
                                   block_size=16, device="cuda", **kw)
    if not graphs:
        cb.close()
    before = pa.paged_pool_attention.launches
    rids = []
    for i, req in enumerate(_requests()):
        rids.append(cb.submit(**req))
        if i % 3 == 2:          # staggered: slots are reused mid-stream
            cb.step()
    out = cb.run_to_completion()
    torch.cuda.synchronize()
    launches = pa.paged_pool_attention.launches - before
    return [out.get(r, []) for r in rids], launches, cb.stats()


@pytest.mark.cuda
@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_chunk_graphs_replay_eager_tokens(decode_chunk):
    """Greedy and sampled rows through ``_paged_decode_chunk``'s graphs:
    the eager batcher's tokens, its launches, and replays counted."""
    _card()
    params, cfg = _model()
    got, n_graph, st = _serve(params, cfg, True, decode_chunk=decode_chunk)
    want, n_eager, st_e = _serve(params, cfg, False,
                                 decode_chunk=decode_chunk)
    assert got == want
    assert st["programs_captured"] == 1 and st_e["programs_captured"] == 0
    assert st["graph_replays_total"] > 0 and st_e["graph_replays_total"] == 0
    assert n_graph == n_eager == cfg.n_layers * st["decode_steps_total"]
    assert st["decode_steps_total"] == st_e["decode_steps_total"]


@pytest.mark.cuda
@pytest.mark.parametrize("spec_rounds", [1, 4])
def test_spec_graphs_replay_eager_tokens(spec_rounds):
    """``_spec_round`` (one round a step) and ``_spec_rounds_chunk``
    replayed: the eager speculative batcher's tokens and launches."""
    _card()
    params, cfg = _model()
    kw = dict(draft_params=params, draft_config=cfg, n_draft=3,
              spec_rounds=spec_rounds)
    got, n_graph, st = _serve(params, cfg, True, **kw)
    want, n_eager, _ = _serve(params, cfg, False, **kw)
    assert got == want
    assert st["graph_replays_total"] > 0
    assert n_graph == n_eager


@pytest.mark.cuda
def test_replay_adds_the_captured_launches():
    """Each replay adds its capture's counts: one decode step's graph,
    replayed three times, counts three steps of paged launches, all at
    T = 1, and the capture itself counts none."""
    _card()
    params, cfg = _model()
    cb = serving.ContinuousBatcher(params, cfg, n_slots=2, max_len=128,
                                   block_size=16, device="cuda")
    cb.submit(list(range(1, 20)), max_new_tokens=4)
    cb.step()   # admission + the first chunk (warm run, then capture)
    args = (cb.params, cb.pool, cb.d_table, cb.d_n_alloc, cb.d_fill,
            cb.tau, cb.d_pos, cb.d_active, list(cb.generators),
            cb.d_temps, cb.d_top_ps, cb.d_top_ks)
    kw = dict(config=cb.config, use_kernel=True, all_greedy=True)
    store = cb._graphs
    with serving.use_graphs(store):
        serving._decode_step_core(*args, **kw)      # warm run + capture
        b0 = pa.paged_pool_attention.launches
        t0 = dict(pa.paged_pool_attention.launches_by_t)
        for _ in range(3):
            serving._decode_step_core(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_pool_attention.launches - b0 == 3 * cfg.n_layers
    assert (pa.paged_pool_attention.launches_by_t[1] - t0.get(1, 0)
            == 3 * cfg.n_layers)
    graphs = [g for g in store.graphs.values()
              if g.program == "_paged_decode_step"]
    assert len(graphs) == 1 and graphs[0].replays == 3
    assert graphs[0].custom_kernels == 2 * cfg.n_layers   # split+combine


@pytest.mark.cuda
def test_slot_generator_reseeded_across_admissions():
    """A slot's generator, held by the graphs, re-seeded at each
    admission: the draws equal a fresh generator's from that seed, and
    the one-sample algorithm equals ``torch.multinomial`` on the card."""
    _card()
    p = torch.softmax(torch.randn(4, 1000, device="cuda") * 3, dim=-1)
    for seed in range(5):
        g1 = torch.Generator(device="cuda").manual_seed(seed)
        g2 = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(3):
            assert torch.equal(torch.multinomial(p, 1, generator=g1)[:, 0],
                               categorical(p, g2))
    params, cfg = _model()
    cb = serving.ContinuousBatcher(params, cfg, n_slots=1, max_len=128,
                                   block_size=16, decode_chunk=4,
                                   device="cuda")
    solo = []
    for seed in (7, 8, 7):
        rid = cb.submit(list(range(1, 12)), max_new_tokens=9,
                        temperature=1.0, seed=seed)
        solo.append(cb.run_to_completion()[rid])
    assert solo[0] == solo[2] != solo[1]
    assert cb.stats()["graph_replays_total"] > 0


def _prefill_traffic(params, cfg, graphs):
    """Fused admissions (a budget of 32 tokens), prefix hits (a shared
    48-token prefix) and a host-tier swap-in, greedy and sampled: the
    tokens per request, the flash wrapper's launches and the batcher
    (its graphs closed first when not ``graphs``)."""
    cb = serving.ContinuousBatcher(params, cfg, n_slots=3, max_len=256,
                                   block_size=16, decode_chunk=4,
                                   prefill_budget=32, host_kv_blocks=8,
                                   n_blocks=40, device="cuda")
    if not graphs:
        cb.close()
    fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
    before = fa.flash_attention.launches
    rng = np.random.RandomState(1)
    shared = rng.randint(1, 256, 48).tolist()
    out, got = [], {}

    def pump():
        for rid, tok, *_ in cb.step():
            got.setdefault(rid, []).append(tok)

    # The shared prefix alone first, then every idle block demoted to the
    # host tier: the next sharer restores it (a swap-in and an adoption).
    rid = cb.submit(shared + [7, 8], max_new_tokens=3)
    while cb.pending():
        pump()
    out.append(got.get(rid, []))
    cb.demote_idle(cb.n_blocks)
    for wave in range(2):
        rids = []
        for i in range(4):
            sampled = i % 2 == 1
            tail = rng.randint(1, 256, rng.randint(5, 70)).tolist()
            rids.append(cb.submit(
                (shared if i < 2 else []) + tail,
                max_new_tokens=int(rng.randint(4, 12)),
                temperature=0.9 if sampled else 0.0,
                top_k=20 if sampled else None,
                seed=300 + 10 * wave + i if sampled else None))
            pump()
        while cb.pending():
            pump()
        out += [got.get(r, []) for r in rids]
    torch.cuda.synchronize()
    return out, fa.flash_attention.launches - before, cb


@pytest.mark.cuda
def test_prefill_graphs_replay_eager_tokens():
    """The prefill-side programs replayed (``_fused_chunk``,
    ``_paged_insert``, ``_paged_suffix_insert``, ``_scatter_rows``,
    ``_adopt_jit``): the eager batcher's tokens, greedy and sampled, and
    its flash launches."""
    _card()
    params, cfg = _model()
    got, n_graph, cb = _prefill_traffic(params, cfg, True)
    want, n_eager, cb_e = _prefill_traffic(params, cfg, False)
    assert got == want and all(got)
    assert n_graph == n_eager > 0
    st = cb.stats()
    assert st["fused_admissions_total"] > 0 and st["swap_ins_total"] > 0
    assert st["prefix_requests_hit_total"] > 0
    captured = {g.program for g in cb._graphs.graphs.values()}
    assert {"_fused_chunk", "_paged_insert", "_scatter_rows",
            "_adopt_jit"} <= captured, captured
    replayed = {g.program for g in cb._graphs.graphs.values() if g.replays}
    assert {"_fused_chunk", "_scatter_rows"} <= replayed, replayed
    cb.close()


@pytest.mark.cuda
def test_insert_graphs_one_per_pool():
    """A self-draft batcher's target and draft inserts share a key (the
    same config and shapes) but not a pool: each pool gets its own graph,
    and the tokens are the eager batcher's."""
    _card()
    params, cfg = _model()
    kw = dict(draft_params=params, draft_config=cfg, n_draft=2,
              spec_rounds=2)
    got, _, st = _serve(params, cfg, True, **kw)
    want, _, _ = _serve(params, cfg, False, **kw)
    assert got == want
    cb = serving.ContinuousBatcher(params, cfg, n_slots=3, max_len=256,
                                   block_size=16, device="cuda", **kw)
    cb.submit(list(range(1, 30)), max_new_tokens=4)
    cb.step()
    inserts = [g for g in cb._graphs.graphs.values()
               if g.program == "_paged_insert"]
    assert len(inserts) == 2 and inserts[0].key == inserts[1].key
    cb.close()


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_generate_graphs_replay_eager_tokens(temperature, monkeypatch):
    """``engine.generate`` through the call's graphs (twice: the first
    call runs its programs warm and captures them, the second captures and
    replays at once) and eagerly (no store): the same tokens from one
    generator seed, the same flash launches; ``score`` alike."""
    from jax_llama_tpu_torch import engine

    _card()
    params, cfg = _model()
    fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
    rng = np.random.RandomState(2)
    tokens = torch.from_numpy(rng.randint(1, 256, (3, 40)).astype(np.int32))
    mask = torch.ones((3, 40), dtype=torch.bool)
    mask[1, :7] = False
    tokens[~mask] = 0
    gc = engine.GenerationConfig(max_new_tokens=21, temperature=temperature,
                                 top_k=30, stop_tokens=(5,))
    runs = []
    for eager in (False, False, True):
        if eager:
            monkeypatch.setattr(engine, "_call_graphs",
                                lambda device, mesh: None)
        gen = torch.Generator(device="cuda").manual_seed(4)
        before = fa.flash_attention.launches
        out = engine.generate(params, tokens, mask, gen, config=cfg,
                              gen_config=gc, device="cuda")
        score = engine.score(params, tokens, mask, config=cfg)
        torch.cuda.synchronize()
        runs.append((out.cpu(), score.cpu(),
                     fa.flash_attention.launches - before))
    for out, score, n in runs[:2]:
        assert torch.equal(out, runs[2][0])
        assert torch.equal(score, runs[2][1])
        assert n == runs[2][2] == 2 * cfg.n_layers   # generate + score
