"""The batcher's programs as CUDA graphs on the card (``utils.programs``).
Marked ``cuda``: each test skips on a host without a GPU.  Like
tests/test_torch_cuda.py, this file imports neither jax nor the JAX
package:

    python -m pytest tests/test_torch_programs_cuda.py -m cuda --noconftest -q

In float32 (matmuls without TF32) a batcher that replays its decode
programs' graphs emits exactly the tokens of one that runs them eagerly
(``close()`` drops a batcher's graphs), greedy and sampled, with slots
reused across admissions; every replay adds the launches its capture
recorded, so the wrappers' counts are an eager run's.
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
