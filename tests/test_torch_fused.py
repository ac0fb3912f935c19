"""Fused prefill-decode scheduling in the port's ContinuousBatcher
(``prefill_budget`` > 0), held against the JAX package's fused batcher on
the same weights (tests/test_serving_fused.py's tiny float32 config and
scenario, blocks of 16, CPU; the JAX batcher's Pallas kernels run in
interpret mode) and against the port's own classic admission: greedy
tokens and logprobs equal to JAX's on a miss and on a prefix hit; sampled
tokens equal to the port's classic path (the per-request generators draw
the first token once, in the dispatch that lands the last chunk); the
first token out of that dispatch, with the decoding row emitting in every
mid-prefill dispatch; a cancel and a rebuild mid-prefill; int8 pools
against the classic path at the same prefill chunking; the
``prefill_chunk`` fault site; ``_pf_chunk``'s clamp on a hit row near the
end of its view; a swap-in landing in the fused lane; one fetch a
dispatch and one state upload an admission; the brownout budget shrink.
"""

import jax
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu.serving import ContinuousBatcher as JaxBatcher

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.faults import FaultInjector, InjectedFault

CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")
BLOCK = 16
LP_ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jc, pp, ptl.get_config("tiny", **CFG)


def _port(model, attn_impl=None, **kw):
    _, _, pp, pc = model
    kw.setdefault("block_size", BLOCK)
    if attn_impl is not None:
        pc = pc.replace(attn_impl=attn_impl)
    return ptl.ContinuousBatcher(pp, pc, device="cpu", **kw)


def _scenario(cb, *, sampled=False, prefix=False, logprobs=True):
    """test_serving_fused.py's request shape: r0 decodes (a cold pool
    admits it classically), then r1, a 2.5-block prompt, is submitted
    mid-decode and rides the fused lane when the batcher has a budget.
    ``prefix``: a sharer warms the cache first, so r1 walks from fill0.
    Returns ((r0, r1) tokens, (r0, r1) logprobs)."""
    toks, lps = {}, {}

    def pump(n=None):
        guard = 0
        while True:
            guard += 1
            assert guard < 500
            for ev in cb.step():
                toks.setdefault(ev[0], []).append(ev[1])
                if logprobs:
                    lps.setdefault(ev[0], []).append(ev[3])
            if n is not None and guard >= n:
                return
            if n is None and not cb.pending():
                return

    rng = np.random.RandomState(3)
    shared = rng.randint(1, 128, size=34).tolist()  # 2 full keyed blocks
    if prefix:
        cb.submit(shared + [7], max_new_tokens=2)
        pump()
    pol0 = (dict(max_new_tokens=9, temperature=0.8, seed=7) if sampled
            else dict(max_new_tokens=9))
    pol1 = (dict(max_new_tokens=6, temperature=0.7, top_p=0.9, seed=12)
            if sampled else dict(max_new_tokens=6))
    r0 = cb.submit([5, 17, 99, 3], **pol0)
    pump(2)  # r0 admitted and mid-decode
    r1 = cb.submit(shared + [9, 11], **pol1)
    pump()
    return (toks[r0], toks[r1]), (lps.get(r0), lps.get(r1))


def _geometry(**kw):
    return dict(dict(n_slots=2, max_len=64, decode_chunk=4), **kw)


def _assert_lps(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=LP_ATOL)


@pytest.mark.parametrize("prefix", [False, True], ids=["miss", "hit"])
def test_fused_greedy_matches_jax_fused_batcher(model, prefix):
    """The tier-1 cell of JAX's matrix (one-block budget, greedy) on a
    miss, and JAX's fused greedy output on a prefix hit: tokens exact,
    logprobs within 1e-5."""
    jp, jc, _, _ = model
    kw = _geometry(prefill_budget=BLOCK, logprobs=True)
    want_t, want_l = _scenario(JaxBatcher(jp, jc, block_size=BLOCK, **kw),
                               prefix=prefix)
    cb = _port(model, **kw)
    got_t, got_l = _scenario(cb, prefix=prefix)
    assert cb.fused_admissions_total == 1
    assert cb.prefill_chunks_total == (1 if prefix else 3)
    assert cb.prefix_requests_hit == (1 if prefix else 0)
    assert got_t == want_t
    _assert_lps(got_l, want_l)


@pytest.fixture(scope="module")
def classic_sampled(model):
    return _scenario(_port(model, **_geometry(logprobs=True)), sampled=True)


@pytest.mark.parametrize("budget", [BLOCK, 2 * BLOCK, 4096])
def test_fused_sampled_matches_port_classic(model, classic_sampled, budget):
    """Seeded sampling: the fused lane's first-token draw consumes the
    request's generator exactly as the classic insert does, and a
    non-final chunk draws nothing, at every budget."""
    want_t, want_l = classic_sampled
    cb = _port(model, **_geometry(prefill_budget=budget, logprobs=True))
    got_t, got_l = _scenario(cb, sampled=True)
    assert cb.fused_admissions_total == 1
    assert got_t == want_t
    _assert_lps(got_l, want_l)


def test_first_token_from_the_prefill_completion_dispatch(model):
    """The dispatch that lands the last prompt chunk emits the row's first
    token; while the prompt is mid-prefill the decoding row emits in every
    dispatch at a chunk size that did not collapse to 1, and fused
    admission adds no fetch beyond the one a dispatch and one state
    upload for the whole admission."""
    cb = _port(model, **_geometry(prefill_budget=BLOCK))
    r0 = cb.submit([5, 17, 99, 3], max_new_tokens=24)
    cb.step()
    cb.step()
    s0, u0, d0 = (cb.host_syncs_total, cb.state_uploads_total,
                  cb.decode_dispatches_total)
    r1 = cb.submit(np.random.RandomState(3).randint(1, 128, 40).tolist(),
                   max_new_tokens=6)
    completion, mid = None, 0
    while cb._pf is not None or cb.prefill_chunks_total == 0:
        before = cb._pf is not None
        if before:
            assert cb.stats()["prefill_tokens_inflight"] > 0
        evs = cb.step()
        if before and cb._pf is None:
            completion = evs
        elif before:
            mid += 1
            assert any(ev[0] == r0 for ev in evs)
            assert not any(ev[0] == r1 for ev in evs)
            assert cb.decode_chunk_last > 1
    assert mid >= 1 and cb.prefill_chunks_total == 3
    assert any(ev[0] == r1 for ev in completion)
    assert cb.host_syncs_total - s0 == cb.decode_dispatches_total - d0
    assert cb.state_uploads_total - u0 == 1
    while cb.pending():
        cb.step()
    st = cb.stats()
    assert st["prefill_tokens_inflight"] == 0
    assert st["decode_stall_ms_total"] == 0.0
    assert st["insert_dispatches_total"] == 1  # r0's cold insert only


def test_cancel_mid_prefill_frees_admission(model):
    cb = _port(model, **_geometry(prefill_budget=BLOCK, prefix_cache=False))
    toks = {}

    def pump(n):
        for _ in range(n):
            for ev in cb.step():
                toks.setdefault(ev[0], []).append(ev[1])

    r0 = cb.submit([5, 17, 99, 3], max_new_tokens=16)
    pump(2)
    r1 = cb.submit(np.random.RandomState(3).randint(1, 128, 40).tolist(),
                   max_new_tokens=6)
    r2 = cb.submit([7, 8, 9], max_new_tokens=4)
    pump(1)
    assert cb._pf is not None and cb._pf.req.rid == r1
    free_before = len(cb.free_blocks)
    assert cb.cancel(r1)
    assert cb._pf is None and len(cb.free_blocks) > free_before
    while cb.pending():
        pump(1)
    assert r1 not in toks
    assert len(toks[r2]) == 4 and len(toks[r0]) == 16
    assert len(cb.free_blocks) == cb.n_blocks


def test_rebuild_drops_inflight_prefill(model):
    """Crash recovery: the rebuilt batcher has no prefill in flight, and
    the resubmitted request regenerates the classic path's tokens."""
    prompt = np.random.RandomState(3).randint(1, 128, 40).tolist()
    oracle = _port(model, **_geometry())
    ro = oracle.submit(list(prompt), max_new_tokens=6)
    want = oracle.run_to_completion()[ro]
    cb = _port(model, **_geometry(prefill_budget=BLOCK))
    cb.submit([5, 17, 99, 3], max_new_tokens=12)
    cb.step()
    cb.step()
    cb.submit(list(prompt), max_new_tokens=6)
    cb.step()
    assert cb._pf is not None
    cb2 = cb.rebuild()
    assert cb2._pf is None and cb2.prefill_budget == cb.prefill_budget
    r = cb2.submit(list(prompt), max_new_tokens=6)
    assert cb2.run_to_completion()[r] == want


def test_int8_fused_matches_classic_at_the_same_chunking(model):
    """An int8 pool quantizes a chunk's KV when it lands, so the oracle is
    the classic path with the same prefill chunking (JAX :110-114)."""
    _, _, pp, pc = model
    qc = pc.replace(kv_cache_dtype="int8")
    mk = lambda **kw: ptl.ContinuousBatcher(  # noqa: E731
        pp, qc, device="cpu", block_size=BLOCK, **_geometry(**kw))
    want_t, want_l = _scenario(mk(prefill_chunk=2 * BLOCK, logprobs=True),
                               sampled=True)
    cb = mk(prefill_budget=2 * BLOCK, logprobs=True)
    got_t, got_l = _scenario(cb, sampled=True)
    assert cb.fused_admissions_total == 1
    assert got_t == want_t
    _assert_lps(got_l, want_l)


def test_prefill_chunk_site_fires_only_mid_prefill(model):
    """``prefill_chunk`` indexes prefill-carrying dispatches only: @1 is
    the second chunk of the fused admission, whatever ran before it; the
    fault names the chunk's flash prefill ("auto": a 16-token chunk runs
    the flash kernel's path) and the paged kernel, leaves nothing
    emitted, and a rebuilt batcher replays the request to the fault-free
    tokens."""
    prompt = np.random.RandomState(3).randint(1, 128, 40).tolist()
    clean = _port(model, attn_impl="auto", **_geometry(prefill_budget=BLOCK))
    a = clean.submit([5, 17, 99, 3], max_new_tokens=30)
    want = {a: [ev[1] for ev in clean.step() + clean.step()]}
    b = clean.submit(list(prompt), max_new_tokens=6)
    for rid, toks in clean.run_to_completion().items():
        want.setdefault(rid, []).extend(toks)
    inj = FaultInjector("prefill_chunk@1:error")
    cb = _port(model, attn_impl="auto", **_geometry(prefill_budget=BLOCK),
               fault_injector=inj)
    got = {}
    cb.submit([5, 17, 99, 3], max_new_tokens=30)
    for _ in range(3):  # decode-only dispatches: the site stays at 0
        for ev in cb.step():
            got.setdefault(ev[0], []).append(ev[1])
    assert inj.calls["prefill_chunk"] == 0 and inj.calls["step"] == 3
    cb.submit(list(prompt), max_new_tokens=6)
    for ev in cb.step():  # chunk 0
        got.setdefault(ev[0], []).append(ev[1])
    delivered = {k: list(v) for k, v in got.items()}
    with pytest.raises(InjectedFault, match="prefill_chunk"):
        cb.step()
    assert cb.last_dispatch_features == ("flash_attention", "paged_kernel")
    # The server's replay: prompt + delivered tokens on a rebuilt batcher.
    cb2 = cb.rebuild()
    r0 = cb2.submit([5, 17, 99, 3] + delivered[0],
                    max_new_tokens=30 - len(delivered[0]))
    r1 = cb2.submit(list(prompt), max_new_tokens=6)
    out = cb2.run_to_completion()
    assert delivered[0] + out[r0] == want[a]
    assert out[r1] == want[b]


def test_pf_chunk_clamp_on_a_hit_row_near_its_view_end(model):
    """A hit row's walk starts at fill0; the chunk halves until its last
    window fits the row's view (JAX :4522), and the fused run then emits
    the classic run's tokens."""
    cb = _port(model, n_slots=2, max_len=64, decode_chunk=4,
               prefill_budget=4096)
    # 4 view blocks; 2 shared: a 33-token suffix bucketed to 4 blocks
    # would run 2 blocks past the view, so C halves to 1 block.
    assert cb._pf_chunk(33, 2) == BLOCK
    assert cb._pf_chunk(33, 0) == 4 * BLOCK
    assert cb._pf_chunk(17, 2) == 2 * BLOCK
    cb.prefill_budget = 3 * BLOCK  # rounds DOWN to a pow2 block count
    assert cb._pf_chunk(60, 0) == 2 * BLOCK
    # 8 view blocks, 1 shared: a 90-token suffix bucketed to 8 blocks
    # (one 128-token window from fill0 16) would pass the view's 128
    # columns; halved twice, 3 windows of 32 end at 112.
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 128, BLOCK).tolist()
    tail = rng.randint(1, 128, 90).tolist()
    outs = []
    for budget in (0, 4096):
        cb = _port(model, n_slots=2, max_len=128, decode_chunk=4,
                   prefill_budget=budget)
        if budget:
            assert cb._pf_chunk(90, 1) == 2 * BLOCK
            assert cb._pf_chunk(90, 0) == 8 * BLOCK
        cb.submit(shared + [3], max_new_tokens=2)
        cb.run_to_completion()
        r0 = cb.submit([5, 17, 99, 3], max_new_tokens=10)
        cb.step()
        cb.step()
        r1 = cb.submit(shared + tail, max_new_tokens=8)
        out = cb.run_to_completion()
        outs.append((out[r1], cb.prefill_chunks_total))
    assert outs[0][0] == outs[1][0]
    assert outs[1][1] == 3


def test_swap_in_lands_in_the_fused_lane(model):
    """A restored prefix admits through the fused lane while a row
    decodes (JAX :4496-4520): its walk starts at the matched depth, the
    decoding row keeps emitting, and the tokens are a cold batcher's."""
    session = np.random.RandomState(47).randint(1, 128, 40).tolist()
    cold = _port(model, n_slots=2, max_len=128, decode_chunk=4,
                 prefix_cache=False)
    rc = cold.submit(list(session), max_new_tokens=4)
    want = cold.run_to_completion()[rc]
    cb = _port(model, n_slots=2, max_len=128, n_blocks=12, decode_chunk=4,
               prefill_budget=BLOCK, host_kv_blocks=8)
    cb.submit(list(session), max_new_tokens=4)
    cb.run_to_completion()
    assert cb.demote_idle(2) == 2
    r0 = cb.submit([3, 5, 9], max_new_tokens=40)
    cb.step()
    cb.step()
    cb.swap_poll_min = 2
    rid = cb.submit(list(session), max_new_tokens=4)
    got = []
    while cb.pending():
        evs = cb.step()
        if cb._restoring or cb._pf is not None:
            assert any(ev[0] == r0 for ev in evs)
        got += [ev[1] for ev in evs if ev[0] == rid]
    st = cb.stats()
    assert got == want
    assert st["swap_ins_total"] == 1 and st["fused_admissions_total"] == 1
    assert cb.prefill_chunks_total == 1  # 8 tokens past the 32 restored


def test_brownout_budget_shrink_adds_chunks(model):
    """The server's brownout rung sets the live budget lower: the next
    fused admission walks in more, smaller chunks to the same tokens."""
    prompt = np.random.RandomState(9).randint(1, 128, 60).tolist()
    runs = []
    for shrink in (False, True):
        cb = _port(model, n_slots=2, max_len=128, decode_chunk=4,
                   prefill_budget=4 * BLOCK, prefix_cache=False)
        cb.submit([4, 5, 6], max_new_tokens=16)
        cb.step()
        cb.step()
        if shrink:
            cb.prefill_budget = BLOCK
        r = cb.submit(list(prompt), max_new_tokens=5)
        out = cb.run_to_completion()
        runs.append((out[r], cb.prefill_chunks_total,
                     cb.describe()["prefill_budget"]))
    assert runs[0][0] == runs[1][0]
    assert (runs[0][1], runs[1][1]) == (1, 4)
    assert (runs[0][2], runs[1][2]) == (4 * BLOCK, BLOCK)
