"""The port's speculative decoding held against the JAX package on the same
weights (CPU, float32, tiny configs).

* The shared rules (``leviathan_verify``, ``place_extra``,
  ``accepted_emit_counts``, ``warped_probs_rows``) against JAX's on the
  same inputs: acceptance counts exact, distributions atol 1e-6.
* ``generate_speculative`` greedy: token-identical to JAX's and to the
  port's plain ``generate`` for n_draft 1-4, and with stop tokens.
* The speculative ``ContinuousBatcher``, greedy, with staggered
  admission: token-identical to JAX's speculative batcher (whose paged
  kernel runs in interpret mode) on the kernel path (the plain version on
  CPU tensors) and the gathered view, at spec_rounds 1 and 4, with the
  same acceptance.  Self-draft accepts every draft; spec_rounds 1 and 4
  agree for greedy and sampled rows; a stop token inside a chunk and a
  non-finite row behave as in the plain batcher.  With int8 weights and
  int8 target and draft pools, the tokens and acceptance are JAX's int8
  speculative batcher's at spec_rounds 1 and 4.
* Sampled: a batcher row emits what a B=1 ``generate_speculative`` with
  the same seed emits (the draws differ from JAX's threefry ones, so the
  sampled path is held by this and by a distribution test: the first
  verified token's histogram over 1500 rows against plain sampling, TV <
  0.12, the JAX package's bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu import spec_decode as jspec
from jax_llama_tpu.engine import GenerationConfig as JaxGenConfig
from jax_llama_tpu.ops import quant as jquant
from jax_llama_tpu.serving import ContinuousBatcher as JaxBatcher
from jax_llama_tpu.serving import warped_probs_rows as jax_warped_probs_rows

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import engine as pengine
from jax_llama_tpu_torch import serving as pserving
from jax_llama_tpu_torch import spec_decode as pspec

# tests/test_spec_decode.py's engine models, tests/test_serving_spec.py's
# batcher model.
TARGET = dict(vocab_size=128, dim=64, n_layers=3, n_heads=4, n_kv_heads=2,
              multiple_of=32, max_seq_len=256, dtype="float32",
              param_dtype="float32")
DRAFT = dict(TARGET, dim=32, n_layers=1, n_heads=2, n_kv_heads=1)
SERVE = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
             multiple_of=32, max_seq_len=128, dtype="float32",
             param_dtype="float32")


def _to_port(tree):
    return ptl.from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# The shared rules
# ---------------------------------------------------------------------------

def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_shared_rules_match_jax():
    rng = np.random.default_rng(0)
    B, G, V = 8, 4, 32
    logits = rng.standard_normal((B, G + 1, V)) * 2
    pprobs = _softmax(logits)
    pprobs[:, :, :4] = 0.0  # warped-out tokens: a draft there is rejected
    pprobs /= pprobs.sum(-1, keepdims=True)
    # a draft near the target: rounds end at every offset
    qprobs = _softmax(logits[:, :G] + 0.5 * rng.standard_normal((B, G, V)))
    qprobs[0] = pprobs[0, :G]  # p == q: accepted, residual fallback to p
    drafts = np.stack([[rng.choice(V, p=qprobs[b, g] / qprobs[b, g].sum())
                        for g in range(G)] for b in range(B)]).astype(np.int32)
    drafts[1, 0] = 2  # p(d) = 0: rejected at once
    u = rng.uniform(size=(B, G)).astype(np.float32)
    want_acc, want_dist = jspec.leviathan_verify(
        *(jnp.asarray(a) for a in (pprobs, qprobs, drafts, u)))
    acc, dist = pspec.leviathan_verify(
        *(torch.from_numpy(a) for a in (pprobs, qprobs, drafts, u)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist),
                               atol=1e-6, rtol=0)
    assert acc[1] == 0 and acc[0] == G
    assert len(set(acc.tolist())) > 2

    extra = rng.integers(0, V, B).astype(np.int32)
    want = jspec.place_extra(jnp.asarray(drafts), want_acc,
                             jnp.asarray(extra))
    got = pspec.place_extra(torch.from_numpy(drafts), acc,
                            torch.from_numpy(extra))
    live = np.arange(G + 1)[None] <= np.asarray(want_acc)[:, None]
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])

    stop_hits = rng.uniform(size=(B, G)) < 0.25
    remaining = rng.integers(1, 6, B).astype(np.int32)
    want_e, want_done = jspec.accepted_emit_counts(
        want_acc, jnp.asarray(stop_hits), jnp.asarray(remaining))
    e, done = pspec.accepted_emit_counts(
        acc, torch.from_numpy(stop_hits), torch.from_numpy(remaining))
    np.testing.assert_array_equal(e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(done.numpy(), np.asarray(want_done))

    logits = rng.standard_normal((4, 3, V)).astype(np.float32) * 3
    pol = (np.array([0.7, 1.0, 1.3, 0.5], np.float32),
           np.array([1.0, 0.9, 0.5, 0.95], np.float32),
           np.array([0, 10, 0, 3], np.int32))
    want_w = jax_warped_probs_rows(jnp.asarray(logits), *pol)
    got_w = pserving.warped_probs_rows(
        torch.from_numpy(logits), *(torch.from_numpy(a) for a in pol))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6,
                               rtol=0)


# ---------------------------------------------------------------------------
# generate_speculative
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_models():
    tc, dc = jlt.get_config("tiny", **TARGET), jlt.get_config("tiny", **DRAFT)
    tp = jlt.init_params(jax.random.PRNGKey(0), tc)
    dp = jlt.init_params(jax.random.PRNGKey(1), dc)
    return (tp, tc, dp, dc, _to_port(tp), ptl.get_config("tiny", **TARGET),
            _to_port(dp), ptl.get_config("tiny", **DRAFT))


def _prompts(rng, B=3, P=12):
    tokens = np.zeros((B, P), np.int32)
    mask = np.zeros((B, P), bool)
    for b in range(B):
        n = rng.randint(3, P + 1)
        tokens[b, P - n:] = rng.randint(1, 128, size=n)
        mask[b, P - n:] = True
    return tokens, mask


def _both_spec(models, tokens, mask, n_draft, max_new, stops=()):
    tp, tc, dp, dc, ptp, ptc, pdp, pdc = models
    want, _ = jspec.generate_speculative(
        tp, dp, jnp.asarray(tokens), jnp.asarray(mask), target_config=tc,
        draft_config=dc, n_draft=n_draft,
        gen_config=JaxGenConfig(max_new_tokens=max_new, temperature=0.0,
                                stop_tokens=stops))
    gc = pengine.GenerationConfig(max_new_tokens=max_new, temperature=0.0,
                                  stop_tokens=stops)
    got, accepted = pspec.generate_speculative(
        ptp, pdp, torch.from_numpy(tokens), torch.from_numpy(mask),
        target_config=ptc, draft_config=pdc, gen_config=gc, n_draft=n_draft,
        device="cpu")
    plain = pengine.generate(ptp, torch.from_numpy(tokens),
                             torch.from_numpy(mask), config=ptc,
                             gen_config=gc, device="cpu")
    return np.asarray(want), got.numpy(), plain.numpy(), accepted


@pytest.mark.parametrize("n_draft", [1, 2, 3, 4])
def test_generate_speculative_matches_jax_and_plain_greedy(engine_models,
                                                           n_draft):
    tokens, mask = _prompts(np.random.RandomState(0))
    want, got, plain, accepted = _both_spec(engine_models, tokens, mask,
                                            n_draft, 24)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    assert got.dtype == np.int32 and (accepted.numpy() >= 0).all()


def test_generate_speculative_with_stop_tokens(engine_models):
    tokens, mask = _prompts(np.random.RandomState(1))
    free = _both_spec(engine_models, tokens, mask, 3, 8)[2]
    stop = int(free[0, tokens.shape[1] + 2])
    want, got, plain, _ = _both_spec(engine_models, tokens, mask, 3, 16,
                                     stops=(stop,))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    assert (got[0, tokens.shape[1] + 3:] == 0).all()


def test_generate_speculative_guards(engine_models):
    _, _, _, _, ptp, ptc, pdp, pdc = engine_models
    tokens, mask = (torch.from_numpy(a) for a in
                    _prompts(np.random.RandomState(2)))
    kw = dict(target_config=ptc, draft_config=pdc, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        pspec.generate_speculative(
            ptp, pdp, tokens, mask,
            gen_config=pengine.GenerationConfig(max_new_tokens=4), **kw)
    with pytest.raises(ValueError, match="vocab"):
        pspec.generate_speculative(
            ptp, pdp, tokens, mask, target_config=ptc, device="cpu",
            draft_config=pdc.replace(vocab_size=64),
            gen_config=pengine.GenerationConfig(temperature=0.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pspec.generate_speculative(
                ptp, pdp, tokens, mask, target_config=ptc, draft_config=pdc,
                gen_config=pengine.GenerationConfig(temperature=0.0))


# ---------------------------------------------------------------------------
# The speculative batcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_models():
    """The target, and a draft that is the target with 5% relative noise
    (so rounds both accept and reject), as JAX trees and port params."""
    jc = jlt.get_config("tiny", **SERVE)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(5)
    jd = jax.tree.map(lambda a: np.asarray(a) * (
        1 + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), jp)
    return dict(jp=jp, jd=jax.tree.map(jnp.asarray, jd), jc=jc,
                pp=_to_port(jp), pd=_to_port(jd),
                pc=ptl.get_config("tiny", **SERVE))


def _staggered(cb, n=6, seed=0):
    """Two requests, then one more submitted after each step."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 128, size=rng.randint(3, 12)).tolist()
               for _ in range(n)]
    results = {}
    cb.submit(prompts[0], max_new_tokens=10)
    cb.submit(prompts[1], max_new_tokens=7)
    submitted = 2
    while cb.pending():
        for rid, tok, *_ in cb.step():
            results.setdefault(rid, []).append(tok)
        if submitted < n:
            cb.submit(prompts[submitted], max_new_tokens=5 + submitted)
            submitted += 1
    return results


def _spec_batcher(m, draft="noisy", **kw):
    pd = m["pd"] if draft == "noisy" else m["pp"]
    return ptl.ContinuousBatcher(m["pp"], m["pc"], draft_params=pd,
                                 draft_config=m["pc"], n_draft=3,
                                 device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_spec_staggered(serve_models):
    """JAX's speculative batcher on its kernel path (spec_rounds 1) and
    its gathered view (spec_rounds 4): the same tokens and acceptance."""
    m = serve_models
    runs = []
    for kernel, rounds in ((True, 1), (False, 4)):
        cb = JaxBatcher(m["jp"], m["jc"], n_slots=2, max_len=64,
                        draft_params=m["jd"], draft_config=m["jc"],
                        n_draft=3, spec_rounds=rounds, prefix_cache=False,
                        use_pallas_kernel=kernel)
        runs.append((_staggered(cb), cb.acceptance_rate()))
    assert runs[0] == runs[1]
    return runs[0]


@pytest.mark.parametrize("path", ["paged", "gathered"])
@pytest.mark.parametrize("spec_rounds", [1, 4])
def test_spec_batcher_matches_jax(serve_models, jax_spec_staggered, path,
                                  spec_rounds):
    want, want_rate = jax_spec_staggered
    cb = _spec_batcher(serve_models, n_slots=2, max_len=64,
                       spec_rounds=spec_rounds,
                       use_pallas_kernel=path == "paged")
    got = _staggered(cb)
    assert got == want
    assert cb.acceptance_rate() == want_rate
    assert 0.0 < want_rate < 1.0  # rounds accepted and rejected drafts
    assert sorted(len(t) for t in got.values()) == [7, 7, 8, 9, 10, 10]
    assert len(cb.free_blocks) == cb.n_blocks
    stats = cb.stats()
    assert stats["drafts_proposed_total"] == cb.drafts_proposed > 0
    assert stats["spec_dispatches_total"] > 0
    if spec_rounds > 1:
        assert stats["spec_rounds_per_dispatch"] >= 1
        assert stats["decode_dispatches_total"] < cb.steps_total


@pytest.mark.parametrize("path", ["paged", "gathered"])
def test_self_draft_accepts_every_draft(serve_models, path):
    m = serve_models
    prompt = [5, 17, 99, 3, 42]
    plain = ptl.ContinuousBatcher(m["pp"], m["pc"], n_slots=1, max_len=64,
                                  device="cpu")
    prid = plain.submit(prompt, max_new_tokens=12)
    want = plain.run_to_completion()[prid]
    cb = _spec_batcher(m, draft="self", n_slots=1, max_len=64,
                       spec_rounds=4, use_pallas_kernel=path == "paged")
    rid = cb.submit(prompt, max_new_tokens=12)
    assert cb.run_to_completion()[rid] == want
    assert cb.acceptance_rate() == 1.0
    assert cb.stats()["spec_window_acceptance_rate"] == 1.0
    # the first token from the prefill, then 3 rounds of tau + 3 drafts:
    # 12 tokens from 3 draft-and-verify rounds, not 12 steps
    assert cb.drafts_proposed == 9


@pytest.fixture(scope="module")
def jax_int8_spec_staggered(serve_models):
    """JAX's int8 speculative batcher (int8 weights, int8 target and draft
    pools) on its gathered view: its kernel path gives the same tokens
    (``jax_spec_staggered`` holds the two equal) at four times the CPU
    time in interpret mode, and the int8 kernel itself is held against
    the interpret-mode Pallas kernel in tests/test_torch_paged.py."""
    m = serve_models
    jc = m["jc"].replace(kv_cache_dtype="int8")
    cb = JaxBatcher(jquant.quantize_params(m["jp"]), jc, n_slots=2,
                    max_len=64, draft_params=jquant.quantize_params(m["jd"]),
                    draft_config=jc, n_draft=3, prefix_cache=False,
                    use_pallas_kernel=False)
    return _staggered(cb), cb.acceptance_rate()


@pytest.mark.parametrize("path,spec_rounds", [("paged", 1), ("paged", 4),
                                              ("gathered", 4)])
def test_int8_spec_batcher_matches_jax(serve_models, jax_int8_spec_staggered,
                                       path, spec_rounds):
    want, want_rate = jax_int8_spec_staggered
    m = serve_models
    pc = m["pc"].replace(kv_cache_dtype="int8")
    cb = ptl.ContinuousBatcher(
        ptl.quantize_params(m["pp"]), pc, n_slots=2, max_len=64,
        draft_params=ptl.quantize_params(m["pd"]), draft_config=pc,
        n_draft=3, spec_rounds=spec_rounds, device="cpu",
        use_pallas_kernel=path == "paged")
    assert cb.pool.quantized and cb.draft_pool.quantized
    got = _staggered(cb)
    assert got == want
    assert cb.acceptance_rate() == want_rate
    assert 0.0 < want_rate < 1.0
    assert len(cb.free_blocks) == cb.n_blocks


SAMPLED = [dict(temperature=0.9, top_p=0.9, seed=11),
           dict(temperature=0.7, top_k=20, seed=5), {}]


def _mixed(cb, prompts, max_new=(12, 9, 10)):
    rids = [cb.submit(p, max_new_tokens=n, **kw)
            for p, n, kw in zip(prompts, max_new, SAMPLED)]
    out = cb.run_to_completion()
    return [out[r] for r in rids]


def test_spec_rounds_1_and_4_agree_for_greedy_and_sampled_rows(
        serve_models):
    prompts = [[7, 3, 99, 41, 2, 8], [1, 2, 3], [60, 61]]
    runs = {}
    for rounds in (1, 4):
        cb = _spec_batcher(serve_models, n_slots=3, max_len=64,
                           spec_rounds=rounds)
        runs[rounds] = (_mixed(cb, prompts), cb.drafts_proposed,
                        cb.drafts_accepted, cb.stats())
    assert runs[1][:3] == runs[4][:3]
    assert [len(t) for t in runs[4][0]] == [12, 9, 10]
    assert (runs[4][3]["spec_host_syncs_per_token"]
            < runs[1][3]["spec_host_syncs_per_token"])


def test_sampled_row_matches_standalone_generate_speculative(serve_models):
    m = serve_models
    prompt, n = [7, 3, 99, 41, 2, 8], 12
    cb = _spec_batcher(m, n_slots=3, max_len=64, spec_rounds=4)
    got = _mixed(cb, [prompt, [1, 2, 3], [60, 61]])[0]
    gc = pengine.GenerationConfig(max_new_tokens=n, temperature=0.9,
                                  top_p=0.9)
    want = pspec.generate_speculative(
        m["pp"], m["pd"], torch.tensor([prompt], dtype=torch.int32),
        torch.ones((1, len(prompt)), dtype=torch.bool),
        torch.Generator(device="cpu").manual_seed(11), target_config=m["pc"],
        draft_config=m["pc"], gen_config=gc, n_draft=3,
        device="cpu")[0][0, len(prompt):].tolist()
    greedy = pengine.generate(
        m["pp"], torch.tensor([prompt], dtype=torch.int32),
        torch.ones((1, len(prompt)), dtype=torch.bool), config=m["pc"],
        gen_config=dataclasses.replace(gc, temperature=0.0),
        device="cpu")[0, len(prompt):].tolist()
    assert got == want
    assert want != greedy  # the draws are not the greedy path


def test_stop_token_inside_a_chunk(serve_models):
    m = serve_models
    prompt = [5, 17, 99, 3, 42]
    free = _spec_batcher(m, n_slots=1, max_len=64, spec_rounds=4)
    rid = free.submit(prompt, max_new_tokens=16)
    tokens = free.run_to_completion()[rid]
    j = next(i for i in range(3, len(tokens)) if tokens[i] not in tokens[:i])
    plain = ptl.ContinuousBatcher(m["pp"], m["pc"], n_slots=1, max_len=64,
                                  stop_tokens=(tokens[j],), device="cpu")
    prid = plain.submit(prompt, max_new_tokens=16)
    want = plain.run_to_completion()[prid]
    assert want == tokens[:j + 1]
    cb = _spec_batcher(m, n_slots=1, max_len=64, spec_rounds=4,
                       stop_tokens=(tokens[j],))
    rid = cb.submit(prompt, max_new_tokens=16)
    assert cb.run_to_completion()[rid] == want
    assert not cb.pending() and len(cb.free_blocks) == cb.n_blocks


@pytest.mark.parametrize("spec_rounds", [1, 4])
def test_nonfinite_row_fails_alone(serve_models, spec_rounds):
    m = serve_models
    clean = _spec_batcher(m, n_slots=2, max_len=64, spec_rounds=spec_rounds)
    ok = clean.submit([3, 4, 5], max_new_tokens=12)
    want = clean.run_to_completion()[ok]
    bad_tok = next(t for t in range(127, 0, -1) if t not in want)
    emb = m["pp"]["embed"]["embedding"].clone()
    emb[bad_tok] = float("nan")
    poisoned = dict(m["pp"], embed={"embedding": emb})
    cb = ptl.ContinuousBatcher(poisoned, m["pc"], n_slots=2, max_len=64,
                               draft_params=m["pd"], draft_config=m["pc"],
                               n_draft=3, spec_rounds=spec_rounds,
                               device="cpu")
    ok = cb.submit([3, 4, 5], max_new_tokens=12)
    bad = cb.submit([9, bad_tok], max_new_tokens=12)
    got = cb.run_to_completion()
    assert got[ok] == want and bad not in got
    assert [rid for rid, _ in cb.pop_failed()] == [bad]
    assert cb.stats()["nonfinite_rows_total"] == 1
    assert len(cb.free_blocks) == cb.n_blocks


def test_spec_constructor_guards(serve_models):
    m = serve_models
    pp, pc = m["pp"], m["pc"]
    kw = dict(n_slots=1, max_len=64, device="cpu", draft_params=pp)
    with pytest.raises(ValueError, match="draft_config"):
        ptl.ContinuousBatcher(pp, pc, **kw)
    with pytest.raises(ValueError, match="vocab"):
        ptl.ContinuousBatcher(pp, pc, draft_config=pc.replace(vocab_size=64),
                              **kw)
    with pytest.raises(ValueError, match="n_draft"):
        ptl.ContinuousBatcher(pp, pc, draft_config=pc, n_draft=0, **kw)
    # a stock-paged draft builds (its rounds run the paged kernel at
    # T = n_draft + 1; tests/test_torch_kernels.py counts the slots)
    cb = ptl.ContinuousBatcher(pp, pc, draft_config=pc.replace(
        decode_kernel="stock-paged"), **kw)
    assert cb.draft_config.decode_kernel == "stock-paged"
    # an int8 draft pool builds beside a bf16/float32 target pool
    cb = ptl.ContinuousBatcher(pp, pc, draft_config=pc.replace(
        kv_cache_dtype="int8"), **kw)
    assert cb.draft_pool.quantized and not cb.pool.quantized
    with pytest.raises(NotImplementedError, match="A17"):
        ptl.ContinuousBatcher(pp, pc, draft_config=pc, logprobs=True, **kw)


# ---------------------------------------------------------------------------
# The sampled distribution
# ---------------------------------------------------------------------------

def test_speculative_sampling_preserves_distribution():
    """tests/test_spec_decode.py's check with the draws as rows of one
    batch: the first token that verification produces (position P+1) has
    the target's sampled distribution."""
    small = dict(vocab_size=16, dim=32, n_layers=2, n_heads=2, n_kv_heads=1,
                 multiple_of=32, max_seq_len=64, dtype="float32",
                 param_dtype="float32")
    tc = ptl.get_config("tiny", **small)
    dc = ptl.get_config("tiny", **{**small, "dim": 16, "n_layers": 1})
    tp = _to_port(jlt.init_params(jax.random.PRNGKey(0),
                                  jlt.get_config("tiny", **small)))
    dp = _to_port(jlt.init_params(
        jax.random.PRNGKey(1),
        jlt.get_config("tiny", **{**small, "dim": 16, "n_layers": 1})))
    n = 1500
    tokens = torch.tensor([[3, 5, 7, 11]], dtype=torch.int32).repeat(n, 1)
    mask = torch.ones_like(tokens, dtype=torch.bool)
    gc = pengine.GenerationConfig(max_new_tokens=3, temperature=0.9,
                                  top_p=None)
    P = tokens.shape[1]
    spec, _ = pspec.generate_speculative(
        tp, dp, tokens, mask, torch.Generator().manual_seed(42),
        target_config=tc, draft_config=dc, gen_config=gc, n_draft=2,
        device="cpu")
    plain = pengine.generate(tp, tokens, mask,
                             torch.Generator().manual_seed(43), config=tc,
                             gen_config=gc, device="cpu")
    V = small["vocab_size"]
    h_spec = np.bincount(spec[:, P + 1].numpy(), minlength=V) / n
    h_plain = np.bincount(plain[:, P + 1].numpy(), minlength=V) / n
    tv = 0.5 * np.abs(h_spec - h_plain).sum()
    # TV noise floor of two empirical estimates at n=1500, V=16 is ~0.05.
    assert tv < 0.12, (tv, h_spec, h_plain)
