"""The port's ContinuousBatcher held against the JAX package's
(``prefix_cache=False``) on the same weights: tiny float32 config
(tests/test_serving.py's), CPU.  The JAX batcher runs its Pallas paged
kernel in interpret mode; the port runs the plain version of its kernel.
Greedy token lists must be identical under staggered submission, at
decode_chunk 1 and 8, on the paged and the gathered-view path; stop
tokens, capacity errors and an overcommitted pool behave as in the JAX
package; a sampled request emits what the port's own engine.generate at
B=1 emits with the same seed; and a steady-state step makes one fetch and
no uploads.  With int8 weights and an int8 KV pool (scale planes through
the inserts, the paged kernel's plain version and the gathered view) the
greedy tokens are the JAX int8 batcher's, at decode_chunk 1 and 8 on both
paths.  A model with more query heads per KV head than the paged kernel
holds decodes through the gathered view, decided at construction.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu.serving import ContinuousBatcher as JaxBatcher
from jax_llama_tpu.ops import quant as jquant
from jax_llama_tpu.serving import _warp_rows as jax_warp_rows

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import engine as pengine
from jax_llama_tpu_torch import serving as pserving
from jax_llama_tpu_torch.parallel import make_mesh

CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jc, pp, ptl.get_config("tiny", **CFG)


def _batcher(model, **kw):
    _, _, pp, pc = model
    return ptl.ContinuousBatcher(pp, pc, device="cpu", **kw)


def _staggered(cb, n=6, seed=0):
    """tests/test_serving.py's staggered pattern: two requests, then one
    more submitted after each step while the others decode."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, 128, size=rng.randint(3, 12)).tolist()
               for _ in range(n)]
    results = {}
    cb.submit(prompts[0], max_new_tokens=10)
    cb.submit(prompts[1], max_new_tokens=7)
    submitted = 2
    while cb.pending():
        for rid, tok, _ in cb.step():
            results.setdefault(rid, []).append(tok)
        if submitted < n:
            cb.submit(prompts[submitted], max_new_tokens=5 + submitted)
            submitted += 1
    return results


@pytest.fixture(scope="module")
def jax_staggered(model):
    jp, jc, _, _ = model
    return _staggered(JaxBatcher(jp, jc, n_slots=2, max_len=64,
                                 prefix_cache=False))


@pytest.mark.parametrize("path", ["paged", "gathered"])
@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_staggered_requests_match_jax_batcher(model, jax_staggered, path,
                                              decode_chunk):
    cb = _batcher(model, n_slots=2, max_len=64, decode_chunk=decode_chunk,
                  use_pallas_kernel=path == "paged")
    got = _staggered(cb)
    assert got == jax_staggered
    assert sorted(len(t) for t in got.values()) == [7, 7, 8, 9, 10, 10]
    assert len(cb.free_blocks) == cb.n_blocks
    if decode_chunk > 1:
        assert cb.stats()["decode_dispatches_total"] < cb.steps_total


@pytest.fixture(scope="module")
def int8_model(model):
    """int8 weights (the same bytes in both packages) and int8 KV configs."""
    jp, _, pp, _ = model
    kw = dict(CFG, kv_cache_dtype="int8")
    return (jquant.quantize_params(jp), jlt.get_config("tiny", **kw),
            ptl.quantize_params(pp), ptl.get_config("tiny", **kw))


@pytest.fixture(scope="module")
def jax_int8_staggered(int8_model):
    jq, jc, _, _ = int8_model
    return _staggered(JaxBatcher(jq, jc, n_slots=2, max_len=64,
                                 prefix_cache=False))


@pytest.mark.parametrize("path", ["paged", "gathered"])
@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_int8_staggered_requests_match_jax_batcher(
        int8_model, jax_int8_staggered, path, decode_chunk):
    _, _, pq, pc = int8_model
    cb = ptl.ContinuousBatcher(pq, pc, n_slots=2, max_len=64,
                               decode_chunk=decode_chunk, device="cpu",
                               use_pallas_kernel=path == "paged")
    assert cb.pool.quantized and cb.pool.k.dtype == torch.int8
    got = _staggered(cb)
    assert got == jax_int8_staggered
    assert len(cb.free_blocks) == cb.n_blocks


def test_more_query_heads_than_the_kernel_holds_take_the_gathered_view():
    """G = 9 > MAX_GROUP: the batcher builds on the gathered view (it must
    not raise at the first step on the card), for a target and for a
    draft, and emits engine.generate's tokens."""
    wide = dict(CFG, dim=72, n_heads=18, n_kv_heads=2)
    c9 = ptl.get_config("tiny", **wide)
    p9 = ptl.init_params(c9, seed=3, device="cpu")
    cb = ptl.ContinuousBatcher(p9, c9, n_slots=2, max_len=64, device="cpu")
    assert not cb.use_pallas_kernel
    prompt = [5, 17, 99, 3]
    rid = cb.submit(prompt, max_new_tokens=6)
    want = pengine.generate(
        p9, torch.tensor([prompt], dtype=torch.int32),
        torch.ones((1, 4), dtype=torch.bool), config=c9,
        gen_config=pengine.GenerationConfig(max_new_tokens=6,
                                            temperature=0.0),
        device="cpu")[0, 4:].tolist()
    assert cb.run_to_completion()[rid] == want
    c8 = ptl.get_config("tiny", **dict(CFG, n_heads=8, n_kv_heads=1))
    p8 = ptl.init_params(c8, seed=4, device="cpu")
    assert ptl.ContinuousBatcher(p8, c8, device="cpu").use_pallas_kernel
    spec = ptl.ContinuousBatcher(p8, c8, draft_params=p9, draft_config=c9,
                                 device="cpu")
    assert not spec.use_pallas_kernel


@pytest.mark.parametrize("block_size", [20, 12])
def test_paged_path_runs_at_any_block_size(model, monkeypatch, block_size):
    """A block size that is not a multiple of 8 still decodes through the
    paged path (the gathered view is only taken when asked for), with the
    JAX batcher's tokens at the same block size."""
    jp, jc, _, _ = model
    want = _staggered(JaxBatcher(jp, jc, n_slots=2, max_len=64,
                                 block_size=block_size, prefix_cache=False))

    def no_gather(*a, **k):
        raise AssertionError("the paged path fell back to the gathered view")

    monkeypatch.setattr(pserving, "_gather_cache", no_gather)
    cb = _batcher(model, n_slots=2, max_len=64, decode_chunk=4,
                  block_size=block_size)
    assert _staggered(cb) == want


def test_gathered_decode_kernel_name_selects_the_gathered_view(model):
    cb = _batcher(model, n_slots=2, max_len=64, decode_kernel="gathered")
    assert not cb.use_pallas_kernel


def test_stop_tokens_free_the_slot(model):
    jp, jc, _, _ = model
    prompt = [5, 17, 99, 3, 42]
    free_run = _batcher(model, n_slots=1, max_len=64)
    rid = free_run.submit(prompt, max_new_tokens=16)
    tokens = free_run.run_to_completion()[rid]
    j = next(i for i in range(1, len(tokens)) if tokens[i] not in tokens[:i])
    cb = _batcher(model, n_slots=1, max_len=64, stop_tokens=(tokens[j],),
                  decode_chunk=8)
    rid = cb.submit(prompt, max_new_tokens=16)
    got = cb.run_to_completion()[rid]
    assert got == tokens[:j + 1]
    assert not cb.pending() and len(cb.free_blocks) == cb.n_blocks
    jcb = JaxBatcher(jp, jc, n_slots=1, max_len=64, stop_tokens=(tokens[j],),
                     prefix_cache=False)
    jrid = jcb.submit(prompt, max_new_tokens=16)
    assert jcb.run_to_completion()[jrid] == got


def _error(make, call):
    with pytest.raises(ValueError) as e:
        call(make())
    return str(e.value)


def test_capacity_and_oversize_errors_match_jax(model):
    jp, jc, _, _ = model
    cases = [
        (dict(n_slots=1, max_len=32), list(range(1, 30)), 16),
        (dict(n_slots=1, max_len=56), list(range(1, 34)), 16),
        (dict(n_slots=1, max_len=64, n_blocks=2), [1, 2, 3], 40),
        (dict(n_slots=1, max_len=64), [], 4),
    ]
    for kw, prompt, max_new in cases:
        want = _error(lambda: JaxBatcher(jp, jc, prefix_cache=False, **kw),
                      lambda cb: cb.submit(prompt, max_new_tokens=max_new))
        got = _error(lambda: _batcher(model, **kw),
                     lambda cb: cb.submit(prompt, max_new_tokens=max_new))
        assert got == want


def test_overcommitted_pool_queues_until_blocks_free(model):
    """A pool of 6 blocks for 2 slots: the second request (3 blocks) waits
    while the first holds 4, then admits when they free; tokens as the
    JAX batcher's with the same pool."""
    jp, jc, _, _ = model
    kw = dict(n_slots=2, max_len=64, n_blocks=6)
    reqs = [([4, 5, 6, 7, 8], 40), ([9, 10, 11], 20), ([12, 13], 8)]
    cb = _batcher(model, decode_chunk=4, **kw)
    rids = [cb.submit(p, max_new_tokens=n) for p, n in reqs]
    blocked = 0
    results = {}
    while cb.pending():
        for rid, tok, _ in cb.step():
            results.setdefault(rid, []).append(tok)
        if cb.queue and any(s is None for s in cb.slots.values()):
            blocked += 1
    assert blocked > 0
    jcb = JaxBatcher(jp, jc, prefix_cache=False, **kw)
    jrids = [jcb.submit(p, max_new_tokens=n) for p, n in reqs]
    want = jcb.run_to_completion()
    assert [results[r] for r in rids] == [want[r] for r in jrids]
    assert [len(results[r]) for r in rids] == [n for _, n in reqs]


@pytest.mark.parametrize("path", ["paged", "gathered"])
def test_sampled_request_matches_engine_generate(model, path):
    """A sampled request draws from its own generator exactly as
    engine.generate at B=1 with a generator seeded alike, while a greedy
    and another sampled request share the batch."""
    _, _, pp, pc = model
    prompt, n = [7, 3, 99, 41, 2, 8], 12
    gc = pengine.GenerationConfig(max_new_tokens=n, temperature=0.9,
                                  top_p=0.9, top_k=40)
    want = pengine.generate(
        pp, torch.tensor([prompt], dtype=torch.int32),
        torch.ones((1, len(prompt)), dtype=torch.bool),
        torch.Generator(device="cpu").manual_seed(11), config=pc,
        gen_config=gc, device="cpu")[0, len(prompt):].tolist()
    argmax = pengine.generate(
        pp, torch.tensor([prompt], dtype=torch.int32),
        torch.ones((1, len(prompt)), dtype=torch.bool), config=pc,
        gen_config=dataclasses.replace(gc, temperature=0.0),
        device="cpu")[0, len(prompt):].tolist()
    assert want != argmax  # the draws are not the greedy path
    cb = _batcher(model, n_slots=3, max_len=64, decode_chunk=8,
                  use_pallas_kernel=path == "paged")
    other = cb.submit([1, 2, 3], max_new_tokens=9, temperature=0.7, seed=5)
    rid = cb.submit(prompt, max_new_tokens=n, temperature=0.9, top_p=0.9,
                    top_k=40, seed=11)
    greedy = cb.submit([60, 61], max_new_tokens=10)
    got = cb.run_to_completion()
    assert got[rid] == want
    assert len(got[other]) == 9 and len(got[greedy]) == 10
    # without a seed, the request's generator seeds from default_seed(rid)
    cb2 = _batcher(model, n_slots=1, max_len=64)
    cb2._next_id = rid
    rid2 = cb2.submit(prompt, max_new_tokens=n, temperature=0.9, top_p=0.9,
                      top_k=40)
    want2 = pengine.generate(
        pp, torch.tensor([prompt], dtype=torch.int32),
        torch.ones((1, len(prompt)), dtype=torch.bool),
        torch.Generator(device="cpu").manual_seed(cb2.default_seed(rid2)),
        config=pc, gen_config=gc, device="cpu")[0, len(prompt):].tolist()
    assert cb2.run_to_completion()[rid2] == want2


def test_warp_rows_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((5, 128)).astype(np.float32) * 3
    temps = np.array([0.7, 1.0, 1.3, 0.5, 2.0], np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.95], np.float32)
    top_k = np.array([0, 0, 10, 3, 128], np.int32)
    want = np.asarray(jax_warp_rows(logits, temps, top_p, top_k))
    got = pserving._warp_rows(*(torch.from_numpy(a) for a in (
        logits, temps, top_p, top_k))).numpy()
    np.testing.assert_array_equal(got <= -1e30, want <= -1e30)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_steady_state_step_one_fetch_no_uploads(model):
    cb = _batcher(model, n_slots=2, max_len=64, decode_chunk=4)
    cb.submit([3, 4, 5], max_new_tokens=30)
    cb.submit([6, 7], max_new_tokens=30)
    cb.step()  # admission: one packed upload, then the first chunk
    assert cb.stats()["state_uploads_total"] == 1
    for _ in range(3):
        before = cb.stats()
        events = cb.step()
        after = cb.stats()
        assert after["host_syncs_total"] - before["host_syncs_total"] == 1
        assert after["state_uploads_total"] == before["state_uploads_total"]
        assert len(events) == 8  # K = 4 tokens for each of the 2 slots


def test_cancel_frees_the_slot_and_uploads_the_row(model):
    cb = _batcher(model, n_slots=2, max_len=64, decode_chunk=2)
    a = cb.submit([3, 4, 5], max_new_tokens=20)
    b = cb.submit([6, 7], max_new_tokens=6)
    queued = cb.submit([8, 9], max_new_tokens=4)
    cb.step()
    assert cb.cancel(queued) and cb.cancel(a) and not cb.cancel(999)
    uploads = cb.stats()["state_uploads_total"]
    out = cb.run_to_completion()
    assert cb.stats()["state_uploads_total"] == uploads + 1
    assert set(out) == {b} and len(cb.free_blocks) == cb.n_blocks


UNPORTED = [
    # Ported with the serving mesh (A14 part 1; the sharded cases are in
    # test_torch_serve_mesh.py), logprobs (A17), fused prefill-decode
    # (A9), the prefix cache and the host tier (A11): None marks a case
    # that builds and serves.  A one-rank mesh serves as no mesh does.
    (dict(mesh=make_mesh(devices=["cpu"])), None),
    (dict(logprobs=True), None),
    (dict(prefill_budget=32), None),
    (dict(host_kv_blocks=4), None),
    (dict(prefix_cache=True, prefix_index="radix"), None),
]


@pytest.mark.parametrize("kw,item", UNPORTED,
                         ids=[next(iter(kw)) for kw, _ in UNPORTED])
def test_unported_arguments_raise(model, kw, item):
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            _batcher(model, n_slots=1, max_len=64, **kw)
        return
    # The same prompt twice: the second admission hits the cached chain
    # (2 full blocks of 4) and emits the same tokens; with a tier, the
    # chain demoted in between comes back through a swap-in first.
    tier = bool(kw.get("host_kv_blocks"))
    cb = _batcher(model, n_slots=1, max_len=64, block_size=4, **kw)
    prompt = list(range(3, 13))
    cb.submit(prompt, max_new_tokens=6)
    cold = cb.run_to_completion()
    assert cb.demote_idle(8) == (2 if tier else 0)
    cb.submit(prompt, max_new_tokens=6)
    hit = cb.run_to_completion()
    st = cb.stats()
    assert list(hit.values()) == list(cold.values())
    assert st["prefix_requests_hit_total"] == 1
    assert st["prefix_blocks_reused_total"] == 2
    assert st["swap_ins_total"] == (1 if tier else 0)
    # One slot: nothing decodes while a request admits, so a budget
    # keeps classic admission; logprobs ride every event.
    assert st["prefill_budget"] == kw.get("prefill_budget", 0)
    assert st["fused_admissions_total"] == 0
    cb.submit(prompt, max_new_tokens=2)
    events = cb.step() + cb.step()
    assert {len(ev) for ev in events} == {4 if kw.get("logprobs") else 3}


# The kernel-selection arguments (ported with ops/kernels.py): each builds
# and runs, and the batcher's config carries the resolved names.  At this
# config's head_dim 16 no insert is splash-eligible, so "splash" emits the
# flash batcher's tokens; tests/test_torch_kernels.py holds both slots
# against the JAX package.
SELECTED = [
    (dict(prefill_kernel="splash"), ("splash", "paged")),
    (dict(decode_kernel="stock-paged"), ("flash", "stock-paged")),
]


@pytest.mark.parametrize("kw,resolved", SELECTED,
                         ids=[next(iter(kw)) for kw, _ in SELECTED])
def test_kernel_selection_arguments_build_and_run(model, kw, resolved):
    cb = _batcher(model, n_slots=2, max_len=64, decode_chunk=4, **kw)
    assert (cb.config.prefill_kernel, cb.config.decode_kernel) == resolved
    rids = [cb.submit([3, 4, 5], max_new_tokens=6),
            cb.submit([6, 7], max_new_tokens=4)]
    out = cb.run_to_completion()
    assert [len(out[r]) for r in rids] == [6, 4]
    assert all(0 <= t < 128 for r in rids for t in out[r])
    if "prefill_kernel" in kw:
        plain = _batcher(model, n_slots=2, max_len=64, decode_chunk=4)
        prids = [plain.submit([3, 4, 5], max_new_tokens=6),
                 plain.submit([6, 7], max_new_tokens=4)]
        pout = plain.run_to_completion()
        assert [out[r] for r in rids] == [pout[r] for r in prids]


def test_constructor_guards(model):
    _, _, pp, pc = model
    with pytest.raises(ValueError, match="attn_impl"):
        ptl.ContinuousBatcher(pp, pc.replace(attn_impl="flash"),
                              device="cpu")
    with pytest.raises(ValueError, match="prefix_index"):
        ptl.ContinuousBatcher(pp, pc, prefix_index="bogus", device="cpu")
    # an int8 KV pool builds, with its scale planes
    cb = ptl.ContinuousBatcher(pp, pc.replace(kv_cache_dtype="int8"),
                               device="cpu")
    assert cb.pool.k.dtype == torch.int8
    assert cb.pool.k_scale.shape == cb.pool.k.shape[:4]
    # prefix_cache=True with the index off is the JAX package's "off" too
    ptl.ContinuousBatcher(pp, pc, prefix_cache=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptl.ContinuousBatcher(pp, pc)


@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_nonfinite_logits_fail_that_request_alone(model, decode_chunk):
    """A token whose embedding is NaN poisons only the row that feeds it:
    the -1 sentinel fails that request (pop_failed) and frees its slot,
    while the other request emits what it emits on clean weights."""
    _, _, pp, pc = model
    clean = _batcher(model, n_slots=2, max_len=64)
    ok = clean.submit([3, 4, 5], max_new_tokens=12)
    want = clean.run_to_completion()[ok]
    bad_tok = next(t for t in range(127, 0, -1) if t not in want)
    emb = pp["embed"]["embedding"].clone()
    emb[bad_tok] = float("nan")
    poisoned = dict(pp, embed={"embedding": emb})
    cb = ptl.ContinuousBatcher(poisoned, pc, n_slots=2, max_len=64,
                               decode_chunk=decode_chunk, device="cpu")
    ok = cb.submit([3, 4, 5], max_new_tokens=12)
    bad = cb.submit([9, bad_tok], max_new_tokens=12)
    got = cb.run_to_completion()
    assert got[ok] == want and bad not in got
    assert [rid for rid, _ in cb.pop_failed()] == [bad]
    assert cb.stats()["nonfinite_rows_total"] == 1
    assert len(cb.free_blocks) == cb.n_blocks
