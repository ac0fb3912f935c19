"""Per-token logprobs, ``engine.score`` and the forward's auxiliary outputs
in the port (ROADMAP A17), held against the JAX package on the same
weights (the tiny float32 config of tests/test_serving.py, CPU): batcher
logprobs at decode_chunk 1 and 4 and under self-draft speculation (the
per-round loop and R rounds a dispatch), ``score`` with left padding,
``forward``'s hidden states and attention probabilities (cache-free and
over a cache), ``window_positions``; and against the port itself: each
emitted token's logprob is ``score`` of the finished sequence at its
position, and the HTTP server returns them in blocking and streaming
replies as JAX's server does.  Logprobs within 1e-5 abs.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu import engine as jengine
from jax_llama_tpu.models import llama as jllama
from jax_llama_tpu.server import LLMServer as JServer
from jax_llama_tpu.serving import ContinuousBatcher as JaxBatcher
from jax_llama_tpu.tokenizers.bytes import ByteTokenizer as JByteTokenizer

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import engine as pengine
from jax_llama_tpu_torch.server import LLMServer as PServer
from jax_llama_tpu_torch.tokenizers import ByteTokenizer

CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")
ATOL = 1e-5
PROMPTS = ([5, 17, 99, 3], [8, 1, 2, 40, 41, 42, 7, 9, 11, 12],
           [100, 3, 3, 3, 7, 64, 2])
MAX_NEW = (9, 6, 7)


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jc, pp, ptl.get_config("tiny", **CFG)


def _serve(cb):
    """Staggered: the first request alone, the rest after one step.
    Returns {index: [(token, logprob), ...]}."""
    rids = {cb.submit(list(PROMPTS[0]), max_new_tokens=MAX_NEW[0]): 0}
    out = {}
    first = True
    while cb.pending():
        for ev in cb.step():
            out.setdefault(rids[ev[0]], []).append((ev[1], ev[3]))
        if first:
            first = False
            for i in (1, 2):
                rids[cb.submit(list(PROMPTS[i]),
                               max_new_tokens=MAX_NEW[i])] = i
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert [t for t, _ in got[i]] == [t for t, _ in want[i]]
        np.testing.assert_allclose([lp for _, lp in got[i]],
                                   [lp for _, lp in want[i]],
                                   atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def jax_plain(model):
    jp, jc, _, _ = model
    return _serve(JaxBatcher(jp, jc, n_slots=2, max_len=64, decode_chunk=4,
                             logprobs=True))


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_batcher_logprobs_match_jax(model, jax_plain, decode_chunk):
    _, _, pp, pc = model
    cb = ptl.ContinuousBatcher(pp, pc, n_slots=2, max_len=64,
                               decode_chunk=decode_chunk, logprobs=True,
                               device="cpu")
    got = _serve(cb)
    _assert_same(got, jax_plain)
    # The logprobs ride the token fetch: no step makes a second one.
    assert cb.host_syncs_total == cb.decode_dispatches_total


@pytest.mark.parametrize("spec_rounds", [1, 4])
def test_self_draft_speculation_logprobs_match_jax(model, spec_rounds):
    """The target's logprob at each emitted offset, per round (JAX
    :1345-1350); the chunked path packs them beside the tokens."""
    jp, jc, pp, pc = model
    kw = dict(n_slots=2, max_len=64, n_draft=3, spec_rounds=spec_rounds,
              logprobs=True)
    want = _serve(JaxBatcher(jp, jc, draft_params=jp, draft_config=jc,
                             **kw))
    cb = ptl.ContinuousBatcher(pp, pc, draft_params=pp, draft_config=pc,
                               device="cpu", **kw)
    _assert_same(_serve(cb), want)
    assert cb.acceptance_rate() == 1.0


def test_logprobs_are_scores_of_the_finished_sequence(model):
    """Each emitted token's logprob is ``engine.score`` of the prompt and
    the completion at that token's position (the raw logits' log-softmax,
    whatever the sampling policy)."""
    _, _, pp, pc = model
    cb = ptl.ContinuousBatcher(pp, pc, n_slots=2, max_len=64,
                               decode_chunk=4, logprobs=True,
                               prefill_budget=16, device="cpu")
    got = _serve(cb)
    for i, prompt in enumerate(PROMPTS):
        toks = [t for t, _ in got[i]]
        seq = torch.tensor([list(prompt) + toks], dtype=torch.int32)
        ref = pengine.score(pp, seq, config=pc)[0, len(prompt) - 1:]
        np.testing.assert_allclose([lp for _, lp in got[i]], ref.numpy(),
                                   atol=ATOL, rtol=0)


def test_score_with_left_padding_matches_jax(model):
    jp, jc, pp, pc = model
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 128, (3, 12)).astype(np.int32)
    mask = np.arange(12)[None, :] >= np.array([0, 3, 7])[:, None]
    want = np.asarray(jengine.score(jp, jnp.asarray(tokens),
                                    jnp.asarray(mask), config=jc))
    got = ptl.score(pp, torch.from_numpy(tokens), torch.from_numpy(mask),
                    config=pc)
    assert got.dtype == torch.float32 and got.shape == (3, 11)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert not got.numpy()[~(mask[:, :-1] & mask[:, 1:])].any()
    # "auto" runs the flash path at T = 12 > 8 (its plain version here).
    auto = ptl.score(pp, torch.from_numpy(tokens), torch.from_numpy(mask),
                     config=pc.replace(attn_impl="auto"))
    np.testing.assert_allclose(auto.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cached", [False, True], ids=["free", "cache"])
def test_forward_aux_outputs_match_jax(model, cached):
    """hidden_states [L+1, B, T, D] and attentions [L, B, H, T, S] (over
    a cache: S = the cache slots, then the new tokens); "auto" keeps its
    path for hidden states (the flash path at T = 12) and the xla path
    for the probabilities."""
    jp, jc, pp, pc = model
    rng = np.random.RandomState(1)
    tokens = rng.randint(1, 128, (2, 12)).astype(np.int32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    for cfg in (pc, pc.replace(attn_impl="auto")):
        kw = dict(output_hidden_states=True, output_attentions=True)
        if cached:
            jcache = jllama.init_cache(jc, 2, max_len=16)
            _, _, want = jllama.forward(jp, tokens, pos, jc, cache=jcache,
                                        **kw)
            pcache = ptl.init_cache(cfg, 2, max_len=16, device="cpu")
            _, _, got = ptl.forward(pp, torch.from_numpy(tokens),
                                    torch.from_numpy(pos), cfg,
                                    cache=pcache, **kw)
        else:
            _, _, want = jllama.forward(jp, tokens, pos, jc, **kw)
            _, _, got = ptl.forward(pp, torch.from_numpy(tokens),
                                    torch.from_numpy(pos), cfg, **kw)
        for name in ("hidden_states", "attentions", "last_hidden_state"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                atol=ATOL, rtol=0)
        hs = ptl.forward(pp, torch.from_numpy(tokens), torch.from_numpy(pos),
                         cfg, output_hidden_states=True)[2]
        np.testing.assert_allclose(hs.hidden_states.numpy(),
                                   np.asarray(want.hidden_states),
                                   atol=ATOL, rtol=0)
        assert hs.attentions is None


def test_window_positions_match_jax():
    for base, off, width, length in ((0, 0, 16, 36), (32, 16, 16, 20),
                                     (128, 0, 8, 3), (16, 32, 16, 40)):
        jp_, jr = jengine.window_positions(
            jnp.int32(base), jnp.int32(off), width, jnp.int32(length))
        pp_, pr = pengine.window_positions(base, off, width, length)
        np.testing.assert_array_equal(pp_.numpy(), np.asarray(jp_))
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        tp, tr = pengine.window_positions(
            torch.tensor(base, dtype=torch.int32), off, width, length)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp_))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def _post(url, payload):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        raw, ctype = r.read(), r.headers.get("Content-Type", "")
    if "ndjson" in ctype:
        return [json.loads(x) for x in raw.splitlines()]
    return json.loads(raw)


def test_server_logprobs_blocking_and_streaming_match_jax(model):
    """``"logprobs": true`` on a batcher built with logprobs=True: the
    blocking reply's ``logprobs`` list and each stream line's
    ``logprob`` (and the final record's list), as JAX's server gives."""
    jp, jc, pp, pc = model
    payload = {"prompt": list(PROMPTS[1]), "max_new_tokens": 6,
               "logprobs": True}
    kw = dict(n_slots=2, max_len=64, decode_chunk=4, logprobs=True,
              prefill_budget=16)
    out = {}
    for name, srv in (
            ("jax", JServer(JaxBatcher(jp, jc, **kw),
                            tokenizer=JByteTokenizer())),
            ("port", PServer(ptl.ContinuousBatcher(pp, pc, device="cpu",
                                                   **kw),
                             tokenizer=ByteTokenizer()))):
        with srv:
            out[name] = (_post(srv.address, payload),
                         _post(srv.address, dict(payload, stream=True)))
    (jb, js), (pb, ps) = out["jax"], out["port"]
    assert pb["tokens"] == jb["tokens"] and len(pb["logprobs"]) == 6
    np.testing.assert_allclose(pb["logprobs"], jb["logprobs"], atol=ATOL)
    lines = [ln for ln in ps if "token" in ln and "tokens" not in ln]
    assert [ln["token"] for ln in lines] == pb["tokens"]
    np.testing.assert_allclose([ln["logprob"] for ln in lines],
                               pb["logprobs"], atol=ATOL)
    np.testing.assert_allclose(ps[-1]["logprobs"], js[-1]["logprobs"],
                               atol=ATOL)
