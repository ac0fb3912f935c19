"""The port's model held against ``jax_llama_tpu.forward`` on the same
weights: ``jax_llama_tpu.init_params`` draws them, ``from_jax_params``
hands the numpy arrays to the port.  Tiny config, float32, CPU; logits
to atol 2e-4 (PARITY.md row 2.16), for attn_impl xla, flash and auto,
without and with a KV cache.  The JAX flash path runs its Pallas kernel
in interpret mode, the port's its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.models import llama as pllama

ATOL = 2e-4
CFG = dict(vocab_size=96, max_seq_len=32)


@pytest.fixture(scope="module")
def weights():
    params = jlt.init_params(jax.random.PRNGKey(0), jlt.get_config("tiny", **CFG))
    tree = jax.tree.map(np.asarray, params)
    return params, ptl.from_jax_params(tree, device="cpu")


def _configs(**kw):
    return jlt.get_config("tiny", **CFG, **kw), ptl.get_config("tiny", **CFG, **kw)


def _prompt(B=2, P=12, pads=(0, 3), seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, CFG["vocab_size"], (B, P)).astype(np.int32)
    mask = np.arange(P)[None, :] >= np.asarray(pads)[:, None]
    pos = np.where(mask, np.cumsum(mask, -1) - 1, -1).astype(np.int32)
    return tokens, mask, pos


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash", "auto"])
def test_forward_matches_jax_uncached(weights, impl):
    jp, pp = weights
    jc, pc = _configs(attn_impl=impl)
    tokens, mask, pos = _prompt()
    want, _ = jlt.forward(jp, jnp.asarray(tokens), jnp.asarray(pos), jc,
                          attn_mask=jnp.asarray(mask))
    got, _ = ptl.forward(pp, torch.from_numpy(tokens), torch.from_numpy(pos),
                         pc, attn_mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("impl", ["xla", "flash", "auto"])
def test_forward_matches_jax_cached(weights, impl):
    """Prefill 12 tokens (left-padded) into a cache, then 3 decode steps."""
    jp, pp = weights
    jc, pc = _configs(attn_impl=impl)
    tokens, mask, pos = _prompt()
    B, P = tokens.shape
    jcache = jlt.init_cache(jc, B, max_len=20)
    pcache = ptl.init_cache(pc, B, max_len=20, device="cpu")
    want, jcache = jlt.forward(jp, jnp.asarray(tokens), jnp.asarray(pos), jc,
                               cache=jcache, attn_mask=jnp.asarray(mask))
    got, pcache = ptl.forward(pp, torch.from_numpy(tokens),
                              torch.from_numpy(pos), pc, cache=pcache,
                              attn_mask=torch.from_numpy(mask))
    _close(got, want)
    lens = mask.sum(-1)
    nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    for step in range(3):
        step_pos = (lens + step)[:, None].astype(np.int32)
        want, jcache = jlt.forward(jp, jnp.asarray(nxt[:, None]),
                                   jnp.asarray(step_pos), jc, cache=jcache)
        got, pcache = ptl.forward(pp, torch.from_numpy(nxt[:, None]),
                                  torch.from_numpy(step_pos), pc,
                                  cache=pcache)
        _close(got, want)
        nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    assert pcache.index == int(jcache.index)
    np.testing.assert_array_equal(pcache.pos.numpy(), np.asarray(jcache.pos))
    np.testing.assert_allclose(pcache.k.numpy(), np.asarray(jcache.k),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash", "auto"])
def test_cached_decode_equals_full_forward(weights, impl):
    """The invariant the verify recipe drives: decoding token by token
    over the cache gives the full forward's logits."""
    _, pp = weights
    _, pc = _configs(attn_impl=impl)
    tokens, _, _ = _prompt(pads=(0, 0), P=10)
    B, T = tokens.shape
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    full, _ = ptl.forward(pp, torch.from_numpy(tokens), torch.from_numpy(pos), pc)
    cache = ptl.init_cache(pc, B, max_len=T, device="cpu")
    outs = []
    for i in range(T):
        lg, cache = ptl.forward(pp, torch.from_numpy(tokens[:, i:i + 1]),
                                torch.from_numpy(pos[:, i:i + 1]), pc,
                                cache=cache)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=1e-4, rtol=0)


def test_chunked_prefill_without_logits_matches_single_shot(weights):
    _, pp = weights
    _, pc = _configs(attn_impl="auto")
    tokens, mask, pos = _prompt(P=16, pads=(0, 4))
    B, P = tokens.shape
    t, m, p = (torch.from_numpy(a) for a in (tokens, mask, pos))
    one, _ = ptl.forward(pp, t, p, pc, cache=ptl.init_cache(pc, B, 16, device="cpu"),
                         attn_mask=m)
    cache = ptl.init_cache(pc, B, 16, device="cpu")
    lg, cache = ptl.forward(pp, t[:, :9], p[:, :9], pc, cache=cache,
                            attn_mask=m[:, :9], compute_logits=False)
    assert lg is None and cache.index == 9
    lg, cache = ptl.forward(pp, t[:, 9:], p[:, 9:], pc, cache=cache,
                            attn_mask=m[:, 9:])
    torch.testing.assert_close(lg, one[:, 9:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_cache_updates_in_place_and_handle_stays_valid(weights, impl):
    """forward returns the cache object it was given, index advanced; a
    caller that keeps only its first handle (ignoring the returned one)
    still decodes the full forward's logits."""
    _, pp = weights
    _, pc = _configs(attn_impl=impl)
    tokens, _, _ = _prompt(pads=(0, 0), P=6)
    B, T = tokens.shape
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    full, _ = ptl.forward(pp, torch.from_numpy(tokens), torch.from_numpy(pos), pc)
    cache = ptl.init_cache(pc, B, max_len=T, device="cpu")
    outs = []
    for i in range(T):
        lg, returned = ptl.forward(pp, torch.from_numpy(tokens[:, i:i + 1]),
                                   torch.from_numpy(pos[:, i:i + 1]), pc,
                                   cache=cache)
        assert returned is cache and cache.index == i + 1
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="cache overflow"):
        ptl.forward(pp, torch.from_numpy(tokens[:, :1]),
                    torch.from_numpy(pos[:, :1]), pc, cache=cache)


def test_tied_head_matches_jax():
    jc, pc = _configs(tie_word_embeddings=True, attn_impl="auto")
    jp = jlt.init_params(jax.random.PRNGKey(1), jc)
    assert "lm_head" not in jp
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tokens, mask, pos = _prompt(P=10)
    want, _ = jlt.forward(jp, jnp.asarray(tokens), jnp.asarray(pos), jc,
                          attn_mask=jnp.asarray(mask))
    got, _ = ptl.forward(pp, torch.from_numpy(tokens), torch.from_numpy(pos),
                         pc, attn_mask=torch.from_numpy(mask))
    _close(got, want)


def test_bf16_weights_convert():
    jc = jlt.get_config("tiny", **CFG, param_dtype="bfloat16", dtype="bfloat16")
    jp = jlt.init_params(jax.random.PRNGKey(2), jc)
    tree = jax.tree.map(np.asarray, jp)
    pp = ptl.from_jax_params(tree, device="cpu")
    emb = pp["embed"]["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.float().numpy(), np.asarray(jp["embed"]["embedding"], np.float32)
    )


def test_init_params_layout_matches_jax():
    jc, pc = _configs()
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.init_params(pc, seed=0, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    pshapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in pp.items()}
    assert pshapes == jshapes
    assert ptl.param_count(pp) == jlt.param_count(jp)
    again = ptl.init_params(pc, seed=0, device="cpu")
    assert torch.equal(again["layers"]["qkv"], pp["layers"]["qkv"])


def test_unported_options_raise(weights):
    _, pp = weights
    _, pc = _configs()
    t = torch.zeros(1, 2, dtype=torch.int32)
    # output_attentions is ported (ROADMAP A17): the xla path's
    # probabilities, one row per query, summing to 1.
    aux = ptl.forward(pp, t, t, pc, output_attentions=True)[2]
    torch.testing.assert_close(aux.attentions.sum(-1),
                               torch.ones_like(aux.attentions.sum(-1)))
    # attn_impl="ring" is ported (ROADMAP A14 part 2): without a seq
    # axis it is dense sdpa, the xla path's logits; the weights it never
    # materializes stay refused, as in the JAX package.
    torch.testing.assert_close(
        ptl.forward(pp, t, t, pc.replace(attn_impl="ring"))[0],
        ptl.forward(pp, t, t, pc.replace(attn_impl="xla"))[0])
    with pytest.raises(NotImplementedError, match="ring"):
        ptl.forward(pp, t, t, pc.replace(attn_impl="ring"),
                    output_attentions=True)
    with pytest.raises(ValueError):
        ptl.forward(pp, t, t, pc, cache=ptl.init_cache(pc, 1, 1, device="cpu"))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a GPU")
    _, pc = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptl.init_params(pc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptl.init_cache(pc, 1)
    assert pllama.resolve_device("cpu").type == "cpu"
