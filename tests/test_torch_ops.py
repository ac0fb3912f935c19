"""The port's plain ops held against the JAX package on the same inputs.

Inputs are drawn with numpy from a seed and handed to both packages;
JAX runs on the CPU.  Tolerances: atol 1e-5 for the float32 tensor ops
(different summation orders, same math), 1e-6 for the sampling
distribution, exact for greedy tokens and masks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_llama_tpu as jlt
from jax_llama_tpu import config as jcfg
from jax_llama_tpu.ops import attention as jattn
from jax_llama_tpu.ops import norm as jnorm
from jax_llama_tpu.ops import rope as jrope
from jax_llama_tpu.ops import sampling as jsamp
from jax_llama_tpu.tokenizers import ByteTokenizer as JByteTokenizer

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import config as pcfg
from jax_llama_tpu_torch.ops import attention as pattn
from jax_llama_tpu_torch.ops import norm as pnorm
from jax_llama_tpu_torch.ops import rope as prope
from jax_llama_tpu_torch.ops import sampling as psamp

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().cpu() if torch.is_tensor(got) else got),
        np.asarray(want), atol=atol, rtol=0,
    )


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_match(name):
    a, b = jcfg.get_config(name), pcfg.get_config(name)
    for field in ("vocab_size", "dim", "n_layers", "n_heads", "kv_heads",
                  "head_dim", "ffn_dim", "max_seq_len", "rope_theta",
                  "use_scaled_rope", "rms_norm_eps"):
        assert getattr(a, field) == getattr(b, field), field
    assert str(a.activation_dtype) == str(b.activation_dtype).split(".")[-1]


def test_llama3_8b_widths():
    c = pcfg.get_config("llama3-8b")
    assert (c.dim, c.n_layers, c.n_heads, c.kv_heads, c.ffn_dim,
            c.vocab_size, c.rope_theta) == (
        4096, 32, 32, 8, 14336, 128256, 500000.0)


def test_config_rejects_unported_paths():
    with pytest.raises(NotImplementedError):
        pcfg.tiny(attn_impl="ring").validate()
    pcfg.tiny(kv_cache_dtype="int8").validate()  # int8 KV is ported
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        pcfg.tiny(kv_cache_dtype="fp8").validate()
    with pytest.raises(ValueError):
        pcfg.tiny(attn_impl="bogus").validate()


def test_byte_tokenizer_matches():
    a, b = JByteTokenizer(), ptl.ByteTokenizer()
    s = "héllo, wörld ✓"
    assert a.encode(s, bos=True, eos=True) == b.encode(s, bos=True, eos=True)
    ids = a.encode(s)
    assert a.decode(ids + [256, 258]) == b.decode(ids + [256, 258])
    assert (a.stop_tokens, len(a), a.pad_id) == (b.stop_tokens, len(b), b.pad_id)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    s = rng.standard_normal(32).astype(np.float32)
    _close(pnorm.rms_norm(_t(x), _t(s), 1e-5),
           jnorm.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("scaled", [False, True])
def test_rope_matches(scaled):
    rng = np.random.default_rng(1)
    hd, P = 16, 64
    jc, js = jrope.rope_table(hd, P, 500000.0, use_scaled_rope=scaled)
    pc, ps = prope.rope_table(hd, P, 500000.0, use_scaled_rope=scaled)
    np.testing.assert_array_equal(jc, pc)
    np.testing.assert_array_equal(js, ps)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, P, (2, 7)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(jc), jnp.asarray(js),
                            jnp.asarray(pos))
    got = prope.apply_rope(_t(x), _t(pc), _t(ps), _t(pos))
    _close(got, want)


def test_llama3_scale_inv_freq_matches():
    inv = 1.0 / (500000.0 ** (np.arange(0, 128, 2, dtype=np.float64) / 128))
    np.testing.assert_array_equal(
        jrope.llama3_scale_inv_freq(inv), prope.llama3_scale_inv_freq(inv)
    )


def _positions(rng, B, T, pad):
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1)) - pad[:, None]
    return np.where(pos >= 0, pos, -1).astype(np.int32)


def test_attention_bias_matches():
    rng = np.random.default_rng(2)
    qp = rng.integers(0, 9, (2, 4)).astype(np.int32)
    kp = rng.integers(-1, 9, (2, 6)).astype(np.int32)
    want = jattn.attention_bias(jnp.asarray(qp), jnp.asarray(kp),
                                jnp.asarray(kp >= 0))
    got = pattn.attention_bias(_t(qp), _t(kp), _t(kp >= 0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)])
def test_sdpa_matches(H, KVH):
    rng = np.random.default_rng(3)
    B, T, d = 2, 6, 8
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    pos = _positions(rng, B, T, np.array([0, 2]))
    qpos = np.maximum(pos, 0)
    jb = jattn.attention_bias(jnp.asarray(qpos), jnp.asarray(pos),
                              jnp.asarray(pos >= 0))
    pb = pattn.attention_bias(_t(qpos), _t(pos), _t(pos >= 0))
    want = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
    got = pattn.sdpa(_t(q), _t(k), _t(v), pb)
    _close(got, want)


def test_sdpa_cached_matches():
    rng = np.random.default_rng(4)
    B, T, S, H, KVH, d = 2, 3, 10, 4, 2, 8
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    kc = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    vc = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    kn = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    vn = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    cache_pos = np.full((B, S), -1, np.int32)
    cache_pos[:, 1:6] = np.arange(5)
    qpos = np.tile(np.arange(5, 5 + T, dtype=np.int32), (B, 1))
    jbc = jattn.attention_bias(jnp.asarray(qpos), jnp.asarray(cache_pos),
                               jnp.asarray(cache_pos >= 0))
    jbn = jattn.attention_bias(jnp.asarray(qpos), jnp.asarray(qpos))
    pbc = pattn.attention_bias(_t(qpos), _t(cache_pos), _t(cache_pos >= 0))
    pbn = pattn.attention_bias(_t(qpos), _t(qpos))
    want = jattn.sdpa_cached(*(jnp.asarray(a) for a in (q, kc, vc, kn, vn)),
                             jbc, jbn)
    got = pattn.sdpa_cached(*(_t(a) for a in (q, kc, vc, kn, vn)), pbc, pbn)
    _close(got, want)


def test_repeat_kv_matches():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        pattn.repeat_kv(_t(x), 3).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(x), 3)),
    )


def _logits(seed, shape=(3, 50)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 7] = x[0, 11] = x[0].max() + 1.0  # a tie for the argmax
    return x


def test_greedy_matches_exactly():
    x = _logits(5)
    np.testing.assert_array_equal(
        psamp.greedy(_t(x)).numpy(), np.asarray(jsamp.greedy(jnp.asarray(x)))
    )
    assert psamp.greedy(_t(x)).dtype == torch.int32


@pytest.mark.parametrize("temperature,top_p,top_k", [
    (1.0, None, None), (0.7, 0.9, None), (1.3, None, 5), (0.8, 0.5, 10),
    (1.0, 0.0, None),
])
def test_warped_probs_match(temperature, top_p, top_k):
    x = _logits(6)
    want = jsamp.warped_probs(jnp.asarray(x), temperature, top_p, top_k)
    got = psamp.warped_probs(_t(x), temperature, top_p, top_k)
    _close(got, want, atol=1e-6)


def test_filters_match():
    x = _logits(7)
    np.testing.assert_array_equal(
        psamp.top_p_filter(_t(x), 0.8).numpy(),
        np.asarray(jsamp.top_p_filter(jnp.asarray(x), 0.8)),
    )
    np.testing.assert_array_equal(
        psamp.top_k_filter(_t(x), 4).numpy(),
        np.asarray(jsamp.top_k_filter(jnp.asarray(x), 4)),
    )


def test_sample_greedy_and_support():
    x = _logits(8)
    assert torch.equal(psamp.sample(None, _t(x), 0.0), psamp.greedy(_t(x)))
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = psamp.sample(g1, _t(x), 1.0, top_k=3)
    b = psamp.sample(g2, _t(x), 1.0, top_k=3)
    assert torch.equal(a, b) and a.dtype == torch.int32
    support = psamp.warped_probs(_t(x), 1.0, top_k=3) > 0
    assert bool(support[torch.arange(3), a.long()].all())


def test_stop_token_hits_matches():
    tokens = np.array([3, -1, 7, 2], np.int32)
    table = np.array([[3, -1], [-1, -1], [1, 7], [5, 6]], np.int32)
    np.testing.assert_array_equal(
        psamp.stop_token_hits(_t(tokens), _t(table)).numpy(),
        np.asarray(jsamp.stop_token_hits(jnp.asarray(tokens),
                                         jnp.asarray(table))),
    )
    block = np.array([[3, 4], [-1, 0], [7, 7], [6, 2]], np.int32)
    np.testing.assert_array_equal(
        psamp.stop_token_hits(_t(block), _t(table)).numpy(),
        np.asarray(jsamp.stop_token_hits(jnp.asarray(block),
                                         jnp.asarray(table))),
    )


def test_swiglu_hidden_size_matches():
    for dim, mult, m in [(4096, 1024, 1.3), (4096, 256, None), (32, 32, None)]:
        assert (pcfg.swiglu_hidden_size(dim, mult, m)
                == jlt.swiglu_hidden_size(dim, mult, m))
