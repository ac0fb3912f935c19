"""The port's int8 path held against the JAX package on the same numpy
inputs (CPU, float32, tiny configs).

* ``quantize_params`` and ``quantize_kv``: the same int8 payloads and the
  same float32 scales, exactly (both compute amax * (1/127), the division
  XLA compiles).
* ``from_jax_params`` of a quantized JAX tree: the same payloads and
  scales, and the JAX package's leaf count.
* The quantized forward: logits within atol 2e-4 of JAX's (PARITY.md row
  2.16, as in tests/test_torch_model.py).
* ``flash_attention_quantized``'s plain version against JAX's Pallas
  kernel in interpret mode, and ``sdpa_cached`` with scales against
  JAX's: atol 1e-5 (summation order).  The int8 forward's instance rule
  (``flash_int8_instance``), and its CPU calls counting no instance.
* int8 ``engine.generate`` (int8 weights and an int8 KV cache) on the xla
  and the flash path: greedy tokens identical to JAX's.

The int8 kernels are held against their plain versions on a card in
tests/test_torch_quant_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu.engine import GenerationConfig as JGenConfig
from jax_llama_tpu.engine import generate as jax_generate
from jax_llama_tpu.models.llama import quantize_kv as jax_quantize_kv
from jax_llama_tpu.ops import attention as jattn
from jax_llama_tpu.ops import quant as jquant
from jax_llama_tpu.ops.flash_attention import (
    flash_attention_quantized as jax_flash_quantized,
)

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import engine as pengine
from jax_llama_tpu_torch.ops import attention as pattn

fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")

ATOL = 1e-5
CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    """JAX params, their JAX quantization, and the port's of each."""
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    jq = jquant.quantize_params(jp)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return dict(jp=jp, jq=jq, pp=pp, pq=ptl.quantize_params(pp),
                pq_from_jax=ptl.from_jax_params(
                    jax.tree.map(np.asarray, jq), device="cpu"))


def _same_quantized(got, want):
    assert isinstance(got, ptl.QuantizedTensor)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("source", ["quantize_params", "from_jax_params"])
def test_quantized_weights_match_jax(weights, source):
    pq = weights["pq" if source == "quantize_params" else "pq_from_jax"]
    jq = weights["jq"]
    for name in ("qkv", "o", "gate_up", "down"):
        _same_quantized(pq["layers"][name], jq["layers"][name])
    _same_quantized(pq["lm_head"], jq["lm_head"])
    # embedding and norms stay as they are
    for name in ("attn_norm", "mlp_norm"):
        torch.testing.assert_close(pq["layers"][name],
                                   weights["pp"]["layers"][name])
    assert ptl.is_quantized(pq) and not ptl.is_quantized(weights["pp"])
    assert ptl.param_count(pq) == sum(
        x.size for x in jax.tree_util.tree_leaves(jq))


def test_quantize_leaves_a_tied_head_and_works_in_slices(weights):
    pp = dict(weights["pp"])
    del pp["lm_head"]
    pq = ptl.quantize_params(pp)
    assert "lm_head" not in pq and pq["embed"] is pp["embed"]
    # a column-chunked quantization equals the one-shot one
    w = weights["pp"]["lm_head"]
    q = importlib.import_module("jax_llama_tpu_torch.ops.quant")
    whole = q.quantize(w, (0,))
    old = q._CHUNK_BYTES
    try:
        q._CHUNK_BYTES = 4 * w.shape[0] * 5  # five columns a step
        chunked = q.quantize(w, (0,))
    finally:
        q._CHUNK_BYTES = old
    torch.testing.assert_close(chunked.q, whole.q, atol=0, rtol=0)
    torch.testing.assert_close(chunked.scale, whole.scale, atol=0, rtol=0)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 5, 2, 16)).astype(
        np.float32)
    x[0, 0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    want_q, want_s = jax.jit(jax_quantize_kv)(jnp.asarray(x))
    got_q, got_s = ptl.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantized_forward_matches_jax(weights):
    jc, pc = jlt.get_config("tiny", **CFG), ptl.get_config("tiny", **CFG)
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, CFG["vocab_size"], (2, 12)).astype(np.int32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    pos[1, :3] = -1  # left padding
    want = np.asarray(jlt.forward(weights["jq"], jnp.asarray(tokens),
                                  jnp.asarray(pos), jc)[0])
    for params in (weights["pq"], weights["pq_from_jax"]):
        got = ptl.forward(params, torch.from_numpy(tokens),
                          torch.from_numpy(pos), pc)[0]
        live = pos >= 0
        np.testing.assert_allclose(got.numpy()[live], want[live], atol=2e-4,
                                   rtol=0)


def _int8_kv(rng, B, S, KVH, d):
    k = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    (kq, ks), (vq, vs) = (jax.jit(jax_quantize_kv)(jnp.asarray(a))
                          for a in (k, v))
    return [np.array(a) for a in (kq, vq, ks, vs)]


# (B, T, S, H, KVH, d, q_base): a causal prefill over a fresh cache with
# left padding, and a chunk at a non-zero base over a cache with a -1 tail.
FLASH = {
    "prefill_gqa": (2, 16, 16, 4, 2, 16, 0),
    "chunk_window": (2, 8, 24, 4, 1, 32, 8),
}


@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_attention_quantized_plain_matches_jax(name):
    B, T, S, H, KVH, d, base = FLASH[name]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    kq, vq, ks, vs = _int8_kv(rng, B, S, KVH, d)
    slots = np.arange(S)[None].repeat(B, 0)
    kv_pos = np.where(slots < base + T, slots, -1).astype(np.int32)
    q_pos = np.tile(base + np.arange(T, dtype=np.int32), (B, 1))
    if base == 0:  # row 1 left-padded by 5
        kv_pos[1] = np.where(slots[1] >= 5, slots[1] - 5, -1)
        q_pos[1] = np.maximum(np.arange(T) - 5, 0)
    ks[:, base + T:] = 0.0  # unwritten slots: payload and scale 0
    kq[:, base + T:] = 0
    want = jax_flash_quantized(*(jnp.asarray(a) for a in (
        q, kq, vq, ks, vs, q_pos, kv_pos)), block_q=8, block_k=8)
    args = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, q_pos, kv_pos)]
    before = fa.flash_attention_quantized.launches
    got = fa.flash_attention_quantized(*args)
    assert fa.flash_attention_quantized.launches == before  # plain on CPU
    torch.testing.assert_close(
        got, fa.flash_attention_quantized_reference(*args), atol=0, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    with pytest.raises(ValueError, match="inference-only"):
        fa.flash_attention_quantized(args[0].requires_grad_(), *args[1:])


@pytest.mark.parametrize("dtype,d,T,S,want", [
    (torch.bfloat16, 128, 1024, 1024, "wgmma"),   # the int8 serving insert
    (torch.bfloat16, 128, 128, 2048, "wgmma"),    # a chunk into a cache
    (torch.bfloat16, 128, 512, 512, "wgmma"),     # generate's prefill
    (torch.bfloat16, 128, 1, 1024, "mma_sync"),   # T = 1 decode
    (torch.bfloat16, 128, 200, 200, "mma_sync"),  # ragged T
    (torch.bfloat16, 64, 512, 512, "mma_sync"),   # head_dim 64
    (torch.bfloat16, 128, 128, 0, "mma_sync"),
    (torch.float32, 128, 1024, 1024, "float32"),
    (torch.float32, 64, 1, 16, "float32"),
])
def test_flash_int8_instance_dispatch(dtype, d, T, S, want):
    """The int8 forward's instance: its Hopper one (int8 tiles widened in
    shared memory for wgmma) for bf16 q at head_dim 128 with T a positive
    multiple of 128 and S > 0, mma.sync for every other bf16 call, float32
    q on its own."""
    assert fa.flash_int8_instance(dtype, d, T, S) == want


def test_cpu_quantized_calls_count_no_instance():
    """The int8 forward's plain version runs on CPU tensors and counts
    nothing, even at a shape its Hopper instance would take."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 128, 2, 128)).astype(
        np.float32)).to(torch.bfloat16)
    kq = torch.from_numpy(rng.integers(-127, 128, (1, 128, 1, 128)).astype(
        np.int8))
    sc = torch.full((1, 128, 1), 0.01)
    pos = torch.arange(128, dtype=torch.int32)[None]
    assert fa.flash_int8_instance(q.dtype, 128, 128, 128) == "wgmma"
    w = fa.flash_attention_quantized
    before = (w.launches, w.kernel_launches, dict(w.launches_by_instance))
    out = w(q, kq, kq, sc, sc, pos, pos)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert (w.launches, w.kernel_launches, w.launches_by_instance) == before


def test_sdpa_cached_with_scales_matches_jax():
    B, T, S, H, KVH, d = 2, 3, 10, 4, 2, 16
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    kq, vq, ks, vs = _int8_kv(rng, B, S, KVH, d)
    kn = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    vn = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    qp = np.tile(np.arange(7, 7 + T, dtype=np.int32), (B, 1))
    cache_pos = np.where(np.arange(S) < 7, np.arange(S), -1)[None].repeat(
        B, 0).astype(np.int32)
    bias = jattn.attention_bias(jnp.asarray(qp), jnp.asarray(cache_pos),
                                jnp.asarray(cache_pos >= 0))
    bias_new = jattn.attention_bias(jnp.asarray(qp), jnp.asarray(qp))
    want = jattn.sdpa_cached(
        *(jnp.asarray(a) for a in (q, kq, vq, kn, vn)), bias, bias_new,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = pattn.sdpa_cached(
        *(torch.from_numpy(a) for a in (q, kq, vq, kn, vn)),
        torch.from_numpy(np.array(bias)),
        torch.from_numpy(np.array(bias_new)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_int8_generate_matches_jax(weights, impl):
    """int8 weights and an int8 KV cache through engine.generate: prefill
    (flash: ``flash_attention_quantized``) and cached decode (the int8
    ``sdpa_cached``; under "flash" the kernel's plain version every step),
    greedy tokens identical to JAX's."""
    kw = dict(CFG, kv_cache_dtype="int8", attn_impl=impl)
    jc, pc = jlt.get_config("tiny", **kw), ptl.get_config("tiny", **kw)
    rng = np.random.default_rng(5)
    P = 12
    tokens = np.zeros((3, P), np.int32)
    mask = np.zeros((3, P), bool)
    for b, n in enumerate((12, 9, 4)):
        tokens[b, P - n:] = rng.integers(1, CFG["vocab_size"], n)
        mask[b, P - n:] = True
    gen = dict(max_new_tokens=10, temperature=0.0)
    want = np.asarray(jax_generate(
        weights["jq"], jnp.asarray(tokens), jnp.asarray(mask),
        jax.random.PRNGKey(0), config=jc, gen_config=JGenConfig(**gen)))
    got = pengine.generate(
        weights["pq"], torch.from_numpy(tokens), torch.from_numpy(mask),
        None, config=pc, gen_config=pengine.GenerationConfig(**gen),
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    cache = ptl.init_cache(pc, 2, max_len=16, device="cpu")
    assert cache.quantized and cache.k.dtype == torch.int8
    assert cache.k_scale.shape == (CFG["n_layers"], 2, 16, CFG["n_kv_heads"])
