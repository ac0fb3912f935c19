"""Ring attention of the port (``jax_llama_tpu_torch.parallel.ring``) held
against the JAX package's (``tests/test_ring.py``'s cases): the JAX side
runs in this process over the 8 virtual CPU devices, the port on four
gloo ranks spawned once for the module (``torch_mesh_worker.MeshPool``;
each rank imports no jax).  The same numpy inputs feed both; float32
outputs are held to atol 1e-5, the dropout keep mask bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax_llama_tpu import get_config as jget_config
from jax_llama_tpu import init_params as jinit_params
from jax_llama_tpu import make_mesh as jmake_mesh
from jax_llama_tpu.engine import GenerationConfig as JGenerationConfig
from jax_llama_tpu.engine import generate as jgenerate
from jax_llama_tpu.models import forward as jforward
from jax_llama_tpu.models import init_cache as jinit_cache
from jax_llama_tpu.ops import attention_bias as jattention_bias
from jax_llama_tpu.ops import sdpa as jsdpa
from jax_llama_tpu.parallel import ring as jring
from jax_llama_tpu.parallel import shard_params as jshard_params
from jax_llama_tpu.parallel import use_mesh as juse_mesh
from jax_llama_tpu.train import init_train_state as jinit_train_state
from jax_llama_tpu.train import make_optimizer as jmake_optimizer
from jax_llama_tpu.train import train_step as jtrain_step

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.ops import attention as pattention
from jax_llama_tpu_torch.parallel import ring as pring

from torch_mesh_worker import MeshPool

ATOL = 1e-5
# The float32 training bound of test_torch_train.py's parity test: params
# to atol max(1e-5, 3 x the JAX package's own spread), here the spread
# between its sharded and unsharded runs of the same steps.
PARITY_ATOL, SPREAD_MULTIPLE = 1e-5, 3.0
CFG = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=16, dtype="float32",
           param_dtype="float32")


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(4, timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def model():
    jc = jget_config("tiny", **CFG)
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    return jp, jc, jax.tree.map(np.asarray, jp)


def _jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(**axes, devices=jax.devices()[:n])


def _qkv(B, T, H, KVH, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, H, D).astype(np.float32),
            rng.randn(B, T, KVH, D).astype(np.float32),
            rng.randn(B, T, KVH, D).astype(np.float32))


def _dense(q, k, v, q_pos, kv_pos):
    bias = jattention_bias(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                           jnp.asarray(kv_pos) >= 0)
    return np.asarray(jsdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            bias))


def _jring(axes, q, k, v, q_pos, kv_pos, **kw):
    with juse_mesh(_jmesh(**axes)):
        return np.asarray(jring.ring_sdpa(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(q_pos), jnp.asarray(kv_pos), **kw))


def _same(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


@pytest.mark.parametrize("axes", [dict(seq=4), dict(data=2, seq=2)],
                         ids=["seq4", "data2_seq2"])
def test_ring_sdpa_matches_jax_and_dense(pool, axes):
    q, k, v = _qkv(2, 32, 4, 2, 8, seed=0)
    pos = np.tile(np.arange(32, dtype=np.int32), (2, 1))
    want = _jring(dict(data=2, seq=4), q, k, v, pos, pos)
    res = pool.run("ring_sdpa_case", q=q, k=k, v=v, q_pos=pos, kv_pos=pos,
                   axes=axes)
    got = _same(res, "out")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, _dense(q, k, v, pos, pos), atol=ATOL,
                               rtol=ATOL)
    n = axes["seq"]
    # n - 1 rotations of k and v (and of their positions).
    assert res[0]["collectives"]["ppermute:p2p/seq"] == 3 * (n - 1)


def test_ring_sdpa_with_padding_positions(pool):
    q, k, v = _qkv(2, 16, 2, 2, 8, seed=1)
    npad = 5
    q_pos = np.tile(np.concatenate([np.zeros(npad), np.arange(16 - npad)])
                    .astype(np.int32), (2, 1))
    kv_pos = q_pos.copy()
    kv_pos[:, :npad] = -1
    want = _jring(dict(seq=8), q, k, v, q_pos, kv_pos)
    got = _same(pool.run("ring_sdpa_case", q=q, k=k, v=v, q_pos=q_pos,
                         kv_pos=kv_pos, axes=dict(seq=4)), "out")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, _dense(q, k, v, q_pos, kv_pos),
                               atol=ATOL, rtol=ATOL)


def test_ring_sdpa_no_mesh_fallback():
    q, k, v = _qkv(1, 8, 2, 2, 4, seed=2)
    pos = np.tile(np.arange(8, dtype=np.int32), (1, 1))
    want = np.asarray(jring.ring_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos)))
    got = pring.ring_sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                          torch.from_numpy(pos), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("axes", [dict(seq=2, tensor=2),
                                  dict(data=2, seq=2)],
                         ids=["seq2_tensor2", "data2_seq2"])
def test_model_forward_ring_matches_jax(pool, model, axes):
    jp, jc, tree = model
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, CFG["vocab_size"], (2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    rc = jc.replace(attn_impl="ring")
    mesh = _jmesh(data=2, seq=2, tensor=2)
    with juse_mesh(mesh):
        want = np.asarray(jax.jit(lambda p, t, q: jforward(p, t, q, rc)[0])(
            jshard_params(jp, mesh, rc), jnp.asarray(tokens),
            jnp.asarray(pos)))
    res = pool.run("forward", cfg=CFG, tree=tree, axes=axes, tokens=tokens,
                   positions=pos, config=dict(attn_impl="ring"))
    got = _same(res, "logits")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, res[0]["unsharded"], atol=ATOL,
                               rtol=ATOL)
    assert res[0]["collectives"]["all_gather/seq"] == 1  # the logits


def _jax_steps(jp, jc, tokens, steps, mesh=None, lr=1e-3):
    opt = jmake_optimizer(learning_rate=lr)
    params = jshard_params(jp, mesh, jc) if mesh is not None else jp
    state = jinit_train_state(jax.tree.map(jnp.copy, params), opt)
    losses = []
    for _ in range(steps):
        state, loss = jtrain_step(state, jnp.asarray(tokens), jc, opt,
                                  mesh=mesh)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _max_diff(a, b):
    if isinstance(a, dict):
        return max(_max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_ring_train_steps_match_jax(pool, model):
    jp, jc, tree = model
    tokens = np.random.RandomState(3).randint(
        0, CFG["vocab_size"], (4, 16)).astype(np.int32)
    rc = jc.replace(attn_impl="ring")
    want_losses, want = _jax_steps(jp, rc, tokens, 3,
                                   _jmesh(data=2, seq=2, tensor=2))
    _, plain = _jax_steps(jp, jc, tokens, 3)
    spread = _max_diff(want, plain)
    res = pool.run("train_case", cfg=CFG, tree=tree,
                   axes=dict(seq=2, tensor=2), tokens=tokens, steps=3,
                   config=dict(attn_impl="ring"))
    losses = _same(res, "losses")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    diff = _max_diff(res[0]["params"], want)
    assert diff <= max(PARITY_ATOL, SPREAD_MULTIPLE * spread), (diff, spread)


def _jax_cached(jc, jp, prompt, steps, mesh=None):
    B, P = prompt.shape
    ppos = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32), (B, P))
    params = jshard_params(jp, mesh, jc) if mesh is not None else jp
    out = []
    with juse_mesh(mesh):
        cache = jinit_cache(jc, B, max_len=jc.max_seq_len)
        step = jax.jit(lambda p, t, q, c: jforward(p, t, q, jc, cache=c))
        lg, cache = step(params, jnp.asarray(prompt), ppos, cache)
        out.append(np.asarray(lg[:, -1]))
        for j in range(steps.shape[1]):
            lg, cache = step(params, jnp.asarray(steps[:, j:j + 1]),
                             jnp.full((B, 1), P + j, jnp.int32), cache)
            out.append(np.asarray(lg[:, 0]))
    return np.stack(out)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_ring_cached_decode_matches_jax(pool, kv):
    jc = jget_config("tiny", **CFG, kv_cache_dtype=kv)
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    rng = np.random.RandomState(5 if kv == "auto" else 11)
    prompt = rng.randint(0, CFG["vocab_size"], (2, 8)).astype(np.int32)
    steps = rng.randint(0, CFG["vocab_size"], (2, 4)).astype(np.int32)
    rc = jc.replace(attn_impl="ring")
    want = _jax_cached(rc, jp, prompt, steps, _jmesh(data=2, seq=4))
    res = pool.run("cached_ring_case",
                   cfg=dict(CFG, kv_cache_dtype=kv),
                   tree=jax.tree.map(np.asarray, jp), axes=dict(seq=4),
                   prompt=prompt, steps=steps)
    got = _same(res, "logits")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    plain = _jax_cached(jc, jp, prompt, steps)
    np.testing.assert_allclose(got, plain, atol=2e-4, rtol=1e-4)
    # Each rank holds 16 / 4 slots; 3 collectives (one max, two sums)
    # over seq per layer and step.
    assert res[0]["slots"] == 4 and res[0]["index"] == 12
    assert res[0]["collectives"]["all_reduce_max/seq"] == 5 * CFG["n_layers"]
    assert res[0]["collectives"]["all_reduce/seq"] == 10 * CFG["n_layers"]


def test_ring_cached_generate_matches_jax(pool, model):
    jp, jc, tree = model
    rng = np.random.RandomState(7)
    prompt = rng.randint(1, CFG["vocab_size"], (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), bool)
    gc = JGenerationConfig(max_new_tokens=8, temperature=0.0, stop_tokens=())
    rc = jc.replace(attn_impl="ring")
    mesh = _jmesh(data=2, seq=4)
    want = np.asarray(jgenerate(jshard_params(jp, mesh, rc),
                                jnp.asarray(prompt), jnp.asarray(mask),
                                jax.random.PRNGKey(0), config=rc,
                                gen_config=gc, mesh=mesh))
    res = pool.run("generate", cfg=dict(CFG, attn_impl="ring"), tree=tree,
                   axes=dict(seq=4), prompt=prompt, mask=mask, max_new=8)
    got = _same(res, "tokens")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, res[0]["unsharded"])
    np.testing.assert_allclose(res[0]["score"], res[0]["score_unsharded"],
                               atol=ATOL)


class _LargestOutput(torch.utils._python_dispatch.TorchDispatchMode):
    """The element count of the largest tensor any op produces."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_ring_forward_no_quadratic_memory_32k():
    """A 32k ring's per-rank body (4096 of 8 shards, one fold of the own
    shard) never makes a [T_local, S_local] tensor: every op's output
    stays within O(T_local x RING_CHUNK) (JAX's jaxpr walk, as a
    dispatch-mode walk of the ops run)."""
    B, S_local, H, D = 1, 4096, 1, 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S_local, H, D, generator=g) for _ in range(3))
    pos = torch.arange(S_local, dtype=torch.int32)[None]
    mode = _LargestOutput()
    with mode:
        out = pring.ring_attention(q, k, v, pos, pos, axis_size=1)
    assert torch.isfinite(out).all()
    limit = B * H * S_local * max(pring.RING_CHUNK, D) * 2
    assert 0 < mode.largest <= limit, (mode.largest, limit)


def test_ring_chunked_accumulate_matches_unchunked():
    rng = np.random.RandomState(9)
    B, H, KVH, T, S, d = 2, 4, 2, 8, 192, 16
    qt = rng.randn(B, H, T, d).astype(np.float32)
    k = rng.randn(B, S, KVH, d).astype(np.float32)
    v = rng.randn(B, S, KVH, d).astype(np.float32)
    q_pos = rng.randint(0, S, (B, T)).astype(np.int32)
    kv_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    m0 = np.full((B, H, T), jring.MASK_VALUE, np.float32)
    l0 = np.zeros((B, H, T), np.float32)
    a0 = np.zeros((B, H, T, d), np.float32)
    want = jring._fold_chunk(*(jnp.asarray(a) for a in (
        qt, q_pos, k, v, kv_pos, m0, l0, a0)), scale=0.25)
    t = [torch.from_numpy(a) for a in (qt, q_pos, k, v, kv_pos, m0, l0, a0)]
    dense = pring._fold_chunk(*t, scale=0.25)
    for chunk in (64, 80, 192, 512):
        got = pring._accumulate(*t, scale=0.25, chunk=chunk)
        for g, w, u in zip(got, want, dense):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=ATOL)
            np.testing.assert_allclose(g.numpy(), u.numpy(), atol=ATOL,
                                       rtol=ATOL)


def _dense_dropped(q, k, v, pos, keep, rate):
    H, KVH, D = q.shape[2], k.shape[2], q.shape[3]
    kr = np.repeat(k, H // KVH, axis=2)
    vr = np.repeat(v, H // KVH, axis=2)
    s = np.einsum("bthd,bshd->bhts", q, kr) / np.sqrt(D)
    s = np.where(pos[:, None, None, :] <= pos[:, None, :, None], s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    return np.einsum("bhts,bshd->bthd",
                     np.where(keep, w / (1.0 - rate), 0.0), vr)


def test_ring_dropout_keep_bit_exact_and_matches_dense(pool):
    """The ring's hash mask equals JAX's bit for bit for the same seed
    words (offsets included); on a data=2 x seq=2 mesh ring_sdpa's
    dropped attention is the dense attention under that mask, and the
    fold is invariant to the chunk size."""
    B, T, H, KVH, D = 2, 32, 4, 2, 8
    rate = 0.3
    words = (0x2545F491, 0x9E3779B9)
    rng = np.random.RandomState(3)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[1, :3] = -1
    for b_off, h_off in ((0, 0), (3, 8)):
        jb = np.asarray(jring.dropout_base(np.asarray(words, np.uint32), B, H,
                                           b_off, h_off))
        pb = pring.dropout_base(words, B, H, b_off, h_off)
        np.testing.assert_array_equal(pb.numpy(), jb.astype(np.int64))
        jk = np.asarray(jring.dropout_keep(jnp.asarray(jb), jnp.asarray(pos),
                                           jnp.asarray(pos), rate))
        pk = pring.dropout_keep(pb, torch.from_numpy(pos),
                                torch.from_numpy(pos), rate)
        np.testing.assert_array_equal(pk.numpy(), jk)
    q, k, v = _qkv(B, T, H, KVH, D, seed=4)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    keep = pring.dropout_keep(pring.dropout_base(words, B, H),
                              torch.from_numpy(pos), torch.from_numpy(pos),
                              rate).numpy()
    want = _dense_dropped(q, k, v, pos, keep, rate)
    got = _same(pool.run("ring_sdpa_case", q=q, k=k, v=v, q_pos=pos,
                         kv_pos=pos, axes=dict(data=2, seq=2), rate=rate,
                         seed=words), "out")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    base = pring.dropout_base(words, B, H)
    t = dict(qt=torch.from_numpy(q).transpose(1, 2), q_pos=torch.from_numpy(
        pos), k=torch.from_numpy(k), v=torch.from_numpy(v),
        kv_pos=torch.from_numpy(pos))
    outs = []
    for chunk in (8, 16, 32):
        m, l, acc = pring._accumulate(
            t["qt"], t["q_pos"], t["k"], t["v"], t["kv_pos"],
            torch.full((B, H, T), pring.MASK_VALUE),
            torch.zeros(B, H, T), torch.zeros(B, H, T, D),
            scale=1.0 / np.sqrt(D), chunk=chunk, dropout_rate=rate,
            drop_base=base)
        outs.append((acc / l[..., None]).transpose(1, 2).numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-6)
    np.testing.assert_allclose(outs[0], want, atol=ATOL, rtol=ATOL)


def test_ring_dropout_gradients_and_model_forward(pool):
    """Gradients through the masked, checkpointed fold equal the dense
    attention's under the same mask; on the mesh the ring's dq, dk, dv
    (the gradient goes back round the ring) equal them too; the model's
    forward with attention dropout on a seq = 4 mesh is deterministic per
    seed, differs across seeds and from no dropout, and is finite."""
    B, T, H, KVH, D = 1, 16, 2, 2, 8
    rate, words = 0.25, (99, 7)
    q, k, v = _qkv(B, T, H, KVH, D, seed=5)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    g = np.random.RandomState(6).randn(B, T, H, D).astype(np.float32)
    keep = torch.from_numpy(pring.dropout_keep(
        pring.dropout_base(words, B, H), torch.from_numpy(pos),
        torch.from_numpy(pos), rate).numpy())

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*ts) * torch.from_numpy(g)).sum().backward()
        return [t.grad.numpy() for t in ts]

    tpos = torch.from_numpy(pos)

    def dense(qq, kk, vv):
        w = pattention.sdpa(qq, kk, vv, pattention.attention_bias(
            tpos, tpos, tpos >= 0), return_weights=True)[1]
        w = torch.where(keep, w / (1.0 - rate), 0.0)
        return torch.einsum("bhts,bshd->bthd", w, vv)

    want = grads(dense)
    got = grads(lambda qq, kk, vv: pring.ring_attention(
        qq, kk, vv, tpos, tpos, axis_size=1, dropout_rate=rate,
        dropout_seed=words))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=ATOL)
    res = pool.run("ring_sdpa_case", q=q, k=k, v=v, q_pos=pos, kv_pos=pos,
                   axes=dict(seq=4), g=g, rate=rate, seed=words)
    for name, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(_same(res, name), w, atol=ATOL, rtol=ATOL)
    # The model: attention dropout on a seq = 4 mesh.
    jc = jget_config("tiny", **CFG)
    tree = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), jc))
    toks = np.arange(1, 17, dtype=np.int32)[None]
    p16 = np.arange(16, dtype=np.int32)[None]
    cfg = dict(attn_impl="ring", attn_pdrop=0.4)
    outs = {s: _same(pool.run("dropout_forward_case", cfg=CFG, tree=tree,
                              axes=dict(seq=4), tokens=toks, config=cfg,
                              seed=s), "logits") for s in (1, 2)}
    det = _same(pool.run("forward", cfg=CFG, tree=tree, axes=dict(seq=4),
                         tokens=toks, positions=p16,
                         config=dict(attn_impl="ring")), "logits")
    assert np.isfinite(outs[1]).all()
    again = _same(pool.run("dropout_forward_case", cfg=CFG, tree=tree,
                           axes=dict(seq=4), tokens=toks, config=cfg,
                           seed=1), "logits")
    np.testing.assert_array_equal(outs[1], again)
    assert np.abs(outs[1] - outs[2]).max() > 0
    assert np.abs(outs[1] - det).max() > 0


def test_collective_routes_agree(pool):
    """The gloo-on-CUDA routes (all_gather_take for ppermute,
    all_reduce_slice for reduce_scatter) give what the p2p and
    reduce-scatter routes give, and the ring's output does not depend on
    the route."""
    for r in pool.run("collective_routes_case", axes=dict(seq=4)):
        for key in ("fwd", "back", "rs"):
            np.testing.assert_array_equal(r["p2p"][key],
                                          r["all_gather_take"][key])
        i = r["seq_index"]
        base = np.arange(8, dtype=np.float32)
        np.testing.assert_array_equal(r["p2p"]["fwd"],
                                      base + 100 * ((i - 1) % 4))
        np.testing.assert_array_equal(r["p2p"]["rs"],
                                      (4 * base + 600)[2 * i:2 * i + 2])
    q, k, v = _qkv(2, 16, 2, 2, 8, seed=8)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    routes = {"ppermute": "all_gather_take",
              "reduce_scatter": "all_reduce_slice"}
    res = pool.run("ring_sdpa_case", q=q, k=k, v=v, q_pos=pos, kv_pos=pos,
                   axes=dict(seq=4), routes=routes)
    np.testing.assert_array_equal(
        _same(res, "out"),
        _same(pool.run("ring_sdpa_case", q=q, k=k, v=v, q_pos=pos,
                       kv_pos=pos, axes=dict(seq=4)), "out"))
    assert res[0]["collectives"]["ppermute:all_gather_take/seq"] == 9
