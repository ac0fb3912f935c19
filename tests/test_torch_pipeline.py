"""Pipeline stages of the port (``jax_llama_tpu_torch.parallel.pipeline``)
held against the JAX package (``tests/test_pipeline.py``'s cases): the
JAX side runs in this process over the 8 virtual CPU devices, the port
on four gloo ranks spawned once for the module
(``torch_mesh_worker.MeshPool``).  The pipeline is numerically
transparent, so its forward, gradients and train steps are held to the
JAX package's plain stack and to its own pipeline: float32 logits to
atol 1e-5, gradients to atol 1e-5, params after train steps to the bound
of ``test_torch_train.py``'s parity test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax_llama_tpu import get_config as jget_config
from jax_llama_tpu import init_params as jinit_params
from jax_llama_tpu import make_mesh as jmake_mesh
from jax_llama_tpu.models import forward as jforward
from jax_llama_tpu.parallel import shard_params as jshard_params
from jax_llama_tpu.train import init_train_state as jinit_train_state
from jax_llama_tpu.train import lm_loss as jlm_loss
from jax_llama_tpu.train import make_optimizer as jmake_optimizer
from jax_llama_tpu.train import train_step as jtrain_step

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.parallel import mesh as pmesh
from jax_llama_tpu_torch.parallel import partition as ppartition

from torch_mesh_worker import MeshPool

ATOL = 1e-5
PARITY_ATOL, SPREAD_MULTIPLE = 1e-5, 3.0
CFG = dict(vocab_size=128, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=32, dtype="float32",
           param_dtype="float32")
# test_pipeline.py's geometries, on four ranks: stage 2 rides a data
# axis of 2.
GEOMS = {"stage2": dict(stage=2, data=2), "stage4": dict(stage=4),
         "stage2_tensor2": dict(stage=2, tensor=2)}


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(4, timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def model():
    jc = jget_config("tiny", **CFG)
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    tokens = np.random.RandomState(0).randint(
        0, CFG["vocab_size"], (8, 16)).astype(np.int32)
    return jp, jc, jax.tree.map(np.asarray, jp), tokens


def _pos(B, T):
    return np.tile(np.arange(T, dtype=np.int32), (B, 1))


def _jlogits(jp, jc, tokens, pos):
    return np.asarray(jforward(jp, jnp.asarray(tokens), jnp.asarray(pos),
                               jc)[0])


def _same(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


def _shape_mesh(**axes):
    shape = {a: axes.get(a, 1) for a in pmesh.AXES}
    n = int(np.prod(list(shape.values())))
    return pmesh.Mesh(shape, ["cpu"] * n, 0, {}, None)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_pipeline_forward_matches_plain(pool, model, geom):
    jp, jc, tree, tokens = model
    pos = _pos(*tokens.shape)
    want = _jlogits(jp, jc, tokens, pos)
    res = pool.run("forward", cfg=CFG, tree=tree, axes=GEOMS[geom],
                   tokens=tokens, positions=pos)
    got = _same(res, "logits")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, res[0]["unsharded"], atol=ATOL,
                               rtol=ATOL)
    S = GEOMS[geom]["stage"]
    # Every tick but the last turns the ring (the state, its positions
    # and slot positions); the result leaves the last stage in one sum.
    M = S
    assert res[0]["collectives"]["ppermute:p2p/stage"] == 3 * (M + S - 2)
    assert res[0]["collectives"]["all_reduce/stage"] == 1
    assert res[0]["qkv_shape"][0] == CFG["n_layers"] // S


def test_pipeline_microbatch_counts(pool, model):
    jp, jc, tree, tokens = model
    pos = _pos(*tokens.shape)
    want = _jlogits(jp, jc, tokens, pos)
    for m in (1, 2, 4):
        res = pool.run("forward", cfg=CFG, tree=tree, axes=GEOMS["stage2"],
                       tokens=tokens, positions=pos,
                       config=dict(pp_microbatches=m))
        np.testing.assert_allclose(_same(res, "logits"), want, atol=ATOL,
                                   rtol=ATOL)
        assert res[0]["collectives"]["ppermute:p2p/stage"] == 3 * m


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_pipeline_respects_padding(pool, model, impl):
    jp, jc, tree, tokens = model
    pos = _pos(*tokens.shape)
    pos[0, :5] = -1
    want = _jlogits(jp, jc, tokens, pos)
    res = pool.run("forward", cfg=CFG, tree=tree, axes=GEOMS["stage2"],
                   tokens=tokens, positions=pos,
                   config=dict(attn_impl=impl))
    got = _same(res, "logits")
    np.testing.assert_allclose(got, res[0]["unsharded"], atol=ATOL,
                               rtol=ATOL)
    # A padding query's output is the path's own (the flash kernel's
    # differs from the dense path's there); live positions agree.
    live = pos >= 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=ATOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("geom", ["stage2", "stage2_tensor2"])
def test_pipeline_grads_match_plain(pool, model, geom):
    """The hand-written backward schedule gives the plain stack's
    gradients (JAX's ``jax.grad(lm_loss)``), leaf for leaf."""
    jp, jc, tree, tokens = model
    want = _flat(jax.grad(jlm_loss)(jp, jnp.asarray(tokens), jc))
    res = pool.run("train_case", cfg=CFG, tree=tree, axes=GEOMS[geom],
                   tokens=tokens, grads_only=True)
    got = _flat(res[0]["grads"])
    assert set(got) == set(want)
    for name in want:
        for r in res[1:]:
            np.testing.assert_array_equal(_flat(r["grads"])[name], got[name])
        np.testing.assert_allclose(got[name], want[name], atol=ATOL,
                                   rtol=ATOL, err_msg=name)


def _jax_steps(jp, jc, tokens, steps, mesh=None, lr=1e-3):
    opt = jmake_optimizer(learning_rate=lr)
    params = jshard_params(jp, mesh, jc) if mesh is not None else jp
    state = jinit_train_state(jax.tree.map(jnp.copy, params), opt)
    losses = []
    for _ in range(steps):
        state, loss = jtrain_step(state, jnp.asarray(tokens), jc, opt,
                                  mesh=mesh)
        losses.append(float(loss))
    return losses, _flat(jax.tree.map(np.asarray, state.params))


def test_pipeline_train_step(pool, model):
    """Three steps on stage 2 x tensor 2: the JAX package's losses (which
    fall) and params, to the parity bound (the spread is JAX's own
    between its pipeline and its plain stack)."""
    jp, jc, tree, tokens = model
    want_losses, want = _jax_steps(jp, jc, tokens, 3)
    mesh = jmake_mesh(stage=2, tensor=2, devices=jax.devices()[:4])
    _, piped = _jax_steps(jp, jc, tokens, 3, mesh)
    spread = max(float(np.abs(piped[k] - want[k]).max()) for k in want)
    res = pool.run("train_case", cfg=CFG, tree=tree,
                   axes=GEOMS["stage2_tensor2"], tokens=tokens, steps=3)
    losses = _same(res, "losses")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[2] < losses[0]
    got = _flat(res[0]["params"])
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert diff <= max(PARITY_ATOL, SPREAD_MULTIPLE * spread), (diff, spread)


def test_pipeline_rejects_seq_axis(model):
    _, _, tree, tokens = model
    pc = ptl.get_config("tiny", **CFG, attn_impl="ring")
    pp = ptl.from_jax_params(tree, device="cpu")
    pos = torch.from_numpy(_pos(*tokens.shape))
    with pmesh.use_mesh(_shape_mesh(stage=2, seq=2)):
        with pytest.raises(NotImplementedError, match="seq"):
            ptl.forward(pp, torch.from_numpy(tokens), pos, pc)


def test_stage_must_divide_layers():
    pc = ptl.get_config("tiny", **dict(CFG, n_layers=3))
    pp = ptl.init_params(pc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="stage"):
        ppartition.shard_params(pp, _shape_mesh(stage=2), pc)


def test_pipeline_rejects_cache_decode(model):
    _, _, tree, tokens = model
    pc = ptl.get_config("tiny", **CFG)
    shard = ppartition.shard_params(ptl.from_jax_params(tree, device="cpu"),
                                    _shape_mesh(stage=2), pc)
    assert shard["layers"]["qkv"].shape[0] == CFG["n_layers"] // 2
    pos = torch.from_numpy(_pos(8, 16))
    with pmesh.use_mesh(_shape_mesh(stage=2)):
        cache = ptl.init_cache(pc, batch=8, max_len=16, device="cpu")
        with pytest.raises(NotImplementedError, match="stage"):
            ptl.forward(shard, torch.from_numpy(tokens), pos, pc,
                        cache=cache)
        with pytest.raises(NotImplementedError, match="stage"):
            ptl.forward(shard, torch.from_numpy(tokens), pos, pc,
                        output_hidden_states=True)


def test_pipeline_dropout_training(pool, model):
    """Dropout on stage 2: every generator mask is drawn whole and this
    rank's microbatch rows kept, so the pipeline's dropped forward is the
    unsharded run's (the xla path, attention dropout included); rows
    that repeat in different microbatches draw different masks; training
    with dropout learns."""
    _, _, tree, tokens = model
    tokens = np.concatenate([tokens[:4], tokens[:4]])
    rates = dict(resid_pdrop=0.2, attn_pdrop=0.1, embd_pdrop=0.1,
                 pp_microbatches=2)
    a = pool.run("dropout_forward_case", cfg=CFG, tree=tree,
                 axes=GEOMS["stage2"], tokens=tokens, config=rates, seed=1)
    got = _same(a, "logits")
    np.testing.assert_allclose(got, a[0]["unsharded"], atol=ATOL, rtol=ATOL)
    b = _same(pool.run("dropout_forward_case", cfg=CFG, tree=tree,
                       axes=GEOMS["stage2"], tokens=tokens, config=rates,
                       seed=2), "logits")
    assert np.abs(got - b).max() > 0
    assert np.abs(got[:4] - got[4:]).max() > 0
    res = pool.run("train_case", cfg=CFG, tree=tree, axes=GEOMS["stage2"],
                   tokens=tokens, steps=8, lr=1e-2, dropout_seed=7,
                   config=rates)
    losses = _same(res, "losses")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] * 0.9, losses
