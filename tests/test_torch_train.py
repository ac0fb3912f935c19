"""The port's training path held against ``jax_llama_tpu.train`` on the
CPU: the same weights (``from_jax_params``), tokens and masks, float32.
lm_loss value and gradients (fused and dense) to rel 1e-5; three
``train_step``s under attn_impl xla and flash on four batches, per-step
losses to rel 1e-5 and the final params to atol 1e-5, or three times the
spread between JAX's own xla and flash paths where that is larger; remat
"dots", "full" and off give identical gradients; dropout is deterministic
per seed and refused with a cache.  The JAX flash path runs its Pallas
kernels in interpret mode, the port's its plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu import train as jtrain

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import train as ptrain
from jax_llama_tpu_torch.ops.attention import sdpa

CFG = dict(vocab_size=96, max_seq_len=32, n_layers=2)


def _configs(**kw):
    return (jlt.get_config("tiny", **CFG, **kw),
            ptl.get_config("tiny", **CFG, **kw))


def _weights(jc, seed=0):
    jp = jlt.init_params(jax.random.PRNGKey(seed), jc)
    return jp, ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(B=2, T=16, seed=7):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    mask = rng.rand(B, T) > 0.3
    return tokens, mask


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if
                                    isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("tied", [False, True])
def test_lm_loss_value_and_grads_match_jax(fused, tied):
    jc, pc = _configs(tie_word_embeddings=tied)
    jp, pp = _weights(jc, seed=3)
    tokens, mask = _batch()
    jv, jg = jax.value_and_grad(
        lambda p: jtrain.lm_loss(p, jnp.asarray(tokens), jc,
                                 loss_mask=jnp.asarray(mask), fused=fused))(jp)
    leaves = ptrain.tree_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    pv = ptl.lm_loss(pp, torch.from_numpy(tokens), pc,
                     loss_mask=torch.from_numpy(mask), fused=fused)
    pg = torch.autograd.grad(pv, leaves)
    np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-5)
    want = _flat(jg)
    assert sorted(want) == sorted(_flat(pp))
    for name, g in zip(sorted(want), pg):
        scale = max(np.abs(want[name]).max(), 1e-8)
        rel = np.abs(g.numpy() - want[name]).max() / scale
        assert rel < 1e-5, (name, rel)


# Batches of the three-step parity test, and its params tolerance: the
# issue's atol, or a multiple of the spread between the JAX package's own
# xla and flash paths on the same batch, whichever is larger.
PARITY_SEEDS = (0, 1, 2, 3)
PARITY_ATOL = 1e-5
SPREAD_MULTIPLE = 3


def _optimizer(mod):
    return mod.make_optimizer(learning_rate=1e-3, warmup_steps=2,
                              total_steps=10)


@functools.lru_cache(maxsize=None)
def _jax_three_steps(impl, seed):
    """JAX's losses and final params after three train_steps on the batch
    of ``seed``, from the weights of ``_weights``."""
    jc, _ = _configs(attn_impl=impl)
    jp, _ = _weights(jc)
    tokens, mask = _batch(seed=seed)
    jopt = _optimizer(jtrain)
    state, losses = jtrain.init_train_state(jp, jopt), []
    for _ in range(3):
        state, loss = jtrain.train_step(state, jnp.asarray(tokens), jc, jopt,
                                        loss_mask=jnp.asarray(mask))
        losses.append(float(loss))
    return losses, _flat(state.params)


def _max_diff(a, b):
    return max(float(np.abs(a[name] - b[name]).max()) for name in a)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_three_train_steps_match_jax(impl):
    """Three train_steps on each batch of PARITY_SEEDS: losses to rel 1e-5,
    final params to atol max(1e-5, 3 x spread).  Adam divides each
    gradient entry by its own running magnitude, so float32 summation
    noise on the entries nearest zero reaches the params: on some batches
    the JAX package's own xla and flash paths end more than 1e-5 apart.
    The spread is measured here, per batch, between those two paths; where
    it is below 1e-5 / 3 the bound is the plain atol 1e-5.  Readings are
    printed (pytest -s)."""
    other = "flash" if impl == "xla" else "xla"
    jc, pc = _configs(attn_impl=impl)
    for seed in PARITY_SEEDS:
        want_losses, want = _jax_three_steps(impl, seed)
        spread = _max_diff(want, _jax_three_steps(other, seed)[1])
        _, pp = _weights(jc)
        tokens, mask = _batch(seed=seed)
        popt = _optimizer(ptl)
        pstate = ptl.init_train_state(pp, popt)
        for step in range(3):
            pstate, pl = ptl.train_step(pstate, torch.from_numpy(tokens), pc,
                                        popt, loss_mask=torch.from_numpy(mask))
            np.testing.assert_allclose(float(pl), want_losses[step],
                                       rtol=1e-5,
                                       err_msg=f"seed {seed} step {step}")
        assert pstate.step == 3 and pstate.opt_state.count == 3
        diff = _max_diff(_flat(pstate.params), want)
        atol = max(PARITY_ATOL, SPREAD_MULTIPLE * spread)
        print(f"seed {seed} {impl}: port vs JAX {diff:.3g}, JAX xla vs "
              f"flash {spread:.3g}, atol {atol:.3g}")
        assert diff <= atol, (seed, diff, spread)


def test_lr_schedule_matches_optax():
    jopt_sched = __import__("optax").warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-3, warmup_steps=3, decay_steps=10)
    popt = ptl.make_optimizer(learning_rate=1e-3, warmup_steps=3,
                              total_steps=10)
    for count in range(14):
        np.testing.assert_allclose(popt.lr(count), float(jopt_sched(count)),
                                   rtol=1e-6, atol=1e-12)
    assert popt.lr(0) == 0.0
    assert ptl.make_optimizer().lr(5) == 3e-4


@pytest.mark.parametrize("dropout", [False, True])
def test_remat_policies_identical_gradients(dropout):
    """remat_policy changes what is recomputed, never the math; with
    dropout, the recomputed blocks redraw the forward's masks."""
    results = {}
    tokens, _ = _batch(T=24, seed=0)
    rates = dict(resid_pdrop=0.1, attn_pdrop=0.2) if dropout else {}
    for label, kw in (("none", dict(remat=False)),
                      ("full", dict(remat=True, remat_policy="full")),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        jc, pc = _configs(attn_impl="flash", **kw, **rates)
        _, pp = _weights(jc)
        leaves = ptrain.tree_leaves(pp)
        for t in leaves:
            t.requires_grad_(True)
        loss = ptl.lm_loss(pp, torch.from_numpy(tokens), pc,
                           dropout_rng=5 if dropout else None)
        results[label] = (loss.detach(), torch.autograd.grad(loss, leaves))
    base_loss, base_grads = results["none"]
    for label in ("full", "dots"):
        loss, grads = results[label]
        assert torch.equal(loss, base_loss), label
        for a, b in zip(grads, base_grads):
            assert torch.equal(a, b), label


def test_dropout_deterministic_per_seed_and_refusals():
    jc, pc = _configs(attn_impl="flash", resid_pdrop=0.1, embd_pdrop=0.1,
                      attn_pdrop=0.2)
    _, pp = _weights(jc)
    tokens, _ = _batch(seed=5)
    t = torch.from_numpy(tokens)
    base = float(ptl.lm_loss(pp, t, pc))
    a = float(ptl.lm_loss(pp, t, pc, dropout_rng=1))
    a2 = float(ptl.lm_loss(pp, t, pc,
                           dropout_rng=torch.Generator().manual_seed(1)))
    b = float(ptl.lm_loss(pp, t, pc, dropout_rng=2))
    assert a == a2 and len({a, b, base}) == 3
    # The xla path draws its attention masks from the layer generators.
    xa = float(ptl.lm_loss(pp, t, pc.replace(attn_impl="xla"), dropout_rng=1))
    assert np.isfinite(xa) and xa != base
    # All-zero rates with a seed is the deterministic path.
    zero = pc.replace(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    assert float(ptl.lm_loss(pp, t, zero, dropout_rng=1)) == base
    cache = ptl.init_cache(pc, 2, max_len=32, device="cpu")
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    with pytest.raises(ValueError, match="training-only"):
        ptl.forward(pp, t, pos, pc, cache=cache, dropout_rng=0)
    with pytest.raises(NotImplementedError, match="A14"):
        ptl.train_step(ptl.init_train_state(pp, ptl.make_optimizer()), t, pc,
                       ptl.make_optimizer(), mesh=object())


def test_train_step_with_dropout_learns_and_varies_per_step():
    jc, pc = _configs(attn_impl="flash", resid_pdrop=0.1, attn_pdrop=0.1)
    _, pp = _weights(jc)
    opt = ptl.make_optimizer(learning_rate=1e-2)
    state = ptl.init_train_state(pp, opt)
    t = torch.from_numpy(_batch(seed=6)[0])
    losses = []
    for _ in range(8):
        state, loss = ptl.train_step(state, t, pc, opt, dropout_seed=7)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and len(set(losses)) == 8
    assert losses[-1] < losses[0], losses
    g1 = ptrain.step_generator(7, 3, "cpu").initial_seed()
    assert g1 == ptrain.step_generator(7, 3, "cpu").initial_seed()
    assert g1 != ptrain.step_generator(7, 4, "cpu").initial_seed()


def test_sdpa_dropout_requires_generator():
    """The xla path's attention dropout, like the flash path's, refuses a
    rate without its source of randomness."""
    q = torch.ones(1, 4, 2, 8)
    k = v = torch.ones(1, 4, 1, 8)
    with pytest.raises(ValueError, match="generator"):
        sdpa(q, k, v, dropout_rate=0.1)
    out = sdpa(q, k, v, dropout_rate=0.1,
               generator=torch.Generator().manual_seed(0))
    assert out.shape == q.shape and torch.isfinite(out).all()
