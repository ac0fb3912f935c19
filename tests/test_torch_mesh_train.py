"""Sharded training of the port (``train_step(mesh=)``, ``shard_batch``,
ZeRO-3 ``fsdp`` layouts, checkpoints from a mesh) held against the JAX
package (``tests/test_train.py``'s sharded step, ``tests/test_data.py``'s
``shard_batch``, ``tests/test_partition.py``'s fsdp cases): the JAX side
runs in this process over the 8 virtual CPU devices, the port on four
gloo ranks spawned once for the module (``torch_mesh_worker.MeshPool``).
Float32 logits are held to atol 1e-5; losses to rtol 1e-5 and params
after three steps to the bound of ``test_torch_train.py``'s parity test
(atol max(1e-5, 3 x the JAX package's own spread between its sharded and
unsharded runs)).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jax_llama_tpu import get_config as jget_config
from jax_llama_tpu import init_params as jinit_params
from jax_llama_tpu import make_mesh as jmake_mesh
from jax_llama_tpu.data import Batch as JBatch
from jax_llama_tpu.data import shard_batch as jshard_batch
from jax_llama_tpu.models import forward as jforward
from jax_llama_tpu.parallel import partition as jpartition
from jax_llama_tpu.parallel import use_mesh as juse_mesh
from jax_llama_tpu.train import init_train_state as jinit_train_state
from jax_llama_tpu.train import make_optimizer as jmake_optimizer
from jax_llama_tpu.train import train_step as jtrain_step

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import data as pdata
from jax_llama_tpu_torch.parallel import mesh as pmesh
from jax_llama_tpu_torch.parallel import partition as ppartition

from torch_mesh_worker import MeshPool

ATOL = 1e-5
PARITY_ATOL, SPREAD_MULTIPLE = 1e-5, 3.0
CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=32, dtype="float32",
           param_dtype="float32")
# Four-rank counterparts of test_train.py's data2 x fsdp2 x tensor2 and
# test_partition.py's fsdp geometries; "fsdp" says whether the tree is
# sharded in the ZeRO-3 layout.
GEOMS = {
    "fsdp2_tensor2": (dict(fsdp=2, tensor=2), True),
    "data2_fsdp2": (dict(data=2, fsdp=2), True),
    "fsdp4": (dict(fsdp=4), True),
    "data2_tensor2": (dict(data=2, tensor=2), False),
}


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(4, timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def model():
    jc = jget_config("tiny", **CFG)
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    tokens = np.random.RandomState(2).randint(
        0, CFG["vocab_size"], (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), bool)
    mask[1, :6] = False
    return jp, jc, jax.tree.map(np.asarray, jp), tokens, mask


def _jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(**axes, devices=jax.devices()[:n])


def _shape_mesh(**axes):
    shape = {a: axes.get(a, 1) for a in pmesh.AXES}
    n = int(np.prod(list(shape.values())))
    return pmesh.Mesh(shape, ["cpu"] * n, 0, {}, None)


def _same(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _jax_steps(jp, jc, tokens, mask, steps, mesh=None, fsdp=False):
    opt = jmake_optimizer(learning_rate=1e-3)
    params = (jpartition.shard_params(jp, mesh, jc, fsdp=fsdp)
              if mesh is not None else jp)
    state = jinit_train_state(jax.tree.map(jnp.copy, params), opt)
    losses = []
    for _ in range(steps):
        state, loss = jtrain_step(state, jnp.asarray(tokens), jc, opt,
                                  loss_mask=jnp.asarray(mask), mesh=mesh)
        losses.append(float(loss))
    return losses, _flat(jax.tree.map(np.asarray, state.params))


@pytest.fixture(scope="module")
def jax_runs(model):
    """The JAX package's three steps unsharded and on data2 x fsdp2 x
    tensor2 (ZeRO-3), and the spread between them."""
    jp, jc, _, tokens, mask = model
    want_losses, want = _jax_steps(jp, jc, tokens, mask, 3)
    _, sharded = _jax_steps(jp, jc, tokens, mask, 3,
                            _jmesh(data=2, fsdp=2, tensor=2), fsdp=True)
    spread = max(float(np.abs(sharded[k] - want[k]).max()) for k in want)
    return want_losses, want, spread


@pytest.mark.parametrize("geom", list(GEOMS))
def test_sharded_train_steps_match_jax(pool, model, jax_runs, geom):
    """Three train_steps from the same weights and batch: the global loss
    (the mean over the global count of masked tokens) and every updated
    leaf, gathered, equal the JAX package's; gradients are reduced over
    the row axes, reduce-scattered for fsdp leaves, and clipped by one
    global norm."""
    _, _, tree, tokens, mask = model
    want_losses, want, spread = jax_runs
    axes, fsdp = GEOMS[geom]
    res = pool.run("train_case", cfg=CFG, tree=tree, axes=axes,
                   tokens=tokens, loss_mask=mask, steps=3, fsdp=fsdp)
    np.testing.assert_allclose(_same(res, "losses"), want_losses,
                               rtol=1e-5)
    got = _flat(res[0]["params"])
    for r in res[1:]:
        for k, v in _flat(r["params"]).items():
            np.testing.assert_array_equal(v, got[k])
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert diff <= max(PARITY_ATOL, SPREAD_MULTIPLE * spread), (diff, spread)
    coll = res[0]["collectives"]
    if fsdp:
        # Each layer's weights are gathered before use and their
        # gradients reduce-scattered.
        assert coll["reduce_scatter:reduce_scatter/fsdp"] > 0
        assert res[0]["local_qkv"][-2] == CFG["dim"] // axes["fsdp"]
    else:
        assert not any("fsdp" in k for k in coll)


def test_train_step_refuses_an_ambient_mesh(model):
    _, _, tree, tokens, _ = model
    pc = ptl.get_config("tiny", **CFG)
    opt = ptl.make_optimizer(1e-3)
    state = ptl.init_train_state(ptl.from_jax_params(tree, device="cpu"),
                                 opt)
    with pmesh.use_mesh(_shape_mesh(tensor=1)):
        with pytest.raises(ValueError, match="pass mesh= explicitly"):
            ptl.train_step(state, torch.from_numpy(tokens), pc, opt)


@pytest.mark.parametrize("geom", ["fsdp2_tensor2", "fsdp4"])
def test_fsdp_sharded_forward_matches_jax(pool, model, geom):
    jp, jc, tree, tokens, _ = model
    axes, _ = GEOMS[geom]
    pos = np.tile(np.arange(16, dtype=np.int32), (4, 1))
    jaxes = dict(tensor=2, fsdp=2, data=2) if "tensor" in axes else dict(
        fsdp=4, data=2)
    mesh = _jmesh(**jaxes)
    with juse_mesh(mesh):
        want = np.asarray(jax.jit(lambda p, t, q: jforward(p, t, q, jc)[0])(
            jpartition.shard_params(jp, mesh, jc, fsdp=True),
            jnp.asarray(tokens), jnp.asarray(pos)))
    res = pool.run("forward", cfg=CFG, tree=tree, axes=axes, tokens=tokens,
                   positions=pos, fsdp=True)
    got = _same(res, "logits")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    assert res[0]["qkv_shape"][-2] == CFG["dim"] // axes["fsdp"]
    assert res[0]["collectives"]["all_gather/fsdp"] > 0


def test_specs_cover_fsdp_variant(model):
    """The spec trees, fsdp and pipeline variants included, are the JAX
    package's (as tuples), and an fsdp shard holds each projection's
    non-tensor dimension split over fsdp."""
    jp, jc, tree, _, _ = model
    pc = ptl.get_config("tiny", **CFG)

    def as_tuples(t):
        if isinstance(t, dict):
            return {k: as_tuples(v) for k, v in t.items()}
        return tuple(t)

    for fsdp in (False, True):
        for pp in (False, True):
            assert ppartition.param_partition_specs(
                pc, fsdp=fsdp, pp=pp) == as_tuples(
                    jpartition.param_partition_specs(jc, fsdp=fsdp, pp=pp))
    full = ptl.from_jax_params(tree, device="cpu")
    mesh = _shape_mesh(fsdp=2, tensor=2)
    shard = ppartition.shard_params(full, mesh, pc, fsdp=True)
    want = ppartition.shard_abstract(full, mesh, pc, fsdp=True)
    assert tuple(shard["layers"]["qkv"].shape) == want["layers"]["qkv"]
    assert shard["layers"]["qkv"].shape[-2] == CFG["dim"] // 2
    assert shard["embed"]["embedding"].shape[0] == CFG["vocab_size"] // 4
    with pytest.raises(ValueError, match="fsdp=3 must divide dim"):
        ppartition.validate_tp(pc, _shape_mesh(fsdp=3), fsdp=True)


def test_shard_batch_gives_each_rank_its_rows():
    """``shard_batch`` splits the rows over data x fsdp in the axes' rank
    order, as the JAX package's NamedSharding places them."""
    tokens = np.arange(32, dtype=np.int32).reshape(8, 4)
    batch = pdata.Batch(tokens=tokens, loss_mask=tokens % 3 > 0)
    jmesh = _jmesh(data=2, fsdp=2, tensor=2)
    jb = jshard_batch(JBatch(tokens=tokens, loss_mask=tokens % 3 > 0), jmesh)
    shards = {d: np.asarray(s.data) for d, s in zip(
        [s.device for s in jb.tokens.addressable_shards],
        jb.tokens.addressable_shards)}
    for data in range(2):
        for fsdp in range(2):
            m = _shape_mesh(data=2, fsdp=2, tensor=2)
            m.coords.update(data=data, fsdp=fsdp)
            got = pdata.shard_batch(batch, m)
            assert got.tokens.dtype == torch.int32
            assert got.loss_mask.dtype == torch.bool
            i = data * 2 + fsdp
            np.testing.assert_array_equal(got.tokens.numpy(),
                                          tokens[2 * i:2 * i + 2])
            # JAX device (data, fsdp, tensor 0) holds the same rows.
            dev = jmesh.devices[data, 0, fsdp, 0, 0]
            np.testing.assert_array_equal(shards[dev], got.tokens.numpy())
    with pytest.raises(ValueError, match="must divide the batch"):
        pdata.shard_batch(pdata.Batch(tokens=tokens[:3],
                                      loss_mask=tokens[:3] > 0),
                          _shape_mesh(data=2))
    assert pdata.to_device(batch, "cpu", mesh=_shape_mesh()).tokens.shape == (
        8, 4)


@pytest.mark.parametrize("geom", ["fsdp2_tensor2", "data2_tensor2"])
def test_mesh_dropout_masks_are_the_unsharded_runs(pool, model, geom):
    """Embedding, residual and attention dropout on a row- and
    tensor-split mesh are the unsharded run's: the generator masks
    (embedding, residual, the xla path's attention) are drawn whole and
    sliced, and the flash hash is keyed on global rows and KV heads
    (``dropout_offsets``), as JAX's flash masks are (see
    ``test_jax_flash_dropout_masks_are_global``).  The dropped forward
    on both paths, and the flash path's loss and gradients, equal the
    unsharded run's."""
    _, _, tree, tokens, mask = model
    axes, fsdp = GEOMS[geom]
    rates = dict(embd_pdrop=0.1, resid_pdrop=0.2, attn_pdrop=0.1)
    for impl in ("xla", "flash"):
        res = pool.run("dropout_forward_case", cfg=CFG, tree=tree,
                       axes=axes, tokens=tokens,
                       config=dict(rates, attn_impl=impl), seed=3,
                       fsdp=fsdp)
        np.testing.assert_allclose(_same(res, "logits"),
                                   res[0]["unsharded"], atol=ATOL,
                                   rtol=ATOL)
    res = pool.run("train_case", cfg=CFG, tree=tree, axes=axes,
                   tokens=tokens, loss_mask=mask, fsdp=fsdp,
                   grads_only=True, unsharded=True, dropout_seed=3,
                   config=dict(attn_pdrop=0.5, attn_impl="flash"))
    r = res[0]
    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-5)
    got, want = _flat(r["grads"]), _flat(r["ref_grads"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=ATOL,
                                   err_msg=k)


def test_flash_dropout_seed_folds_offsets():
    """A flash call that holds rows and KV heads of a larger batch draws,
    with its first row and KV head as ``dropout_offsets``, exactly its
    slice of the whole batch's dropped attention, forward and backward;
    at offset zero the key draws the bits of a call without offsets."""
    import importlib

    pfa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
    rng = np.random.RandomState(5)
    B, T, KVH, G, d = 4, 12, 4, 2, 16
    q, g = (torch.from_numpy(rng.randn(B, T, KVH * G, d).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B, T, KVH, d).astype(np.float32))
            for _ in range(2))
    pos = torch.arange(T, dtype=torch.int32).expand(B, T).contiguous()
    seed, rate = (0x2545F491, 0x9E3779B9), 0.3
    whole = pfa.flash_attention_reference(q, k, v, pos, pos, rate, seed,
                                          return_lse=True)
    dwhole = pfa.flash_backward_reference(q, k, v, pos, pos, *whole, g,
                                          rate, seed)
    zero = pfa.flash_attention_reference(q, k, v, pos, pos, rate, seed,
                                         dropout_offsets=(0, 0))
    assert torch.equal(zero, whole[0])
    rows, heads = slice(2, 4), slice(1, 3)
    qh = slice(heads.start * G, heads.stop * G)
    part = [x[rows][:, :, qh] for x in (q, g)] + [
        x[rows][:, :, heads] for x in (k, v)]
    pq, pg, pk, pv = (x.contiguous() for x in part)
    off = (rows.start, heads.start)
    out, lse = pfa.flash_attention_reference(
        pq, pk, pv, pos[rows], pos[rows], rate, seed, return_lse=True,
        dropout_offsets=off)
    torch.testing.assert_close(out, whole[0][rows][:, :, qh], rtol=0,
                               atol=0)
    dq, dk, dv = pfa.flash_backward_reference(
        pq, pk, pv, pos[rows], pos[rows], out, lse, pg, rate, seed,
        dropout_offsets=off)
    for a, b in ((dq, dwhole[0][rows][:, :, qh]),
                 (dk, dwhole[1][rows][:, :, heads]),
                 (dv, dwhole[2][rows][:, :, heads])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    plain = pfa.flash_attention_reference(pq, pk, pv, pos[rows], pos[rows],
                                          rate, seed)
    assert not torch.allclose(plain, out)


@pytest.mark.parametrize("axes", [dict(tensor=2), dict(data=2)],
                         ids=["tensor2", "data2"])
def test_jax_flash_dropout_masks_are_global(axes):
    """The reference the port's flash offsets follow: on JAX's CPU device
    mesh, one flash train step with attention dropout at tensor = 2 or
    data = 2 has the unsharded step's loss and gradients (GSPMD does not
    partition a ``pallas_call``, so the kernel draws every mask whole),
    and a step without dropout does not."""
    from jax_llama_tpu.train import lm_loss as jlm_loss

    jc = jget_config("tiny", **dict(CFG, n_layers=1, attn_impl="flash",
                                    attn_pdrop=0.5))
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    tokens = jnp.asarray(np.random.RandomState(2).randint(
        0, CFG["vocab_size"], (4, 16)).astype(np.int32))

    def step(config, mesh=None):
        params = (jpartition.shard_params(jp, mesh, config)
                  if mesh is not None else jp)
        with juse_mesh(mesh):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, t: jlm_loss(p, t, config, None,
                                      jax.random.PRNGKey(7))))(params, tokens)
        return float(loss), _flat(jax.tree.map(np.asarray, grads))

    want_loss, want = step(jc)
    loss, got = step(jc, _jmesh(**axes))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=ATOL,
                                   err_msg=k)
    plain_loss, _ = step(jc.replace(attn_pdrop=0.0))
    assert abs(plain_loss - want_loss) > 1e-3


@pytest.mark.parametrize("geom", ["fsdp2_tensor2", "data2_tensor2"])
def test_train_state_roundtrip_from_a_mesh(pool, model, tmp_path, geom):
    """``save_train_state`` under the mesh gathers params and moments and
    rank 0 writes; ``load_train_state(mesh=, fsdp=)`` gives each rank its
    shards back, and the next step is the same from either."""
    _, _, tree, tokens, _ = model
    axes, fsdp = GEOMS[geom]
    res = pool.run("train_state_roundtrip", cfg=CFG, tree=tree, axes=axes,
                   tokens=tokens, path=str(tmp_path / "state"), fsdp=fsdp)
    for r in res:
        assert r["same"] and r["count"] == 1 and r["step"] == 1
        assert r["losses"][0] == r["losses"][1]


def test_fsdp_checkpoint_load_is_the_fsdp_shard(pool, model, tmp_path):
    """``load_checkpoint(mesh=, fsdp=True)`` reads each rank's ZeRO-3
    shard: ``shard_params(fsdp=True)`` of the saved tree; a save from
    the mesh writes the unsharded save's manifest."""
    _, _, tree, _, _ = model
    pc = ptl.get_config("tiny", **CFG)
    from jax_llama_tpu_torch.convert import save_checkpoint

    path = tmp_path / "ckpt"
    save_checkpoint(str(path), ptl.from_jax_params(tree, device="cpu"), pc)
    res = pool.run("fsdp_load_case", cfg=CFG, tree=tree,
                   axes=dict(fsdp=2, tensor=2), path=str(path))
    for r in res:
        assert r["same"] and r["manifest_same"]
        assert r["qkv"][-2] == CFG["dim"] // 2


@pytest.mark.parametrize("axes,impl", [
    (dict(fsdp=2, tensor=2), "flash"), (dict(seq=2, tensor=2), "ring"),
    (dict(stage=2, tensor=2), "xla")], ids=["fsdp_tensor", "ring", "stage"])
def test_backward_on_another_thread_reenters_the_mesh(pool, model, axes,
                                                      impl):
    """Autograd runs the backward of CUDA tensors on a thread of its own,
    where no mesh is active: the rematerialized blocks (their gathers,
    reductions and ring rotations) re-enter the mesh they first ran
    under, so two steps with every backward on another thread equal two
    steps without."""
    _, _, tree, tokens, _ = model
    kw = dict(cfg=CFG, tree=tree, axes=axes, tokens=tokens, steps=2,
              fsdp="fsdp" in axes, config=dict(remat=True, attn_impl=impl))
    want = pool.run("train_case", **kw)
    got = pool.run("train_case", backward_thread=True, **kw)
    assert got[0]["losses"] == want[0]["losses"]
    for k, v in _flat(want[0]["params"]).items():
        np.testing.assert_array_equal(_flat(got[0]["params"])[k], v)
