"""Tensor and data parallelism of the port (``jax_llama_tpu_torch.parallel``)
held against the JAX package's sharded runs (``tests/test_partition.py``'s
geometries, over the 8 virtual CPU devices of ``conftest.py``) and against
the port's own unsharded run.

The port runs one process per rank: each geometry's ranks are spawned
once per module (``torch_mesh_worker.MeshPool``, gloo on the CPU) and
reused by every case; each rank imports no jax (checked).  Weights go
through ``from_jax_params``; inputs come from a numpy seed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh

from jax_llama_tpu import get_config as jget_config
from jax_llama_tpu.engine import GenerationConfig as JGenerationConfig
from jax_llama_tpu.engine import generate as jgenerate
from jax_llama_tpu.models import forward as jforward
from jax_llama_tpu.models import init_params as jinit_params
from jax_llama_tpu.parallel import make_mesh as jmake_mesh
from jax_llama_tpu.parallel import mesh as jmesh_mod
from jax_llama_tpu.parallel import partition as jpartition
from jax_llama_tpu.parallel import use_mesh as juse_mesh

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import parallel as pparallel
from jax_llama_tpu_torch.parallel import distributed as pdist
from jax_llama_tpu_torch.parallel import mesh as pmesh
from jax_llama_tpu_torch.parallel import partition as ppartition

from torch_mesh_worker import MeshPool

CFG = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=64, dtype="float32",
           param_dtype="float32")

# Geometry name -> (ranks, axes); test_partition.py's tensor/data cases.
GEOMS = {
    "tp2": (2, dict(tensor=2)),
    "dp2": (2, dict(data=2)),
    "dp2tp2": (4, dict(data=2, tensor=2)),
}


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        if n not in made:
            made[n] = MeshPool(n)
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


@pytest.fixture(scope="module")
def model():
    jc = jget_config("tiny", **CFG)
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    return jp, jc, jax.tree.map(np.asarray, jp)


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(**axes, devices=jax.devices()[:n])


def _shape_mesh(**axes):
    """A port mesh of the given axes seen from rank 0, without process
    groups: enough for the checks that read only the shape."""
    shape = {a: axes.get(a, 1) for a in pmesh.AXES}
    n = int(np.prod(list(shape.values())))
    return pmesh.Mesh(shape, ["cpu"] * n, 0, {}, None)


def _inputs(B, T, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab_size"], (B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    return tokens, positions


def _agree(results, key):
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_import_no_jax(pools, world):
    for i, r in enumerate(pools(world).run("_ready")):
        assert r["rank"] == i and r["world"] == world
        assert not r["jax_loaded"] and not r["jax_package_loaded"]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_sharded_forward_matches_jax(pools, model, geom, impl):
    jp, jc, tree = model
    world, axes = GEOMS[geom]
    tokens, positions = _inputs(4, 10)
    mesh = _jax_mesh(axes)
    with juse_mesh(mesh):
        want = np.asarray(jax.jit(
            lambda p, t, pos: jforward(p, t, pos, jc)[0])(
                jpartition.shard_params(jp, mesh, jc), jnp.asarray(tokens),
                jnp.asarray(positions)))
    res = pools(world).run("forward", cfg=CFG, tree=tree, axes=axes,
                           tokens=tokens, positions=positions,
                           config=dict(attn_impl=impl))
    got = _agree(res, "logits")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, res[0]["unsharded"], atol=1e-4,
                               rtol=1e-4)
    tp = axes.get("tensor", 1)
    assert res[0]["qkv_shape"][1] == CFG["n_kv_heads"] // tp
    coll = res[0]["collectives"]
    # Per layer: o and down all-reduced; the embedding's masked gather,
    # the head's gather over tensor; the logits gathered over the rows.
    assert coll.get("all_reduce/tensor", 0) == (
        2 * CFG["n_layers"] + 1 if tp > 1 else 0)
    assert coll.get("all_gather/tensor", 0) == (1 if tp > 1 else 0)
    assert coll.get("all_gather/data/fsdp", 0) == (
        1 if "data" in axes else 0)


@pytest.mark.parametrize("geom", ["tp2", "dp2tp2"])
def test_sharded_aux_outputs_match_unsharded(pools, model, geom):
    world, axes = GEOMS[geom]
    tokens, positions = _inputs(4, 9, seed=1)
    res = pools(world).run("forward", cfg=CFG, tree=model[2], axes=axes,
                           tokens=tokens, positions=positions,
                           output_hidden_states=True, output_attentions=True)
    for name in ("logits", "last_hidden_state", "hidden_states",
                 "attentions"):
        got = _agree(res, name)
        want = res[0]["unsharded" if name == "logits" else name
                      + "_unsharded"]
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_cached_forward_matches_unsharded(pools, model, geom):
    """Prefill in chunks through a KV cache that holds the rank's head
    slice and every row, then a decode step (every data rank lands every
    row's K/V)."""
    world, axes = GEOMS[geom]
    tokens, positions = _inputs(4, 12, seed=2)
    res = pools(world).run("cached_forward", cfg=CFG, tree=model[2],
                           axes=axes, tokens=tokens, positions=positions,
                           chunk=5)
    got = _agree(res, "logits")
    np.testing.assert_allclose(got, res[0]["unsharded"], atol=1e-4,
                               rtol=1e-4)
    kvh = CFG["n_kv_heads"] // axes.get("tensor", 1)
    assert res[0]["cache_shape"] == (CFG["n_layers"], 4, 16, kvh,
                                     CFG["dim"] // CFG["n_heads"])


@pytest.mark.parametrize("geom", list(GEOMS))
def test_generate_on_mesh_matches_jax(pools, model, geom):
    jp, jc, tree = model
    world, axes = GEOMS[geom]
    prompt = np.asarray([[5, 17, 200, 3], [0, 9, 8, 7]], np.int32)
    mask = np.asarray([[1, 1, 1, 1], [0, 1, 1, 1]], bool)
    gc = JGenerationConfig(max_new_tokens=8, temperature=0.0)
    mesh = _jax_mesh(axes)
    want = np.asarray(jgenerate(
        jpartition.shard_params(jp, mesh, jc), jnp.asarray(prompt),
        jnp.asarray(mask), jax.random.PRNGKey(0), config=jc, gen_config=gc,
        mesh=mesh))
    res = pools(world).run("generate", cfg=CFG, tree=tree, axes=axes,
                           prompt=prompt, mask=mask, max_new=8)
    got = _agree(res, "tokens")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(res[0]["unsharded"], want)
    np.testing.assert_array_equal(_agree(res, "via_llama"), want)
    np.testing.assert_allclose(_agree(res, "score"),
                               res[0]["score_unsharded"], atol=1e-5)


@pytest.mark.parametrize("geom", ["tp2", "dp2tp2"])
def test_generate_speculative_on_mesh(pools, model, geom):
    world, axes = GEOMS[geom]
    prompt = np.asarray([[5, 17, 200, 3], [4, 9, 8, 7]], np.int32)
    res = pools(world).run("generate", cfg=CFG, tree=model[2], axes=axes,
                           prompt=prompt, mask=np.ones_like(prompt, bool),
                           max_new=8, spec=True)
    np.testing.assert_array_equal(_agree(res, "tokens"),
                                  res[0]["unsharded"])
    np.testing.assert_array_equal(res[0]["tokens"], res[0]["via_llama"])


@pytest.mark.parametrize("geom", list(GEOMS))
def test_init_params_mesh_is_shard_of_the_same_tree(pools, geom):
    world, axes = GEOMS[geom]
    assert all(pools(world).run("init_params_shard", cfg=CFG, axes=axes,
                                seed=3))


@pytest.mark.parametrize("geom", ["tp2", "dp2tp2"])
def test_load_checkpoint_keeps_this_ranks_shard(pools, model, geom,
                                                tmp_path):
    world, axes = GEOMS[geom]
    res = pools(world).run("load_checkpoint_shard", cfg=CFG, tree=model[2],
                           axes=axes, path=str(tmp_path / "ckpt"))
    tp = axes.get("tensor", 1)
    for r in res:
        assert r["same"]
        assert "use_mesh" in r["refused"]
        assert r["manifest_same"]
        assert r["qkv"][1] == CFG["n_kv_heads"] // tp


def test_ambient_mesh_without_mesh_argument_is_refused(pools):
    for msg in pools(2).run("ambient_mesh_refused", axes=dict(tensor=2)):
        assert "pass mesh= explicitly" in msg


# ---------------------------------------------------------------------------
# One process: specs, validation, shapes, refusals
# ---------------------------------------------------------------------------

def _as_tuples(tree):
    """A spec tree with each PartitionSpec (or tuple) as a tuple padded
    with None to ``n`` entries."""
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _same_specs(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_specs(a[k], b[k])
        return
    n = max(len(a), len(b))
    assert a + (None,) * (n - len(a)) == b + (None,) * (n - len(b))


@pytest.mark.parametrize("fsdp,pp", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("tied", [False, True])
def test_spec_tree_is_jaxs(fsdp, pp, tied):
    jc = jget_config("tiny", **CFG, tie_word_embeddings=tied)
    pc = ptl.get_config("tiny", **CFG, tie_word_embeddings=tied)
    _same_specs(_as_tuples(jpartition.param_partition_specs(
        jc, fsdp=fsdp, pp=pp)),
        _as_tuples(ppartition.param_partition_specs(pc, fsdp=fsdp, pp=pp)))


@pytest.mark.parametrize("axes", [dict(tensor=8), dict(tensor=4),
                                  dict(tensor=2, stage=4),
                                  dict(tensor=2, fsdp=2), dict(tensor=2)],
                         ids=["kv", "vocab", "stage", "fsdp", "ok"])
def test_validate_tp_messages_are_jaxs(axes):
    cfg = dict(CFG, n_heads=8, n_kv_heads=4, n_layers=6, vocab_size=250)
    jc = jget_config("tiny", **cfg)
    pc = ptl.get_config("tiny", **cfg)
    shape = {a: axes.get(a, 1) for a in pmesh.AXES}
    n = int(np.prod(list(shape.values())))
    jm = JMesh(np.asarray(jax.devices()[:n]).reshape(
        [shape[a] for a in pmesh.AXES]), pmesh.AXES)
    fsdp = "fsdp" in axes

    def msg(fn, mesh, config):
        try:
            fn(config, mesh, fsdp=fsdp)
        except ValueError as e:
            return str(e)
        return None

    want = msg(jpartition.validate_tp, jm, jc)
    assert msg(ppartition.validate_tp, _shape_mesh(**axes), pc) == want
    if axes == dict(tensor=8):
        assert "n_kv_heads" in want


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("axes", [dict(tensor=2), dict(data=2, tensor=2)])
def test_shard_shapes_are_jaxs(model, axes, quantized):
    """Each leaf's local shape (``shard_abstract`` and ``shard_params``,
    quantized scales by ``_scale_spec``) is the JAX shard's."""
    jp, jc, tree = model
    from jax_llama_tpu.ops.quant import quantize_params as jquantize

    if quantized:
        jp = jquantize(jp)
    jm = _jax_mesh(axes)
    jsh = jpartition.shard_params(jp, jm, jc)
    want = [leaf.sharding.shard_shape(leaf.shape)
            for leaf in jax.tree.leaves(jsh)]
    pc = ptl.get_config("tiny", **CFG)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    pm = _shape_mesh(**axes)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, ptl.QuantizedTensor):
            return [t.q, t.scale]
        return [t]

    def shape_leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in shape_leaves(t[k])]
        if isinstance(t, ptl.QuantizedTensor):
            return [tuple(t.q), tuple(t.scale)]
        return [tuple(t)]

    # JAX flattens dicts by sorted key, q before scale: the same order.
    got = [tuple(x.shape) for x in leaves(
        ppartition.shard_params(pp, pm, pc))]
    assert got == [tuple(s) for s in want]
    assert shape_leaves(ppartition.shard_abstract(pp, pm, pc)) == got


def test_logical_to_spec_and_axes_are_jaxs():
    assert pmesh.AXES == jmesh_mod.AXES
    assert pmesh.LOGICAL_RULES == jmesh_mod.LOGICAL_RULES
    for names in [("data", None, "tensor"), ("data", "seq", None),
                  (None, "fsdp")]:
        assert pmesh.logical_to_spec(*names) == tuple(
            jmesh_mod.logical_to_spec(*names))
    for name in ("make_mesh", "auto_mesh", "use_mesh", "constrain"):
        assert name in ptl.__all__ and name in pparallel.__all__


def test_constrain_checks_local_shapes():
    x = torch.zeros(4, 3, 8)
    assert pmesh.constrain(x, "data", None, "tensor", full=(4, 3, 16)) is x
    with pmesh.use_mesh(_shape_mesh(data=2, tensor=2)):
        # Rows divide data (2 per rank); 16 over tensor = 8 per rank.
        y = torch.zeros(2, 3, 8)
        assert pmesh.constrain(y, "data", None, "tensor",
                               full=(4, 3, 16)) is y
        # Rows that do not divide replicate.
        z = torch.zeros(3, 3, 8)
        assert pmesh.constrain(z, "data", None, "tensor",
                               full=(3, 3, 16)) is z
        with pytest.raises(ValueError, match="over 'tensor'"):
            pmesh.constrain(y, "data", None, "tensor", full=(4, 3, 8))
        assert pmesh.current_mesh().shape["tensor"] == 2
    assert pmesh.current_mesh() is None


def test_make_mesh_single_process_and_refusals():
    assert not pdist.is_initialized()
    pdist.initialize()  # one process: nothing to bring up
    assert not pdist.is_initialized()
    assert (pdist.process_index(), pdist.process_count()) == (0, 1)
    one = pparallel.make_mesh(devices=["cpu"])
    assert one.size == 1 and one.device == torch.device("cpu")
    x = torch.ones(3)
    assert one.all_reduce(x) is x and one.all_gather(x) is x
    assert one.agree(True) and not one.agree(False)
    assert pparallel.auto_mesh(devices=["cpu"]).shape["tensor"] == 1
    # seq and stage axes are ported (ROADMAP A14 part 2): like any axis
    # they need one process per rank.
    with pytest.raises(ValueError, match="!= 1 processes"):
        pparallel.make_mesh(seq=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="!= 1 processes"):
        pparallel.make_mesh(stage=2, devices=["cpu"] * 2)
    # The collective routes follow the backend and the device.
    assert pmesh.collective_routes("gloo", torch.device("cuda")) == {
        "ppermute": "all_gather_take", "reduce_scatter": "all_reduce_slice"}
    for backend, dev in (("gloo", "cpu"), ("nccl", "cuda")):
        assert pmesh.collective_routes(backend, torch.device(dev)) == {
            "ppermute": "p2p", "reduce_scatter": "reduce_scatter"}
    with pytest.raises(ValueError, match="!= 1 processes"):
        pparallel.make_mesh(tensor=2, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pparallel.make_mesh()


def test_row_slices_handed_to_kernels_are_aligned():
    """A data rank's slice of a per-row int32 array can start off a
    16-byte boundary (row 1 of 2 starts 4 bytes in), which the kernels
    refuse: ``take`` hands them an aligned copy, while a cache plane's
    slice stays a view that the step writes in place."""
    from jax_llama_tpu_torch.models.llama import _Shard

    mesh = _shape_mesh(data=2)
    q_pos = torch.arange(2, dtype=torch.int32)
    plane = torch.zeros(2, 16, 2, 8)
    for i in range(2):
        sh = _Shard(mesh, slice(i, i + 1))
        got = sh.take(q_pos)
        assert got.data_ptr() % 16 == 0 and got.tolist() == [i]
        sh.view(plane).fill_(i + 1)
        assert (plane[i] == i + 1).all()
    assert _Shard(mesh, None).take(q_pos) is q_pos


def test_sharded_tree_without_its_mesh_is_refused(model):
    pc = ptl.get_config("tiny", **CFG)
    pp = ptl.from_jax_params(model[2], device="cpu")
    shard = ppartition.shard_params(pp, _shape_mesh(tensor=2), pc)
    tokens, positions = (torch.from_numpy(a) for a in _inputs(2, 4))
    with pytest.raises(ValueError, match="tensor-parallel shard"):
        ptl.forward(shard, tokens, positions, pc)
    with pmesh.use_mesh(_shape_mesh(tensor=1)):
        with pytest.raises(ValueError, match="constrain"):
            ptl.forward(shard, tokens, positions, pc)
    # An fsdp (ZeRO-3) shard holds D / fsdp of each projection and is
    # refused without its mesh too.
    fshard = ppartition.shard_params(pp, _shape_mesh(fsdp=2), pc, fsdp=True)
    assert fshard["layers"]["qkv"].shape[-2] == CFG["dim"] // 2
    with pytest.raises(ValueError, match="fsdp shard"):
        ptl.forward(fshard, tokens, positions, pc)
