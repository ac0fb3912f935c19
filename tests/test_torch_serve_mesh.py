"""The batcher on a serving mesh (``jax_llama_tpu_torch.parallel.serve_mesh``)
held against the JAX package (``tests/test_serve_mesh.py``'s cases and
geometries: mesh22 = data 2 x tensor 2, tensor-only, and data-only) and
against the port's unsharded batcher.

Each geometry's ranks are spawned once per module
(``torch_mesh_worker.MeshPool``, gloo on the CPU) and run the same
scenario on their own shards; every rank must emit the unsharded
batcher's tokens and hold the same host state (block tables, free list,
radix digest).  Sampled requests draw from ``torch.Generator``s, so they
are held against the port's unsharded run; greedy requests against the
JAX batcher too.
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from jax_llama_tpu import get_config as jget_config
from jax_llama_tpu import init_params as jinit_params
from jax_llama_tpu.parallel import serve_mesh as jsmesh
from jax_llama_tpu.parallel.mesh import make_mesh as jmake_mesh
from jax_llama_tpu.parallel.partition import shard_params as jshard_params
from jax_llama_tpu.parallel.mesh import use_mesh as juse_mesh
from jax_llama_tpu.serving import ContinuousBatcher as JaxBatcher

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.parallel import mesh as pmesh
from jax_llama_tpu_torch.parallel import serve_mesh as psmesh

import torch_mesh_worker as worker
from torch_mesh_worker import MeshPool

CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")

GEOMS = {
    "mesh22": (4, dict(data=2, tensor=2)),
    "tp2": (2, dict(tensor=2)),
    "dp2": (2, dict(data=2)),
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


_BASE = {}


def _serve(pools, model, geom, scenario, **kw):
    """(every rank's result, the unsharded port batcher's result)."""
    key = (scenario, tuple(sorted(kw.items())))
    if key not in _BASE:
        _BASE[key] = worker.serve(CFG, model[2], {}, scenario, **kw)
    world, axes = GEOMS[geom]
    res = pools(world).run("serve", cfg=CFG, tree=model[2], axes=axes,
                           scenario=scenario, **kw)
    return res, _BASE[key]


def _same_host_state(res, axes):
    for r in res[1:]:
        for key in ("table", "free", "digest", "tokens"):
            assert r[key] == res[0][key], key
    tp = axes.get("tensor", 1)
    for r in res:
        assert r["pool_k"][1] == CFG["n_kv_heads"] // tp
        assert r["placed"]
        assert r["describe_mesh"] == psmesh.mesh_shape(
            pmesh.Mesh({a: axes.get(a, 1) for a in pmesh.AXES},
                       ["cpu"] * len(res), 0, {}, None))
        assert r["stats"]["serve_mesh_tensor"] == tp
        assert r["stats"]["serve_mesh_data"] == axes.get("data", 1)


_JAX = {}


def _jax_fused(model, axes):
    """The JAX batcher on the same mesh geometry (its ``make_mesh`` over
    the virtual CPU devices) and the same fused scenario: every
    request's tokens and logprobs (the sampled one draws from threefry,
    so only the greedy ones compare)."""
    key = tuple(sorted(axes.items()))
    if key not in _JAX:
        jp, jc, _ = model
        n = int(np.prod(list(axes.values())))
        mesh = jmake_mesh(**axes, devices=jax.devices()[:n])
        _JAX[key] = _jax_chunks(jshard_params(jp, mesh, jc), jc, mesh,
                                prefill_budget=16, logprobs=True,
                                fused_admission=True)
    return _JAX[key]


def _jax_chunks(jp, jc, mesh, prefill_budget, logprobs, fused_admission):
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 128, size=n).tolist() for n in (5, 9)]
    cb = JaxBatcher(jp, jc, n_slots=2, max_len=128, decode_chunk=2,
                    prefill_budget=prefill_budget, logprobs=logprobs,
                    mesh=mesh)
    rids = [cb.submit(prompts[0], max_new_tokens=4),
            cb.submit(prompts[1], max_new_tokens=6, temperature=0.9,
                      seed=11)]
    toks, lps = {}, {}

    def drain(n=None):
        i = 0
        while cb.pending() and (n is None or i < n):
            i += 1
            for ev in cb.step():
                toks.setdefault(ev[0], []).append(ev[1])
                if logprobs:
                    lps.setdefault(ev[0], []).append(ev[3])

    drain(2)
    if fused_admission:
        rids.append(cb.submit(rng.randint(1, 128, size=40).tolist(),
                              max_new_tokens=3, seed=99))
    drain()
    return [toks[r] for r in rids], [lps.get(r) for r in rids]


def _assert_parity(res, base, logprobs):
    for r in res:
        assert r["tokens"] == base["tokens"]
        if logprobs:
            for got, want in zip(r["logprobs"], base["logprobs"]):
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_sharded_chunk_programs_parity(pools, model, geom):
    """The fused prefill lane and the decode chunk on the mesh: tokens of
    every request equal the unsharded batcher's (greedy ones the JAX
    batcher's on the same mesh geometry too), logprobs allclose, both
    programs dispatched, the host state identical on every rank."""
    res, base = _serve(pools, model, geom, "chunks", prefill_budget=16,
                       logprobs=True, fused_admission=True)
    _assert_parity(res, base, True)
    _same_host_state(res, GEOMS[geom][1])
    j_toks, j_lps = _jax_fused(model, GEOMS[geom][1])
    for i in (0, 2):  # the greedy requests
        assert res[0]["tokens"][i] == j_toks[i]
        np.testing.assert_allclose(res[0]["logprobs"][i], j_lps[i],
                                   rtol=1e-4, atol=1e-5)
    r = res[0]
    assert r["fused"] >= 1 and r["prefill_chunks"] >= 1
    assert r["decode_dispatches"] > r["prefill_chunks"]


@pytest.mark.parametrize("kernel", ["paged", "gathered"])
@pytest.mark.parametrize("geom", ["mesh22", "tp2"])
def test_sharded_decode_chunk_only_parity(pools, model, geom, kernel):
    """Classic admission (prefill_budget 0): the decode chunk alone, on
    the paged kernel's plain version and on the gathered view."""
    res, base = _serve(pools, model, geom, "chunks", logprobs=True,
                       fused_admission=True, decode_kernel=kernel)
    _assert_parity(res, base, True)
    _same_host_state(res, GEOMS[geom][1])
    assert res[0]["fused"] == 0


@pytest.mark.parametrize("geom", ["mesh22", "tp2"])
def test_pool_and_state_placement_stable(pools, model, geom):
    """The pool holds the rank's KV-head slice, the state rows every row,
    and both keep their shapes and device across dispatches."""
    res, base = _serve(pools, model, geom, "placement")
    tp = GEOMS[geom][1].get("tensor", 1)
    for r in res:
        assert r["first"] == r["after"]
        assert r["first"]["k"][0][1] == CFG["n_kv_heads"] // tp
        assert r["first"]["fill"] == (2,) and r["first"]["table"][0] == 2
        assert r["first"]["k"][1] == "cpu"
    assert base["first"]["k"][0][1] == CFG["n_kv_heads"]


@pytest.mark.parametrize("geom", ["mesh22", "tp2"])
def test_sharded_spec_chunk_parity(pools, model, geom):
    """Speculative chunked serving (both pools sharded, self-draft) equals
    the unsharded batcher's tokens, greedy and sampled."""
    res, base = _serve(pools, model, geom, "spec", self_draft=True)
    _assert_parity(res, base, False)
    _same_host_state(res, GEOMS[geom][1])
    assert res[0]["acceptance"] == base["acceptance"] == 1.0


def test_sharded_host_tier_restore_on_mesh(pools, model):
    """Demote a served chain into the host tier and serve it again: the
    swap-in stages each rank's head slice (agreed readiness) and the
    restored serve is token-identical."""
    res, base = _serve(pools, model, "mesh22", "host_tier")
    _assert_parity(res, base, False)
    _same_host_state(res, GEOMS["mesh22"][1])
    for r in res:
        assert r["tokens"][0] == r["tokens"][1]
        assert r["demoted"] > 0 and r["host"] == r["demoted"]
        assert r["swap_in_blocks"] > 0


@pytest.mark.parametrize("geom", ["dp2", "mesh22"])
def test_prefix_hit_on_blocks_another_data_rank_computed(pools, model,
                                                         geom):
    """Two prompts insert as one 2-row batch, so each data rank computes
    one row's K/V and every data rank lands both; a later prompt hits the
    second row's blocks, which data rank 0 did not compute."""
    res, base = _serve(pools, model, geom, "prefix")
    _assert_parity(res, base, False)
    _same_host_state(res, GEOMS[geom][1])
    assert base["hits"] == 1 and base["reused"] >= 1
    for r in res:
        assert (r["hits"], r["reused"]) == (base["hits"], base["reused"])


def test_serve_mesh_build_on_ranks(pools):
    for r in pools(4).run("serve_mesh_checks", cfg=CFG,
                          axes=dict(data=2, tensor=2)):
        assert r["shape"] == {"data": 2, "tensor": 2, "devices": 4}
        assert r["placement_ok"]
        assert "must divide n_slots=3" in r["odd_slots"]


# ---------------------------------------------------------------------------
# One process: parsing, validation, envelope, specs
# ---------------------------------------------------------------------------

def _meshes(**axes):
    shape = {a: axes.get(a, 1) for a in pmesh.AXES}
    n = int(np.prod(list(shape.values())))
    jm = JMesh(np.asarray(jax.devices()[:n]).reshape(
        [shape[a] for a in pmesh.AXES]), pmesh.AXES)
    return jm, pmesh.Mesh(shape, ["cpu"] * n, 0, {}, None)


@pytest.mark.parametrize("text", ["2,4", "4", " 1 , 2 ", "2,4,8",
                                  "zero,none", "0,2"])
def test_parse_serve_mesh_is_jaxs(text):
    def parse(mod):
        try:
            s = mod.parse_serve_mesh(text)
            return (s.data, s.tensor, s.n_devices)
        except ValueError as e:
            return str(e)

    assert parse(psmesh) == parse(jsmesh)


@pytest.mark.parametrize("axes,n_slots,draft", [
    (dict(data=2, tensor=2), 4, False), (dict(data=2, tensor=2), 3, False),
    (dict(tensor=8), 8, False), (dict(tensor=4), 4, False),
    (dict(seq=2, tensor=2, data=2), 8, False),
    (dict(tensor=2), 2, True), (dict(data=4), 6, False),
], ids=["ok", "rows", "kv8", "kv4", "seq", "draft", "data4"])
def test_validate_and_placement_are_jaxs(axes, n_slots, draft):
    jc = jget_config("tiny", **CFG)
    pc = ptl.get_config("tiny", **CFG)
    jdc = jget_config("tiny", **dict(CFG, n_kv_heads=1)) if draft else None
    pdc = ptl.get_config("tiny", **dict(CFG, n_kv_heads=1)) if draft else None
    jm, pm = _meshes(**axes)

    def validate(mod, config, mesh, dc):
        try:
            mod.validate_serve_mesh(config, mesh, n_slots, draft_config=dc)
        except ValueError as e:
            return str(e)
        return None

    assert validate(psmesh, pc, pm, pdc) == validate(jsmesh, jc, jm, jdc)
    assert psmesh.placement_ok(pc, pm, n_slots, pdc) == jsmesh.placement_ok(
        jc, jm, n_slots, jdc)
    assert psmesh.is_serving_mesh(pm) == jsmesh.is_serving_mesh(jm)
    assert psmesh.row_shards(pm) == jsmesh.row_shards(jm)
    assert psmesh.mesh_shape(pm) == jsmesh.mesh_shape(jm)
    with pmesh.use_mesh(pm), juse_mesh(jm):
        assert psmesh.constraints_apply(2, n_slots) == (
            jsmesh.constraints_apply(2, n_slots))
    assert not psmesh.placement_ok(pc, None, n_slots)


def test_specs_and_staging_are_jaxs():
    for name, ndim in (("k", 5), ("v", 5), ("pos", 2), ("k_scale", 4),
                       ("d_v_scale", 4), ("d_pos", 2)):
        assert psmesh.pool_pspec(name, ndim) == tuple(
            jsmesh.pool_pspec(name, ndim))
    for ndim in (1, 2, 3):
        assert psmesh.row_pspec(ndim) == tuple(jsmesh.row_pspec(ndim))
    assert psmesh.mesh_shape(None) == jsmesh.mesh_shape(None)
    assert psmesh.staging_shardings(None, ["k"]) is None
    jm, pm = _meshes(data=2, tensor=2)
    names = ["k", "v", "pos", "d_k", "d_v", "d_pos"]
    got = psmesh.staging_shardings(pm, names)
    want = jsmesh.staging_shardings(jm, names)
    assert set(got) == set(want)
    for name in got:
        assert got[name].spec == tuple(want[name].spec)
        assert got[name].device == pm.device


def test_shard_pool_and_shape_checks():
    """``shard_pool`` slices each leaf's head axis; the constrain_*
    checks accept this rank's slice and refuse another."""
    pc = ptl.get_config("tiny", **dict(CFG, kv_cache_dtype="int8"))
    _, pm = _meshes(tensor=2)
    from jax_llama_tpu_torch.serving import init_pool

    full = init_pool(pc, 8, 16, device="cpu")
    full.k.copy_((torch.arange(full.k.numel()) % 100).reshape(
        full.k.shape).to(full.k.dtype))
    local = psmesh.shard_pool(full, pm)
    assert local.k.shape[1] == 1 and local.k_scale.shape[1] == 1
    assert local.pos.shape == full.pos.shape
    assert (local.k == full.k[:, :1]).all()
    direct = init_pool(pc, 8, 16, device="cpu", mesh=pm)
    assert direct.k.shape == local.k.shape
    with pmesh.use_mesh(pm):
        assert psmesh.constrain_pool(local, pc.kv_heads) is local
        with pytest.raises(ValueError, match="constrain: dimension 1 "):
            psmesh.constrain_pool(full, pc.kv_heads)
        rows = psmesh.constrain_rows(local.pos, n_rows=8)
        assert rows[0] is local.pos
        with pytest.raises(ValueError, match="constrain_rows"):
            psmesh.constrain_rows(local.pos, n_rows=4)
    assert psmesh.place_rows(None, np.zeros(3, np.int32)).shape == (3,)
    assert psmesh.place_rows(pm, np.zeros(3)).device.type == "cpu"

