"""The port's sliced replicas (``parallel.slices``): ``run.py --http 0
--replicas 2 --serve-mesh 1,2`` over four ranks puts each replica on a
serving mesh of its own, held against JAX's CLI on the same argv, whose
router gives each replica its own slice of the conftest's virtual
devices (``devs[0:2]`` and ``devs[2:4]``, each a 1 x 2 serving mesh with
``shard_params`` per slice).

Four gloo ranks on the CPU (one module-scoped ``torch_mesh_worker.
MeshPool``) run the port's CLI once: rank 0 leads slice 0 (the router, the
fleet controller, replica 0 and the grown replica 2, which time-shares
slice 0), rank 2 leads slice 1 (replica 1's server, reached through a
``RemoteReplica``), ranks 1 and 3 follow their slice's log.  The same
traffic (``torch_mesh_worker.sliced_session``) runs through JAX's CLI:
greedy tokens, ``/healthz`` meshes, router handoffs both ways between the
slices (each a prefix hit with its cold serve's tokens), a scale-up and a
drain of replica 1 by migration onto slice 0.  The geometry rule is held
against JAX's ``_geometry`` itself, and an export and import between
slices lands every head slice bit for bit with bf16 and int8 KV and with
a draft's twins.  A fault drill pins the port's rule for ``site@N``
under slices (each slice counts its own replicas' dispatches).
"""

import types

import jax
import numpy as np
import pytest

import jax_llama_tpu as jlt
import jax_llama_tpu.run as jrun
from jax_llama_tpu.convert.checkpoint import save_checkpoint as jsave

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.convert import save_checkpoint as psave
from jax_llama_tpu_torch.parallel import slices as slicing

from test_tokenizers import _CORPUS, _train_bpe_ranks
from test_torch_tokenizers import write_rank_file
from torch_mesh_worker import MeshPool, sliced_session

FLAGS = ["--http", "0", "--slots", "2", "--temperature", "0", "--replicas",
         "2", "--serve-mesh", "1,2", "--route", "cache-aware",
         "--autoscale", "--autoscale-min", "2", "--autoscale-max", "3",
         "--autoscale-interval-s", "3600", "--canary-interval-s", "0"]


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(4, timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """test_torch_router_mesh's tiny float32 model, saved as JAX's and as
    the port's checkpoint, and its trained Llama-3 rank file."""
    root = tmp_path_factory.mktemp("sliced")
    ranks = _train_bpe_ranks(_CORPUS, n_merges=200)
    rank_file = write_rank_file(root / "trained.model", ranks)
    cfg = dict(vocab_size=len(ranks) + 256, dim=64, n_layers=2, n_heads=4,
               n_kv_heads=2, multiple_of=32, max_seq_len=128,
               dtype="float32", param_dtype="float32")
    jc = jlt.get_config("tiny", **cfg)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    tree = jax.tree.map(np.asarray, jp)
    jsave(str(root / "jax"), jp, jc)
    psave(str(root / "port"), ptl.from_jax_params(tree, device="cpu"),
          ptl.get_config("tiny", **cfg))
    return types.SimpleNamespace(cfg=cfg, tree=tree, root=root,
                                 rank_file=str(rank_file))


@pytest.fixture(scope="module")
def sliced(pool, stack):
    """The port's CLI over two slices of two ranks: every rank's result."""
    argv = ["--ckpt-dir", str(stack.root / "port"), "--tokenizer",
            stack.rank_file, *FLAGS, "--device", "cpu"]
    return pool.run("run_sliced_cli", argv=argv)


@pytest.fixture(scope="module")
def jax_sliced(stack):
    """JAX's CLI on the same argv over the conftest's eight virtual
    devices: each replica on its own 1 x 2 slice, the same traffic."""
    got = {}

    def hook(router, servers):
        got.update(sliced_session(router, servers))
        got["devices"] = [[d.id for d in s.batcher.mesh.devices.flat]
                          for s in servers]

    mp = pytest.MonkeyPatch()
    orig = jrun._serve_router
    try:
        mp.setattr(jrun, "_serve_router", lambda *a, **kw: orig(
            *a, **dict(kw, _test_hook=hook)))
        mp.setattr("sys.argv", ["run", "--ckpt-dir", str(stack.root / "jax"),
                                "--tokenizer", stack.rank_file, *FLAGS])
        jrun.main()
    finally:
        mp.undo()
    return got


def _tokens(reply):
    status, body = reply
    return status, body.get("tokens")


REPLIES = ("cold", "routed_hit", "grown_serve", "drain_revisit")


def test_greedy_tokens_through_the_cli_are_jaxs(sliced, jax_sliced):
    """Every reply of the sliced run is JAX's: the routed session and its
    revisit, both handoffs' cold serves and hits, the grown replica's
    serve and the revisit after the drain."""
    lead = sliced[0]
    for k in REPLIES:
        assert _tokens(lead[k]) == _tokens(jax_sliced[k]), k
        assert lead[k][0] == 200
    for got, want in zip(lead["moved"], jax_sliced["moved"]):
        for k in ("cold", "hit"):
            assert _tokens(got[k]) == _tokens(want[k])
    # JAX put replicas 0 and 1 on devices of their own, as the port its
    # ranks.
    assert jax_sliced["devices"] == [[0, 1], [2, 3]]
    assert [w["slice"] for w in lead["where"][:2]] == [0, 1]
    assert lead["where"][1]["remote"] and not lead["where"][0]["remote"]
    assert "serve_mesh_sliced" in sliced[0]["out"]


def test_healthz_reports_each_replicas_slice_mesh(sliced, jax_sliced):
    for health in (sliced[0]["health"], jax_sliced["health"]):
        meshes = [r["replica"]["serve_mesh"] for r in health["replicas"]]
        assert meshes == [{"data": 1, "tensor": 2, "devices": 2}] * 3


def test_handoffs_between_slices_land_the_chain(sliced, jax_sliced):
    """The router's handoff path moves a chain from slice 0 to slice 1
    and another back, neither skipped: each moved prompt is a prefix hit
    on the destination with its cold serve's tokens."""
    lead = sliced[0]
    assert [(m["src"], m["dst"]) for m in lead["moved"]] == [(0, 1), (1, 0)]
    for m in lead["moved"]:
        assert m["idle"] and _tokens(m["hit"]) == _tokens(m["cold"])
    assert lead["handoffs_completed"] == 2 == jax_sliced["handoffs_completed"]
    blocks = (50 - 1) // 16
    for stats, jstats in ((lead["stats_moved"], jax_sliced["stats_moved"]),):
        for mine, theirs in zip(stats, jstats):
            for k in ("kv_export_blocks_total", "kv_import_blocks_total",
                      "prefix_requests_hit_total"):
                assert mine[k] == theirs[k], k
    assert [s["kv_import_blocks_total"] for s in lead["stats_moved"]] == [
        blocks, blocks]
    # Slice 1's head ran the export and the import of replica 1 in its
    # own log; slice 0's leader those of replica 0.
    head = sliced[2]["head"]["lockstep"]["records"]
    assert head["export_prefix"] >= 1 and head["import_prefix"] == 1


def test_scale_up_time_shares_slice_0_and_drain_migrates_onto_it(sliced,
                                                                 jax_sliced):
    """A scale-up builds replica 2 on slice 0 (the job has two slices),
    in rank 0's process; draining replica 1 migrates its session onto
    slice 0, and the session's revisit gets the served tokens."""
    lead = sliced[0]
    assert lead["up"]["ok"] and lead["up"]["replica"] == 2
    assert lead["where"][2] == {"remote": False, "slice": 0}
    down = lead["down"]
    assert down["ok"] and down["drain"]["migrated"] >= 1
    assert set(down["drain"]["destinations"]) <= {"0", "2"}
    assert _tokens(lead["drain_revisit"]) == _tokens(lead["moved"][0]["cold"])
    jdown = jax_sliced["down"]
    assert jdown["ok"] and jdown["drain"]["migrated"] == \
        down["drain"]["migrated"]


def test_each_slices_ranks_agree_on_host_state(sliced):
    """Every host_state record ran on each slice's ranks, which agreed
    (the log compares them); each follower's states are its head's."""
    lead, follow0, head1, follow1 = sliced
    grown, after = lead["states_grown"], lead["states"]
    assert len(grown) == len(after) == 3
    assert follow0["followed"]["states"] == [grown[0], grown[2],
                                             after[0], after[2]]
    assert follow1["followed"]["states"] == [grown[1], after[1]]
    assert follow1["followed"]["records"]["import_prefix"] == 1
    assert head1["head"]["replicas"] == 1


def test_fault_sites_count_each_slices_own_dispatches(pool, stack):
    """The port's rule for ``--inject-faults`` under sliced replicas
    (ROADMAP Queue C, a known difference): every rank arms the same spec,
    so ``step@1`` fails the first step on each slice (each replica
    recovers once and answers), where JAX's one injector counts every
    replica's dispatches in one process and fails one step in all."""
    argv = ["--ckpt-dir", str(stack.root / "port"), "--tokenizer",
            stack.rank_file, *FLAGS, "--device", "cpu", "--inject-faults",
            "step@1:error"]
    lead = pool.run("run_sliced_cli", argv=argv, session="faults")[0]
    assert [st for st, _ in lead["replies"]] == [200, 200]
    assert all(len(body["tokens"]) == 4 for _, body in lead["replies"])
    assert lead["recoveries"] == [1, 1]
    assert lead["channels"][0]["messages"] >= 1


class _Fake:
    """A stand-in for the JAX objects ``_serve_router`` builds: records
    its constructor's arguments."""

    def __init__(self, *a, **kw):
        self.args, self.kwargs = a, kw
        self.batcher = a[0] if a else None
        self.mesh = kw.get("mesh")
        self.address = "http://127.0.0.1:1"
        self.block_size = 16

    def start(self):
        return self

    def stop(self, *a, **kw):
        pass

    close = stop


def _jax_geometry(monkeypatch, world, per, replicas, grow):
    """The slice JAX's ``_serve_router`` gives replicas ``0 .. grow - 1``
    (its ``_geometry``, reached through the FleetController's
    ``replica_factory``) on a host of ``world`` devices at ``per`` a
    mesh: the slice its mesh's devices start, or 0 for replica 0's mesh
    (time-shared)."""
    import jax_llama_tpu.obs
    import jax_llama_tpu.parallel.partition as jpart
    import jax_llama_tpu.parallel.serve_mesh as jsm
    import jax_llama_tpu.router as jrouter
    import jax_llama_tpu.server as jserver
    import jax_llama_tpu.serving as jserving

    def mesh(devices):
        return types.SimpleNamespace(shape={"tensor": per},
                                     devices=tuple(devices))

    monkeypatch.setattr(jax, "devices", lambda *a: list(range(world)))
    monkeypatch.setattr(jsm, "build_serve_mesh",
                        lambda spec, devices: mesh(devices))
    monkeypatch.setattr(jsm, "validate_serve_mesh", lambda *a, **kw: None)
    monkeypatch.setattr(jpart, "shard_params", lambda p, m, c: p)
    monkeypatch.setattr(jax_llama_tpu.obs, "Observability", _Fake)
    for module, name in ((jserving, "ContinuousBatcher"),
                         (jserver, "LLMServer"), (jrouter, "ReplicaRouter"),
                         (jrouter, "FleetController")):
        monkeypatch.setattr(module, name, _Fake)
    seen = {}

    def hook(router, servers):
        seen["servers"] = list(servers)

    args = types.SimpleNamespace(
        serve_mesh=f"1,{per}", replicas=replicas, slots=2, seed=0,
        temperature=0.0, top_p=1.0, host="127.0.0.1", http=0,
        autoscale=True)
    controllers = []
    orig_init = _Fake.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        if "replica_factory" in kw:
            controllers.append(kw["replica_factory"])

    monkeypatch.setattr(_Fake, "__init__", init)
    tok = types.SimpleNamespace(eos_id=0, stop_tokens=[0])
    jrun._serve_router({}, types.SimpleNamespace(max_seq_len=64), tok,
                       mesh(["shared"]), args, _test_hook=hook)
    factory = controllers[0]
    servers = seen["servers"] + [factory(i)
                                 for i in range(replicas, grow)]
    out = []
    for srv in servers:
        first = srv.batcher.mesh.devices[0]
        out.append(0 if first == "shared" else first // per)
    return out


@pytest.mark.parametrize("world,per", [
    (2, 2), (4, 2), (6, 2), (8, 2), (3, 1), (4, 4), (8, 4), (16, 8)])
def test_geometry_rule_is_jaxs(monkeypatch, world, per):
    """Replica i's slice (seed replicas 0 and 1, then replicas the fleet
    controller grows, up to index 4) is JAX's over a table of host
    sizes: slice i while the job has it, slice 0 after."""
    want = _jax_geometry(monkeypatch, world, per, replicas=2, grow=5)
    n = slicing.slice_count(world, per)
    assert [slicing.replica_slice(i, n) for i in range(5)] == want


@pytest.mark.parametrize("world,per", [(3, 2), (5, 4), (1, 2)])
def test_a_world_of_no_whole_slices_is_refused(world, per):
    with pytest.raises(ValueError, match="not a whole number of slices"):
        slicing.slice_count(world, per)


@pytest.mark.parametrize("kv", ["bf16", "int8", "draft"])
def test_export_and_import_between_slices_land_head_slices_bit_for_bit(
        pool, stack, kv):
    """Each slice serves a prompt and exports its chain, its head holding
    every KV head (plus int8 scale planes, or the draft pool's twins);
    the heads swap the slabs and each rank of the other slice lands its
    own head slice: its planes equal, bit for bit, those of the rank at
    the same tensor index on the exporting slice."""
    out = pool.run("sliced_slabs", cfg=stack.cfg, tree=stack.tree, kv=kv)
    by = {(r["slice"], r["tensor"]): r for r in out}
    assert sorted(by) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    blocks = (50 - 1) // 16
    for s in (0, 1):
        head = by[(s, 0)]
        assert head["exported"] == head["landed"] == blocks
        # The head's slabs hold both KV heads of the tiny model.
        assert head["full_heads"]["k"][1] == 2
        assert ("k_scale" in head["full_heads"]) == (kv == "int8")
        assert ("d_k" in head["full_heads"]) == (kv == "draft")
    for t in (0, 1):
        for src in (0, 1):
            mine = by[(src, t)]["own"]
            theirs = by[(1 - src, t)]["imported"]
            names = [n for n in mine if n != "blocks"]
            assert names == [n for n in theirs if n != "blocks"]
            assert len(theirs["blocks"]) == blocks
            for n in names:
                np.testing.assert_array_equal(theirs[n], mine[n], err_msg=n)
            if kv == "int8":
                assert mine["k"].dtype == np.int8 and "k_scale" in names
            if kv == "draft":
                assert "d_k" in names and "d_v" in names
