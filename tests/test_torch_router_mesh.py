"""The port's replica router over a serving mesh of two ranks, in JAX's
time-shared geometry (``parallel.lockstep``), held against JAX's router
over two replicas sharing one serving mesh of the conftest's virtual
devices.

Two gloo ranks on the CPU (one module-scoped ``torch_mesh_worker.MeshPool``)
run two replicas behind a cache-aware ``ReplicaRouter``; rank 0 leads
(the router, every replica's server, the fleet controller) and builds
each replica's batcher on every rank through the log, rank 1 follows.
The routed tokens are JAX's; the router's handoff path moves a chain from
one replica to the other and the moved prompt is served token-identically
to its cold serve; a ``FleetController`` scale-up and a drain by
migration keep the ranks' host state equal; the router's and the
replicas' ``/healthz`` and ``/metrics`` report the mesh as JAX's do.
"""

import types

import jax
import numpy as np
import pytest

import jax_llama_tpu as jlt
from jax_llama_tpu.parallel import serve_mesh as jsmesh
from jax_llama_tpu.parallel.partition import shard_params as jshard_params
from jax_llama_tpu.router import ReplicaRouter as JRouter
from jax_llama_tpu.server import LLMServer as JServer
from jax_llama_tpu.serving import ContinuousBatcher as JBatcher
from jax_llama_tpu.tokenizers import ChatFormat as JChatFormat
from jax_llama_tpu.tokenizers import LLaMA3Tokenizer as JTokenizer

from test_tokenizers import _CORPUS, _train_bpe_ranks
from test_torch_router import _series
from test_torch_tokenizers import write_rank_file
from torch_mesh_worker import ROUTER_SCENARIOS, MeshPool

AXES = dict(tensor=2)


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(2, timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    ranks = _train_bpe_ranks(_CORPUS, n_merges=200)
    rank_file = write_rank_file(
        tmp_path_factory.mktemp("vocab") / "trained.model", ranks)
    cfg = dict(vocab_size=len(ranks) + 256, dim=64, n_layers=2, n_heads=4,
               n_kv_heads=2, multiple_of=32, max_seq_len=128,
               dtype="float32", param_dtype="float32")
    jc = jlt.get_config("tiny", **cfg)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    return types.SimpleNamespace(cfg=cfg, jc=jc, jp=jp,
                                 tree=jax.tree.map(np.asarray, jp),
                                 rank_file=str(rank_file))


_RUNS = {}


def _run(pool, stack, scenario):
    if scenario not in _RUNS:
        _RUNS[scenario] = pool.run(
            "router_mesh", cfg=stack.cfg, tree=stack.tree,
            rank_file=stack.rank_file, axes=AXES, scenario=scenario)
    return _RUNS[scenario]


@pytest.fixture(scope="module")
def jax_routed(stack):
    """JAX's router over two replicas time-sharing one 1 x 2 serving mesh
    (the batchers the worker builds: seed i, 2 slots, max_len 128,
    decode_chunk 4), through the worker's own scenario."""
    spec = jsmesh.ServeMeshSpec(1, 2)
    mesh = jsmesh.build_serve_mesh(spec, devices=jax.devices()[:2])
    params = jshard_params(stack.jp, mesh, stack.jc)
    tok = JTokenizer(stack.rank_file)
    chat = JChatFormat(tok)
    servers = [
        JServer(JBatcher(params, stack.jc, n_slots=2, max_len=128,
                         decode_chunk=4, seed=i, mesh=mesh,
                         stop_tokens=tuple(sorted(tok.stop_tokens))),
                tokenizer=tok, chat_format=chat, replica_id=i).start()
        for i in range(2)]
    router = JRouter(servers, policy="cache-aware", tokenizer=tok,
                     chat_format=chat,
                     block_size=servers[0].batcher.block_size).start()
    try:
        return ROUTER_SCENARIOS["routed"](router, servers, None)
    finally:
        router.stop()
        for s in servers:
            s.stop()


def test_routed_tokens_are_jaxs_on_a_mesh(pool, stack, jax_routed):
    """A session, an unrelated prompt and the session's revisit through
    the cache-aware router: the port's replies on two ranks are JAX's on
    its serving mesh, and the revisit was a routed prefix hit."""
    lead, follow = _run(pool, stack, "routed")
    got = [(st, body["tokens"], body["text"]) for st, body in lead["replies"]]
    want = [(st, body["tokens"], body["text"])
            for st, body in jax_routed["replies"]]
    assert got == want and all(st == 200 for st, _, _ in got)
    index = lead["health"][1]["cache_index"]
    assert index["hit_depth_blocks_total"] >= 1
    assert lead["states"] == follow["states"] and len(lead["states"]) == 2
    # Each replica's batcher was made on both ranks through the log.
    assert follow["records"]["make"] == lead["lockstep"]["records"]["make"] \
        == 2


def test_health_and_metrics_report_the_mesh_as_jax(pool, stack, jax_routed):
    lead = _run(pool, stack, "routed")[0]
    ph, jh = lead["health"][1], jax_routed["health"][1]
    assert set(ph) == set(jh)
    assert set(ph["replicas"][0]["replica"]) == set(
        jh["replicas"][0]["replica"])
    for health in (ph, jh):
        assert all(r["replica"]["serve_mesh"] == {"data": 1, "tensor": 2,
                                                  "devices": 2}
                   for r in health["replicas"])
    for (st, h), (jst, j) in zip(lead["replica_health"],
                                 jax_routed["replica_health"]):
        assert st == jst == 200
        assert h["replica"]["serve_mesh"] == j["replica"]["serve_mesh"]
        assert h["replica"]["serve_mesh_placed"] is True
    assert _series(lead["metrics"]) == _series(jax_routed["metrics"])
    for text in (lead["metrics"], jax_routed["metrics"]):
        for i in (0, 1):
            assert f'llm_router_replica_mesh_devices{{replica="{i}"}} 2' \
                in text
    for text in lead["replica_metrics"] + jax_routed["replica_metrics"]:
        assert "llm_serve_mesh_tensor 2" in text.splitlines()
        assert "llm_serve_mesh_data 1" in text.splitlines()


def test_handoff_through_the_router_is_token_identical(pool, stack):
    """The router's handoff path moves a served prompt's chain from
    replica 0 to replica 1 (each rank lands its own head slice); its
    serve there is a prefix hit with the cold serve's tokens."""
    lead, follow = _run(pool, stack, "handoff")
    (st, cold), (st2, hit) = lead["cold"], lead["hit"]
    assert st == st2 == 200 and hit["tokens"] == cold["tokens"]
    assert lead["idle"] and lead["completed"] == 1
    assert lead["exported"] == lead["imported"] == (50 - 1) // 16
    assert lead["hits"] == 1
    assert lead["states"] == follow["states"]
    assert follow["records"]["import_prefix"] == 1
    assert follow["records"]["export_prefix"] == 1


def test_autoscale_grow_and_drain_keep_the_ranks_equal(pool, stack):
    """A scale-up builds a third replica on both ranks; a scale-down
    drains it by migrating its session to a survivor and drops its
    batcher on both ranks; the ranks' host states agree throughout and
    the revisit gets the served tokens."""
    lead, follow = _run(pool, stack, "elastic")
    assert lead["up"]["ok"] is True and lead["up"]["replica"] == 2
    down = lead["down"]
    assert down["ok"] is True and down["drain"]["migrated"] >= 1
    (st, served), (st2, revisit) = lead["served"], lead["revisit"]
    assert st == st2 == 200 and revisit["tokens"] == served["tokens"]
    assert len(lead["grown"]) == 3 and len(lead["after"]) == 2
    assert follow["states"] == lead["grown"] + lead["after"]
    assert follow["records"]["make"] == 3
    assert follow["records"]["drop"] == lead["lockstep"]["records"]["drop"]
    assert follow["records"]["drop"] >= 1
