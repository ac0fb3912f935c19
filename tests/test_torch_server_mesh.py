"""The port's HTTP server over a serving mesh of two ranks
(``parallel.lockstep``) held against JAX's ``LLMServer`` over
``ContinuousBatcher(mesh=)`` on the same geometry of the conftest's
virtual devices, and against the port's unsharded server.

Two gloo ranks on the CPU (one module-scoped ``torch_mesh_worker.MeshPool``)
serve ``test_torch_server``'s request set, sent together: blocking
``/generate``, NDJSON streams, a token-id prompt and ``/chat``.  Rank 0
runs the server; rank 1 follows its log.  On a 1 x 2 tensor mesh and on a
2 x 1 data mesh the greedy tokens and text must be JAX's on the mesh and
the unsharded port server's; every rank's host state (block tables, free
list, radix digest), computed at the same record, must be the same; the
replica's ``/healthz`` and ``/metrics`` report the mesh as JAX's do.  A
``step`` fault armed on both ranks replays token-identically; one armed on
one rank only stops both ranks with the divergence error, naming the
record, inside the pool's per-case timeout (the last case: it leaves the
mesh it built for it behind).
"""

import re
import time
import types

import jax
import numpy as np
import pytest

import jax_llama_tpu as jlt
from jax_llama_tpu.parallel import serve_mesh as jsmesh
from jax_llama_tpu.parallel.partition import shard_params as jshard_params
from jax_llama_tpu.server import LLMServer as JServer
from jax_llama_tpu.serving import ContinuousBatcher as JBatcher
from jax_llama_tpu.tokenizers import ChatFormat as JChatFormat
from jax_llama_tpu.tokenizers import LLaMA3Tokenizer as JTokenizer

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import server as pserver
from jax_llama_tpu_torch.tokenizers import ChatFormat as PChatFormat
from jax_llama_tpu_torch.tokenizers import LLaMA3Tokenizer as PTokenizer

from test_tokenizers import _CORPUS, _train_bpe_ranks
from test_torch_tokenizers import write_rank_file
from torch_mesh_worker import MeshPool, _http, _send_together

PROMPTS = ["the quick brown fox", "pack my box with five dozen",
           "sphinx of black quartz judge my vow, the the the and"]
DIALOG = [{"role": "system", "content": "be brief"},
          {"role": "user", "content": "the quick brown fox?"}]
REQUESTS = (
    [("/generate", {"text": p, "max_new_tokens": 8}) for p in PROMPTS]
    + [("/generate", {"text": p, "max_new_tokens": 8, "stream": True})
       for p in PROMPTS]
    + [("/generate", {"prompt": [5, 9, 13, 200, 7], "max_new_tokens": 6,
                      "stop_tokens": []}),
       ("/chat", {"messages": DIALOG, "max_new_tokens": 12})])
GEOMS = {"tp2": dict(tensor=2), "dp2": dict(data=2)}
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(2, timeout_s=TIMEOUT_S)
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
    tree = jax.tree.map(np.asarray, jp)
    return types.SimpleNamespace(cfg=cfg, jc=jc, jp=jp, tree=tree,
                                 rank_file=str(rank_file))


def _stops(tok):
    return tuple(sorted(tok.stop_tokens))


_REF = {}


def _jax_on_mesh(stack, axes):
    """JAX's server over its batcher on the same geometry of the
    virtual devices: the replies, /healthz and /metrics."""
    key = tuple(sorted(axes.items()))
    if key not in _REF:
        spec = jsmesh.ServeMeshSpec(axes.get("data", 1),
                                    axes.get("tensor", 1))
        mesh = jsmesh.build_serve_mesh(
            spec, devices=jax.devices()[:spec.n_devices])
        tok = JTokenizer(stack.rank_file)
        cb = JBatcher(jshard_params(stack.jp, mesh, stack.jc), stack.jc,
                      n_slots=2, max_len=64, decode_chunk=4, mesh=mesh,
                      stop_tokens=_stops(tok))
        with JServer(cb, tokenizer=tok, chat_format=JChatFormat(tok)) as s:
            replies = _send_together(s.address, REQUESTS)
            _REF[key] = dict(replies=replies,
                             health=_http(s.address, "/healthz"),
                             metrics=_http(s.address, "/metrics")[1])
    return _REF[key]


def _port_unsharded(stack):
    if "port" not in _REF:
        tok = PTokenizer(stack.rank_file)
        cb = ptl.ContinuousBatcher(
            ptl.from_jax_params(stack.tree, device="cpu"),
            ptl.get_config("tiny", **stack.cfg), n_slots=2, max_len=64,
            decode_chunk=4, stop_tokens=_stops(tok), device="cpu")
        with pserver.LLMServer(cb, tokenizer=tok,
                               chat_format=PChatFormat(tok)) as s:
            _REF["port"] = dict(replies=_send_together(s.address, REQUESTS))
    return _REF["port"]


_MESH = {}


def _on_mesh(pool, stack, geom, **kw):
    key = (geom, tuple(sorted(kw.items())))
    if key not in _MESH:
        _MESH[key] = pool.run("server_mesh", cfg=stack.cfg, tree=stack.tree,
                              rank_file=stack.rank_file, axes=GEOMS[geom],
                              requests=REQUESTS, **kw)
    return _MESH[key]


def _answers(replies):
    """Each reply's status, tokens and text (a stream's per line)."""
    out = []
    for status, body in replies:
        if isinstance(body, list):
            out.append((status, [(ln.get("token"), ln.get("text"))
                                 for ln in body]))
        else:
            out.append((status, body.get("tokens"), body.get("text")))
    return out


@pytest.mark.parametrize("geom", list(GEOMS))
def test_server_on_a_mesh_matches_jax_and_one_rank(pool, stack, geom):
    """Rank 0's replies are JAX's server on the same mesh and the port's
    unsharded server's: the same statuses, greedy tokens and text."""
    res = _on_mesh(pool, stack, geom)
    got = _answers(res[0]["replies"])
    assert all(a[0] == 200 for a in got)
    assert got == _answers(_jax_on_mesh(stack, GEOMS[geom])["replies"])
    assert got == _answers(_port_unsharded(stack)["replies"])


@pytest.mark.parametrize("geom", list(GEOMS))
def test_ranks_hold_the_same_host_state(pool, stack, geom):
    """The host state each rank computed at the same record is the same
    (the log also compared it); the follower applied every record."""
    res = _on_mesh(pool, stack, geom)
    lead, follow = res
    assert lead["states"] == follow["states"] and len(lead["states"]) == 1
    assert lead["states"][0]["queue"] == []
    assert follow["records_total"] == lead["lockstep"]["records_total"]
    assert follow["records"]["step"] == lead["lockstep"]["records"]["step"]
    assert lead["lockstep"]["records"]["submit"] == len(REQUESTS)
    assert lead["lockstep"]["broken"] is None


@pytest.mark.parametrize("geom", list(GEOMS))
def test_health_and_metrics_report_the_mesh_as_jax(pool, stack, geom):
    axes = GEOMS[geom]
    res = _on_mesh(pool, stack, geom)[0]
    want = _jax_on_mesh(stack, axes)
    status, health = res["health"]
    assert status == 200 and health["ok"] is True
    rep, jrep = health["replica"], want["health"][1]["replica"]
    assert rep["serve_mesh"] == jrep["serve_mesh"] == {
        "data": axes.get("data", 1), "tensor": axes.get("tensor", 1),
        "devices": 2}
    assert rep["serve_mesh_placed"] is jrep["serve_mesh_placed"] is True
    for name in ("serve_mesh_data", "serve_mesh_tensor"):
        line = f"llm_{name} {axes.get(name.split('_')[-1], 1)}"
        assert line in res["metrics"].splitlines()
        assert line in want["metrics"].splitlines()


def test_a_plain_batcher_on_a_mesh_is_refused():
    """A batcher on a mesh of two ranks that was not built through the
    log (``lockstep.Leader.make``) is refused: no other rank would replay
    what the server does to it."""
    plain = types.SimpleNamespace(mesh=types.SimpleNamespace(size=2))
    with pytest.raises(ValueError, match=r"lockstep\.Leader\.make"):
        pserver.LLMServer(plain)


def test_step_fault_on_every_rank_replays_token_identically(pool, stack):
    """``step@1:error`` armed on both ranks fires at the same record on
    each: the leader rebuilds and replays, the follower follows, and the
    replies are the fault-free ones."""
    res = _on_mesh(pool, stack, "tp2", faults="step@1:error")
    lead, follow = res
    assert _answers(lead["replies"]) == _answers(
        _on_mesh(pool, stack, "tp2")[0]["replies"])
    assert lead["health"][1]["recoveries_total"] == 1
    assert lead["lockstep"]["records"]["rebuild"] == 1
    assert follow["records"]["rebuild"] == 1
    assert lead["states"] == follow["states"]


def test_fault_on_one_rank_stops_both_ranks_naming_the_record(pool, stack):
    """A fault armed on the follower only: its step raises where the
    leader's runs on (and waits in the step's first all-reduce until the
    mesh's bound); both ranks then stop with the divergence error naming
    the record, inside the per-case timeout, instead of hanging."""
    t = time.monotonic()
    with pytest.raises(AssertionError) as err:
        pool.run("server_mesh", cfg=stack.cfg, tree=stack.tree,
                 rank_file=stack.rank_file, axes=GEOMS["tp2"],
                 requests=REQUESTS[:1], faults="step@1:error",
                 fault_ranks=[1],
                 timeouts=dict(timeout_s=5.0, control_timeout_s=20.0))
    text = str(err.value)
    assert time.monotonic() - t < TIMEOUT_S
    # MeshPool.run reports each failed rank as "rank N:\n<traceback>".
    sections = re.split(r"(?m)^rank (\d):$", text)[1:]
    ranks = dict(zip(sections[::2], sections[1::2]))
    assert sorted(ranks) == ["0", "1"], text
    for tb in ranks.values():
        last = tb.strip().splitlines()[-1]
        assert "LockstepDivergence: lockstep record" in last, text
        assert "(step): the ranks diverged" in last, text
