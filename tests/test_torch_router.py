"""The port's ReplicaRouter held against the JAX package's
(tests/test_router.py's drills on both packages): each package's router
over two of its own ``LLMServer`` replicas, on the same tiny float32
weights (``from_jax_params``) and the byte tokenizer.  Two routed port
replicas give the tokens of one JAX server and of one port server,
blocking and NDJSON; a draining replica drains and its traffic re-routes;
affinity pins sessions; the aggregate ``/healthz`` keys, the ``/metrics``
series and the ``/debug/fleet``, ``/debug/decisions``, ``/debug/kv/fleet``
and ``/debug/trace`` schemas are JAX's (with the handoff link and the
duplicate-chain count); the routing record shows in
``/debug/requests/<id>``; and bad input gets JAX's status codes.  The
router module imports with ``jax`` and ``jax_llama_tpu`` blocked."""

import json
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import jax_llama_tpu as jlt
from jax_llama_tpu import router as jrouter
from jax_llama_tpu.router import ReplicaRouter as JRouter
from jax_llama_tpu.router import handoff_prefix as j_handoff_prefix
from jax_llama_tpu.server import LLMServer as JServer
from jax_llama_tpu.serving import ContinuousBatcher as JBatcher
from jax_llama_tpu.tokenizers.bytes import ByteTokenizer as JByteTokenizer

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import router as prouter
from jax_llama_tpu_torch.router import ReplicaRouter as PRouter
from jax_llama_tpu_torch.router import handoff_prefix as p_handoff_prefix
from jax_llama_tpu_torch.server import LLMServer as PServer
from jax_llama_tpu_torch.tokenizers.bytes import ByteTokenizer

CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")
PROMPTS = ["hello tpu", "paged kv", "radix tree"]

# Router /metrics series the two packages do not share: none.  The
# replicas here run unsharded batchers, so their /healthz reports JAX's
# unplaced shape and ``llm_router_replica_mesh_devices`` reads 1 in both
# packages (tests/test_torch_router_mesh.py holds replicas on a serving
# mesh).
PORT_ONLY_SERIES = set()
JAX_ONLY_SERIES = set()


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return {"jax": (jp, jc), "port": (pp, ptl.get_config("tiny", **CFG))}


def _batcher(model, pkg, tok, **kw):
    kw = dict(dict(n_slots=2, max_len=64), **kw)
    params, config = model[pkg]
    if pkg == "jax":
        return JBatcher(params, config,
                        stop_tokens=tuple(tok.stop_tokens), **kw)
    return ptl.ContinuousBatcher(params, config, device="cpu",
                                 stop_tokens=tuple(tok.stop_tokens), **kw)


def _tok(pkg):
    return JByteTokenizer() if pkg == "jax" else ByteTokenizer()


def _servers(model, pkg, n=2):
    tok = _tok(pkg)
    cls = JServer if pkg == "jax" else PServer
    return [cls(_batcher(model, pkg, tok), tokenizer=tok,
                replica_id=i).start() for i in range(n)]


def _router(pkg, servers, **kw):
    kw.setdefault("health_interval_s", 0)
    return (JRouter if pkg == "jax" else PRouter)(servers, **kw).start()


@pytest.fixture(scope="module")
def fleets(model):
    """Each package's two started replicas behind a least-loaded router
    (manual health polls), shared by the tests that leave the replicas
    healthy."""
    out = {}
    try:
        for pkg in ("jax", "port"):
            servers = _servers(model, pkg)
            out[pkg] = (_router(pkg, servers, policy="least-loaded"),
                        servers)
        yield out
    finally:
        for router, servers in out.values():
            router.stop()
            for s in servers:
                s.stop()


def _request(url, path, payload=None, body=None, headers=None,
             timeout=120):
    """(status, parsed body, headers); HTTP errors are answers too."""
    data = body if body is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(
        url + path, data=data,
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), dict(e.headers)
    if "ndjson" in hdrs.get("Content-Type", ""):
        return status, [json.loads(x) for x in raw.splitlines() if x], hdrs
    try:
        return status, json.loads(raw), hdrs
    except ValueError:
        return status, raw.decode(), hdrs


def _generate(url, text, max_new=8, **kw):
    return _request(url, "/generate",
                    dict({"text": text, "max_new_tokens": max_new}, **kw))


def _schema(obj):
    """The keys of ``obj``, recursively: a dict maps each key to its
    value's schema, a list to the union of its elements' schemas."""
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    if isinstance(obj, list):
        merged = {}
        for x in obj:
            s = _schema(x)
            if not isinstance(s, dict):
                return "list"
            for k, v in s.items():
                merged.setdefault(k, v)
        return [merged] if merged else "list"
    return None


def _series(text):
    """(sample names, {family: type}) of a /metrics exposition."""
    samples, types = set(), {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
        elif line and not line.startswith("#"):
            samples.add(line.split("{")[0].split(" ")[0])
    return samples, types


def test_router_imports_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jax_llama_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import jax_llama_tpu_torch.router as r\n"
        "assert r.ReplicaRouter and r.handoff_prefix and r.chain_keys\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'jax_llama_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_metric_table_is_jax(fleets):
    """The router's metric table has JAX's names, types and help text,
    and the exposition declares every family of it and no other."""
    assert prouter.ROUTER_METRICS == jrouter.ROUTER_METRICS
    _, types = _series(fleets["port"][0].metrics_text())
    assert types == {k: v[0] for k, v in prouter.ROUTER_METRICS.items()}


def test_routed_2_replicas_token_identical(model, fleets):
    """Two routed port replicas give the tokens of one JAX server and of
    one port server, blocking and streaming, and both replicas serve."""
    router, servers = fleets["port"][0], fleets["port"][1]
    jserver = fleets["jax"][1][0]
    seen = set()
    for p in PROMPTS:
        st_j, want_jax, _ = _generate(jserver.address, p)
        st_p, want_port, _ = _generate(servers[0].address, p)
        st, body, hdrs = _generate(router.address, p)
        assert st == st_j == st_p == 200
        assert body["tokens"] == want_jax["tokens"] == want_port["tokens"]
        assert len(body["tokens"]) == 8
        seen.add(hdrs.get("X-Replica-Id"))
    assert seen == {"0", "1"}  # least-loaded alternates on idle replicas
    _, want, _ = _generate(jserver.address, PROMPTS[0])
    st, lines, hdrs = _generate(router.address, PROMPTS[0], stream=True)
    assert st == 200 and "ndjson" in hdrs["Content-Type"]
    assert [ln["token"] for ln in lines if "token" in ln] == want["tokens"]
    assert any(ln.get("done") for ln in lines)


def test_unhealthy_replica_drains_and_reroutes(model):
    """A draining replica (ok false on its /healthz) gets no new request;
    the other serves them with the JAX server's tokens."""
    want = {}
    for pkg in ("jax", "port"):
        servers = _servers(model, pkg)
        router = _router(pkg, servers, policy="least-loaded")
        try:
            servers[0].begin_drain(timeout_s=60.0)
            router.check_health_now()
            h = router.health()
            assert [r["healthy"] for r in h["replicas"]] == [False, True]
            assert h["ok"]
            for _ in range(2):
                st, body, hdrs = _generate(router.address, "hello tpu")
                assert st == 200 and hdrs["X-Replica-Id"] == "1"
                want.setdefault(pkg, body["tokens"])
                assert body["tokens"] == want[pkg]
        finally:
            router.stop()
            for s in servers:
                s.stop()
    assert want["port"] == want["jax"]


def test_affinity_pins_sessions(fleets):
    """The same session lands on the same replica; a new one goes to the
    other (least-loaded), as in the JAX router."""
    _, servers = fleets["port"]
    router = _router("port", servers, policy="affinity")
    try:
        seen = {_generate(router.address, "session one says hi",
                          4)[2]["X-Replica-Id"] for _ in range(3)}
        assert len(seen) == 1
        other = _generate(router.address, "a different session",
                          4)[2]["X-Replica-Id"]
        assert other not in seen
        assert router.health()["affinity_sessions"] == 2
    finally:
        router.stop()


def _exercise(fleet, rid):
    """The same traffic on either package's fleet: two requests, a health
    poll and the fleet cache view."""
    router, servers = fleet
    for i, text in enumerate(("trace seed a", "trace seed b")):
        st, _, _ = _request(router.address, "/generate",
                            {"text": text, "max_new_tokens": 4},
                            headers={"X-Request-Id": f"{rid}-{i}"})
        assert st == 200
    router.check_health_now()
    st, _, _ = _request(router.address, "/debug/kv/fleet")
    assert st == 200


def _handoff(model, pkg, router, rid):
    tok = _tok(pkg)
    prompt = [int(x) for x in np.random.RandomState(7).randint(1, 128, 40)]
    src = _batcher(model, pkg, tok, block_size=16)
    dst = _batcher(model, pkg, tok, block_size=16)
    src.submit(prompt, max_new_tokens=4)
    src.run_to_completion()
    fn = j_handoff_prefix if pkg == "jax" else p_handoff_prefix
    n = fn(src, dst, prompt, router=router, request_id=rid, src=0, dst=1)
    for cb, name in ((src, "prefix_export"), (dst, "prefix_import")):
        evs = [e for e in cb.obs.trace_json()["traceEvents"]
               if e.get("name") == name]
        assert evs and evs[-1]["args"]["request_id"] == rid, name
    keys = dst._chain_keys(prompt, dst.block_size)
    assert len(dst._match_prefix(keys).blocks) == n
    return n


def test_healthz_and_metrics_match_jax(model, fleets):
    """The aggregate /healthz keys (and its ``replicas`` section's) and
    the /metrics series and types are JAX's after the same traffic."""
    docs = {}
    for pkg in ("jax", "port"):
        router, servers = fleets[pkg]
        _exercise(fleets[pkg], f"hm-{pkg}")
        n = _handoff(model, pkg, router, f"hm-handoff-{pkg}")
        assert n > 0
        st, health, _ = _request(router.address, "/healthz")
        st2, text, _ = _request(router.address, "/metrics")
        assert st == st2 == 200
        docs[pkg] = (health, text, n)
    (jh, jtext, jn), (ph, ptext, pn) = docs["jax"], docs["port"]
    assert pn == jn
    assert set(ph) == set(jh)
    assert set(ph["replicas"][0]) == set(jh["replicas"][0])
    assert set(ph["replicas"][0]["replica"]) == \
        set(jh["replicas"][0]["replica"])
    assert _schema(ph["cache_index"]) == _schema(jh["cache_index"])
    assert ph["kv_handoffs_total"] == jh["kv_handoffs_total"] >= 1
    assert all(r["replica"]["serve_mesh"] == {"data": 1, "tensor": 1,
                                              "devices": 1}
               for r in ph["replicas"])
    jsamples, jtypes = _series(jtext)
    psamples, ptypes = _series(ptext)
    assert psamples - jsamples == PORT_ONLY_SERIES
    assert jsamples - psamples == JAX_ONLY_SERIES
    assert ptypes == jtypes
    assert "llm_router_replicas 2" in ptext
    assert 'llm_router_replica_healthy{replica="0"} 1' in ptext
    assert 'llm_router_replica_mesh_devices{replica="0"} 1' in ptext
    assert 'llm_router_routed_requests_total{policy="least-loaded"}' \
        in ptext


def test_debug_schemas_match_jax(model, fleets):
    """/debug/fleet, /debug/decisions, /debug/kv/fleet and /debug/trace
    have JAX's schemas; the fleet trace carries the router's track, both
    replicas' tracks, causally ordered route -> forward spans and the
    handoff span linked by request id; the duplicate-chain count of a
    chain published on both replicas is JAX's."""
    docs = {}
    shared = "shared system prompt for chat session A"
    for pkg in ("jax", "port"):
        router, servers = fleets[pkg]
        _exercise(fleets[pkg], f"ds-{pkg}")
        rid = f"sess-handoff-{pkg}"
        n = _handoff(model, pkg, router, rid)
        for s in servers:
            assert _generate(s.address, shared, 4)[0] == 200
        router.check_health_now()
        doc = {path: _request(router.address, path)[1] for path in (
            "/debug/fleet", "/debug/decisions?n=256", "/debug/kv/fleet",
            "/debug/trace")}
        docs[pkg] = (doc, n, rid, servers[0].batcher.block_bytes)
    (jd, jn, _, jbb), (pd, pn, prid, pbb) = docs["jax"], docs["port"]
    assert _schema(pd["/debug/fleet"]) == _schema(jd["/debug/fleet"])
    jdec, pdec = jd["/debug/decisions?n=256"], pd["/debug/decisions?n=256"]
    assert set(pdec) == set(jdec)

    def by_kind(doc):
        out = {}
        for d in doc["decisions"]:
            out.setdefault(d["kind"], set()).update(d)
        return out

    assert by_kind(pdec) == by_kind(jdec)
    jkv, pkv = jd["/debug/kv/fleet"], pd["/debug/kv/fleet"]
    assert _schema(pkv) == _schema(jkv)
    for key in ("duplicate_chains", "duplicate_kv_blocks"):
        assert pkv["fleet"][key] == jkv["fleet"][key] >= 2, key
    assert pkv["fleet"]["duplicate_kv_bytes"] == \
        pkv["fleet"]["duplicate_kv_blocks"] * pbb
    assert pbb == jbb
    jtr, ptr = jd["/debug/trace"], pd["/debug/trace"]
    assert set(ptr) == set(jtr)
    assert sorted(ptr["replicas"]) == [0, 1]

    def router_track(doc):
        evs = doc["traceEvents"]
        procs = {e["args"]["name"] for e in evs
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        spans = {}
        for e in evs:
            if e.get("pid") == 0 and e.get("ph") == "X":
                spans.setdefault(e["name"], set()).update(e["args"])
        return procs, spans, {e["pid"] for e in evs if e.get("ph") == "X"}

    assert router_track(ptr) == router_track(jtr)
    procs, _, pids = router_track(ptr)
    assert {"router", "replica-0", "replica-1"} <= procs
    assert {0, 1, 2} <= pids
    router_x = [e for e in ptr["traceEvents"]
                if e.get("pid") == 0 and e.get("ph") == "X"]
    routes = [e for e in router_x if e["name"] == "route"]
    for f in (e for e in router_x if e["name"] == "forward"):
        assert any(r["ts"] <= f["ts"]
                   and r["args"]["replica"] == f["args"]["replica"]
                   for r in routes)
    hand = [e for e in router_x if e["name"] == "handoff"]
    assert hand[-1]["args"]["request_id"] == prid
    assert (hand[-1]["args"]["blocks"], hand[-1]["args"]["src"],
            hand[-1]["args"]["dst"]) == (pn, 0, 1)
    assert pn == jn


def test_routing_record_in_debug_requests(fleets):
    """/debug/requests aggregates both replicas (each entry tagged with
    its replica), and /debug/requests/<id> resolves through the routing
    record: the timeline carries the routing decision."""
    router, _ = fleets["port"]
    ids = {}
    for i, text in enumerate(["fleet dbg a", "fleet dbg b"]):
        st, _, hdrs = _request(router.address, "/generate",
                               {"text": text, "max_new_tokens": 4},
                               headers={"X-Request-Id": f"fleet-req-{i}"})
        assert st == 200
        ids[f"fleet-req-{i}"] = int(hdrs["X-Replica-Id"])
    assert set(ids.values()) == {0, 1}
    st, idx, _ = _request(router.address, "/debug/requests")
    assert st == 200 and sorted(idx["replicas"]) == [0, 1]
    by_id = {e["request_id"]: e for e in idx["requests"]}
    for rid, rep in ids.items():
        assert by_id[rid]["replica"] == rep
        st, tl, _ = _request(router.address, "/debug/requests/" + rid)
        assert st == 200
        assert tl["replica"] == tl["routed_replica"] == rep
        assert tl["route"] == f"replica-{rep}/least-loaded"
        assert tl["router_decisions"]


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/nope", None),
    ("GET", "/debug/requests/no-such-id", None),
    ("POST", "/generate", b"{not json"),
    ("POST", "/generate", b'{"max_new_tokens": 4}'),
    ("POST", "/nope", b"{}"),
], ids=["get_unknown", "unknown_request", "bad_json", "no_prompt",
        "post_unknown"])
def test_input_validation_status_codes_match_jax(fleets, method, path,
                                                 body):
    got = {}
    for pkg in ("jax", "port"):
        router, _ = fleets[pkg]
        st, doc, _ = _request(router.address, path, body=body)
        got[pkg] = st
    assert got["port"] == got["jax"] >= 400
    for cls in (JRouter, PRouter):
        with pytest.raises(ValueError):
            cls([], policy="least-loaded")
        with pytest.raises(ValueError):
            cls(["127.0.0.1:1"], policy="round-robin")


def test_affinity_stale_route_counted_on_digest_loss(fleets):
    """An affinity hit onto a replica whose digest loss_version moved
    since the pin routes there anyway, counted once per loss."""
    _, servers = fleets["port"]
    router = _router("port", servers, policy="affinity")
    text = "sticky session for staleness"
    try:
        router.check_health_now()
        rep = int(_generate(router.address, text, 4)[2]["X-Replica-Id"])

        def lose(by):
            with router._lock:
                r = router._replicas[rep]
                kv = dict(r.last_health.get("kv") or {})
                dig = dict(kv.get("digest") or {})
                dig["loss_version"] = (dig.get("loss_version") or 0) + by
                kv["digest"] = dig
                r.last_health = dict(r.last_health, kv=kv)

        lose(7)
        assert int(_generate(router.address, text, 4)[2]
                   ["X-Replica-Id"]) == rep
        assert router.affinity_stale_routes_total == 1
        assert "llm_router_affinity_stale_routes_total 1" in \
            router.metrics_text()
        _generate(router.address, text, 4)
        assert router.affinity_stale_routes_total == 1
    finally:
        router.stop()
