"""The port's HTTP server held against the JAX package's: each package's
``LLMServer`` over its own ``ContinuousBatcher`` on the same tiny float32
weights (``from_jax_params``) takes the same requests and must give the
same greedy tokens and text from ``/generate`` (blocking and NDJSON) and
``/chat`` (a Llama-3 ``ChatFormat`` over a rank table trained here), the
same status codes for bad and oversized bodies and a full queue, the same
``/healthz`` keys and the same ``/metrics`` series names (the differences
are listed below with their reason).  Then the port's own recovery paths:
a ``step`` fault replays token-identically; ``paged_kernel``,
``flash_kernel`` and ``stock_paged_kernel`` faults quarantine onto their
fallbacks and a probe restores them (the degrade clock is injected, so no
test waits out a cooldown; the flash and paged kernels' rungs onto plain
PyTorch are the CPU's only, and a batcher on the card sends those
failures to the breaker); the breaker trips to 503s; the watchdog flags
a stall under an injected clock; a ``nan`` fault fails one request with a
500.  Kernel calls are counted by wrapping the model's attention entry
points (on the CPU each runs its kernel's plain version)."""

import http.client
import json
import os
import re
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu.server import LLMServer as JServer
from jax_llama_tpu.serving import ContinuousBatcher as JBatcher
from jax_llama_tpu.tokenizers import ChatFormat as JChatFormat
from jax_llama_tpu.tokenizers import LLaMA3Tokenizer as JTokenizer

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import server as pserver
from jax_llama_tpu_torch.degrade import DegradeManager
from jax_llama_tpu_torch.faults import FaultInjector, InjectedFault
from jax_llama_tpu_torch.models import llama as pllama
from jax_llama_tpu_torch.overload import (
    OverloadController,
    open_loop_flood,
    summarize_flood,
)
from jax_llama_tpu_torch.tokenizers import ChatFormat as PChatFormat
from jax_llama_tpu_torch.tokenizers import LLaMA3Tokenizer as PTokenizer

from test_tokenizers import _CORPUS, _train_bpe_ranks
from test_torch_tokenizers import write_rank_file

PROMPTS = ["the quick brown fox", "pack my box with five dozen",
           "sphinx of black quartz judge my vow, the the the and"]
MAX_NEW = 8
DIALOG = [{"role": "system", "content": "be brief"},
          {"role": "user", "content": "the quick brown fox?"}]

# /metrics series the two packages do not share, each with its reason.
PORT_ONLY_SERIES = {
    # The port's count of batched prefill dispatches (one per admitted
    # burst; the chip smoke run's flash launch counts divide by it).
    "llm_insert_dispatches_total",
    # The program layer's CUDA graphs (utils.programs): whether the
    # batcher captures, graphs captured, replays; XLA compiles every
    # program, so JAX has no such choice to report.
    "llm_programs_captured", "llm_graph_captures_total",
    "llm_graph_replays_total",
}
JAX_ONLY_SERIES = {
    # Samples appear once a kernel is built inside a dispatch: XLA
    # compiles on every host, the port builds its CUDA sources on the
    # card only (the family's HELP/TYPE header is in both).
    "llm_program_compiles_total",
}


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Both packages' weights, tokenizers and chat formats."""
    ranks = _train_bpe_ranks(_CORPUS, n_merges=200)
    rank_file = write_rank_file(
        tmp_path_factory.mktemp("vocab") / "trained.model", ranks)
    cfg = dict(vocab_size=len(ranks) + 256, dim=64, n_layers=2, n_heads=4,
               n_kv_heads=2, multiple_of=32, max_seq_len=128,
               dtype="float32", param_dtype="float32")
    jc = jlt.get_config("tiny", **cfg)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    jtok, ptok = JTokenizer(str(rank_file)), PTokenizer(str(rank_file))
    return types.SimpleNamespace(
        jc=jc, jp=jp, pc=ptl.get_config("tiny", **cfg), pp=pp,
        tok={"jax": jtok, "port": ptok},
        chat={"jax": JChatFormat(jtok), "port": PChatFormat(ptok)})


def _batcher(stack, pkg, **kw):
    kw = dict(dict(n_slots=2, max_len=64, decode_chunk=4), **kw)
    stops = tuple(sorted(stack.tok[pkg].stop_tokens))
    if pkg == "jax":
        return JBatcher(stack.jp, stack.jc, stop_tokens=stops, **kw)
    config = kw.pop("config", stack.pc)
    return ptl.ContinuousBatcher(stack.pp, config, device="cpu",
                                 stop_tokens=stops, **kw)


def _server(stack, pkg, batcher_kw=None, **kw):
    cls = JServer if pkg == "jax" else pserver.LLMServer
    return cls(_batcher(stack, pkg, **(batcher_kw or {})),
               tokenizer=stack.tok[pkg], chat_format=stack.chat[pkg], **kw)


def _request(url, path, payload=None, body=None, headers=None,
             timeout=120):
    """(status, parsed body, headers); HTTP errors are answers too."""
    data = body if body is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url + path, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw, hdrs = r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        status, raw, hdrs = e.code, e.read(), dict(e.headers)
    ctype = hdrs.get("Content-Type", "")
    if "ndjson" in ctype:
        return status, [json.loads(x) for x in raw.splitlines()], hdrs
    if "json" in ctype:
        return status, json.loads(raw), hdrs
    return status, raw.decode(), hdrs


def _concurrently(fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return out


def _serve_requests(srv):
    """The shared request set, sent together: blocking /generate per
    prompt, a stream per prompt, one token-id prompt, one /chat."""
    gen = [lambda p=p: _request(srv.address, "/generate",
                                {"text": p, "max_new_tokens": MAX_NEW})
           for p in PROMPTS]
    streams = [lambda p=p: _request(
        srv.address, "/generate",
        {"text": p, "max_new_tokens": MAX_NEW, "stream": True})
        for p in PROMPTS]
    ids = [lambda: _request(srv.address, "/generate",
                            {"prompt": [5, 9, 13, 200, 7],
                             "max_new_tokens": 6, "stop_tokens": []})]
    chat = [lambda: _request(srv.address, "/chat",
                             {"messages": DIALOG, "max_new_tokens": 12})]
    return _concurrently(gen + streams + ids + chat)


@pytest.fixture(scope="module")
def served(stack):
    """Each package's answers to the shared requests, and its /metrics,
    /healthz and /debug payloads afterwards."""
    out = {}
    for pkg in ("jax", "port"):
        with _server(stack, pkg, batcher_kw=dict(cost_models=True)) as srv:
            replies = _serve_requests(srv)
            rid = replies[0][1]["request_id"]
            out[pkg] = dict(
                replies=replies,
                metrics=_request(srv.address, "/metrics")[1],
                health=_request(srv.address, "/healthz"),
                timeline=_request(srv.address, f"/debug/requests/{rid}"),
                debug={p: _request(srv.address, p) for p in (
                    "/debug/requests", "/debug/dispatches",
                    "/debug/decisions", "/debug/trace", "/debug/bundle")},
            )
    return out


def test_generate_and_chat_match_jax(served):
    n = len(PROMPTS)
    for got, want in zip(served["port"]["replies"],
                         served["jax"]["replies"]):
        assert got[0] == want[0] == 200
        if isinstance(want[1], list):  # a stream
            assert [ln.get("token") for ln in got[1]] == [
                ln.get("token") for ln in want[1]]
            assert [ln.get("text") for ln in got[1]] == [
                ln.get("text") for ln in want[1]]
        else:
            assert got[1]["tokens"] == want[1]["tokens"]
            assert got[1].get("text") == want[1].get("text")
    port = served["port"]["replies"]
    for i in range(n):  # each stream: its tokens, then the same record
        blocking, stream = port[i][1], port[n + i][1]
        final = stream[-1]
        assert final["done"] is True
        assert [ln["token"] for ln in stream[:-1]] == final["tokens"]
        assert final["tokens"] == blocking["tokens"]
        assert all(ln["request_id"] == final["request_id"] for ln in stream)
    assert len(port[2 * n][1]["tokens"]) == 6
    chat = port[-1][1]
    assert chat["tokens"] and "text" in chat


def test_healthz_keys_match_jax(served):
    def keys(d, pre=""):
        out = set()
        for k, v in d.items():
            out.add(pre + k)
            if isinstance(v, dict):
                out |= keys(v, pre + k + ".")
        return out

    (js, jh, _), (ps, ph, _) = (served["jax"]["health"],
                               served["port"]["health"])
    assert js == ps == 200 and ph["ok"] is True
    assert keys(ph) == keys(jh)
    assert ph["kv"]["prefix_index"] == jh["kv"]["prefix_index"] == "radix"
    assert ph["replica"]["serve_mesh"] == jh["replica"]["serve_mesh"]
    assert ph["features"].keys() == jh["features"].keys()


_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[a-zA-Z_]+="[^"]*"'
    r'(,[a-zA-Z_]+="[^"]*")*\})? (-?[0-9.e+-]+|[+-]Inf|NaN)$')


def _parse_prometheus(text):
    """{sample name}, {family: type}; every line must parse."""
    samples, types_ = set(), {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            assert "UNREGISTERED" not in line, line
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            types_[name] = kind
            continue
        m = _SAMPLE.match(line)
        assert m, f"unparsable /metrics line: {line!r}"
        samples.add(m.group(1))
    for name in samples:  # every sample belongs to a typed family
        assert (name in types_
                or re.sub(r"_(bucket|sum|count)$", "", name) in types_), name
    return samples, types_


def test_metrics_series_match_jax(served):
    jsamples, jtypes = _parse_prometheus(served["jax"]["metrics"])
    psamples, ptypes = _parse_prometheus(served["port"]["metrics"])
    assert psamples - jsamples == PORT_ONLY_SERIES
    assert jsamples - psamples == JAX_ONLY_SERIES
    assert set(ptypes) - set(jtypes) == PORT_ONLY_SERIES
    assert set(jtypes) == set(ptypes) - PORT_ONLY_SERIES
    assert {k: v for k, v in ptypes.items() if k in jtypes} == jtypes
    text = served["port"]["metrics"]
    # The analytic cost models fed both dispatch kinds' gauges.
    for fam in ("mxu_utilization", "hbm_utilization",
                "host_overhead_ratio"):
        for kind in ("decode", "insert"):
            assert f'llm_{fam}{{kind="{kind}"}}' in text
    # Both packages label the gauge by JAX's program names.
    jtext = served["jax"]["metrics"]
    for prog in ("_paged_decode_chunk", "_paged_insert", "_adopt_jit"):
        assert f'llm_jit_cache_entries{{program="{prog}"}}' in text
        assert f'llm_jit_cache_entries{{program="{prog}"}}' in jtext
    assert re.search(
        r'llm_jit_cache_entries\{program="_paged_decode_chunk"\} [1-9]',
        text)


def test_debug_payloads_match_jax(served):
    for path in served["jax"]["debug"]:
        (js, jb, _), (ps, pb, _) = (served["jax"]["debug"][path],
                                   served["port"]["debug"][path])
        assert js == ps == 200, path
        assert set(pb) == set(jb), path
    (_, jt, _), (_, pt, _) = (served["jax"]["timeline"],
                              served["port"]["timeline"])
    assert set(pt) == set(jt)
    assert [s["state"] for s in pt["spans"]] == [
        "queued", "prefilling", "decoding"]
    assert pt["outcome"] == "finished" and pt["dispatch_spans"]
    bundle = served["port"]["debug"]["/debug/bundle"][1]
    assert set(bundle["config"]["batcher"]) == set(
        served["jax"]["debug"]["/debug/bundle"][1]["config"]["batcher"])
    assert bundle["log_tail"] == [] or isinstance(bundle["log_tail"], list)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_refusal_statuses(stack, pkg):
    """Bad bodies 400, oversize and length-less bodies 413, a full queue
    503 with Retry-After; the port's answers are checked against the
    same table for both packages."""
    srv = _server(stack, pkg, max_body_bytes=256)
    with srv:
        url = srv.address
        cases = [
            (dict(body=b"{not json"), 400),
            (dict(payload=[1, 2, 3]), 400),
            (dict(payload={"max_new_tokens": 4}), 400),
            (dict(payload={"prompt": [1, 2], "priority": "urgent"}), 400),
            (dict(payload={"prompt": [1, 2], "timeout_s": "never"}), 400),
            (dict(payload={"text": "x" * 400}), 413),
        ]
        for kw, code in cases:
            status, body, hdrs = _request(url, "/generate", **kw)
            assert status == code, (kw, body)
            assert body["request_id"] == hdrs["X-Request-Id"]
        host, port = urllib.parse.urlsplit(url).netloc.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.putrequest("POST", "/generate")
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
        assert _request(url, "/nowhere")[0] == 404
    with _server(stack, pkg, max_queue=0) as srv:
        status, body, hdrs = _request(srv.address, "/generate",
                                      {"prompt": [1, 2]})
        assert status == 503 and int(hdrs["Retry-After"]) >= 1
        assert "overloaded" in body["error"]


# The profiler endpoints' error paths, in order: (method, path, payload,
# status), with {dir} the session's log_dir.  (A summary of a directory
# with no capture is tested on the port alone: JAX's imports the xplane
# protos first, which costs seconds.)
PROFILER_STEPS = (
    ("POST", "/debug/profiler", {"action": "bogus"}, 400),
    ("POST", "/debug/profiler", {"action": "stop"}, 409),
    ("GET", "/debug/profile/summary", None, 404),
    ("POST", "/debug/profiler", {"action": "start"}, 400),
    ("POST", "/debug/profiler", {"action": "start", "log_dir": "{dir}"}, 200),
    ("POST", "/debug/profiler", {"action": "start", "log_dir": "{dir}"}, 409),
    ("GET", "/debug/profile/summary?log_dir={dir}", None, 409),
    ("POST", "/debug/profiler", {"action": "stop"}, 200),
    ("POST", "/debug/profiler", {"action": "stop"}, 409),
)


def _profiler_codes(srv, log_dir):
    codes = []
    for method, path, payload, _ in PROFILER_STEPS:
        if payload is not None:
            payload = {k: v.format(dir=log_dir) for k, v in payload.items()}
        status, body, _ = _request(
            srv.address, path.format(dir=urllib.parse.quote(log_dir)),
            payload)
        codes.append(status)
        if status >= 400:
            assert body["error"]
    return codes


def test_profiler_endpoints_error_paths_match_jax(stack, tmp_path):
    """POST /debug/profiler and GET /debug/profile/summary are ported
    (ROADMAP A16 part 1): each step of the session lifecycle answers with
    the JAX server's status code (a bad action 400, a stray stop 409, a
    summary before any session 404, a second start and a summary of the
    active session 409), and no port endpoint answers 501."""
    codes = {}
    for pkg in ("jax", "port"):
        with _server(stack, pkg) as srv:
            codes[pkg] = _profiler_codes(srv, str(tmp_path / pkg))
    assert codes["port"] == codes["jax"] == [
        step[3] for step in PROFILER_STEPS]
    with _server(stack, "port") as srv:
        # /debug/kv is ported (ROADMAP A11): an idle store's digest walk,
        # and with ?since= its (empty) journal.
        status, body, _ = _request(srv.address, "/debug/kv")
        assert status == 200 and body["nodes"] == []
        assert body["summary"]["prefix_index"] == "radix"
        status, body, _ = _request(srv.address, "/debug/kv?since=0")
        assert status == 200 and body["events"] == []
        for path in ("/healthz", "/metrics", "/debug/requests",
                     "/debug/dispatches", "/debug/trace", "/debug/decisions",
                     "/debug/bundle", "/debug/profile/summary"):
            assert _request(srv.address, path)[0] != 501, path


def test_debug_profiler_endpoint(stack, tmp_path):
    """JAX's test_debug_profiler_endpoint on the port: POST /debug/profiler
    brackets a torch.profiler session that writes a Chrome trace under
    log_dir, and GET /debug/profile/summary attributes the bracketed
    request's decode chunks to ``_paged_decode_chunk`` with host ms > 0
    (the session runs on the serving loop's thread, whose dispatch ranges
    it records; a CPU capture has no device time).  A second server of the
    process cannot start a session while the first traces (500, JAX's
    answer), and the first session is unharmed."""
    log_dir = str(tmp_path / "trace")
    other_dir = str(tmp_path / "other")
    with _server(stack, "port") as srv, _server(stack, "port") as srv2:
        status, body, _ = _request(srv.address, "/debug/profiler",
                                   {"action": "start", "log_dir": log_dir})
        assert status == 200 and body == {"ok": True, "log_dir": log_dir}
        status, body, _ = _request(srv2.address, "/debug/profiler",
                                   {"action": "start",
                                    "log_dir": other_dir})
        assert status == 500
        assert body["error"].startswith("profiler start failed")
        assert "already active" in body["error"]
        status, body, _ = _request(srv.address, "/generate",
                                   {"prompt": [3, 4, 5], "max_new_tokens": 6})
        assert status == 200 and len(body["tokens"]) == 6
        status, body, _ = _request(srv.address, "/debug/profiler",
                                   {"action": "stop"})
        assert status == 200 and body["log_dir"] == log_dir
        status, summary, _ = _request(srv.address, "/debug/profile/summary")
        assert status == 200 and summary["log_dir"] == log_dir
        assert set(summary) == {"trace", "programs", "total_device_ms",
                                "total_host_ms", "log_dir"}
        assert summary["trace"].startswith(log_dir)
        progs = summary["programs"]
        assert progs["_paged_decode_chunk"]["host_ms"] > 0
        assert progs["_paged_insert"]["host_ms"] > 0
        assert summary["total_device_ms"] == 0
        assert summary["total_host_ms"] >= sum(
            p["host_ms"] for p in progs.values()) - 1e-2
        # The claim is free again: the second server traces now.
        status, _, _ = _request(srv2.address, "/debug/profiler",
                                {"action": "start", "log_dir": other_dir})
        assert status == 200
        status, _, _ = _request(srv2.address, "/debug/profiler",
                                {"action": "stop"})
        assert status == 200
        status, body, _ = _request(
            srv.address, "/debug/profile/summary?log_dir="
            + urllib.parse.quote(str(tmp_path)) + "/nothing")
        assert status == 404 and "capture" in body["error"]
    assert any(f.endswith(".pt.trace.json")
               for _, _, fs in os.walk(log_dir) for f in fs)


def test_server_stop_closes_an_open_profiler_session(stack, tmp_path):
    """A server stopped mid-session closes it on its loop thread and
    writes the capture, so that the process's one profiler claim is free
    for the next server."""
    log_dir = str(tmp_path / "left-open")
    with _server(stack, "port") as srv:
        assert _request(srv.address, "/debug/profiler",
                        {"action": "start", "log_dir": log_dir})[0] == 200
    assert any(f.endswith(".pt.trace.json")
               for _, _, fs in os.walk(log_dir) for f in fs)
    with _server(stack, "port") as srv:
        assert _request(srv.address, "/debug/profiler",
                        {"action": "start",
                         "log_dir": str(tmp_path / "next")})[0] == 200
        assert _request(srv.address, "/debug/profiler",
                        {"action": "stop"})[0] == 200


# ---------------------------------------------------------------------------
# The port's recovery, quarantine, breaker, watchdog and non-finite guard
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _generate_all(srv, prompts, max_new=MAX_NEW):
    replies = _concurrently([
        lambda p=p: _request(srv.address, "/generate",
                             {"prompt": p, "max_new_tokens": max_new})
        for p in prompts])
    assert [r[0] for r in replies] == [200] * len(prompts), replies
    return [r[1]["tokens"] for r in replies]


ID_PROMPTS = [[5, 17, 99, 3, 44, 8, 1, 2, 9, 10], [7, 8, 9, 31, 2, 6, 60],
              [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22]]


@pytest.fixture(scope="module")
def reference(stack):
    """Fault-free greedy tokens of ID_PROMPTS through the port batcher."""
    cb = _batcher(stack, "port")
    rids = [cb.submit(p, max_new_tokens=MAX_NEW) for p in ID_PROMPTS]
    out = cb.run_to_completion()
    return [out[r] for r in rids]


def _wait_for(cond, timeout_s=60.0):
    """Poll ``cond`` (an event another thread brings about; the bound
    only keeps a broken server from hanging the test)."""
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


def _count(monkeypatch, name):
    """Count calls of the model's attention entry point ``name``."""
    calls = [0]
    orig = getattr(pllama, name)

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(pllama, name, counted)
    return calls


def test_step_fault_replays_token_identically(stack, reference):
    inj = FaultInjector("step@2:error")
    with _server(stack, "port", batcher_kw=dict(fault_injector=inj)) as srv:
        assert _generate_all(srv, ID_PROMPTS) == reference
        health = _request(srv.address, "/healthz")[1]
        kinds = [d["kind"] for d in _request(
            srv.address, "/debug/decisions")[1]["decisions"]]
    assert health["recoveries_total"] == 1 and health["ok"]
    assert kinds == ["recovery"] and inj.injected_total == 1


def _fault_free(stack, prompts, **kw):
    cb = _batcher(stack, "port", **kw)
    rids = [cb.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    out = cb.run_to_completion()
    return [out[r] for r in rids]


@pytest.mark.parametrize("feature,site,kernel_kw,fallback_kw,kernel", [
    ("paged_kernel", "paged_kernel", {}, dict(use_pallas_kernel=False),
     "paged_decode_attention"),
    ("flash_attention", "flash_kernel", dict(attn_impl="auto"),
     dict(attn_impl="xla"), "flash_attention"),
    ("stock_paged", "stock_paged_kernel", dict(decode_kernel="stock-paged"),
     dict(decode_kernel="paged"), "stock_paged_decode_attention"),
], ids=["paged", "flash", "stock"])
def test_kernel_fault_quarantines_then_probe_restores(
        stack, monkeypatch, feature, site, kernel_kw, fallback_kw, kernel):
    """Two faults at the site quarantine its feature (threshold 2): every
    request still completes, with the fault-free tokens of the fallback
    (the replays ran there), and the kernel stops running; once the
    injected clock passes the cooldown a probe rebuild runs the kernel
    again, with the fault-free tokens of the kernel path, and marks the
    feature healthy.  In float32 the paged kernel and the gathered view,
    and the flash kernel and plain attention, give the same tokens; the
    stock kernel rounds q through bf16, so its tokens are its own, and
    depend on the float32 rounding of the batch they were admitted with:
    after the probe each request runs alone, against a fault-free run of
    it alone."""

    def kw(extra):
        out = dict(extra)
        if "attn_impl" in out:
            out["config"] = stack.pc.replace(attn_impl=out.pop("attn_impl"))
        return out

    ref_alone = [_fault_free(stack, [p], **kw(kernel_kw))[0]
                 for p in ID_PROMPTS]
    ref_fallback = _fault_free(stack, ID_PROMPTS, **kw(fallback_kw))
    if feature != "stock_paged":
        assert ref_alone == ref_fallback
    calls = _count(monkeypatch, kernel)
    paged = (_count(monkeypatch, "paged_decode_attention")
             if feature == "stock_paged" else None)
    clock = _Clock()
    degrade = DegradeManager(threshold=2, window_s=60.0, cooldown_s=30.0,
                             clock=clock)
    inj = FaultInjector(f"{site}@0:error,{site}@1:error")
    with _server(stack, "port", degrade=degrade,
                 batcher_kw=dict(kw(kernel_kw), fault_injector=inj)) as srv:
        assert _generate_all(srv, ID_PROMPTS) == ref_fallback
        health = _request(srv.address, "/healthz")[1]
        assert health["ok"] and health["quarantined"] == [feature]
        assert health["features"][feature]["state"] == "quarantined"
        metrics = _request(srv.address, "/metrics")[1]
        assert f"llm_feature_quarantined_{feature} 1" in metrics
        assert "llm_quarantine_rebuilds_total 1" in metrics
        # The fallback serves: the kernel does not run.
        before = calls[0]
        paged_before = paged[0] if paged else 0
        assert _generate_all(srv, ID_PROMPTS[:1]) == ref_fallback[:1]
        assert calls[0] == before
        if paged:  # stock-paged falls back to the paged kernel
            assert paged[0] > paged_before
        clock.t += 31.0  # past the cooldown: the idle loop probes
        _wait_for(lambda: srv.probe_rebuilds_total == 1)
        for p, want in zip(ID_PROMPTS, ref_alone):
            assert _generate_all(srv, [p]) == [want]
        assert calls[0] > before  # the kernel runs again
        health = _request(srv.address, "/healthz")[1]
        decisions = [d["kind"] for d in _request(
            srv.address, "/debug/decisions")[1]["decisions"]]
    assert health["quarantined"] == []
    assert health["features"][feature]["state"] == "healthy"
    assert health["features"][feature]["probes_total"] == 1
    assert decisions == ["recovery", "quarantine", "recovery", "probe"]


class _CardBatcher:
    """What ``LLMServer._attribute`` reads of a batcher on the card."""

    device = torch.device("cuda")

    def __init__(self, feats):
        self.last_dispatch_features = feats


@pytest.mark.parametrize("error,feats,on_cpu,on_card", [
    (InjectedFault("x", "paged_kernel"), ("paged_kernel",),
     "paged_kernel", None),
    (InjectedFault("x", "flash_kernel"), ("flash_attention",),
     "flash_attention", None),
    (InjectedFault("x", "splash_kernel"),
     ("flash_attention", "splash_prefill"), "splash_prefill",
     "splash_prefill"),
    (InjectedFault("x", "stock_paged_kernel"),
     ("paged_kernel", "stock_paged"), "stock_paged", "stock_paged"),
    (InjectedFault("x", "spec_decode"), ("spec_decode", "paged_kernel"),
     "spec_decode", "spec_decode"),
    (InjectedFault("x", "step"), ("paged_kernel",), None, None),
    (RuntimeError("flash_fwd_wgmma launch failed: cudaError_t 700"),
     ("flash_attention", "splash_prefill"), "splash_prefill",
     "splash_prefill"),
    (RuntimeError("stock_paged launch failed: cudaError_t 719"),
     ("paged_kernel", "stock_paged"), "stock_paged", "stock_paged"),
    (RuntimeError("paged_decode launch failed: cudaError_t 700"),
     ("paged_kernel",), "paged_kernel", None),
    (RuntimeError("nvcc failed building flash_fwd"), ("flash_attention",),
     "flash_attention", None),
    (RuntimeError("shape mismatch"), ("paged_kernel",), None, None),
], ids=["paged", "flash", "splash", "stock", "spec", "step", "real-splash",
        "real-stock", "real-paged", "real-build", "not-a-kernel"])
def test_card_failures_quarantine_only_onto_kernels(stack, error, feats,
                                                    on_cpu, on_card):
    """A failure is attributed to the feature its site or its kernel
    text names (the opt-in kernel first).  On the card a flash or paged
    kernel failure is not: its only rung is plain PyTorch, so it goes to
    the crash-recovery budget and its breaker instead."""
    srv = _server(stack, "port")
    try:
        srv.batcher.last_dispatch_features = feats
        assert srv._attribute(error) == on_cpu
        srv.batcher = _CardBatcher(feats)
        assert srv._attribute(error) == on_card
    finally:
        srv.httpd.server_close()


def test_recovery_rebuilds_through_the_batcher_unless_degraded(
        stack, monkeypatch):
    """A crash recovery in the degrade state the batcher was built for
    goes through ``ContinuousBatcher.rebuild()``; a quarantine and the
    probe after it rebuild from the original construction."""
    rebuilt = []
    orig = ptl.ContinuousBatcher.rebuild

    def counted(self):
        rebuilt.append(self.use_pallas_kernel)
        return orig(self)

    monkeypatch.setattr(ptl.ContinuousBatcher, "rebuild", counted)
    clock = _Clock()
    degrade = DegradeManager(threshold=1, window_s=60.0, cooldown_s=30.0,
                             clock=clock)
    # In order: a step fault on the paged path, the paged kernel's
    # quarantine (the 4th paged call comes after the 2nd step call), a
    # step fault on the gathered view (no paged calls once quarantined).
    inj = FaultInjector("step@1:error,paged_kernel@3:error,step@6:error")
    with _server(stack, "port", degrade=degrade,
                 batcher_kw=dict(fault_injector=inj)) as srv:
        for p in ID_PROMPTS:
            _generate_all(srv, [p])
        assert inj.injected_total == 3
        assert rebuilt == [True, False]
        assert srv.quarantine_rebuilds_total == 1
        assert srv.batcher.use_pallas_kernel is False
        clock.t += 31.0
        _wait_for(lambda: srv.probe_rebuilds_total == 1)
        assert srv.batcher.use_pallas_kernel is True
    assert rebuilt == [True, False]


class _Event:
    """Stands in for a CUDA event on the CPU (``query``,
    ``synchronize``, ``elapsed_time``)."""

    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return 12.5


@pytest.mark.parametrize("fault", [None, "step@0:error"])
def test_inserts_timed_on_the_device_are_recorded(stack, fault):
    """An insert timed between CUDA events waits for a fetch to pass it
    (a step's start records only the ones already done), then is
    recorded ahead of that fetch's own dispatch with its device time; a
    failed step records it before the batcher is dropped."""
    inj = FaultInjector(fault) if fault else None
    cb = _batcher(stack, "port", fault_injector=inj)
    rec = dict(kind="insert", k=1, occupancy=1, prefill_tokens=5,
               rids=[], program="_paged_insert", flops=None,
               bytes_accessed=None)
    cb._unsettled.append((rec, cb.obs.now_ms(), _Event(True),
                          _Event(False)))
    cb.submit(ID_PROMPTS[0], max_new_tokens=2)
    if fault:
        with pytest.raises(InjectedFault):
            cb.step()
    else:
        cb.step()
    kinds = [(r["kind"], r["wall_ms"] == 12.5) for r in cb.obs.dispatches]
    tail = [] if fault else [("decode", False)]
    assert kinds == [("insert", False), ("insert", True), *tail]
    assert cb._unsettled == []


def test_deadline_refusal_reads_the_insert_rate(stack):
    """The overload controller learns prefill throughput from the
    batcher's insert records (prompt tokens over the insert's wall
    time): a request whose prompt would take longer than its timeout_s
    at that rate is refused, one with twice that time admits."""
    cb = _batcher(stack, "port")
    ov = OverloadController()
    cb.obs.on_dispatch = ov.on_dispatch
    prompt = ID_PROMPTS[2]
    cb.submit(prompt, max_new_tokens=2)
    cb.step()
    inserts = [r for r in cb.obs.dispatches if r["kind"] == "insert"]
    assert [r["prefill_tokens"] for r in inserts] == [len(prompt)]
    rate = len(prompt) / (inserts[0]["wall_ms"] / 1000.0)
    cost = 4096
    refused = ov.admit("interactive", cost, 0.5 * cost / rate, depth=0)
    assert refused is not None and refused.kind == "deadline"
    assert ov.ttft_estimate_last_ms == pytest.approx(cost / rate * 1000.0)
    assert ov.admit("interactive", cost, 2.0 * cost / rate, depth=0) is None


def test_breaker_trips_to_503s(stack):
    """Unattributable faults past max_recoveries hard-drain the server:
    every in-flight client gets 503, later POSTs 503 with Retry-After,
    and /healthz says the loop is gone."""
    inj = FaultInjector("step~1.0:error")
    with _server(stack, "port", batcher_kw=dict(fault_injector=inj),
                 max_recoveries=2) as srv:
        replies = _concurrently([
            lambda p=p: _request(srv.address, "/generate",
                                 {"prompt": p, "max_new_tokens": 4})
            for p in ID_PROMPTS])
        assert [r[0] for r in replies] == [503] * len(ID_PROMPTS)
        assert all("crashed" in r[1]["error"] for r in replies)
        assert srv.wait_drained(60)
        status, body, hdrs = _request(srv.address, "/generate",
                                      {"prompt": [1, 2]})
        assert status == 503 and int(hdrs["Retry-After"]) >= 1
        health = _request(srv.address, "/healthz")
        decisions = [d["kind"] for d in _request(
            srv.address, "/debug/decisions")[1]["decisions"]]
    assert health[0] == 503 and health[1]["loop_alive"] is False
    assert health[1]["recoveries_total"] == 2
    assert decisions == ["recovery", "recovery", "recovery_breaker_tripped"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_watchdog_flags_a_stall_under_an_injected_clock(stack, pkg,
                                                        monkeypatch):
    """The watchdog thread reads the server module's clock: with the loop
    not started (no heartbeat), moving the clock past the deadline flips
    /healthz to stalled and counts one stall; a fresh heartbeat clears
    it."""
    import jax_llama_tpu.server as jserver

    mod = jserver if pkg == "jax" else pserver
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock, time=time.time, sleep=time.sleep))
    srv = _server(stack, pkg, watchdog_deadline_s=5.0,
                  watchdog_interval_s=0.01)
    try:
        srv._heartbeat = clock()
        srv._watchdog_thread.start()
        clock.t += 6.0

        _wait_for(lambda: srv._stalled)
        health = srv._health()
        assert health["stalled"] and not health["ok"]
        assert health["last_step_age_s"] == 6.0
        assert srv.watchdog_stalls_total == 1
        srv._heartbeat = clock()
        _wait_for(lambda: not srv._stalled)
        assert srv.watchdog_stalls_total == 1
        assert srv.logger.tail()[-1].startswith("watchdog_stall")
    finally:
        srv._stop.set()
        srv._watchdog_thread.join(timeout=60)
        srv.httpd.server_close()
    assert not srv._watchdog_thread.is_alive()


def test_nan_fault_fails_one_request_with_500(stack, reference):
    inj = FaultInjector("step@1:nan")
    with _server(stack, "port", batcher_kw=dict(fault_injector=inj,
                                                n_slots=1)) as srv:
        bad = _request(srv.address, "/generate",
                       {"prompt": ID_PROMPTS[0], "max_new_tokens": MAX_NEW})
        good = _generate_all(srv, ID_PROMPTS[1:2])
        metrics = _request(srv.address, "/metrics")[1]
    assert bad[0] == 500 and "non-finite" in bad[1]["error"]
    assert good == reference[1:2]
    assert "llm_nonfinite_requests_failed_total 1" in metrics
    assert "llm_fault_nans_armed_total 1" in metrics


def test_open_loop_flood_leaves_no_client_hanging(stack):
    """A burst past the queue bound: every client gets an answer (200 or
    a 503 carrying Retry-After), none hangs."""
    with _server(stack, "port", max_queue=2) as srv:
        records = open_loop_flood(
            srv.address, [0.0] * 8,
            lambda i: {"prompt": ID_PROMPTS[i % 3], "max_new_tokens": 4,
                       "priority": ("interactive", "batch")[i % 2]},
            timeout_s=120.0, join_timeout_s=180.0)
    summary = summarize_flood(records)
    assert summary["hung_total"] == 0
    for cls in ("interactive", "batch"):
        s = summary[cls]
        assert s["served"] + s["refused_503"] == s["offered"]
        assert s["refused_with_retry_after"] == s["refused_503"]
    assert sum(summary[c]["served"] for c in ("interactive", "batch")) >= 1
