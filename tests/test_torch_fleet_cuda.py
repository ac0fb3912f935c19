"""The fleet controller and the live profiler on the card.  Marked ``cuda``:
each test skips on a host without a GPU.  This file imports neither jax
nor the JAX package:

    python -m pytest tests/test_torch_fleet_cuda.py -m cuda --noconftest -q

A tiny float32 model (head_dim 128) serves from two ``LLMServer``
replicas behind the cache-aware router.  A ``FleetController`` grows a
third replica through its factory (the same weight tensors), a session
served there is drained onto a survivor by ``scale_down``, its revisit
hits there with the tokens it had, and the card's allocated memory falls
back to its level before the scale-up.  One server's profiler session
(``POST /debug/profiler``) attributes the paged and flash kernels of a
bracketed request to ``_paged_decode_chunk`` and ``_paged_insert``, and
the trace's paged-kernel events match the wrapper's count."""

import gc
import importlib
import json
import urllib.error
import urllib.request

import pytest
import torch

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.router import FleetController, ReplicaRouter
from jax_llama_tpu_torch.server import LLMServer
from jax_llama_tpu_torch.tokenizers.bytes import ByteTokenizer

pa = importlib.import_module("jax_llama_tpu_torch.ops.paged_attention")
fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")

CFG = dict(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
           multiple_of=32, max_seq_len=1024, dtype="float32",
           param_dtype="float32", attn_impl="auto")
SESSION = "the quick brown fox jumps over the lazy dog, " * 4


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _post(url, payload, path="/generate"):
    req = urllib.request.Request(url + path,
                                 data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=300) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def model():
    _need_gpu()
    cfg = ptl.get_config("tiny", **CFG)
    return ptl.init_params(cfg, seed=0, device="cuda"), cfg


def _server(model, i):
    params, cfg = model
    cb = ptl.ContinuousBatcher(params, cfg, n_slots=2, max_len=512,
                               block_size=32, decode_chunk=4, seed=i,
                               device="cuda")
    return LLMServer(cb, tokenizer=ByteTokenizer(), replica_id=i).start()


@pytest.mark.cuda
def test_scale_up_and_drain_on_the_card(model):
    _need_gpu()
    servers = [_server(model, i) for i in range(2)]
    router = ReplicaRouter(servers, policy="cache-aware",
                           health_interval_s=0, canary_interval_s=0,
                           tokenizer=ByteTokenizer(),
                           block_size=32).start()
    grown = {}

    def factory(i):
        grown[i] = _server(model, i)
        return grown[i]

    ctrl = FleetController(router, replica_factory=factory, min_replicas=2,
                           max_replicas=3)
    try:
        router.check_health_now()
        torch.cuda.synchronize()
        gc.collect()
        before = torch.cuda.memory_allocated()
        up = ctrl.scale_up()
        assert up["ok"] and up["replica"] == 2
        srv = grown.pop(2)
        assert (srv.batcher.params["embed"]["embedding"].data_ptr()
                == servers[0].batcher.params["embed"]["embedding"]
                .data_ptr())
        for i in (0, 1):
            router.set_retiring(i)
        paged0, flash0 = pa.paged_pool_attention.launches, \
            fa.flash_attention.launches
        st, first, hdrs = _post(router.address, {"text": SESSION,
                                                 "max_new_tokens": 8})
        assert st == 200 and int(hdrs["X-Replica-Id"]) == 2
        assert pa.paged_pool_attention.launches > paged0
        assert fa.flash_attention.launches > flash0
        for i in (0, 1):
            router.set_retiring(i, False)
        router.check_health_now()
        chains = srv.call_on_loop(lambda b: b.resident_chain_keys())
        del srv
        down = ctrl.scale_down(victim=2)
        assert down["ok"], down
        assert down["drain"]["migrated"] == len(chains) >= 1
        gc.collect()
        torch.cuda.synchronize()
        assert abs(torch.cuda.memory_allocated() - before) <= 64 << 20
        st, again, hdrs = _post(router.address, {"text": SESSION,
                                                 "max_new_tokens": 8})
        assert st == 200 and again["tokens"] == first["tokens"]
        dst = int(hdrs["X-Replica-Id"])
        assert str(dst) in down["drain"]["destinations"]
        assert servers[dst].batcher.stats()["prefix_requests_hit_total"] >= 1
    finally:
        ctrl.close(stop_owned=True)
        router.stop()
        for s in servers:
            s.stop()


@pytest.mark.cuda
def test_profiler_session_attributes_kernels(model, tmp_path):
    _need_gpu()
    srv = _server(model, 0)
    try:
        _post(srv.address, {"prompt": [5, 6, 7], "max_new_tokens": 4})
        k0 = pa.paged_pool_attention.kernel_launches
        st, _, _ = _post(srv.address, {"action": "start",
                                       "log_dir": str(tmp_path)},
                         path="/debug/profiler")
        assert st == 200
        st, body, _ = _post(srv.address, {"prompt": list(range(3, 60)),
                                          "max_new_tokens": 12})
        assert st == 200 and len(body["tokens"]) == 12
        st, _, _ = _post(srv.address, {"action": "stop"},
                         path="/debug/profiler")
        assert st == 200
        launched = pa.paged_pool_attention.kernel_launches - k0
        summary = _get(srv.address, "/debug/profile/summary")
    finally:
        srv.stop()
    progs = summary["programs"]
    assert progs["_paged_decode_chunk"]["device_ms"] > 0
    assert progs["_paged_decode_chunk"]["host_ms"] > 0
    assert progs["_paged_insert"]["device_ms"] > 0
    with open(summary["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    total = sum(e["dur"] for e in kernels) / 1e3
    assert summary["total_device_ms"] == pytest.approx(total, rel=0.01)
    assert launched > 0 and launched == sum(
        1 for e in kernels if "paged_decode_split" in e["name"]
        or "paged_decode_combine" in e["name"])
