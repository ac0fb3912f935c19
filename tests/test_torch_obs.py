"""``jax_llama_tpu_torch.obs`` held against ``jax_llama_tpu.obs``: each
unit test body runs on both packages' module (the ``ob`` fixture) —
histogram bucket math and exposition, the metric registry, span
timelines, binding and rings under an injected clock, SLO accounting,
the trace export, the decision log and the structured logger — and the
two packages must render the same metric text from the same events.  The
port's own parts: the H100 peaks, the analytic ``CostModel`` (counted
here against a hand count and a brute-force sum), and the kernel-build
listener on ``ops._build``."""

import json

import pytest

import jax_llama_tpu.obs as jobs
import jax_llama_tpu_torch.obs as pobs
from jax_llama_tpu_torch import get_config, init_params
from jax_llama_tpu_torch.ops import _build

MODULES = {"jax": jobs, "port": pobs}


@pytest.fixture(params=sorted(MODULES))
def ob(request):
    return MODULES[request.param]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


# ---------------------------------------------------------------------------
# Histogram bucket math
# ---------------------------------------------------------------------------

def test_histogram_bucket_math(ob):
    h = ob.Histogram("x_ms", "help", buckets=(1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 1.5, 5.0, 7.0):
        h.observe(v)
    # le is LESS-THAN-OR-EQUAL: a value on a bound lands in that bucket.
    assert h.cumulative() == [
        ("1", 2), ("2", 3), ("5", 4), ("+Inf", 5),
    ]
    assert h.count == 5
    assert h.sum == pytest.approx(15.0)


def test_histogram_exposition_format(ob):
    h = ob.Histogram("lat_ms", "latency help", buckets=(10.0, 100.0))
    h.observe(3.0)
    h.observe(250.0)
    lines = h.expose("llm_")
    assert lines[0] == "# HELP llm_lat_ms latency help"
    assert lines[1] == "# TYPE llm_lat_ms histogram"
    assert 'llm_lat_ms_bucket{le="10"} 1' in lines
    assert 'llm_lat_ms_bucket{le="+Inf"} 2' in lines
    assert "llm_lat_ms_sum 253.0" in lines
    assert "llm_lat_ms_count 2" in lines
    # The +Inf bucket always equals _count (Prometheus invariant).
    inf = [ln for ln in lines if 'le="+Inf"' in ln][0]
    cnt = [ln for ln in lines if ln.endswith("_count 2")][0]
    assert inf.rsplit(" ", 1)[1] == cnt.rsplit(" ", 1)[1]


def test_histogram_rejects_unsorted_buckets(ob):
    with pytest.raises(ValueError):
        ob.Histogram("bad", "h", buckets=(5.0, 1.0))
    with pytest.raises(ValueError):
        ob.Histogram("bad", "h", buckets=(1.0, 1.0, 2.0))


def test_metric_registry_shape(ob):
    """Every registered metric carries a valid type and a non-empty
    HELP; the names the exposition derives families from are covered."""
    for name, (kind, help_text) in ob.METRICS.items():
        assert kind in ("counter", "gauge"), name
        assert help_text, name
    assert ob.metric_meta("emitted_tokens_total") == ob.METRICS[
        "emitted_tokens_total"
    ]
    assert ob.metric_meta("definitely_not_registered") is None
    # radix_nodes_total is the deliberate counter-convention exception.
    assert ob.METRICS["radix_nodes_total"][0] == "gauge"
    assert set(ob.HISTOGRAMS) == {
        "ttft_ms", "itl_ms", "queue_wait_ms", "prefill_chunk_ms",
        "swap_in_ms", "compile_ms", "dispatch_ms",
        "prefix_hit_depth_tokens", "session_kv_blocks",
    }
    # dispatch_ms renders as one labeled series per dispatch kind.
    assert ob.LABELED_HISTOGRAMS == {"dispatch_ms"}
    # The labeled attribution families are registered too.
    for fam in ("mxu_utilization", "hbm_utilization",
                "host_overhead_ratio", "jit_cache_entries",
                "program_compiles_total", "compiles_total"):
        assert ob.metric_meta(fam) is not None, fam


# ---------------------------------------------------------------------------
# Span lifecycle / binding / rings (fake clock)
# ---------------------------------------------------------------------------

def test_span_lifecycle_and_dispatch_links(ob):
    clk = FakeClock()
    obs = ob.Observability(clock=clk)
    obs.request_queued(7, prompt_tokens=12)
    clk.advance(0.050)
    obs.begin_span(7, "prefilling")
    seq = obs.record_dispatch(
        kind="insert", k=1, occupancy=1, prefill_tokens=12,
        wall_ms=5.0, fetch_ms=1.0, rids=[7],
    )
    clk.advance(0.010)
    obs.begin_span(7, "decoding")
    seq2 = obs.record_dispatch(kind="decode", k=4, occupancy=1,
                               wall_ms=2.0, rids=[7])
    clk.advance(0.008)
    obs.request_end(7, "finished")

    obs.bind(7, "ext-abc")
    tl = obs.timeline_json("ext-abc")
    assert tl is not None
    assert tl["request_id"] == "ext-abc" and tl["rids"] == [7]
    assert tl["prompt_tokens"] == 12
    assert tl["outcome"] == "finished" and tl["error"] is None
    states = [sp["state"] for sp in tl["spans"]]
    assert states == ["queued", "prefilling", "decoding"]
    q, pf, dec = tl["spans"]
    assert q["duration_ms"] == pytest.approx(50.0)
    assert pf["dispatches"] == [seq]
    assert dec["dispatches"] == [seq2]
    # Every linked seq resolves to a real record in the payload.
    linked = {d["seq"] for d in tl["dispatch_spans"]}
    assert linked == {seq, seq2}
    # The queued->prefilling edge fed the queue-wait histogram.
    assert obs.hist["queue_wait_ms"].count == 1
    assert obs.hist["queue_wait_ms"].sum == pytest.approx(50.0)
    # dispatch_ms saw both (one per-kind series each);
    # prefill_chunk_ms only the insert.
    assert obs.hist_dispatch["insert"].count == 1
    assert obs.hist_dispatch["decode"].count == 1
    assert obs.hist["prefill_chunk_ms"].count == 1
    # Lookup also works by provisional id and bare rid.
    assert obs.timeline_json("7")["request_id"] == "ext-abc"


def test_bind_before_spans_and_unknown_rid_is_noop(ob):
    obs = ob.Observability(clock=FakeClock())
    obs.bind(99, "never-queued")  # unknown rid: no crash, no timeline
    assert obs.timeline_json("never-queued") is None
    obs.begin_span(42, "decoding")  # unknown rid: no-op
    obs.request_end(42, "finished")
    assert obs.requests_json()["requests"] == []


def test_bind_replay_folds_into_existing_timeline(ob):
    """Crash-recovery replay: the fresh rid (and its queued span) fold
    into the external id's existing timeline — one continuous story."""
    clk = FakeClock()
    obs = ob.Observability(clock=clk)
    obs.request_queued(1, 8)
    obs.bind(1, "cli-id")
    obs.begin_span(1, "decoding")
    clk.advance(0.010)
    # crash: replay resubmits under a fresh rid
    obs.request_queued(2, 8)
    obs.bind(2, "cli-id", replay=True)
    clk.advance(0.005)
    obs.begin_span(2, "decoding")
    obs.request_end(2, "finished")
    tl = obs.timeline_json("cli-id")
    assert tl["rids"] == [1, 2]
    assert tl["outcome"] == "finished"
    states = [sp["state"] for sp in tl["spans"]]
    assert states == ["queued", "decoding", "queued", "decoding"]
    assert tl["spans"][2]["note"] == "replay"
    # The rid-2 lookups now resolve to the folded timeline too.
    assert obs.timeline_json("2")["request_id"] == "cli-id"


def test_bind_id_collision_keeps_separate_timelines(ob):
    """A NON-replay bind onto an id another request owns (a client
    reusing X-Request-Id) must not merge the two: the live timeline
    keeps its state, the new request stays addressable by rid."""
    clk = FakeClock()
    obs = ob.Observability(clock=clk)
    obs.request_queued(1, 4)
    obs.bind(1, "reused-id")
    obs.begin_span(1, "decoding")
    obs.request_queued(2, 9)  # different request, same client id
    obs.bind(2, "reused-id")
    tl = obs.timeline_json("reused-id")
    assert tl["rids"] == [1] and tl["prompt_tokens"] == 4
    tl2 = obs.timeline_json("2")
    assert tl2["request_id"] == "r2" and tl2["prompt_tokens"] == 9
    obs.request_end(1, "finished")
    assert obs.timeline_json("reused-id")["outcome"] == "finished"


def test_bind_replay_rid_index_bounded(ob):
    """Folded replay rids are capped: only the most recent
    incarnations stay in the by-rid index (a crash-looping request
    cannot grow its timeline's index entries without bound)."""
    _MAX_RIDS = ob._MAX_RIDS

    obs = ob.Observability(clock=FakeClock())
    obs.request_queued(0, 4)
    obs.bind(0, "storm")
    for rid in range(1, 3 * _MAX_RIDS):
        obs.request_queued(rid, 4)
        obs.bind(rid, "storm", replay=True)
    tl = obs.timeline_json("storm")
    assert len(tl["rids"]) == _MAX_RIDS
    assert tl["rids"][-1] == 3 * _MAX_RIDS - 1
    # Aged-out rids no longer resolve; recent ones do.
    assert obs.timeline_json("0") is None
    assert obs.timeline_json(str(3 * _MAX_RIDS - 1)) is not None


def test_timeline_lru_eviction_and_dispatch_ring_bound(ob):
    obs = ob.Observability(max_timelines=4, ring=8, clock=FakeClock())
    for rid in range(10):
        obs.request_queued(rid, 4)
    assert len(obs.requests_json(64)["requests"]) == 4
    assert obs.timeline_json("r0") is None          # evicted
    assert obs.timeline_json("r9") is not None      # newest retained
    for i in range(20):
        obs.record_dispatch(kind="decode", k=1, wall_ms=1.0)
    d = obs.dispatches_json(128)["dispatches"]
    assert len(d) == 8
    assert d[-1]["seq"] == 19  # seq is ring-global, not index
    # n <= 0 returns nothing, never the whole store ([-0:] trap).
    assert obs.dispatches_json(0)["dispatches"] == []
    assert obs.requests_json(-3)["requests"] == []


def test_timeline_eviction_prefers_terminal_over_live(ob):
    """A long-running LIVE request must survive a burst of newer
    finished requests: terminal timelines evict first, so its
    request_end still lands (the finished counter never undercounts a
    request the server is actively serving)."""
    obs = ob.Observability(max_timelines=4, clock=FakeClock())
    obs.request_queued(0, 4)            # the long-running stream
    obs.begin_span(0, "decoding")
    for rid in range(1, 10):            # newer, all finished
        obs.request_queued(rid, 4)
        obs.request_end(rid, "finished")
    assert obs.timeline_json("r0") is not None   # live: kept
    obs.request_end(0, "finished")
    assert obs.timeline_json("r0")["outcome"] == "finished"
    assert obs.requests_finished_total == 10
    # All-live pathology: the hard bound still holds.
    obs2 = ob.Observability(max_timelines=3, clock=FakeClock())
    for rid in range(8):
        obs2.request_queued(rid, 4)
    assert len(obs2.requests_json(64)["requests"]) == 3


def test_slo_accounting_gauges_and_goodput(ob):
    obs = ob.Observability(slo_ttft_ms=100.0, slo_itl_ms=50.0,
                        clock=FakeClock())
    assert obs.slo_account(80.0, 40.0, tokens=10) is True
    assert obs.slo_account(150.0, 40.0, tokens=7) is False   # ttft miss
    assert obs.slo_account(80.0, 90.0, tokens=7) is False    # itl miss
    assert obs.slo_account(None, None, tokens=0) is False    # no token
    assert obs.slo_account(80.0, 40.0, tokens=9,
                           completed=False) is False         # failed
    m = obs.metrics()
    assert m["requests_slo_ok_total"] == 1
    assert m["goodput_tokens_total"] == 10
    # ttft passes rows 1,3 (the no-token row fails a configured TTFT);
    # itl passes rows 1,2,4 (no-token trivially passes ITL); the
    # completed=False row passes neither.
    assert m["slo_ttft_attainment"] == pytest.approx(2 / 5)
    assert m["slo_itl_attainment"] == pytest.approx(3 / 5)
    assert m["slo_attainment"] == pytest.approx(1 / 5)
    assert m["slo_ttft_ms"] == 100.0 and m["slo_itl_ms"] == 50.0


def test_slo_unconfigured_dimensions_always_pass(ob):
    obs = ob.Observability(clock=FakeClock())  # no SLOs set
    assert obs.slo_account(9999.0, 9999.0, tokens=5) is True
    assert obs.slo_account(None, None, tokens=3) is True
    m = obs.metrics()
    assert m["slo_attainment"] == 1.0
    assert m["goodput_tokens_total"] == 8  # == delivered tokens
    # One configured dimension scores independently of the other.
    obs2 = ob.Observability(slo_itl_ms=50.0, clock=FakeClock())
    assert obs2.slo_account(99999.0, 10.0, tokens=1) is True
    assert obs2.slo_account(None, 90.0, tokens=1) is False


def test_request_rejected_records_terminal_timeline(ob):
    """A pre-admission 504 (no batcher rid ever existed) still gets a
    terminal timeline under its external id and counts as failed, so
    the overload failure signals (/debug + requests_failed_total +
    SLO attainment) agree instead of contradicting."""
    obs = ob.Observability(clock=FakeClock())
    obs.request_rejected("overload-1", "timed out before admission")
    tl = obs.timeline_json("overload-1")
    assert tl["outcome"] == "failed" and tl["rids"] == []
    assert tl["spans"][0]["state"] == "queued"
    assert tl["spans"][0]["end_ms"] is not None
    assert obs.requests_failed_total == 1
    # Id reuse keeps the existing (richer) record — but the failure
    # still COUNTS (every 504 the client saw is a failure).
    obs.request_queued(1, 4)
    obs.bind(1, "live-id")
    obs.request_rejected("live-id", "should not clobber")
    assert obs.timeline_json("live-id")["outcome"] is None
    assert obs.requests_failed_total == 2


def test_request_kv_merge_semantics_and_timeline_field(ob):
    """Per-session KV accounting: gauge-like fields set-latest,
    ledger fields (swap bytes, evictions suffered) accumulate, and the
    merged dict rides /debug/requests/<id> as ``kv``."""
    obs = ob.Observability(clock=FakeClock())
    obs.request_queued(1, prompt_tokens=64)
    obs.bind(1, "kv-req")
    obs.request_kv(1, blocks_held=4, prefix_hit_tokens=32)
    obs.request_kv(1, evictions_suffered=2)
    obs.request_kv(1, swap_in_bytes=1000, evictions_suffered=1)
    obs.request_kv(1, blocks_held=6)       # set-latest
    obs.request_kv(1, swap_in_bytes=500)   # accumulates
    tl = obs.timeline_json("kv-req")
    assert tl["kv"] == {
        "blocks_held": 6, "prefix_hit_tokens": 32,
        "evictions_suffered": 3, "swap_in_bytes": 1500,
    }
    # Unknown rid is a no-op, never a KeyError.
    obs.request_kv(99, blocks_held=1)
    # A timeline that never saw KV traffic exposes an empty dict.
    obs.request_queued(2, prompt_tokens=8)
    obs.bind(2, "kv-none")
    assert obs.timeline_json("kv-none")["kv"] == {}


def test_observe_kv_histograms_token_block_buckets(ob):
    """prefix_hit_depth_tokens / session_kv_blocks are pow2 TOKEN and
    BLOCK histograms (not ms): 0-depth cold admissions land in the
    first bucket, the families render into the exposition."""
    obs = ob.Observability(clock=FakeClock())
    obs.observe_kv(hit_depth_tokens=0)
    obs.observe_kv(hit_depth_tokens=32)
    obs.observe_kv(session_blocks=3)
    h = obs.hist["prefix_hit_depth_tokens"]
    assert h.buckets[0] == 1.0 and h.buckets[-1] == 16384.0
    assert h.count == 2
    cum = dict(h.cumulative())
    assert cum["1"] == 1 and cum["32"] == 2
    hb = obs.hist["session_kv_blocks"]
    assert hb.buckets[-1] == 1024.0 and hb.count == 1
    lines = obs.expose_histograms("llm_")
    assert any(
        ln.startswith("llm_prefix_hit_depth_tokens_bucket")
        for ln in lines
    )
    assert "llm_session_kv_blocks_count 1" in lines


def test_trace_json_kv_track(ob):
    """KV-cache events (tier transitions, swap-ins, handoff
    export/import) render on their own named track, instant-linked to
    the owning request via their args; non-KV annotations stay on the
    dispatch track."""
    clk = FakeClock()
    obs = ob.Observability(clock=clk)
    obs.request_queued(1, prompt_tokens=32)
    clk.advance(0.01)
    obs.annotate("kv_demote", block=3, depth=2)
    obs.annotate("fault", site="step")  # non-KV control
    obs.annotate("prefix_export", blocks=2, request_id="sess-1")
    obs.record_swap_in(12.5, blocks=2)  # emits kv_swap_in
    doc = obs.trace_json()
    names = {
        e["args"]["name"] for e in doc["traceEvents"]
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    assert "kv cache" in names
    kv_tid = next(
        e["tid"] for e in doc["traceEvents"]
        if e.get("ph") == "M" and e.get("name") == "thread_name"
        and e["args"]["name"] == "kv cache"
    )
    inst = {
        e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "i"
    }
    for nm in ("kv_demote", "prefix_export", "kv_swap_in"):
        assert inst[nm]["tid"] == kv_tid, nm
    assert inst["fault"]["tid"] == 1  # non-KV stays on dispatches
    # The request link: args carry the emitter's request id.
    assert inst["prefix_export"]["args"]["request_id"] == "sess-1"
    # KV track never collides with a request track.
    req_tids = {
        e["tid"] for e in doc["traceEvents"]
        if e.get("cat") == "request"
    }
    assert kv_tid not in req_tids


def test_annotation_ring_bounded(ob):
    obs = ob.Observability(max_events=4, clock=FakeClock())
    for i in range(10):
        obs.annotate("fault_injected", site="step", kind="error", call=i)
    assert len(obs.events) == 4
    assert obs.events[-1]["fields"]["call"] == 9


def test_evict_locked_ring_pressure_no_orphans_and_decision_join(ob):
    """Timelines evicted under ring pressure
    — including LIVE ones in the pathological all-live branch — must
    leave no orphaned ``_by_rid`` entries, make every later touch of
    the evicted rid a clean no-op (no resurrection, no miscount), and
    never corrupt the decision join by request_id (the join degrades
    to decisions-only for an evicted timeline)."""
    obs = ob.Observability(max_timelines=8, clock=FakeClock())
    # 16 LIVE timelines: the terminal-preference scan finds none, so
    # the oldest live ones go — the hard-bound branch.
    for rid in range(16):
        obs.request_queued(rid, prompt_tokens=4)
        obs.bind(rid, f"req-{rid}")
    assert len(obs._timelines) == 8
    # No orphans: every rid index entry points at a timeline that is
    # still reachable under its request_id.
    for rid, tl in obs._by_rid.items():
        assert obs._timelines.get(tl.request_id) is tl
    assert obs.timeline_json("req-0") is None     # evicted
    assert obs.timeline_json("req-15") is not None
    # A dispatch naming an evicted rid neither crashes nor resurrects
    # it; spans of retained timelines still link.
    obs.record_dispatch("decode", rids=[0, 15])
    assert 0 not in obs._by_rid
    tl15 = obs.timeline_json("req-15")
    assert tl15["spans"][0]["dispatches"], "live span keeps its link"
    # request_end on the evicted rid is a clean no-op — the finished
    # counter must not move for a request /debug can no longer name.
    fin0 = obs.requests_finished_total
    obs.request_end(0, "finished")
    assert obs.requests_finished_total == fin0
    # Decision join under eviction: decisions recorded for the evicted
    # id still answer by request_id (decisions-only degradation).
    obs.decisions.record("route", request_id="req-0", replica=1)
    joined = obs.decisions.for_request("req-0")
    assert len(joined) == 1 and joined[0]["replica"] == 1
    # Terminal preference: once terminal timelines exist they are
    # evicted FIRST, keeping every live (debuggable) one resident.
    obs.request_end(8, "finished")
    obs.request_end(9, "failed", "boom")
    for rid in range(16, 18):
        obs.request_queued(rid, prompt_tokens=4)
        obs.bind(rid, f"req-{rid}")
    assert "req-8" not in obs._timelines
    assert "req-9" not in obs._timelines
    for live in (10, 11, 17):
        assert f"req-{live}" in obs._timelines
    for rid, tl in obs._by_rid.items():
        assert obs._timelines.get(tl.request_id) is tl


def test_metric_snapshot_ring_bounded_and_stamped(ob):
    obs = ob.Observability(max_snapshots=4, clock=FakeClock())
    for i in range(10):
        obs.record_metrics_snapshot({"emitted_tokens_total": i})
    snaps = obs.metric_snapshots_json()
    assert len(snaps) == 4
    assert snaps[-1]["emitted_tokens_total"] == 9
    assert "t_ms" in snaps[-1] and "unix_s" in snaps[-1]


def test_structured_logger_tail_ring(ob, capsys):
    log = ob.StructuredLogger(quiet=True, ring=3)
    for i in range(5):
        log.log("event", index=i)
    assert capsys.readouterr().out == ""  # quiet: ring only
    tail = log.tail()
    assert len(tail) == 3 and tail[-1] == "event index=4"
    assert log.tail(1) == ["event index=4"]


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace_event export schema
# ---------------------------------------------------------------------------

def test_trace_json_schema(ob):
    clk = FakeClock()
    obs = ob.Observability(clock=clk)
    obs.request_queued(1, 4)
    obs.bind(1, "req-a")
    clk.advance(0.020)
    obs.begin_span(1, "decoding")
    obs.record_dispatch(kind="decode", k=4, occupancy=1, wall_ms=3.0,
                        rids=[1])
    obs.annotate("quarantine_transition", feature="flash_attention",
                 state="quarantined")
    clk.advance(0.010)
    obs.request_end(1, "finished")

    doc = json.loads(json.dumps(obs.trace_json()))  # JSON round-trips
    evs = doc["traceEvents"]
    assert isinstance(evs, list) and evs
    assert doc["displayTimeUnit"] == "ms"
    for ev in evs:
        assert ev["ph"] in ("M", "X", "i")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert "name" in ev
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 1  # us, integer-safe
        if ev["ph"] == "i":
            assert ev["s"] == "g"
    # One metadata track for dispatches, one per request.
    meta = [e for e in evs if e["ph"] == "M"]
    names = {e["args"]["name"] for e in meta}
    assert "dispatches" in names and "req req-a" in names
    # Request lifecycle slices carry their dispatch links.
    req_slices = [e for e in evs if e.get("cat") == "request"]
    assert any(e["args"]["dispatches"] for e in req_slices)
    annos = [e for e in evs if e.get("cat") == "annotation"]
    assert annos and annos[0]["args"]["feature"] == "flash_attention"


def test_trace_json_window_filters_old_events(ob):
    clk = FakeClock()
    obs = ob.Observability(clock=clk)
    obs.record_dispatch(kind="decode", k=1, wall_ms=1.0)
    clk.advance(10.0)
    obs.record_dispatch(kind="decode", k=2, wall_ms=1.0)
    evs = obs.trace_json(window_ms=1000.0)["traceEvents"]
    dispatch = [e for e in evs if e.get("cat") == "dispatch"]
    assert len(dispatch) == 1 and dispatch[0]["args"]["seq"] == 1


# ---------------------------------------------------------------------------
# Device-time attribution: per-kind histograms, cost models, compiles
# ---------------------------------------------------------------------------

def test_per_kind_dispatch_histograms_and_utilization(ob):
    """Dispatches split into per-kind labeled dispatch_ms series; a
    dispatch carrying a cost model feeds the per-kind utilization
    window (flops/bytes over wall vs the configured peaks) and its
    record gains a roofline device-time estimate."""
    obs = ob.Observability(peak_flops=1e12, peak_bytes_per_s=1e12)
    # 1 GFLOP + 1 MB over 10 ms wall -> 10% MXU, ~0.01% HBM, and a
    # device estimate of 1 ms -> host_overhead_ratio 10.
    obs.record_dispatch(kind="decode", k=4, wall_ms=10.0,
                        program="_paged_decode_chunk",
                        flops=1e8, bytes_accessed=1e6)
    obs.record_dispatch(kind="spec", k=2, wall_ms=5.0)  # no model
    rec = list(obs.dispatches)[0]
    assert rec["program"] == "_paged_decode_chunk"
    assert rec["device_est_ms"] == pytest.approx(0.1)
    assert obs.hist_dispatch["decode"].count == 1
    assert obs.hist_dispatch["spec"].count == 1
    lines = obs.expose_histograms()
    # ONE family header, labeled series per kind.
    assert lines.count("# TYPE llm_dispatch_ms histogram") == 1
    assert any(
        ln.startswith('llm_dispatch_ms_bucket{kind="decode",le=')
        for ln in lines
    )
    assert 'llm_dispatch_ms_count{kind="spec"} 1' in lines
    util = {
        (fam, lab.get("kind")): v
        for fam, lab, v in obs.utilization_metrics()
    }
    assert util[("mxu_utilization", "decode")] == pytest.approx(0.01)
    assert util[("host_overhead_ratio", "decode")] == pytest.approx(
        100.0
    )
    # The model-less spec dispatch feeds no utilization window.
    assert ("mxu_utilization", "spec") not in util


def test_compile_recording_spans_and_counters(ob):
    """record_compile (the compile listener's sink) feeds the
    compile_ms histogram, the per-program counters, and a span on the
    trace's dedicated compile track; the trace carries the wall-clock
    anchor."""
    clk = FakeClock()
    obs = ob.Observability(clock=clk)
    clk.advance(0.100)
    obs.record_compile("_fused_chunk", 40.0)
    obs.record_compile("_fused_chunk", 10.0)
    obs.record_compile("_paged_insert", 5.0)
    assert obs.hist["compile_ms"].count == 3
    assert obs.metrics()["compiles_total"] == 3
    assert obs.compiles_by_program == {
        "_fused_chunk": 2, "_paged_insert": 1,
    }
    assert (
        "program_compiles_total", {"program": "_fused_chunk"}, 2,
    ) in obs.utilization_metrics()
    doc = obs.trace_json()
    assert doc["t0_unix_s"] > 0
    compiles = [
        e for e in doc["traceEvents"] if e.get("cat") == "compile"
    ]
    assert len(compiles) == 3
    assert compiles[0]["name"] == "compile _fused_chunk"
    assert compiles[0]["tid"] == 0  # its own track
    assert compiles[0]["dur"] == 40000  # us


# ---------------------------------------------------------------------------
# Structured logging
# ---------------------------------------------------------------------------

def test_structured_logger_json_and_text(ob, capsys):
    ob.StructuredLogger(json_mode=True).log(
        "request_failed", "nan guard", request_id="abc", rid=3,
        skipped=None,
    )
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["event"] == "request_failed"
    assert rec["message"] == "nan guard"
    assert rec["request_id"] == "abc" and rec["rid"] == 3
    assert "skipped" not in rec and "ts" in rec
    ob.StructuredLogger(json_mode=False).log(
        "serving", address="http://x", endpoints="a, b"
    )
    line = capsys.readouterr().out.strip()
    assert line.startswith("serving ") and "address=http://x" in line



# ---------------------------------------------------------------------------
# The two packages side by side
# ---------------------------------------------------------------------------

# Help texts the port rewrites because its mechanism differs: kernel builds
# (nvcc) where JAX counts XLA compiles, program keys (CUDA graphs on the
# card) where JAX counts jit-cache entries, a roofline share without the
# TPU's MXU.
PORT_HELP = {"compiles_total", "program_compiles_total", "jit_cache_entries",
             "mxu_utilization", "host_overhead_ratio"}


def test_registry_is_the_jax_packages():
    assert set(jobs.METRICS) <= set(pobs.METRICS)
    assert set(pobs.METRICS) - set(jobs.METRICS) == {
        "insert_dispatches_total", "programs_captured",
        "graph_captures_total", "graph_replays_total"}
    for name, (kind, help_text) in jobs.METRICS.items():
        assert pobs.METRICS[name][0] == kind, name
        if name not in PORT_HELP:
            assert pobs.METRICS[name][1] == help_text, name
    assert set(pobs.HISTOGRAMS) == set(jobs.HISTOGRAMS)
    assert pobs.DISPATCH_KINDS == jobs.DISPATCH_KINDS
    assert (pobs.STATES, pobs.OUTCOMES) == (jobs.STATES, jobs.OUTCOMES)


def test_peaks_are_the_h100s():
    assert pobs.DEFAULT_PEAK_FLOPS == 989.4e12
    assert pobs.DEFAULT_PEAK_BYTES_PER_S == 3.35e12


class _Clock:
    def __init__(self):
        self.t = 5.0

    def __call__(self):
        return self.t


def _scripted(mod):
    """The same timeline, dispatch and SLO events on one package's
    Observability; returns what /metrics and /debug would render."""
    clk = _Clock()
    o = mod.Observability(slo_ttft_ms=40.0, slo_itl_ms=9.0,
                          peak_flops=1e12, peak_bytes_per_s=1e11,
                          clock=clk)
    for rid in range(6):
        o.request_queued(rid, prompt_tokens=10 + rid)
        o.bind(rid, f"req-{rid}")
        clk.t += 0.003 * (rid + 1)
        o.begin_span(rid, "prefilling")
        o.record_dispatch("insert", k=1, occupancy=rid, prefill_tokens=10,
                          wall_ms=2.5 * rid, fetch_ms=0.5, rids=[rid],
                          program="p", flops=1e9, bytes_accessed=1e6)
        o.begin_span(rid, "decoding")
        for k in (1, 2, 4, 8):
            clk.t += 0.001 * k
            o.record_dispatch("decode", k=k, occupancy=3, wall_ms=0.7 * k,
                              fetch_ms=0.1, rids=[rid], program="q",
                              flops=2e8 * k, bytes_accessed=3e7 * k)
        o.observe_ttft(7.0 * rid)
        for i in range(5):
            o.observe_itl(1.5 * i + rid)
        o.slo_account(7.0 * rid, 4.0 + rid, tokens=8)
        o.request_end(rid, "finished" if rid % 3 else "failed", None)
    o.record_compile("p", 120.0)
    o.annotate("quarantine_transition", feature="paged_kernel",
               state="quarantined")
    o.decisions.record("quarantine", feature="paged_kernel")
    trace = o.trace_json()
    trace.pop("t0_unix_s")
    decisions = o.decisions.json()
    for ev in decisions["decisions"]:
        ev.pop("unix_s")
    return (o.metrics(), o.expose_histograms("llm_"),
            o.utilization_metrics(), o.requests_json(), o.dispatches_json(),
            o.timeline_json("req-4"), trace, decisions, o.events_json())


def _same_mechanism(out):
    """Drop the two strings that name the compile mechanism (the
    compile_ms help and the build track's name); everything else must
    match byte for byte."""
    metrics, hist, util, reqs, disp, tl, trace, dec, events = out
    hist = [ln for ln in hist if not ln.startswith("# HELP llm_compile_ms")]
    for ev in trace["traceEvents"]:
        if ev["ph"] == "M" and ev["tid"] == 0:
            ev["args"]["name"] = "compile track"
    return metrics, hist, util, reqs, disp, tl, trace, dec, events


def test_both_packages_render_the_same_text():
    jout = _same_mechanism(_scripted(jobs))
    pout = _same_mechanism(_scripted(pobs))
    for j, p in zip(jout, pout):
        assert p == j


def test_structured_logger_tails_and_streams_like_jax(capsys):
    import io

    outs = []
    for mod in (jobs, pobs):
        buf = io.StringIO()
        log = mod.StructuredLogger(stream=buf, ring=2)
        log.log("a", x=1)
        log.log("b", "msg", y=None, z="w")
        log.log("c")
        outs.append((buf.getvalue(), log.tail()))
    assert outs[0] == outs[1]
    assert outs[1][1] == ["b msg z=w", "c"]


# ---------------------------------------------------------------------------
# The port's analytic cost model
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=96, dim=32, n_layers=3, n_heads=4, n_kv_heads=2,
           multiple_of=16, max_seq_len=64, dtype="float32",
           param_dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny", **CFG)
    return cfg, init_params(cfg, seed=0, device="cpu")


def test_cost_model_terms_by_hand(tiny):
    cfg, params = tiny
    cm = pobs.CostModel(cfg, params)
    L, D, H, KVH, hd, F, V = 3, 32, 4, 2, 8, cfg.ffn_dim, 96
    assert cm.body_elems == L * (D * (H + 2 * KVH) * hd + H * hd * D
                                 + 3 * D * F)
    assert cm.head_elems == D * V
    assert cm.attn_flops_per_pair == 4 * hd * H * L
    assert cm.kv_bytes_per_slot == L * 2 * KVH * hd * 4
    weights = sum(t.numel() * 4 for k, t in params["layers"].items())
    weights += D * 4 + (0 if "lm_head" not in params else D * V * 4)
    if "lm_head" not in params:
        weights += V * D * 4  # the head reads the tied table
    assert cm.weight_bytes == weights
    # One row at position 5, one token: 6 attended slots.
    fl, by = cm.forward([(5, 1)], 1)
    assert fl == 2 * cm.body_elems + 2 * cm.head_elems + 6 * (4 * hd * H * L)
    assert by == cm.weight_bytes + D * 4 + 6 * cm.kv_bytes_per_slot


def _brute(cm, rows, logits):
    """(FLOPs, bytes) summed query token by query token."""
    fl = by = 0
    for p, T in rows:
        for j in range(T):
            fl += 2 * cm.body_elems + cm.attn_flops_per_pair * (p + j + 1)
        by += cm.kv_bytes_per_slot * (p + T) + cm.embed_row_bytes * T
    fl += 2 * cm.head_elems * logits
    return fl, by + cm.weight_bytes


def test_cost_model_dispatches_sum_their_forwards(tiny):
    cfg, params = tiny
    cm = pobs.CostModel(cfg, params)
    lengths = [7, 3, 12]
    # One insert forward: every prompt causally from 0, logits at each
    # row's last token.
    assert cm.insert(lengths) == _brute(cm, [(0, n) for n in lengths], 3)
    # Chunked by 4: forwards over [0,4), [4,8), [8,12).
    want = [_brute(cm, [(s, min(n, s + 4) - s) for n in lengths if n > s],
                   0) for s in (0, 4, 8)]
    got = cm.insert(lengths, chunk=4)
    assert got[0] == sum(f for f, _ in want) + 2 * cm.head_elems * 3
    assert got[1] == sum(b for _, b in want)
    # A decode chunk: row a runs 3 iterations from 10, row b 1 from 4.
    want = [_brute(cm, [(10, 1), (4, 1)], 2), _brute(cm, [(11, 1)], 1),
            _brute(cm, [(12, 1)], 1)]
    assert cm.decode([(10, 3), (4, 1)]) == (
        sum(f for f, _ in want), sum(b for _, b in want))
    # Two speculative rounds, n_draft 2, self-draft: per round 2 chain
    # passes and the verify with logits on all 3 tokens, one landing
    # pass without.
    G, rows = 2, [20, 8]
    fl = by = 0
    for r in range(2):
        blk = [(p + r, G + 1) for p in rows]
        for passes, logits in ((G, 6), (1, 0), (1, 6)):
            f, b = _brute(cm, blk, logits)
            fl, by = fl + passes * f, by + passes * b
    assert cm.spec(rows, G, 2, cm) == (fl, by)


def test_compile_listener_books_builds_onto_the_dispatch():
    assert pobs.install_compile_listener()
    assert pobs.install_compile_listener()  # idempotent
    assert _build.BUILD_LISTENERS.count(pobs._compile_listener) == 1
    o = pobs.Observability(clock=_Clock())
    for fn in list(_build.BUILD_LISTENERS):  # no sink yet: ignored
        fn("paged_decode", 1.0)
    pobs.attribute_compiles(o, "_chunk_scan")
    try:
        for fn in list(_build.BUILD_LISTENERS):
            fn("paged_decode", 1.5)
    finally:
        pobs.attribute_compiles(None, None)
    assert o.compiles_total == 1
    assert o.compiles_by_program == {"_chunk_scan": 1}
    assert o.hist["compile_ms"].sum == 1500.0


def test_ewma_detector_scores_like_jax(ob):
    """Warm-up gives no verdict; a spike scores against the baseline
    before it; the floor keeps a flat signal's noise from scoring high;
    both packages give the same z-scores."""
    with pytest.raises(ValueError):
        ob.EwmaDetector(alpha=0.0)
    d = ob.EwmaDetector(alpha=0.2, min_samples=5, floor=1.0)
    zs = [d.update(10.0 + 0.01 * (i % 3)) for i in range(8)]
    assert zs[:5] == [None] * 5 and all(abs(z) < 1.0 for z in zs[5:])
    assert d.update(40.0) > 20.0
    seq = [5.0, 7.5, 6.0, 30.0, 6.5, 6.1, 5.9, 80.0, 6.0]
    j, p = jobs.EwmaDetector(min_samples=3), pobs.EwmaDetector(min_samples=3)
    assert [j.update(x) for x in seq] == [p.update(x) for x in seq]


def test_dispatch_recorded_after_the_fact_links_into_its_start_span():
    """An insert timed on the card is recorded once a later fetch has
    passed it, after its requests moved on to decoding: with ``start_ms``
    it keeps its own start and links into the span each request was in
    when it was submitted, and its wall time feeds the prefill
    histogram and the overload hook like any other record."""
    clk = FakeClock()
    obs = pobs.Observability(clock=clk)
    fed = []
    obs.on_dispatch = fed.append
    obs.request_queued(7, prompt_tokens=12)
    clk.advance(0.050)
    obs.begin_span(7, "prefilling")
    start = obs.now_ms()
    assert start == pytest.approx(50.0)
    clk.advance(0.001)
    obs.begin_span(7, "decoding")
    clk.advance(0.030)
    seq = obs.record_dispatch(kind="insert", k=1, occupancy=1,
                              prefill_tokens=12, wall_ms=20.0, rids=[7],
                              start_ms=start)
    seq2 = obs.record_dispatch(kind="decode", k=1, occupancy=1,
                               wall_ms=31.0, rids=[7])
    obs.bind(7, "ext")
    q, pf, dec = obs.timeline_json("ext")["spans"]
    assert pf["dispatches"] == [seq] and dec["dispatches"] == [seq2]
    ins = obs.dispatches_json(8)["dispatches"][0]
    assert ins["start_ms"] == pytest.approx(50.0)
    assert ins["wall_ms"] == 20.0
    assert obs.hist["prefill_chunk_ms"].sum == 20.0
    assert [r["seq"] for r in fed] == [seq, seq2]
