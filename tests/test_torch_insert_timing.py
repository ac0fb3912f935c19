"""The decode record after a classic insert carries none of the insert's
time (ROADMAP Queue C2).

On the card the port enqueues a classic insert without a fetch and times
it between CUDA events; the next decode chunk's fetch waits for it, so
that chunk's host wall holds the insert's device time too.  The batcher
starts such a record at the insert's end event.  Here, on the CPU, the
events are stand-ins whose device times are scripted, the host clock is
scripted through the serving module's ``time``, and the chunk scan
advances that clock by the wall the card would show: the insert's X ms
plus the chunk's own W ms (the batcher's timer and fetch mark, which
make events on the card only, make stand-ins here).  The record the overload controller receives
must read W, and its decode-rate EWMA must be what it is without the
insert.  Without stand-ins nothing is left unsettled on the CPU, so the
records there are the host's clock, as before.
"""

import time

import numpy as np
import pytest

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import serving as pserving
from jax_llama_tpu_torch.overload import OverloadController

CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")
W_MS = 40.0      # one decode chunk on the device
X_MS = 240.0     # one classic insert on the device (an 8-row, 1024-token one)


class _Clock:
    """The serving module's ``time`` with a scripted ``monotonic``."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


class _Device:
    """A device timeline: each recorded stand-in event takes the next
    scripted time."""

    def __init__(self):
        self.t = 0.0


class _Event:
    def __init__(self, device):
        self.device = device
        self.t = None

    def record(self):
        self.t = self.device.t

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture(scope="module")
def params():
    cfg = ptl.get_config("tiny", **CFG)
    return ptl.init_params(cfg, seed=0, device="cpu"), cfg


def _run(params, monkeypatch, scripted: bool):
    """Serve one request through classic admission, then admit a second
    while the first decodes.  ``scripted``: the inserts are timed by
    stand-in events as on the card.  Returns the dispatch records and
    the controller the batcher fed."""
    pp, cfg = params
    clock, dev = _Clock(), _Device()
    monkeypatch.setattr(pserving, "time", clock)
    real_scan = pserving._chunk_scan

    def scan(*a, **kw):
        # The chunk's fetch waits for every insert still running: on the
        # device the insert ends X ms after this chunk was enqueued, and
        # the chunk W ms after that.
        pending = bool(cb._unsettled)
        out = real_scan(*a, **kw)
        clock.t += ((X_MS if pending else 0.0) + W_MS) / 1000.0
        dev.t += (X_MS if pending else 0.0) + W_MS
        return out

    monkeypatch.setattr(pserving, "_chunk_scan", scan)
    cb = ptl.ContinuousBatcher(pp, cfg, n_slots=2, max_len=64,
                               block_size=16, decode_chunk=4,
                               device="cpu")
    assert cb.prefill_budget == 0  # classic admission
    if scripted:
        def start_timer():
            ev0 = _Event(dev)
            ev0.record()
            return clock.monotonic(), cb.obs.now_ms(), ev0

        real_record = cb._record_timed

        def record_timed(timer, rec):
            # The insert occupies the device for X ms from its start.
            dev.t += X_MS
            real_record(timer, rec)
            dev.t -= X_MS  # the chunk that waits for it adds it back

        def fetch_mark():
            # The batcher's own marks an unsettled insert's fetch on the
            # card only.
            if not cb._unsettled:
                return None
            ev = _Event(dev)
            ev.record()
            return ev

        monkeypatch.setattr(cb, "_start_timer", start_timer)
        monkeypatch.setattr(cb, "_record_timed", record_timed)
        monkeypatch.setattr(cb, "_fetch_mark", fetch_mark)
        monkeypatch.setattr(pserving, "_timing_event", lambda: _Event(dev))
    else:
        def no_event():
            raise AssertionError("no event is made on the CPU")

        monkeypatch.setattr(pserving, "_timing_event", no_event)
    oc = OverloadController()
    cb.obs.on_dispatch = oc.on_dispatch
    rng = np.random.RandomState(0)
    cb.submit(rng.randint(1, 128, size=9).tolist(), max_new_tokens=24)
    cb.step()
    cb.step()
    cb.submit(rng.randint(1, 128, size=7).tolist(), max_new_tokens=6)
    while cb.pending():
        cb.step()
    return cb.obs.dispatches_json(512)["dispatches"], oc


def test_decode_record_after_classic_insert_carries_none_of_it(
        params, monkeypatch):
    recs, oc = _run(params, monkeypatch, scripted=True)
    kinds = [r["kind"] for r in recs]
    inserts = [r for r in recs if r["kind"] == "insert"]
    decodes = [r for r in recs if r["kind"] == "decode"]
    assert len(inserts) == 2 and len(decodes) >= 4
    # The inserts carry their device time...
    assert [r["wall_ms"] for r in inserts] == [X_MS, X_MS]
    # ...and every decode record, the ones right after an insert too,
    # carries W alone, where its host wall was W + X.
    after = [recs[i + 1] for i, k in enumerate(kinds) if k == "insert"]
    assert all(r["kind"] == "decode" for r in after)
    assert all(r["wall_ms"] == pytest.approx(W_MS) for r in decodes)
    # The controller's decode rate, after every record, is the one the
    # decode records give with no insert at all: a controller fed the
    # same records, each at the steady wall W.  The host wall (what the
    # record read before the repair) dips it right after each insert.
    def trajectory(wall_of):
        c = OverloadController()
        rates = []
        for r in decodes:
            c.on_dispatch(dict(r, wall_ms=wall_of(r)))
            rates.append(c._decode_tps)
        return rates

    steady = trajectory(lambda r: W_MS)
    dipped = trajectory(lambda r: W_MS + (X_MS if r in after else 0.0))
    assert oc._decode_tps == pytest.approx(steady[-1], rel=1e-12)
    assert trajectory(lambda r: r["wall_ms"]) == pytest.approx(steady,
                                                               rel=1e-12)
    for i, r in enumerate(decodes):
        if r in after and i > 0:
            assert dipped[i] < 0.9 * steady[i]


def test_cpu_records_unchanged_without_events(params, monkeypatch):
    """On the CPU an insert is recorded as it is called, nothing stays
    unsettled, and no event is made: every record is the host's clock."""
    recs, _ = _run(params, monkeypatch, scripted=False)
    inserts = [r for r in recs if r["kind"] == "insert"]
    decodes = [r for r in recs if r["kind"] == "decode"]
    assert len(inserts) == 2
    assert all(r["wall_ms"] == 0.0 for r in inserts)
    assert all(r["wall_ms"] == pytest.approx(W_MS) for r in decodes)
