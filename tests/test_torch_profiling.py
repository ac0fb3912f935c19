"""The port's profiling utilities (``jax_llama_tpu_torch/utils/profiling.py``)
held against tests/test_profiling.py's cases and JAX's own functions:
``Timer``, ``DecodeStats``, ``trace`` writing a capture,
``normalize_program_name`` on JAX's spellings and the port's dispatch
labels; ``summarize_trace`` on a CPU capture of batcher dispatches made
on the thread that started the session (as the server's loop runs them),
on a synthetic trace with kernels (the correlation join that gives
device ms), and on a directory with no capture; one session per process.
The module imports with ``jax`` and ``jax_llama_tpu`` blocked."""

import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu.utils import profiling as jprof

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.utils import DecodeStats, Timer, trace
from jax_llama_tpu_torch.utils import profiling as pprof

CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")

# JAX's own cases (tests/test_profiling.py) and the port's labels.
NAMES = ["PjitFunction(_paged_decode_chunk)", "jit__fused_chunk",
         "jit_myprog.3", "%fusion.12", "Thread dispatch", "",
         *pprof.PROGRAMS, "aten::mm", "cudaLaunchKernel",
         "_paged_decode_chunk_extra"]


def test_profiling_imports_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jax_llama_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import jax_llama_tpu_torch.utils.profiling as p\n"
        "import jax_llama_tpu_torch.server as s\n"
        "assert p.summarize_trace and p.trace and s.LLMServer\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'jax_llama_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_timer_measures_work():
    x = torch.randn(256, 256)
    with Timer() as t:
        y = x
        for _ in range(4):
            y = y @ x
    assert t.elapsed_s > 0


def test_decode_stats_math_matches_jax():
    kw = dict(batch=8, prompt_len=128, new_tokens=100, prefill_s=0.5,
              decode_s=2.0, n_devices=4)
    s, j = DecodeStats(**kw), jprof.DecodeStats(**kw)
    assert s.decode_tokens_per_s == 8 * 100 / 2.0
    assert s.decode_tokens_per_s_per_chip == 8 * 100 / 2.0 / 4
    assert s.per_token_latency_ms == 20.0
    assert s.summary() == j.summary() and "tok/s/chip" in s.summary()


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        (torch.ones((8, 8)) * 2).sum()
    found = [f for _, _, fs in os.walk(d) for f in fs
             if f.endswith(pprof.TRACE_SUFFIX)]
    assert len(found) == 1
    with open(os.path.join(d, found[0])) as f:
        assert json.load(f)["traceEvents"]


def test_trace_stops_and_writes_when_the_body_raises(tmp_path):
    d = str(tmp_path / "raised")
    with pytest.raises(KeyError):
        with trace(d):
            raise KeyError("body")
    assert any(f.endswith(pprof.TRACE_SUFFIX)
               for _, _, fs in os.walk(d) for f in fs)
    with trace(str(tmp_path / "after")):  # the claim was released
        pass


@pytest.mark.parametrize("name", NAMES)
def test_normalize_program_name(name):
    """JAX's spellings map as JAX maps them; a port dispatch label is its
    own program; an aten op, a runtime call and a near miss are None."""
    got = pprof.normalize_program_name(name)
    if name in pprof.PROGRAMS:
        assert got == name
    elif name.startswith(("PjitFunction(", "jit_")):
        assert got == jprof.normalize_program_name(name) is not None
    else:
        assert got is None
        if name in ("%fusion.12", "Thread dispatch", ""):
            assert jprof.normalize_program_name(name) is None


def test_programs_are_jax_serving_programs():
    from jax_llama_tpu import serving as jserving

    assert set(pprof.PROGRAMS) == set(jserving._programs())
    with pytest.raises(ValueError):
        pprof.program_range("_chunk_scan")


def test_summarize_trace_missing_capture_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        pprof.summarize_trace(str(tmp_path))


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    return (ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu"),
            ptl.get_config("tiny", **CFG))


def _serve_on(thread_name, cb, session=None):
    """Run ``cb`` to completion on a thread of its own (as the server's
    loop does), starting and stopping ``session`` there when given."""
    done = {}

    def run():
        if session is not None:
            session.start()
        cb.submit([3, 4, 5, 6], max_new_tokens=6)
        cb.submit(list(range(7, 30)), max_new_tokens=4)
        done["out"] = cb.run_to_completion()
        if session is not None:
            session.stop()

    t = threading.Thread(target=run, name=thread_name)
    t.start()
    t.join(120)
    return done["out"]


def test_summarize_trace_attributes_loop_thread_dispatches(model, tmp_path):
    """A session started and stopped on the thread that runs the batcher
    (exported on another) attributes its decode chunks to
    ``_paged_decode_chunk`` and its insert to ``_paged_insert``, host ms >
    0 and device ms 0 on the CPU; a session started on another thread
    sees none of the loop's ranges, which is why the server starts its
    sessions on the loop."""
    pp, cfg = model
    session = pprof.ProfilerSession("test")
    cb = ptl.ContinuousBatcher(pp, cfg, n_slots=2, max_len=64,
                               decode_chunk=4, device="cpu")
    _serve_on("loop", cb, session)
    session.export(str(tmp_path / "loop"))
    summary = pprof.summarize_trace(str(tmp_path / "loop"))
    progs = summary["programs"]
    assert {"_paged_decode_chunk", "_paged_insert",
            "_scatter_rows"} <= set(progs)
    assert set(progs) <= set(pprof.PROGRAMS)
    assert progs["_paged_decode_chunk"]["host_ms"] > 0
    assert progs["_paged_insert"]["host_ms"] > 0
    assert summary["total_device_ms"] == 0
    assert summary["total_host_ms"] == pytest.approx(
        sum(p["host_ms"] for p in progs.values()), abs=1e-2)

    other = tmp_path / "other"
    cb = ptl.ContinuousBatcher(pp, cfg, n_slots=2, max_len=64,
                               decode_chunk=4, device="cpu")
    with trace(str(other)):
        _serve_on("elsewhere", cb)
    assert pprof.summarize_trace(str(other))["programs"] == {}


def _event(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid, "args": args}


def test_summarize_trace_joins_kernels_to_their_launching_range(tmp_path):
    """Device ms: a kernel belongs to the innermost range of the launching
    thread that holds its runtime launch (correlation id); a kernel
    launched outside every range, or from another thread, counts nowhere.
    The result is JAX's shape with the capture's path under ``trace``."""
    events = [
        _event("_paged_decode_chunk", "user_annotation", 100, 50),
        _event("_paged_insert", "user_annotation", 200, 40),
        _event("_release_blocks", "user_annotation", 210, 5),
        _event("aten::mm", "cpu_op", 101, 3),
        _event("cudaLaunchKernel", "cuda_runtime", 102, 1, correlation=1),
        _event("cudaLaunchKernel", "cuda_runtime", 120, 1, correlation=2),
        _event("cudaLaunchKernel", "cuda_runtime", 211, 1, correlation=3),
        _event("cudaLaunchKernel", "cuda_runtime", 230, 1, correlation=4),
        _event("cudaLaunchKernel", "cuda_runtime", 300, 1, correlation=5),
        _event("cudaLaunchKernel", "cuda_runtime", 105, 1, tid=2,
               correlation=6),
        # the ranges' mirrors on the GPU timeline are not host ranges
        _event("_paged_insert", "gpu_user_annotation", 400, 99, tid=9),
    ] + [_event(f"k{c}", "kernel", 500 + 10 * c, dur, tid=9, correlation=c)
         for c, dur in ((1, 2.0), (2, 3.0), (3, 4.0), (4, 5.0), (5, 6.0),
                        (6, 7.0))]
    (tmp_path / "x.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    summary = pprof.summarize_trace(str(tmp_path))
    assert summary == {
        "trace": str(tmp_path / "x.pt.trace.json"),
        "programs": {
            "_paged_decode_chunk": {"device_ms": 0.005, "host_ms": 0.05},
            "_paged_insert": {"device_ms": 0.005, "host_ms": 0.04},
            "_release_blocks": {"device_ms": 0.004, "host_ms": 0.005},
        },
        "total_device_ms": 0.014,
        "total_host_ms": 0.095,
    }


def test_one_profiler_session_per_process(tmp_path):
    first = pprof.ProfilerSession("first")
    first.start()
    try:
        with pytest.raises(RuntimeError, match="already active.*first"):
            pprof.ProfilerSession("second").start()
        with pytest.raises(RuntimeError, match="already active"):
            with trace(str(tmp_path / "nested")):
                pass
    finally:
        first.stop()
        first.stop()  # idempotent
        first.export(str(tmp_path / "first"))
    assert pprof.device_op_times(lambda: torch.ones(4).sum()) == {}
    with pytest.raises(ValueError):
        pprof.device_op_times(lambda: None, by="source")
