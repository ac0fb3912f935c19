"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``jax_llama_tpu_torch/csrc/`` becomes one shared library
with a plain C interface, compiled for ``sm_90a`` at first use into
``jax_llama_tpu_torch/_build/`` (listed in ``.gitignore``).  The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is; the hash covers the
shared headers (``csrc/*.cuh``) too.  ``build_all`` compiles
every source at once, one ``nvcc`` process each, so a cold build takes as
long as the slowest source rather than the sum.

Each successful build is reported to ``BUILD_LISTENERS`` as (source,
seconds): ``obs.install_compile_listener`` books it onto the serving
dispatch that triggered it.  The first ``load`` of a serving kernel's
library fires its fault-injection site (``faults.fire_trace``), the moment
a failed build would surface.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

from ..faults import fire_trace

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}
# ``load`` runs on every serving loop thread of a process (one per replica
# behind a router): it loads each library, and fires its fault site, once.
_LOAD_LOCK = threading.Lock()
# The wrappers' launch counters are read-modify-writes shared by those
# threads; each wrapper updates its counts under this lock, on the object
# ``counts`` returns.
COUNT_LOCK = threading.Lock()
# Per thread: the launch counts a CUDA graph capture records in place of
# the wrappers' own (``record_counts``).
_COUNT_TLS = threading.local()
# Called as fn(source, seconds) after each successful build.
BUILD_LISTENERS: List[Callable[[str, float], None]] = []


class CountRecord:
    """The launch counts one wrapper made while a CUDA graph was being
    captured on this thread: a capture enqueues no kernel, so its counts
    are kept apart and added to the wrapper on each replay
    (``add_counts``), the launches that replay runs."""

    INTS = ("launches", "kernel_launches", "launches_int8")
    DICTS = ("launches_by_t", "launches_by_instance")

    def __init__(self, wrapper):
        self.wrapper = wrapper
        for name in self.INTS:
            setattr(self, name, 0)
        for name in self.DICTS:
            setattr(self, name, {})

    @property
    def kernels(self) -> int:
        """The kernels these launches ran (``kernel_launches`` where the
        wrapper counts them apart from its calls, else ``launches``)."""
        if hasattr(self.wrapper, "kernel_launches"):
            return self.kernel_launches
        return self.launches


def counts(wrapper):
    """The object ``wrapper``'s launch counts go to (call under
    ``COUNT_LOCK``): the wrapper itself, or, while this thread captures a
    CUDA graph, the capture's ``CountRecord`` of it."""
    record = getattr(_COUNT_TLS, "record", None)
    if record is None:
        return wrapper
    rec = record.get(id(wrapper))
    if rec is None:
        rec = record[id(wrapper)] = CountRecord(wrapper)
    return rec


@contextlib.contextmanager
def record_counts():
    """Route this thread's launch counts into a fresh ``{id: CountRecord}``
    (yielded) for the duration: a graph capture's counts."""
    record: Dict[int, CountRecord] = {}
    _COUNT_TLS.record = record
    try:
        yield record
    finally:
        _COUNT_TLS.record = None


def add_counts(records: Iterable[CountRecord]) -> None:
    """Add recorded counts to their wrappers (one replay's launches)."""
    with COUNT_LOCK:
        for rec in records:
            w = rec.wrapper
            for name in CountRecord.INTS:
                if hasattr(w, name):
                    setattr(w, name, getattr(w, name) + getattr(rec, name))
            for name in CountRecord.DICTS:
                if hasattr(w, name):
                    by = getattr(w, name)
                    for k, n in getattr(rec, name).items():
                        by[k] = by.get(k, 0) + n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built on this machine"
    )


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` (default: every source there) whose
    library does not exist yet, one ``nvcc`` per source, all started
    together; return each library's path.  The compiler's output goes
    beside the library as ``.log``; a failed build raises with that
    output."""
    names = (sorted(p.stem for p in CSRC_DIR.glob("*.cu")) if names is None
             else list(names))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        if library_path(name).exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in started.items():
        log = proc.communicate()[0]
        # From its start until its compiler was seen to exit (exact for a
        # single source; the builds run together, and are waited on in
        # order).
        seconds = time.perf_counter() - t0
        out = library_path(name)
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
            for fn in list(BUILD_LISTENERS):
                fn(name, seconds)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library's path."""
    return build_all([name])[name]


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``csrc/<name>.cu``, or '' if it was not
    built in this checkout."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process);
    the first load of a serving kernel fires its fault-injection site."""
    with _LOAD_LOCK:
        if name not in _LOADED:
            # kernels imports this module: its table is read at call time.
            from .kernels import fault_site_of_source

            site = fault_site_of_source(name)
            if site is not None:
                fire_trace(site)
            _LOADED[name] = ctypes.CDLL(str(build(name)))
        return _LOADED[name]


def loaded() -> Dict[str, int]:
    """{source: 1 if its library is loaded in this process, else 0} for
    every source under ``csrc/``."""
    return {p.stem: int(p.stem in _LOADED)
            for p in sorted(CSRC_DIR.glob("*.cu"))}
