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

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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
# Called as fn(source, seconds) after each successful build.
BUILD_LISTENERS: List[Callable[[str, float], None]] = []


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
