"""Launch counts and the ``nvcc`` build shared by the port's kernels.

Every kernel wrapper calls ``count_launch`` right after its kernel was
launched (and nowhere else), so a run can show which kernels the main
path went through: set the counts to zero with ``reset_launches``, run,
read ``LAUNCHES``.  ``LAST_SHAPES`` keeps the input shapes of each
kernel's latest launch (for ``attention`` also its ``(causal, window)``),
and ``SHAPES`` counts each kernel's launches at every distinct one since
the reset, so a measurement or a check can replay the main path's shapes
and read how often each ran.

CUDA C++ kernels are compiled on first use, from the sources under
``csrc/``, by ``nvcc`` into a shared library with a plain C interface
(loaded with ``ctypes``) under ``.torch_ext_build/`` at the root of the
checkout.  The library's name carries a hash of its source, of every
header it includes from ``csrc/`` and of the flags, so an edited source
or header is rebuilt and never loaded stale.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

LAUNCHES: collections.Counter = collections.Counter()
LAST_SHAPES: dict = {}
SHAPES: collections.defaultdict = collections.defaultdict(
    collections.Counter)
# seconds spent in nvcc by this process, per source (0 when cached), and
# ptxas's report of each kernel's registers, spills and shared memory
BUILD_SECONDS: dict = {}
BUILD_LOGS: dict = {}

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".torch_ext_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def count_launch(name: str, *shapes) -> None:
    LAUNCHES[name] += 1
    LAST_SHAPES[name] = tuple(tuple(s) for s in shapes)
    SHAPES[name][LAST_SHAPES[name]] += 1


def reset_launches() -> None:
    LAUNCHES.clear()
    LAST_SHAPES.clear()
    SHAPES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the GPU")
    return found


def _sources(src: Path, seen: list) -> list:
    """``src`` and, depth first, every ``#include "..."`` of it that lies
    in ``csrc/``, each once."""
    seen.append(src)
    for name in re.findall(r'^\s*#include\s+"([^"]+)"', src.read_text(),
                           re.MULTILINE):
        dep = CSRC / name
        if dep.exists() and dep not in seen:
            _sources(dep, seen)
    return seen


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` (once per content hash of it and its
    headers) and load it."""
    src = CSRC / source
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in
                                     _sources(src, []))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{src.stem}-{digest[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_SECONDS[source] = time.perf_counter() - t0
        BUILD_LOGS[source] = proc.stderr
    else:
        BUILD_SECONDS.setdefault(source, 0.0)
    return ctypes.CDLL(str(out))
