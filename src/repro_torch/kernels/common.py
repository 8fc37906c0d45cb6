"""Launch counts and the ``nvcc`` build shared by the port's kernels.

Every kernel wrapper calls ``count_launch`` right after its kernel was
launched (and nowhere else), so a run can show which kernels the main
path went through: set the counts to zero with ``reset_launches``, run,
read ``LAUNCHES``.  ``LAST_SHAPES`` keeps the input shapes of each
kernel's latest launch, so a measurement can replay the main path's
shapes.

CUDA C++ kernels are compiled on first use, from the sources under
``csrc/``, by ``nvcc`` into a shared library with a plain C interface
(loaded with ``ctypes``) under ``.torch_ext_build/`` at the root of the
checkout.  The library's name carries a hash of its source and flags, so
an edited source is rebuilt and never loaded stale.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

LAUNCHES: collections.Counter = collections.Counter()
LAST_SHAPES: dict = {}
# seconds spent in nvcc by this process, per source (0 when cached)
BUILD_SECONDS: dict = {}

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".torch_ext_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def count_launch(name: str, *shapes) -> None:
    LAUNCHES[name] += 1
    LAST_SHAPES[name] = tuple(tuple(s) for s in shapes)


def reset_launches() -> None:
    LAUNCHES.clear()
    LAST_SHAPES.clear()


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


@functools.cache
def load_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` (once per content hash) and load it."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
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
    else:
        BUILD_SECONDS.setdefault(source, 0.0)
    return ctypes.CDLL(str(out))
