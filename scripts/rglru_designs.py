#!/usr/bin/env python3
"""Times the RG-LRU scan's designs on one NVIDIA GPU, in one process.

    python3 scripts/rglru_designs.py [--shape B T D]

  * ``one_pass``, the kernel (``src/repro_torch/kernels/csrc/rglru_scan.cu``):
    a block of 128 threads owns (batch, 32 channels) and walks T in
    segments of 128 steps (16 runs of 8), carrying h between them; 12
    bytes an element;
  * ``two_pass``, the design not kept: one launch writes every segment's
    pair (prod a, its h from 0) per channel in f64, a second walks the
    earlier segments' pairs to its carry-in and replays its segment as
    the kernel does; every (segment, channel tile) is a block of its own;
    20 bytes an element;
  * the kernel's source with other block shapes (``VARIANTS``: threads a
    block, float4 groups a time row, steps a run, the blocks an SM that
    ``__launch_bounds__`` asks for), made by exact text edits of the
    source that must follow its text.

The two-launch source below includes the kernel's source, so both share
its loads, tiles and constants.  Every design is held to the plain
version at atol 1e-5 + rtol 1e-5 and timed by CUDA events over
back-to-back calls; the kernel is timed first and last.  Prints one JSON
object with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TWO_PASS = r"""
#include "rglru_scan.cu"

namespace {

// One segment of one channel tile: the runs' pairs in shared memory.
template <bool kVec>
__device__ void run_pairs(const float* a, const float* b, size_t row0,
                          int t0, int ch, int T, int D, float4* av,
                          float4* bv, double (*A_s)[kTile],
                          double (*H_s)[kTile]) {
  const int g = threadIdx.x % kGroups, r = threadIdx.x / kGroups;
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const int t = t0 + j;
    if (t < T) {
      const size_t o = (row0 + t) * D + ch;
      av[j] = load4<kVec>(a + o, ch, D, 1.f);
      bv[j] = load4<kVec>(b + o, ch, D, 0.f);
    } else {
      av[j] = make_float4(1.f, 1.f, 1.f, 1.f);
      bv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    double A = 1.0, H = 0.0;
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const double aj = at(av[j], c);
      A *= aj;
      H = fma(aj, H, (double)at(bv[j], c));
    }
    A_s[r][4 * g + c] = A;
    H_s[r][4 * g + c] = H;
  }
}

// grid (channel tiles, segments, B): each segment's pair per channel
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
seg_pairs(const float* __restrict__ a, const float* __restrict__ b,
          double* __restrict__ A_out, double* __restrict__ H_out, int T,
          int D) {
  __shared__ double A_s[kRuns][kTile];
  __shared__ double H_s[kRuns][kTile];
  const int tid = threadIdx.x, ch0 = blockIdx.x * kTile;
  const int r = tid / kGroups, ch = ch0 + 4 * (tid % kGroups);
  float4 av[kL], bv[kL];
  run_pairs<kVec>(a, b, (size_t)blockIdx.z * T, blockIdx.y * kSeg + r * kL,
                  ch, T, D, av, bv, A_s, H_s);
  __syncthreads();
  if (tid < kTile && ch0 + tid < D) {
    double A = 1.0, H = 0.0;
    for (int q = 0; q < kRuns; ++q) {
      H = fma(A_s[q][tid], H, H_s[q][tid]);
      A *= A_s[q][tid];
    }
    const size_t o = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * D
                     + ch0 + tid;
    A_out[o] = A;
    H_out[o] = H;
  }
}

// grid (channel tiles, segments, B): carry-in from the earlier segments'
// pairs, then the kernel's segment body
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
seg_replay(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ h0, const double* __restrict__ A_in,
           const double* __restrict__ H_in, float* __restrict__ y,
           float* __restrict__ h_last, int T, int D) {
  __shared__ double A_s[kRuns][kTile];
  __shared__ double H_s[kRuns][kTile];
  __shared__ __align__(16) float cin_s[kRuns][kTile];
  const int tid = threadIdx.x, ch0 = blockIdx.x * kTile;
  const int g = tid % kGroups, r = tid / kGroups, ch = ch0 + 4 * g;
  const int bi = blockIdx.z;
  const size_t row0 = (size_t)bi * T;
  const int t0 = blockIdx.y * kSeg + r * kL;
  float4 av[kL], bv[kL];
  run_pairs<kVec>(a, b, row0, t0, ch, T, D, av, bv, A_s, H_s);
  __syncthreads();
  if (tid < kTile) {
    double h = ch0 + tid < D ? h0[(size_t)bi * D + ch0 + tid] : 0.0;
    for (int s = 0; s < (int)blockIdx.y; ++s) {
      const size_t o = ((size_t)bi * gridDim.y + s) * D + ch0 + tid;
      if (ch0 + tid < D) h = fma(A_in[o], h, H_in[o]);
    }
    for (int q = 0; q < kRuns; ++q) {
      cin_s[q][tid] = (float)h;
      h = fma(A_s[q][tid], h, H_s[q][tid]);
    }
  }
  __syncthreads();
  float4 h = *reinterpret_cast<const float4*>(&cin_s[r][4 * g]);
#pragma unroll
  for (int j = 0; j < kL; ++j) {
    const int t = t0 + j;
    h.x = fmaf(av[j].x, h.x, bv[j].x);
    h.y = fmaf(av[j].y, h.y, bv[j].y);
    h.z = fmaf(av[j].z, h.z, bv[j].z);
    h.w = fmaf(av[j].w, h.w, bv[j].w);
    if (t < T) store4<kVec>(y + (row0 + t) * D + ch, ch, D, h);
    if (t == T - 1) store4<false>(h_last + (size_t)bi * D + ch, ch, D, h);
  }
}

}  // namespace

extern "C" int two_pass_segments(int T) { return (T + kSeg - 1) / kSeg; }

// pairs: 2 * B * two_pass_segments(T) * D doubles of scratch.  D % 4 == 0
// and 16-byte aligned pointers only.
extern "C" int two_pass_launch(const void* a, const void* b, const void* h0,
                               void* y, void* h_last, void* pairs, int B,
                               int T, int D, void* stream) {
  const int nseg = (T + kSeg - 1) / kSeg;
  const dim3 grid((D + kTile - 1) / kTile, nseg, B);
  const cudaStream_t st = (cudaStream_t)stream;
  double* A = (double*)pairs;
  double* H = A + (size_t)B * nseg * D;
  seg_pairs<true><<<grid, kThreads, 0, st>>>((const float*)a,
                                             (const float*)b, A, H, T, D);
  seg_replay<true><<<grid, kThreads, 0, st>>>(
      (const float*)a, (const float*)b, (const float*)h0, A, H, (float*)y,
      (float*)h_last, T, D);
  return (int)cudaGetLastError();
}
"""


# (threads a block, float4 groups a time row, steps a run, blocks an SM
# for __launch_bounds__); the kernel's own is (128, 8, 8, 4)
VARIANTS = [(128, 4, 8, 4), (256, 16, 8, 2), (128, 8, 8, 3), (64, 8, 8, 8),
            (128, 16, 8, 4), (256, 8, 4, 4), (128, 8, 6, 5), (256, 16, 4, 4)]
KEPT = ("constexpr int kThreads = 128;", "constexpr int kGroups = 8; ",
        "constexpr int kL = 8; ", "__launch_bounds__(kThreads, 4)")


def variant_source(threads, groups, run, blocks):
    from repro_torch.kernels import common
    src = (common.CSRC / "rglru_scan.cu").read_text()
    new = (f"constexpr int kThreads = {threads};",
           f"constexpr int kGroups = {groups}; ", f"constexpr int kL = {run}; ",
           f"__launch_bounds__(kThreads, {blocks})")
    for old, rep_ in zip(KEPT, new):
        if src.count(old) != 1:
            raise RuntimeError(f"rglru_scan.cu no longer holds {old!r} once")
        src = src.replace(old, rep_)
    return src


def build(name, source):
    """Compiles ``source`` (it may include the kernel's source) into a
    library of its own under the build directory and loads it."""
    from repro_torch.kernels import common
    tag = hashlib.sha256(source.encode() + (common.CSRC / "rglru_scan.cu")
                         .read_bytes()).hexdigest()[:16]
    out = common.BUILD_DIR / f"rglru_{name}-{tag}.so"
    if not out.exists():
        common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = out.with_suffix(".cu")
        cu.write_text(source)
        proc = subprocess.run([common._nvcc(), *common.NVCC_FLAGS,
                               "-I", str(common.CSRC), "-o", str(out),
                               str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        regs = [line.split(":", 1)[1].strip() for line in
                proc.stderr.splitlines() if "registers" in line]
        print(f"ptxas, {name}: {regs}", flush=True)
    return ctypes.CDLL(str(out))


def launcher(fn, pointers, ints):
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_cuda
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=(4, 3072, 2560))
    B, T, D = ap.parse_args().shape
    if not torch.cuda.is_available():
        print("rglru_designs: no CUDA device", file=sys.stderr)
        return 2
    if D % 4:
        print("rglru_designs: the two-launch design takes D % 4 == 0",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    a, b, h0 = cs.rglru_inputs(torch, B, T, D, 94, dev)
    stream = torch.cuda.current_stream().cuda_stream
    two = build("two_pass", TWO_PASS)
    nseg = two.two_pass_segments(T)
    pairs = torch.empty(2 * B * nseg * D, dtype=torch.float64, device=dev)

    def call(fn, pre=(), post=()):
        def run():
            y, h_last = torch.empty_like(a), torch.empty_like(h0)
            err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
                     h_last.data_ptr(), *pre, B, T, D, *post, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            return y, h_last
        return run

    designs = {"one_pass": lambda: rglru_cuda(a, b, h0),
               "two_pass": call(launcher(two.two_pass_launch, 6, 3),
                                (pairs.data_ptr(),))}
    for v in VARIANTS:
        name = "one_pass_%d_%d_%d_%d" % v
        lib = build(name, variant_source(*v))
        designs[name] = call(launcher(lib.rglru_launch, 5, 4),
                             post=(dev.index or 0,))
    want, want_last = ref.rglru_ref(a, b, h0)
    out = {}
    for name, fn in designs.items():
        y, h_last = fn()
        torch.cuda.synchronize()
        for got, ref_out in ((y, want), (h_last, want_last)):
            err = (got - ref_out).abs()
            cs.require(bool((err <= 1e-5 + 1e-5 * ref_out.abs()).all()),
                       f"{name}: max abs err {float(err.max()):.3g}")
        out[name] = {"max_abs_err": float((y - want).abs().max()), "ms": []}
    for name in [*designs, "one_pass"]:
        out[name]["ms"].append(cs.time_ms(torch, designs[name]))
    from repro_torch.roofline import HBM_BW
    out["bound_ms"] = {f"{k} ({v} B an element)":
                       v * B * T * D / HBM_BW * 1e3
                       for k, v in (("one_pass", 12), ("two_pass", 20))}
    out["shape"] = [B, T, D]
    out["card"] = cs.smi()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
