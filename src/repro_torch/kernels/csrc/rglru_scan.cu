// RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py
// (rglru_pallas, body _rglru_kernel).  a, b [B, T, D] f32 and h0 [B, D]
// f32 give h [B, T, D] f32 and h_T [B, D] f32.
//
// Design.  The TPU kernel walked (channel block, time chunk) tiles in a
// sequential grid and carried h in VMEM scratch.  Here one thread owns
// one (batch, channel) pair and walks all T steps itself, with h in a
// register: neighbouring threads take neighbouring channels, so every
// step's loads and stores are coalesced.  The product and the sum are
// rounded separately (no fused multiply-add), as the plain version
// computes them, so the kernel gives the plain version's bits.
//
// What bounds it on an H100: bytes.  Each element of a and b is read
// once and each h written once (12 bytes per element, no reuse), so at
// the recurrentgemma-2b prefill shape [4, 3072, 2560] it moves 377 MB:
// 0.11 ms at 3.35 TB/s.  Only B * D threads exist (10,240 there), so
// the loop is latency-bound long before that: the unrolled loop issues
// several steps' loads ahead of the dependent chain of h.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ y,
             float* __restrict__ h_last, int B, int T, int D) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= B * D) return;
  const int bi = idx / D, d = idx - bi * D;
  const size_t base = (size_t)bi * T * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* yp = y + base;
  float h = h0[idx];
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const size_t o = (size_t)t * D;
    h = __fadd_rn(__fmul_rn(ap[o], h), bp[o]);
    yp[o] = h;
  }
  h_last[idx] = h;
}

}  // namespace

extern "C" int rglru_launch(const void* a, const void* b, const void* h0,
                            void* y, void* h_last, int B, int T, int D,
                            void* stream) {
  const int n = B * D;
  const int blocks = (n + kThreads - 1) / kThreads;
  rglru_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)y,
      (float*)h_last, B, T, D);
  return (int)cudaGetLastError();
}
