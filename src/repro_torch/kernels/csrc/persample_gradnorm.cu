// Eq. 10 sigma-hat for a softmax-CE head, batched over devices (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/persample_gradnorm.py
// (persample_gradnorm_pallas, body _psg_kernel).  For device v with
// penultimate features h [B, d], logits [B, C] and labels [B]:
//
//   e_i      = softmax(logits_i) - onehot(y_i)
//   gi_sq_i  = ||h_i||^2 * ||e_i||^2           (per-sample grad norm^2)
//   gbar     = H^T E / B                        ([d, C] mean gradient)
//   sigma    = sqrt(max(mean_i gi_sq_i - ||gbar||^2, 0))
//
// without ever forming the [B, d, C] per-sample gradients.
//
// Design.  One thread block per device.  The TPU kernel walked 128-row
// blocks in a sequential grid and carried H^T E in VMEM scratch between
// steps; blocks on a GPU run in no order, so here one block owns one
// device and does both passes itself:
//   1. one warp per row: a stable softmax over the C classes, the error
//      row e_i written to shared memory, ||h_i||^2 and ||e_i||^2 by warp
//      shuffles, gi_sq_i to global memory;
//   2. every thread takes (k, c) entries of H^T E and accumulates
//      sum_i h[i, k] * e[i, c] in its own loop (E from shared memory,
//      h from global memory / L1), squares the mean and adds it to its
//      share of ||gbar||^2; a block reduction finishes sigma.
// Shared memory holds E only (B * C floats).  What bounds it on an
// H100: at the round's shapes (B = 32, d = 120, C = 10, V <= 64) the
// whole input is ~0.6 MB and the work ~0.3 MFLOP per device, so it is
// neither memory- nor compute-bound; the time is the launch.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Sum of one float per thread over the block; every thread gets it.
__device__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float t = lane < kWarps ? scratch[lane] : 0.f;
  return warp_sum(t);
}

__global__ void __launch_bounds__(kThreads)
psg_kernel(const float* __restrict__ h, const float* __restrict__ logits,
           const int* __restrict__ labels, float* __restrict__ gi_sq,
           float* __restrict__ sigma, int B, int d, int C) {
  extern __shared__ float e_s[];  // [B, C]
  __shared__ float scratch[kWarps];
  const int v = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  h += (size_t)v * B * d;
  logits += (size_t)v * B * C;
  labels += (size_t)v * B;
  gi_sq += (size_t)v * B;

  // pass 1: softmax errors, per-sample squared gradient norms
  float gi_total = 0.f;  // lane 0 of each warp: its rows' gi_sq sum
  for (int r = warp; r < B; r += kWarps) {
    const float* lr = logits + (size_t)r * C;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, lr[c]);
    m = warp_max(m);
    float z = 0.f;
    for (int c = lane; c < C; c += 32) z += expf(lr[c] - m);
    z = warp_sum(z);
    const int y = labels[r];
    float ee = 0.f;
    for (int c = lane; c < C; c += 32) {
      float e = expf(lr[c] - m) / z - (c == y ? 1.f : 0.f);
      e_s[r * C + c] = e;
      ee += e * e;
    }
    ee = warp_sum(ee);
    const float* hr = h + (size_t)r * d;
    float hh = 0.f;
    for (int k = lane; k < d; k += 32) hh += hr[k] * hr[k];
    hh = warp_sum(hh);
    if (lane == 0) {
      gi_sq[r] = hh * ee;
      gi_total += hh * ee;
    }
  }
  __syncthreads();

  // pass 2: ||H^T E / B||^2, one (k, c) entry of H^T E per loop trip
  float gb = 0.f;
  const float inv_b = 1.f / (float)B;
  for (int idx = threadIdx.x; idx < d * C; idx += kThreads) {
    const int k = idx / C, c = idx - k * C;
    float acc = 0.f;
    for (int i = 0; i < B; ++i) acc += h[(size_t)i * d + k] * e_s[i * C + c];
    const float g = acc * inv_b;
    gb += g * g;
  }
  gi_total = block_sum(gi_total, scratch);
  gb = block_sum(gb, scratch);
  if (threadIdx.x == 0) sigma[v] = sqrtf(fmaxf(gi_total * inv_b - gb, 0.f));
}

}  // namespace

extern "C" int psg_sigma_launch(const void* h, const void* logits,
                                const void* labels, void* gi_sq, void* sigma,
                                int V, int B, int d, int C, void* stream) {
  const size_t smem = (size_t)B * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        psg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  psg_kernel<<<V, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)logits, (const int*)labels,
      (float*)gi_sq, (float*)sigma, B, d, C);
  return (int)cudaGetLastError();
}
