// Batched WEMD add row and swap matrix for the P1 schedulers (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/wemd_swap.py:
//
//   wemd_add_kernel  <- wemd_add_pallas  (body _add_kernel), the GS add row
//       W[b, v]    = sum_c cw * | (p_sum + p_dev_v) / (s + 1) - gd |
//   wemd_swap_kernel <- wemd_swap_pallas (body _swap_kernel), the FSCD
//       swap matrix
//       W[b, i, j] = sum_c cw * | ((p_sum - p_dev_i) + p_dev_j) / s - gd |
//
// with p_sum, gd, cw [B, C], p_dev [B, V, C] and the set sizes s [B].  The
// output is the dense f32 [B, V] / [B, V, V] of the Pallas kernels;
// validity masking is the caller's.
//
// Numbers.  Both compute the Pallas kernels' f32 function.  The inputs are
// all f32 or all f64 (the scheduler keeps its state in f64): an f64 value
// is rounded to f32 as it is loaded, by __double2float_rn, which is the
// rounding of .to(torch.float32), so no cast kernel runs in front of the
// scan and the f64 route gives the f32 route's bits on the cast inputs.
// Every step is rounded on its own (__fadd_rn, __fmul_rn, IEEE __fdiv_rn,
// no fused multiply-add) and the classes are summed in class order in a
// register, so the result does not depend on the tile sizes.
//
// Design.  The TPU kernels walked (row block, class tile) steps of a
// sequential grid and carried class partials in the output block.  Here
// blocks run in no order, so a thread owns an output for the whole class
// axis and walks the classes itself, in class order; any V and C fit.
//   add:  one block per problem; thread t owns devices t, t + kAddThreads,
//         ...  It reads its p_dev row through L1 in chunks of kAddCT
//         classes, all of a chunk's loads issued before its arithmetic;
//         p_sum, gd and cw are the same address across a warp, one
//         transaction each, so they are not staged.
//   swap: grid (B, ceil(V / kTI)); warp w owns row i0 + w, lane l the
//         columns j0 + l of each kTJ-wide column tile, so the stores are
//         coalesced.  For each (column tile, kCT-class tile) the block
//         stages p_sum - p_dev_i of its rows, the tile's p_dev_j rows, gd
//         and cw in shared memory as f32: lane = class, so each row is one
//         contiguous load, and the p_dev_j tile is padded to kCT + 1 so
//         that lane j reads row j without bank conflicts.  (Read straight
//         from L1, lane j's p_dev_j would cost one transaction a lane for
//         each load once a row is longer than a cache line.)
//
// What bounds it on an H100: neither bytes nor operations.  At the
// round's shapes ([1, 23, 10] add, [32, 23, 10] swap) the inputs are a
// few KB and the work a few hundred KFLOP, 3e-7 / 3e-5 ms of bound, far
// under the ~2 us any launch takes; a call's time is its host launch
// path, which the Python wrapper keeps short.  There is no matrix
// product for the tensor cores and nothing for asynchronous copies.
//
// Plain C interface, loaded with ctypes.  Each launcher makes `device`
// current for the launch and restores the caller's device after it, and
// returns cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kAddThreads = 128;
constexpr int kAddCT = 4;        // add: classes a chunk of loads
constexpr int kCT = 32;          // swap: classes a tile, one lane each
constexpr int kTI = 8;           // swap: rows a block, one warp each
constexpr int kTJ = 32;          // swap: columns a tile, one lane each

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const double* p, size_t i) {
  return __double2float_rn(p[i]);
}

// acc + cw * |x / s - gd|, each step rounded on its own
__device__ __forceinline__ float term(float acc, float x, float s, float gd,
                                      float cw) {
  return __fadd_rn(acc, __fmul_rn(fabsf(__fsub_rn(__fdiv_rn(x, s), gd)), cw));
}

// W[b, v] = sum_c cw * |(p_sum + p_dev_v) / (s + 1) - gd|
template <typename T>
__global__ void __launch_bounds__(kAddThreads)
wemd_add_kernel(const T* __restrict__ p_sum, const T* __restrict__ p_dev,
                const T* __restrict__ gd, const T* __restrict__ cw,
                const T* __restrict__ sizes, float* __restrict__ out, int V,
                int C) {
  const int b = blockIdx.x;
  const float s1 = __fadd_rn(ld(sizes, b), 1.f);
  p_sum += (size_t)b * C;
  gd += (size_t)b * C;
  cw += (size_t)b * C;
  p_dev += (size_t)b * V * C;
  for (int v = threadIdx.x; v < V; v += kAddThreads) {
    const T* row = p_dev + (size_t)v * C;
    float acc = 0.f;
    for (int c0 = 0; c0 < C; c0 += kAddCT) {
      float x[kAddCT], g[kAddCT], w[kAddCT];
#pragma unroll
      for (int k = 0; k < kAddCT; ++k)
        if (c0 + k < C) {
          x[k] = __fadd_rn(ld(p_sum, c0 + k), ld(row, c0 + k));
          g[k] = ld(gd, c0 + k);
          w[k] = ld(cw, c0 + k);
        }
#pragma unroll
      for (int k = 0; k < kAddCT; ++k)
        if (c0 + k < C) acc = term(acc, x[k], s1, g[k], w[k]);
    }
    out[(size_t)b * V + v] = acc;
  }
}

// W[b, i, j] = sum_c cw * |((p_sum - p_dev_i) + p_dev_j) / s - gd|
template <typename T>
__global__ void __launch_bounds__(kTI * 32)
wemd_swap_kernel(const T* __restrict__ p_sum, const T* __restrict__ p_dev,
                 const T* __restrict__ gd, const T* __restrict__ cw,
                 const T* __restrict__ sizes, float* __restrict__ out, int V,
                 int C) {
  static_assert(kCT == 32 && kTJ == 32, "a lane is a class or a column");
  __shared__ float a_s[kTI][kCT];            // p_sum - p_dev_i, by row
  __shared__ float pj_s[kTJ][kCT + 1];       // p_dev_j, one column tile
  __shared__ float gd_s[kCT], cw_s[kCT];
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.y * kTI + warp;
  const float s = ld(sizes, b);
  p_sum += (size_t)b * C;
  gd += (size_t)b * C;
  cw += (size_t)b * C;
  p_dev += (size_t)b * V * C;
  for (int j0 = 0; j0 < V; j0 += kTJ) {
    const bool owns = i < V && j0 + lane < V;
    float acc = 0.f;
    for (int c0 = 0; c0 < C; c0 += kCT) {
      const int c = c0 + lane;
      if (j0 + c0 > 0) __syncthreads();      // the last tile has been read
      if (c < C) {
        if (i < V) a_s[warp][lane] = __fsub_rn(ld(p_sum, c),
                                               ld(p_dev, (size_t)i * C + c));
        if (warp == 0) {
          gd_s[lane] = ld(gd, c);
          cw_s[lane] = ld(cw, c);
        }
#pragma unroll
        for (int r = warp; r < kTJ; r += kTI)
          if (j0 + r < V) pj_s[r][lane] = ld(p_dev, (size_t)(j0 + r) * C + c);
      }
      __syncthreads();
      if (owns) {
        const int cc = min(kCT, C - c0);
        for (int k = 0; k < cc; ++k)
          acc = term(acc, __fadd_rn(a_s[warp][k], pj_s[lane][k]), s, gd_s[k],
                     cw_s[k]);
      }
    }
    if (owns) out[((size_t)b * V + i) * V + j0 + lane] = acc;
  }
}

// Launches `launch()` on `device`, restoring the caller's current device.
template <typename F>
int on_device(int device, F launch) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  launch();
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

}  // namespace

// f64 != 0: the five inputs are double, else float.  B = 0 or V = 0
// launches nothing.
extern "C" int wemd_add_launch(const void* p_sum, const void* p_dev,
                               const void* gd, const void* cw,
                               const void* sizes, void* out, int B, int V,
                               int C, int f64, int device, void* stream) {
  if (B == 0 || V == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return on_device(device, [&] {
    if (f64)
      wemd_add_kernel<double><<<B, kAddThreads, 0, st>>>(
          (const double*)p_sum, (const double*)p_dev, (const double*)gd,
          (const double*)cw, (const double*)sizes, (float*)out, V, C);
    else
      wemd_add_kernel<float><<<B, kAddThreads, 0, st>>>(
          (const float*)p_sum, (const float*)p_dev, (const float*)gd,
          (const float*)cw, (const float*)sizes, (float*)out, V, C);
  });
}

extern "C" int wemd_swap_launch(const void* p_sum, const void* p_dev,
                                const void* gd, const void* cw,
                                const void* sizes, void* out, int B, int V,
                                int C, int f64, int device, void* stream) {
  if (B == 0 || V == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B, (V + kTI - 1) / kTI);
  return on_device(device, [&] {
    if (f64)
      wemd_swap_kernel<double><<<grid, kTI * 32, 0, st>>>(
          (const double*)p_sum, (const double*)p_dev, (const double*)gd,
          (const double*)cw, (const double*)sizes, (float*)out, V, C);
    else
      wemd_swap_kernel<float><<<grid, kTI * 32, 0, st>>>(
          (const float*)p_sum, (const float*)p_dev, (const float*)gd,
          (const float*)cw, (const float*)sizes, (float*)out, V, C);
  });
}
