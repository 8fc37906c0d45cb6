// RWKV6 WKV recurrence with data-dependent decay (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv_scan.py (wkv_pallas,
// body _wkv_kernel).  Per (batch, head), with the state S [hd, hd]:
//
//   y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// r, k, v, w [B, T, H, hd] f32, u [H, hd] f32 and the initial state
// s0 [B, H, hd, hd] f32 give y [B, T, H, hd] f32 and the final state.
//
// Design.  The TPU kernel cut T into chunks of 16, carried S in VMEM
// between sequential grid steps and did each chunk's work as matrix
// products in log space (so that the products of decays never
// overflow).  Here one thread block owns one (batch, head) and walks the
// T steps itself, so no state crosses blocks and nothing needs the log
// space: thread j holds column j of S in registers (hd floats), reads
// r_t, k_t, w_t and u from shared memory (the same address for every
// thread, a broadcast) and forms y_t[j] = sum_i r_t[i] S[i][j] in its own
// loop.  The block stages 16 steps of r, k, v, w in shared memory per
// synchronisation, each step's hd values read coalesced.
//
// What bounds it on an H100: bytes.  At the rwkv6-3b prefill shape
// [4, 3072, 40, 64] it must read r, k, v, w (503 MB) and write y
// (126 MB): 0.19 ms at 3.35 TB/s; its ~1e10 floating-point operations
// take 0.15 ms at the 67 TFLOP/s f32 rate.  With only B * H = 160
// blocks of hd threads, and one dependent step after another, the
// simple kernel is latency-bound far above both.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // time steps staged in shared memory per sync

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out, int T, int H) {
  __shared__ __align__(16) float rs[kChunk][HD];
  __shared__ __align__(16) float ks[kChunk][HD];
  __shared__ __align__(16) float ws[kChunk][HD];
  __shared__ __align__(16) float vs[kChunk][HD];
  __shared__ __align__(16) float us[HD];
  const int bh = blockIdx.x;
  const int bi = bh / H, h = bh - bi * H, j = threadIdx.x;

  float S[HD];  // column j of the state
  const float* sp = s0 + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = sp[(size_t)i * HD + j];
  us[j] = u[h * HD + j];

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();  // the previous chunk has been consumed
    for (int c = 0; c < n; ++c) {
      const size_t o = (((size_t)bi * T + t0 + c) * H + h) * HD + j;
      rs[c][j] = r[o];
      ks[c][j] = k[o];
      ws[c][j] = w[o];
      vs[c][j] = v[o];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float yj = 0.f, ruk = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[c][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&us[i]);
        yj += r4.x * S[i] + r4.y * S[i + 1] + r4.z * S[i + 2]
              + r4.w * S[i + 3];
        ruk += r4.x * u4.x * k4.x + r4.y * u4.y * k4.y
               + r4.z * u4.z * k4.z + r4.w * u4.w * k4.w;
        S[i] = w4.x * S[i] + k4.x * vj;
        S[i + 1] = w4.y * S[i + 1] + k4.y * vj;
        S[i + 2] = w4.z * S[i + 2] + k4.z * vj;
        S[i + 3] = w4.w * S[i + 3] + k4.w * vj;
      }
      y[(((size_t)bi * T + t0 + c) * H + h) * HD + j] = yj + ruk * vj;
    }
  }
  float* so = s_out + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) so[(size_t)i * HD + j] = S[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int T, int H, cudaStream_t stream) {
  wkv_kernel<HD><<<B * H, HD, 0, stream>>>(r, k, v, w, u, s0, y, s_out, T,
                                            H);
  return (int)cudaGetLastError();
}

}  // namespace

// Head sizes the kernel is built for; any other returns -1.
extern "C" int wkv_launch(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int B, int T, int H, int hd,
                          void* stream) {
  const float *rp = (const float*)r, *kp = (const float*)k,
              *vp = (const float*)v, *wp = (const float*)w,
              *up = (const float*)u, *sp = (const float*)s0;
  float *yp = (float*)y, *op = (float*)s_out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(rp, kp, vp, wp, up, sp, yp, op, B, T, H, st);
    case 32: return launch<32>(rp, kp, vp, wp, up, sp, yp, op, B, T, H, st);
    case 64: return launch<64>(rp, kp, vp, wp, up, sp, yp, op, B, T, H, st);
    case 128:
      return launch<128>(rp, kp, vp, wp, up, sp, yp, op, B, T, H, st);
    default: return -1;
  }
}
