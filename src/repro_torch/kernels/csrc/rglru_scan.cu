// RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + b_t, as a
// time-parallel scan (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py:50
// (rglru_pallas, body _rglru_kernel).  a, b [B, T, D] f32 and h0 [B, D]
// f32 give h [B, T, D] f32 and h_T [B, D] f32 (h_T is h[:, T - 1] bit for
// bit).  Any B, T, D: the kernel masks the tail of T and of D itself.
//
// What bounds it on an H100: bytes.  Each element of a and b is read once
// and each h written once (12 bytes an element, 2 FLOPs), so at the
// recurrentgemma-2b prefill shape [4, 3072, 2560] it must move 377 MB:
// 0.1127 ms at 3.35 TB/s.  Streaming at that rate needs several MB of
// loads in flight on the card.  The TPU kernel walked T in order and
// carried h in VMEM; a thread per (batch, channel) walking T, as the
// first port did, had 10,240 threads and under 1 MB in flight, so it was
// latency-bound at 0.5 TB/s.
//
// Design: one pass, 12 bytes an element.  A block of 128 threads owns one
// batch row and a tile of 32 channels, and walks T in segments of 128
// steps.  A segment is cut into 16 runs of 8 steps; thread (run r,
// group g) loads its run's a and b for channels 4g .. 4g + 3 into
// registers (16-byte loads; the 8 groups of a time row read one 128-byte
// line) and composes them into the run's pair (A, H) = (prod a, the run's
// h from 0), in f64.  The run pairs meet in shared memory; one thread a
// channel walks them in run order, carry_{r+1} = A_r carry_r + H_r (f64),
// and leaves each run its carry-in; then every thread replays its run
// from its carry-in in f32 (h = fma(a, h, b)) and stores h.  The carry
// after the segment's last run feeds the next segment.  At the prefill
// shape that is 4 x 80 = 320 blocks, all resident at once (2 or 3 an SM
// at 128 registers a thread), each with 32 KB of loads in flight while it
// waits on a segment.
//
// Numerics.  The scan re-associates the recurrence, so h is not the plain
// version's bits.  The pairs and the carry are f64: in f32, a constant a
// (0.9999, say) rounds prod a the same way in every run and the carry
// drifts coherently over thousands of steps; in f64 the kernel stays
// closer to the exact recurrence than the step-by-step f32 plain version
// is (tests/test_torch_lm_kernels_ref.py shows both).  No atomics; the
// order of every sum is fixed, so two calls on one input give one bit
// pattern.
//
// Where the time goes (scripts/rglru_designs.py times this kernel beside
// other block shapes and a two-launch design; PERF.md has the numbers):
// the bytes, at about 80 % of the HBM rate.  Tiles of 16 channels, 64
// bytes of a time row a block, were a quarter slower than 32 or 64
// channels: the width of a row's piece, not the count of blocks or of
// bytes in flight, moved the time most.  Each segment is a load burst,
// a walk of 16 pairs between two barriers, and the replay's stores; the
// blocks sharing an SM overlap those phases.
//
// The source also holds the backward (rglru_scan_bwd, rglru_bwd_launch):
// the JAX package has none, it differentiates its plain recurrence.
//
// Plain C interface, loaded with ctypes.  The launcher makes `device`
// current for the launch and restores the caller's device after it, and
// returns cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = 8;                  // float4 groups a time row
constexpr int kTile = 4 * kGroups;          // channels a block
constexpr int kRuns = kThreads / kGroups;   // runs a segment
constexpr int kL = 8;                       // steps a run
constexpr int kSeg = kRuns * kL;            // steps a segment
constexpr int kBwdBlocksPerSM = 4;          // the backward's, as the forward's

// Channels ch .. ch + 3 of one time row; past D the value is `pad`.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int ch, int D,
                                        float pad) {
  if (kVec)                             // D % 4 == 0: all four or none
    return ch < D ? __ldcs(reinterpret_cast<const float4*>(p))
                  : make_float4(pad, pad, pad, pad);
  float4 v;
  v.x = ch < D ? __ldcs(p) : pad;
  v.y = ch + 1 < D ? __ldcs(p + 1) : pad;
  v.z = ch + 2 < D ? __ldcs(p + 2) : pad;
  v.w = ch + 3 < D ? __ldcs(p + 3) : pad;
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, int ch, int D, float4 v) {
  if (kVec) {
    if (ch < D) __stcs(reinterpret_cast<float4*>(p), v);
    return;
  }
  if (ch < D) __stcs(p, v.x);
  if (ch + 1 < D) __stcs(p + 1, v.y);
  if (ch + 2 < D) __stcs(p + 2, v.z);
  if (ch + 3 < D) __stcs(p + 3, v.w);
}

__device__ __forceinline__ float& at(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// kVec: D % 4 == 0 and a, b, y 16-byte aligned (16-byte loads and stores).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
rglru_scan(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ h0, float* __restrict__ y,
           float* __restrict__ h_last, int T, int D) {
  __shared__ double A_s[kRuns][kTile];
  __shared__ double H_s[kRuns][kTile];
  __shared__ __align__(16) float cin_s[kRuns][kTile];
  const int tid = threadIdx.x;
  const int g = tid % kGroups, r = tid / kGroups;
  const int ch0 = blockIdx.x * kTile;
  const int ch = ch0 + 4 * g;
  const int bi = blockIdx.y;
  const size_t row0 = (size_t)bi * T;
  // thread c < kTile walks channel ch0 + c; its carry lives across segments
  double carry = 0.0;
  if (tid < kTile && ch0 + tid < D) carry = h0[(size_t)bi * D + ch0 + tid];

  for (int seg0 = 0; seg0 < T; seg0 += kSeg) {
    const int t0 = seg0 + r * kL;
    float4 av[kL], bv[kL];
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const int t = t0 + j;
      if (t < T) {                      // past T: a = 1, b = 0 (identity)
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
    __syncthreads();
    if (tid < kTile) {                  // the runs' carry-ins, in run order
      double h = carry;
#pragma unroll
      for (int q = 0; q < kRuns; ++q) {
        cin_s[q][tid] = (float)h;
        h = fma(A_s[q][tid], h, H_s[q][tid]);
      }
      carry = h;
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
}

// The backward, a reverse scan of the same form: with a_T = 1,
//   g_{T-1} = dy_{T-1} + dh_T,  g_t = dy_t + a_{t+1} g_{t+1},
//   db_t = g_t,  da_t = g_t h_{t-1} (h_{-1} = h0),  dh0 = a_0 g_0.
// The forward's layout walked from the last segment to the first: thread
// (run r, group g) loads its run's coefficients a_{t+1} and inputs dy_t,
// composes them from the run's last step down into an f64 pair (prod,
// g from 0), one thread a channel walks the pairs in reverse run order
// from the carry (dh_T at the start), and every thread replays its run
// downwards in f32, reading h_{t-1} as it stores db and da.  20 bytes an
// element: a, dy and h read once, da and db written once.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
rglru_scan_bwd(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ h0, const float* __restrict__ dy,
               const float* __restrict__ dh_last, float* __restrict__ da,
               float* __restrict__ db, float* __restrict__ dh0, int T,
               int D) {
  __shared__ double A_s[kRuns][kTile];
  __shared__ double H_s[kRuns][kTile];
  __shared__ __align__(16) float cin_s[kRuns][kTile];
  const int tid = threadIdx.x;
  const int g = tid % kGroups, r = tid / kGroups;
  const int ch0 = blockIdx.x * kTile;
  const int ch = ch0 + 4 * g;
  const int bi = blockIdx.y;
  const size_t row0 = (size_t)bi * T;
  double carry = 0.0;
  if (tid < kTile && ch0 + tid < D) carry = dh_last[(size_t)bi * D + ch0 + tid];

  for (int seg0 = ((T - 1) / kSeg) * kSeg; seg0 >= 0; seg0 -= kSeg) {
    const int t0 = seg0 + r * kL;
    float4 cv[kL], xv[kL];              // a_{t+1} and dy_t
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      const int t = t0 + j;
      cv[j] = make_float4(1.f, 1.f, 1.f, 1.f);
      xv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) {
        const size_t o = (row0 + t) * D + ch;
        xv[j] = load4<kVec>(dy + o, ch, D, 0.f);
        if (t + 1 < T) cv[j] = load4<kVec>(a + o + D, ch, D, 1.f);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      double A = 1.0, H = 0.0;
#pragma unroll
      for (int j = kL - 1; j >= 0; --j) {
        const double cj = at(cv[j], c);
        A *= cj;
        H = fma(cj, H, (double)at(xv[j], c));
      }
      A_s[r][4 * g + c] = A;
      H_s[r][4 * g + c] = H;
    }
    __syncthreads();
    if (tid < kTile) {                  // the runs' carry-ins, last run first
      double x = carry;
#pragma unroll
      for (int q = kRuns - 1; q >= 0; --q) {
        cin_s[q][tid] = (float)x;
        x = fma(A_s[q][tid], x, H_s[q][tid]);
      }
      carry = x;
    }
    __syncthreads();
    float4 gv = *reinterpret_cast<const float4*>(&cin_s[r][4 * g]);
#pragma unroll
    for (int j = kL - 1; j >= 0; --j) {
      const int t = t0 + j;
      gv.x = fmaf(cv[j].x, gv.x, xv[j].x);
      gv.y = fmaf(cv[j].y, gv.y, xv[j].y);
      gv.z = fmaf(cv[j].z, gv.z, xv[j].z);
      gv.w = fmaf(cv[j].w, gv.w, xv[j].w);
      if (t < T) {
        const size_t o = (row0 + t) * D + ch;
        const float4 hp = t > 0 ? load4<kVec>(h + o - D, ch, D, 0.f)
                                : load4<false>(h0 + (size_t)bi * D + ch, ch,
                                               D, 0.f);
        store4<kVec>(db + o, ch, D, gv);
        store4<kVec>(da + o, ch, D,
                     make_float4(gv.x * hp.x, gv.y * hp.y, gv.z * hp.z,
                                 gv.w * hp.w));
        if (t == 0) {
          const float4 a0 = load4<kVec>(a + o, ch, D, 0.f);
          store4<false>(dh0 + (size_t)bi * D + ch, ch, D,
                        make_float4(a0.x * gv.x, a0.y * gv.y, a0.z * gv.z,
                                    a0.w * gv.w));
        }
      }
    }
  }
}

template <class F>
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

// B, T or D = 0 launches nothing.
extern "C" int rglru_launch(const void* a, const void* b, const void* h0,
                            void* y, void* h_last, int B, int T, int D,
                            int device, void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  const bool vec = D % 4 == 0 && ((uintptr_t)a | (uintptr_t)b | (uintptr_t)y)
                                         % 16 == 0;
  const dim3 grid((D + kTile - 1) / kTile, B);
  const cudaStream_t st = (cudaStream_t)stream;
  const float *ap = (const float*)a, *bp = (const float*)b,
              *hp = (const float*)h0;
  float *yp = (float*)y, *lp = (float*)h_last;
  return on_device(device, [&] {
    if (vec)
      rglru_scan<true><<<grid, kThreads, 0, st>>>(ap, bp, hp, yp, lp, T, D);
    else
      rglru_scan<false><<<grid, kThreads, 0, st>>>(ap, bp, hp, yp, lp, T, D);
  });
}

// The backward: a, h (the forward's output), dy [B, T, D], h0, dh_last
// [B, D] f32 give da, db [B, T, D] and dh0 [B, D] f32.  B, T or D = 0
// launches nothing.
extern "C" int rglru_bwd_launch(const void* a, const void* h, const void* h0,
                                const void* dy, const void* dh_last, void* da,
                                void* db, void* dh0, int B, int T, int D,
                                int device, void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  const bool vec =
      D % 4 == 0 && ((uintptr_t)a | (uintptr_t)h | (uintptr_t)dy |
                     (uintptr_t)da | (uintptr_t)db) % 16 == 0;
  const dim3 grid((D + kTile - 1) / kTile, B);
  const cudaStream_t st = (cudaStream_t)stream;
  const float *ap = (const float*)a, *hp = (const float*)h,
              *h0p = (const float*)h0, *dyp = (const float*)dy,
              *dlp = (const float*)dh_last;
  float *dap = (float*)da, *dbp = (float*)db, *dh0p = (float*)dh0;
  return on_device(device, [&] {
    if (vec)
      rglru_scan_bwd<true><<<grid, kThreads, 0, st>>>(ap, hp, h0p, dyp, dlp,
                                                      dap, dbp, dh0p, T, D);
    else
      rglru_scan_bwd<false><<<grid, kThreads, 0, st>>>(ap, hp, h0p, dyp, dlp,
                                                       dap, dbp, dh0p, T, D);
  });
}
