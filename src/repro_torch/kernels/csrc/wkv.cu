// RWKV6 WKV recurrence with data-dependent decay, as a chunked scan (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv_scan.py:75 (wkv_pallas,
// body _wkv_kernel).  Per (batch, head), with the state S [hd, hd]:
//
//   y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// r, k, v, w [B, T, H, hd] f32, u [H, hd] f32 and the initial state
// s0 [B, H, hd, hd] f32 give y [B, T, H, hd] f32 and the final state.  w is
// clipped to [1e-8, 1], as the Pallas kernel clips it.
//
// What bounds it on an H100: bytes.  At the rwkv6-3b prefill shape
// [4, 3072, 40, 64] it must read r, k, v, w (503 MB) and write y (126 MB):
// 0.1894 ms at 3.35 TB/s, the states included; its ~1e10 f32 operations
// take 0.15 ms at 67 TFLOP/s.
//
// What held the step-by-step kernel back was latency: one block of hd
// threads per (batch, head) walked the 3072 steps one after another, each
// step a dependent chain of hd FMAs, on 160 blocks of 2 warps.  Here T is
// cut into chunks of kL = 16 steps, as the Pallas kernel cuts it, and the
// work inside a chunk is done in parallel: a block walks 192 dependent chunk
// steps instead of 3072 time steps.  Column j of the state reads only column
// j of v, so a block owns one (batch, head) and all hd of its state columns,
// and prepares each chunk once for them (cutting the columns into 2 or 4
// tiles, each of which prepares the chunk again, was slower at the rwkv6-3b
// prefill shape: PERF.md).  The state stays in registers across chunks:
// thread (g, j) holds rows g * RPT .. g * RPT + RPT - 1 of column j (16
// floats at hd 64 with 256 threads).  Per chunk, between barriers:
//   1. cp.async stages the chunk's r, k, w rows [16, hd] and its v columns
//      [16, hd] in shared memory, 16 bytes a copy, double buffered: chunk
//      n + 1 loads while chunk n computes.  Rows past T are zero filled
//      (k = v = 0) and their decay is 1, so the kernel masks the tail itself
//      and writes no y there.
//   2. Log-space decays, base 2, per channel d: lw = log2(clip(w)) <= 0 and
//      lc[t] = lw[0] + ... + lw[t], four threads a channel, each over steps
//      q, q + 4, q + 8, q + 12: four shuffle scans side by side, only their
//      totals carried.  lc_prev[t] is read as lc[t - 1] (lc[-1] = 0), so the
//      exponent of a pair (t, t - 1) is exactly 0, and lct = lc[15].  Every
//      exponent below is <= 0.  The same threads sum A's diagonal
//      r[t,d] u[d] k[t,d] over their warp's channels.
//   3. A [16, 16]: below the diagonal sum_d r[t,d] k[s,d] 2^(lc[t-1,d] -
//      lc[s,d]), one exponent a term, never split into 2^lc[t-1] * 2^-lc[s]:
//      at w = 1e-8, -lc reaches 425 (base 2) in 16 steps and 2^425 is no f32.
//      Two threads a pair (four at hd 128) take interleaved 16-byte pieces
//      of d; a thread a diagonal element adds up the warps' sums.
//   4. y[t, j] = sum_d r[t,d] 2^lc[t-1,d] S[d,j] + sum_s A[t,s] v[s,j]:
//      each thread sums its RPT rows for the 16 steps and its 16 / G keys of
//      A; the G row groups meet in shared memory, and y is stored coalesced.
//   5. S[d,j] = 2^lct[d] S[d,j] + sum_t k[t,d] 2^(lct[d] - lc[t,d]) v[t,j],
//      in the registers that hold S.
// The math is f32 on the CUDA cores: the per-chunk products are 16 x hd x
// hd.  2^x and log2 are the special function unit's (ex2/lg2.approx, about
// 2^-22 relative).  Rows of the r, k, lc, and decayed r, k tiles are padded
// by 8 floats, so the four threads of a channel (rows q + 4 i) and the pair
// threads (rows s .. s + 3) hit distinct banks.
//
// Where the time goes (scripts/wkv_ablation.py times the kernel with each
// step taken out; PERF.md has the numbers): not the bytes.  A block is
// bound by its instruction count and by the serial chain of its steps
// between four barriers, and 160 blocks on 132 SMs put two blocks on 28 of
// them, which set the time.
//
// Plain C interface, loaded with ctypes.  The launcher makes `device`
// current for the launch and restores the caller's device after it, and
// returns cudaGetLastError() (or -1 for a head size it is not built for); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 16;                    // steps a chunk
constexpr int kPad = 8;                   // floats of padding on a tile row
constexpr int kPairs = kL * (kL - 1) / 2;  // (t, s) pairs below the diagonal

template <int HD>
struct Tile {
  static constexpr int kThreads = HD == 128 ? 512 : 256;
  static constexpr int G = kThreads / HD;     // row groups
  static constexpr int RPT = HD / G;          // state rows a thread
  static constexpr int SPAN = kL / G;         // keys of A a row group applies
  static constexpr int SPLIT = kThreads / 128;  // threads a pair of A
  static constexpr int RS = HD + kPad;        // row stride of the padded tiles
  static constexpr int kScanWarps = HD / 8;   // warps of the decay scan
  // shared memory, in floats: two stages of r, k, w (-> lc) [kL][RS] and
  // v [kL][HD]; decayed r and k [kL][RS]; 2^lct and u [HD]; A [kL][kL]; the
  // scan warps' parts of A's diagonal [kScanWarps][kL]; the row groups'
  // partial y [G][kL][HD]
  static constexpr int kStage = 3 * kL * RS + kL * HD;
  static constexpr int kFloats = 2 * kStage + 2 * kL * RS + 2 * HD +
                                 kL * kL + kScanWarps * kL + G * kL * HD;
  static_assert(G <= kL && kL % G == 0, "row groups");
  static_assert(4 * HD <= kThreads, "four threads a channel in the scan");
  static_assert(kPairs * SPLIT + kL <= kThreads, "threads for A");
  static_assert(HD % (4 * SPLIT) == 0, "pair threads split d in float4s");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x and log2(x) on the special function unit, one instruction each
// (relative error about 2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sum over the RPT rows of one thread: acc += x[0..RPT) . S[0..RPT)
template <int RPT>
__device__ __forceinline__ float dot_rows(const float* x, const float* S) {
  float acc = 0.f;
  if constexpr (RPT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < RPT; i += 4) {
      const float4 a = ld4(x + i);
      acc += a.x * S[i] + a.y * S[i + 1] + a.z * S[i + 2] + a.w * S[i + 3];
    }
  } else {
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc += x[i] * S[i];
  }
  return acc;
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads)
wkv_chunked(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int T, int H) {
  using C = Tile<HD>;
  constexpr int kThreads = C::kThreads, G = C::G, RPT = C::RPT,
                SPAN = C::SPAN, SPLIT = C::SPLIT, RS = C::RS;
  extern __shared__ __align__(16) float smem[];
  float* const rdec = smem + 2 * C::kStage;   // r[t,d] 2^lc[t-1,d]
  float* const kdec = rdec + kL * RS;         // k[t,d] 2^(lct[d] - lc[t,d])
  float* const sdec = kdec + kL * RS;         // 2^lct[d]
  float* const us = sdec + HD;
  float* const As = us + HD;
  float* const diagp = As + kL * kL;
  float* const yred = diagp + C::kScanWarps * kL;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int g = tid / HD, j = tid - g * HD;   // row group, state column
  const size_t step = (size_t)H * HD;         // elements from t to t + 1
  const size_t base = ((size_t)b * T * H + h) * HD;

  float S[RPT];                               // rows g*RPT.. of column j
  {
    const float* sp = s0 + (size_t)bh * HD * HD + (size_t)g * RPT * HD + j;
#pragma unroll
    for (int i = 0; i < RPT; ++i) S[i] = sp[(size_t)i * HD];
  }
  for (int i = tid; i < HD; i += kThreads) us[i] = u[h * HD + i];
  for (int i = tid; i < kL * kL; i += kThreads) As[i] = 0.f;  // above: 0

  // this thread's role in A: pair (pt, ps), part of d; or diagonal element
  const int pair = tid / SPLIT, part = tid - pair * SPLIT;
  const int diag = tid - kPairs * SPLIT;
  int pt = 1;
  while (pair < kPairs && (pt + 1) * pt / 2 <= pair) ++pt;
  const int ps = pair - pt * (pt - 1) / 2;

  // this thread's 16-byte pieces of a chunk's r, k, w rows and v columns:
  // the source at the chunk's first step, the byte offset in a stage, the
  // step in the chunk (kL: no piece)
  constexpr int kRow = HD / 4, kVRow = HD / 4;   // 16-byte pieces a row
  constexpr int kRKW = 3 * kL * kRow, kAll = kRKW + kL * kVRow;
  constexpr int kPieces = (kAll + kThreads - 1) / kThreads;
  const float* src[kPieces];
  uint32_t dst[kPieces];
  int pt_t[kPieces];
#pragma unroll
  for (int m = 0; m < kPieces; ++m) {
    const int i = tid + m * kThreads;
    int t = kL, off = 0;
    const float* p = r;
    if (i < kRKW) {
      const int a = i / (kL * kRow), rem = i - a * kL * kRow;
      t = rem / kRow;
      const int c = rem - t * kRow;
      p = (a == 0 ? r : a == 1 ? k : w) + base + (size_t)t * step + 4 * c;
      off = a * kL * RS + t * RS + 4 * c;
    } else if (i < kAll) {
      const int rem = i - kRKW;
      t = rem / kVRow;
      const int c = rem - t * kVRow;
      p = v + base + (size_t)t * step + 4 * c;
      off = 3 * kL * RS + t * HD + 4 * c;
    }
    src[m] = p;
    dst[m] = 4u * off;
    pt_t[m] = t;
  }
  const uint32_t smem_base = (uint32_t)__cvta_generic_to_shared(smem);

  // chunk n's pieces into stage `buf`
  auto load = [&](int n, int buf) {
    const int t0 = n * kL;
    const uint32_t sa = smem_base + 4u * buf * C::kStage;
#pragma unroll
    for (int m = 0; m < kPieces; ++m) {
      if (pt_t[m] == kL) continue;
      const bool in = t0 + pt_t[m] < T;
      cp_async16(sa + dst[m], in ? src[m] + (size_t)t0 * step : r, in);
    }
    cp_commit();
  };

  const int nch = (T + kL - 1) / kL;
  if (nch > 0) load(0, 0);
  for (int n = 0; n < nch; ++n) {
    const int t0 = n * kL;
    if (n + 1 < nch) {
      load(n + 1, (n + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                 // chunk n staged; chunk n - 1 consumed
    float* const rs = smem + (n & 1) * C::kStage;
    float* const ks = rs + kL * RS;
    float* const lcs = ks + kL * RS;         // w, then lc
    float* const vs = lcs + kL * RS;

    // 2. decays: thread (d, q) takes steps q, q + 4, q + 8, q + 12.  The
    // four rounds are scanned over q side by side; only the rounds'
    // totals are carried, in the thread, so the dependent chain is short.
    if (tid < 4 * HD) {
      const int d = tid >> 2, q = tid & 3;
      float lc[4], tot[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q + 4 * i;
        lc[i] = t0 + t < T ? lg2(fminf(fmaxf(lcs[t * RS + d], 1e-8f), 1.f))
                           : 0.f;
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)     // inclusive scans over q
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float o = __shfl_up_sync(0xffffffffu, lc[i], off, 4);
          if (q >= off) lc[i] += o;
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tot[i] = __shfl_sync(0xffffffffu, lc[i], 3, 4);
      // carry[i] = lc at step 4i - 1: the sum of the earlier rounds' totals,
      // taken in the order in which lane 3 adds them
      float carry[4];
      carry[0] = 0.f;
#pragma unroll
      for (int i = 1; i < 4; ++i) carry[i] = carry[i - 1] + tot[i - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lc[i] = carry[i] + lc[i];
        // lc[t - 1]: lane q - 1 of this round, or lane 3 of the last one
        const float up = __shfl_up_sync(0xffffffffu, lc[i], 1, 4);
        const float lp = q ? up : carry[i];
        const int t = q + 4 * i;
        lcs[t * RS + d] = lc[i];
        rdec[t * RS + d] = rs[t * RS + d] * ex2(lp);
      }
      const float carry4 = carry[3] + tot[3];
      const float lct = carry4, ud = us[d];
      float dg[4];                  // r[t,d] u[d] k[t,d] at this lane's steps
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q + 4 * i;
        const float kv = ks[t * RS + d];
        kdec[t * RS + d] = kv * ex2(lct - lc[i]);
        dg[i] = rs[t * RS + d] * ud * kv;
      }
      if (q == 0) sdec[d] = ex2(lct);
      // A's diagonal, summed over the warp's 8 channels; the diagonal
      // threads of A add up the warps
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], off);
      if ((tid & 31) < 4)
#pragma unroll
        for (int i = 0; i < 4; ++i) diagp[(tid >> 5) * kL + q + 4 * i] = dg[i];
    }
    __syncthreads();

    // 3. A
    {
      float acc = 0.f;
      if (pair < kPairs) {
        const float *ra = rs + pt * RS, *kb = ks + ps * RS,
                    *la = lcs + (pt - 1) * RS, *lb = lcs + ps * RS;
        float p4[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, one a lane of d
#pragma unroll
        for (int i = 0; i < HD / (4 * SPLIT); ++i) {
          const int d = 4 * (SPLIT * i + part);
          const float4 a = ld4(ra + d), kk = ld4(kb + d), x = ld4(la + d),
                       z = ld4(lb + d);
          p4[0] += a.x * kk.x * ex2(x.x - z.x);
          p4[1] += a.y * kk.y * ex2(x.y - z.y);
          p4[2] += a.z * kk.z * ex2(x.z - z.z);
          p4[3] += a.w * kk.w * ex2(x.w - z.w);
        }
        acc = (p4[0] + p4[1]) + (p4[2] + p4[3]);
      } else if (diag < kL) {
#pragma unroll
        for (int wp = 0; wp < C::kScanWarps; ++wp) acc += diagp[wp * kL + diag];
      }
      float sum = acc;
#pragma unroll
      for (int off = 1; off < SPLIT; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (pair < kPairs) {
        if (part == 0) As[pt * kL + ps] = sum;
      } else if (diag < kL) {
        As[diag * kL + diag] = acc;
      }
    }

    // 4. (first half) y from the state entering the chunk
    float yacc[kL];
#pragma unroll
    for (int t = 0; t < kL; ++t)
      yacc[t] = dot_rows<RPT>(rdec + t * RS + g * RPT, S);

    // 5. the state, in registers
#pragma unroll
    for (int i = 0; i < RPT; ++i) S[i] *= sdec[g * RPT + i];
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      const float vt = vs[t * HD + j];
      const float* kd = kdec + t * RS + g * RPT;
      if constexpr (RPT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RPT; i += 4) {
          const float4 a = ld4(kd + i);
          S[i] += a.x * vt;
          S[i + 1] += a.y * vt;
          S[i + 2] += a.z * vt;
          S[i + 3] += a.w * vt;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RPT; ++i) S[i] += kd[i] * vt;
      }
    }
    __syncthreads();                 // A complete

    // 4. (second half) the chunk's own keys through A, then the row groups
    // meet in shared memory
    {
      float vv[SPAN];
#pragma unroll
      for (int e = 0; e < SPAN; ++e) vv[e] = vs[(g * SPAN + e) * HD + j];
#pragma unroll
      for (int t = 0; t < kL; ++t) {
#pragma unroll
        for (int e = 0; e < SPAN; ++e)
          yacc[t] += As[t * kL + g * SPAN + e] * vv[e];
        yred[(g * kL + t) * HD + j] = yacc[t];
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < SPAN; ++m) {          // kL * HD outputs, SPAN a thread
      const int o = tid + m * kThreads;
      const int t = o / HD, jj = o - t * HD;
      float sum = 0.f;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) sum += yred[(gg * kL + t) * HD + jj];
      if (t0 + t < T) y[base + (size_t)(t0 + t) * step + jj] = sum;
    }
  }

  float* so = s_out + (size_t)bh * HD * HD + (size_t)g * RPT * HD + j;
#pragma unroll
  for (int i = 0; i < RPT; ++i) so[(size_t)i * HD] = S[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int T, int H, int device, cudaStream_t stream) {
  using C = Tile<HD>;
  constexpr int smem = C::kFloats * (int)sizeof(float);
  static unsigned opted_in = 0;   // devices whose attribute is set (bit)
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (smem > 48 * 1024 && !(opted_in & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_chunked<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= bit;
  }
  wkv_chunked<HD><<<B * H, C::kThreads, smem, stream>>>(
      r, k, v, w, u, s0, y, s_out, T, H);
  return (int)cudaGetLastError();
}

template <class F>
int on_device(int device, F fn) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  int res = fn();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (res == 0) res = (int)back;
  }
  return res;
}

}  // namespace

extern "C" int wkv_launch(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_out, int B, int T, int H, int hd,
                          int device, void* stream) {
  if (B == 0 || H == 0) return 0;
  const float *rp = (const float*)r, *kp = (const float*)k,
              *vp = (const float*)v, *wp = (const float*)w,
              *up = (const float*)u, *sp = (const float*)s0;
  float *yp = (float*)y, *op = (float*)s_out;
  const cudaStream_t st = (cudaStream_t)stream;
#define WKV_CASE(HD)                                                      \
  if (hd == HD)                                                           \
    return on_device(device, [&] {                                        \
      return launch<HD>(rp, kp, vp, wp, up, sp, yp, op, B, T, H, device,   \
                        st);                                              \
    });
  WKV_CASE(16) WKV_CASE(32) WKV_CASE(64) WKV_CASE(128)
#undef WKV_CASE
  return -1;
}
