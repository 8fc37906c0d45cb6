// The backward of the RWKV6 WKV recurrence (sm_90a): K5-bwd.
//
// The JAX package has no backward kernel: it differentiates its plain
// chunked scan (repro/models/rwkv6.py:104 wkv_chunked, whose chunk body is
// a jax.checkpoint).  This kernel computes the gradient of the function of
// the Pallas TPU kernel repro/kernels/rwkv_scan.py:75 (wkv_pallas), which
// csrc/wkv.cu computes on the card:
//
//   y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t,   S_t = diag(w_t) S_{t-1}
//   + k_t v_t^T, with w clipped to [1e-8, 1].
//
// With G_t = dL/dS_t (G_T the final state's gradient) and G_{t-1} =
// diag(w_t) G_t + r_t dy_t^T:
//
//   dr_t = S_{t-1} dy_t + (u * k_t)(v_t . dy_t)
//   dk_t = G_t v_t + (r_t * u)(v_t . dy_t)
//   dv_t = G_t^T k_t + (r_t . (u * k_t)) dy_t
//   dw_t = rowsum(G_t * S_{t-1}) (times the clip's gradient)
//   du   = sum over b, t of r_t * k_t (v_t . dy_t),   dS_0 = G_0.
//
// dw needs S_{t-1} at every step, and walking S back divides by decays
// clipped to 1e-8, so the forward saves the state entering each chunk of
// kL = 16 steps (wkv.cu's wkv_launch given s_chunks: [B, T/16, H, hd, hd]
// f32), and this kernel walks the chunks from the last to the first,
// carrying G, in the forward's log-space, base-2 form.  Per channel d of
// a chunk:
// lc[t] = lw[0] + ... + lw[t] with lw = log2(clip(w)) <= 0, lp[t] =
// lc[t - 1] (0 at the first step), lct = lc[15];
// a[t] = 2^(lct - lc[t]), b[t] = 2^lp[t], e[t][s] = 2^(lp[t] - lc[s]) for
// s < t: every exponent is <= 0, each factor at most 1, so a product of
// them never overflows where the true value does not.  With S0 the saved
// state, G the carried gradient (leaving the chunk), B[t][s] = dy_t . v_s,
// SD[t] = S0 dy_t, GV[t] = G v_t, X = rowsum(G * S0) and the forward's
// A[t][s] (A[t][s] = sum_d r_t k_s e[t][s], A[t][t] = r_t . (u * k_t)):
//
//   dr[t] = b[t] SD[t] + sum_{s<t} B[t][s] e[t][s] k_s + u k_t B[t][t]
//   dk[t] = a[t] GV[t] + sum_{s>t} B[s][t] e[s][t] r_s + r_t u B[t][t]
//   dv[t] = (k_t a[t])^T G + sum_{s>=t} A[s][t] dy_s
//   dw[t] = a[t] (b[t] X + sum_{q<t} e[t][q] k_q GV[q])
//         + sum_{s>t} e[s][t] r_s (b[t] SD[s] + sum_{q<t} e[t][q] k_q B[s][q])
//   G    <- 2^lct G + sum_t (r_t b[t]) dy_t^T
//
// (dw[t] is rowsum(G_t * S_{t-1}) with G_t and S_{t-1} written from G and
// S0.)  Rows past T are zero with a decay of 1, and nothing is written
// there.  du is summed without atomics: each block writes its
// (batch, head)'s partial sum, and a second launch adds the B partial sums
// of a head in batch order, so two runs give the same bits.
//
// Layout: one block of 256 threads a (batch, head), as the forward; S0, G
// and the chunk's tiles live in shared memory (rows padded by one float, so
// a warp reading a column of S0 or G, or 16 rows of a tile, hits 32
// banks), and every product is a loop of a thread over shared memory:
// simple, not fast.  What bounds it on an H100: at the rwkv6-3b train
// shape [16, 256, 40, 64] it must read r, k, v, w, dy, the saved states
// and dS_T and write dr, dk, dv, dw and dS_0 (0.566 GB: 0.169 ms at 3.35
// TB/s); the design's f32 operations, 10.7 G (1.04 M a chunk of a
// (batch, head), chip_smoke.py's wkv_bwd_chunk_ops), take 0.159 ms at 67
// TFLOP/s, so bytes bound it, just;
// the loops run from shared memory, one load an FMA or more.
//
// Plain C interface, loaded with ctypes.  The launcher makes `device`
// current for the launch and restores the caller's device after it, and
// returns cudaGetLastError() (or -1 for a head size it is not built for);
// the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 16;          // steps a chunk
constexpr int kThreads = 256;
constexpr float kLo = 1e-8f;    // the decay's clip

template <int HD>
struct Bwd {
  static constexpr int RS = HD + 1;          // padded row stride
  static constexpr int kMat = HD * RS;       // S0, G
  static constexpr int kTile = kL * RS;      // a chunk's [16][hd] tile
  // S0, G; r, k, v, dy, w, lc, b r, a k, SD, GV; B, A; X, 2^lct, u
  static constexpr int kFloats = 2 * kMat + 10 * kTile + 2 * kL * kL + 3 * HD;
};

// 2^x and log2(x) on the special function unit, as csrc/wkv.cu takes them
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_chunked(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u,
                const float* __restrict__ states,
                const float* __restrict__ dy, const float* __restrict__ ds,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ ds0, int T,
                int H) {
  using C = Bwd<HD>;
  constexpr int RS = C::RS;
  extern __shared__ __align__(16) float smem[];
  float* const S0 = smem;
  float* const G = S0 + C::kMat;
  float* const rs = G + C::kMat;
  float* const ks = rs + C::kTile;
  float* const vs = ks + C::kTile;
  float* const dys = vs + C::kTile;
  float* const ws = dys + C::kTile;
  float* const lcs = ws + C::kTile;
  float* const rdec = lcs + C::kTile;     // r[t,d] b[t,d]
  float* const kdec = rdec + C::kTile;    // k[t,d] a[t,d]
  float* const SD = kdec + C::kTile;      // [t][d]
  float* const GV = SD + C::kTile;        // [t][d]
  float* const Bm = GV + C::kTile;        // [t][s]
  float* const A = Bm + kL * kL;          // [t][s]
  float* const X = A + kL * kL;
  float* const sdec = X + HD;
  float* const us = sdec + HD;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const size_t step = (size_t)H * HD;
  const size_t base = ((size_t)b * T * H + h) * HD;
  const int nch = (T + kL - 1) / kL;

  {
    const float* dsp = ds + (size_t)bh * HD * HD;
    for (int i = tid; i < HD * HD; i += kThreads)
      G[(i / HD) * RS + i % HD] = dsp[i];
  }
  for (int i = tid; i < HD; i += kThreads) us[i] = u[h * HD + i];
  float duacc = 0.f;                      // thread d < HD: du[d]'s part

  for (int n = nch - 1; n >= 0; --n) {
    const int t0 = n * kL;
    // 1. the chunk's tiles (zero past T, decay 1) and its saved state
    for (int i = tid; i < kL * HD; i += kThreads) {
      const int t = i / HD, x = i - t * HD;
      const bool in = t0 + t < T;
      const size_t off = base + (size_t)(t0 + t) * step + x;
      rs[t * RS + x] = in ? r[off] : 0.f;
      ks[t * RS + x] = in ? k[off] : 0.f;
      vs[t * RS + x] = in ? v[off] : 0.f;
      dys[t * RS + x] = in ? dy[off] : 0.f;
      ws[t * RS + x] = in ? w[off] : 1.f;
    }
    {
      const float* sp = states + (((size_t)b * nch + n) * H + h) * HD * HD;
      for (int i = tid; i < HD * HD; i += kThreads)
        S0[(i / HD) * RS + i % HD] = sp[i];
    }
    __syncthreads();

    // 2. log decays and the decayed r, k (a thread a channel); B; SD, GV; X
    if (tid < HD) {
      const int d = tid;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        if (t0 + t < T)
          acc += lg2(fminf(fmaxf(ws[t * RS + d], kLo), 1.f));
        lcs[t * RS + d] = acc;
      }
      const float lct = acc;
      sdec[d] = ex2(lct);
      float prev = 0.f;
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        const float lc = lcs[t * RS + d];
        rdec[t * RS + d] = rs[t * RS + d] * ex2(prev);
        kdec[t * RS + d] = ks[t * RS + d] * ex2(lct - lc);
        prev = lc;
      }
    }
    for (int i = tid; i < kL * kL; i += kThreads) {
      const int t = i / kL, s = i - t * kL;
      float acc = 0.f;
      for (int j = 0; j < HD; ++j) acc += dys[t * RS + j] * vs[s * RS + j];
      Bm[i] = acc;
    }
    for (int i = tid; i < kL * HD; i += kThreads) {
      const int t = i / HD, d = i - t * HD;
      float sd = 0.f, gv = 0.f;
      for (int j = 0; j < HD; ++j) {
        sd += S0[d * RS + j] * dys[t * RS + j];
        gv += G[d * RS + j] * vs[t * RS + j];
      }
      SD[t * RS + d] = sd;
      GV[t * RS + d] = gv;
    }
    for (int d = tid; d < HD; d += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < HD; ++j) acc += G[d * RS + j] * S0[d * RS + j];
      X[d] = acc;
    }
    __syncthreads();

    // 3. the forward's A, and du's part
    for (int i = tid; i < kL * kL; i += kThreads) {
      const int t = i / kL, s = i - t * kL;
      float acc = 0.f;
      if (s < t) {
        for (int d = 0; d < HD; ++d)
          acc += rs[t * RS + d] * ks[s * RS + d] *
                 ex2(lcs[(t - 1) * RS + d] - lcs[s * RS + d]);
      } else if (s == t) {
        for (int d = 0; d < HD; ++d)
          acc += rs[t * RS + d] * us[d] * ks[t * RS + d];
      }
      A[i] = acc;
    }
    if (tid < HD) {
#pragma unroll
      for (int t = 0; t < kL; ++t)
        duacc += rs[t * RS + tid] * ks[t * RS + tid] * Bm[t * kL + t];
    }
    __syncthreads();

    // 4. dr, dk, dw a (t, d); dv a (t, j)
    for (int i = tid; i < kL * HD; i += kThreads) {
      const int t = i / HD, d = i - t * HD;
      const float lct = lcs[(kL - 1) * RS + d], lc_t = lcs[t * RS + d];
      const float lp_t = t ? lcs[(t - 1) * RS + d] : 0.f;
      const float a = ex2(lct - lc_t), bt = ex2(lp_t);
      float ek[kL];                       // e[t][q] k_q for q < t, else 0
#pragma unroll
      for (int q = 0; q < kL; ++q)
        ek[q] = q < t ? ex2(lp_t - lcs[q * RS + d]) * ks[q * RS + d] : 0.f;
      const float bd = Bm[t * kL + t], ud = us[d];
      float drv = bt * SD[t * RS + d] + ud * ks[t * RS + d] * bd;
      float inner = bt * X[d];
#pragma unroll
      for (int q = 0; q < kL; ++q) {
        drv += Bm[t * kL + q] * ek[q];
        inner += ek[q] * GV[q * RS + d];
      }
      float dkv = a * GV[t * RS + d] + rs[t * RS + d] * ud * bd;
      float dwv = a * inner;
      for (int s = t + 1; s < kL; ++s) {
        const float er = ex2(lcs[(s - 1) * RS + d] - lc_t) * rs[s * RS + d];
        dkv += Bm[s * kL + t] * er;
        float z = bt * SD[s * RS + d];
#pragma unroll
        for (int q = 0; q < kL; ++q) z += ek[q] * Bm[s * kL + q];
        dwv += er * z;
      }
      if (t0 + t < T) {
        // jnp.clip's gradient: 1 inside the bounds, 1/2 on one, 0 outside
        const float wv = ws[t * RS + d];
        const float cg = (wv > kLo && wv < 1.f)     ? 1.f
                         : (wv == kLo || wv == 1.f) ? 0.5f
                                                    : 0.f;
        const size_t off = base + (size_t)(t0 + t) * step + d;
        dr[off] = drv;
        dk[off] = dkv;
        dw[off] = dwv * cg;
      }
    }
    for (int i = tid; i < kL * HD; i += kThreads) {
      const int t = i / HD, j = i - t * HD;
      float acc = 0.f;
      for (int d = 0; d < HD; ++d) acc += kdec[t * RS + d] * G[d * RS + j];
      for (int s = t; s < kL; ++s) acc += A[s * kL + t] * dys[s * RS + j];
      if (t0 + t < T) dv[base + (size_t)(t0 + t) * step + j] = acc;
    }
    __syncthreads();                      // every read of G done

    // 5. G to the chunk's start
    for (int i = tid; i < HD * HD; i += kThreads) {
      const int d = i / HD, j = i - d * HD;
      float acc = sdec[d] * G[d * RS + j];
#pragma unroll
      for (int t = 0; t < kL; ++t) acc += rdec[t * RS + d] * dys[t * RS + j];
      G[d * RS + j] = acc;
    }
    __syncthreads();
  }

  {
    float* o = ds0 + (size_t)bh * HD * HD;
    for (int i = tid; i < HD * HD; i += kThreads)
      o[i] = G[(i / HD) * RS + i % HD];
  }
  if (tid < HD) du_part[(size_t)bh * HD + tid] = duacc;
}

// du[h, d] = sum over b, in order, of the blocks' parts
__global__ void wkv_bwd_du(const float* __restrict__ du_part,
                           float* __restrict__ du, int B, int HHD) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HHD) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[(size_t)b * HHD + i];
  du[i] = acc;
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* states, const float* dy,
           const float* ds, float* dr, float* dk, float* dv, float* dw,
           float* du_part, float* du, float* ds0, int B, int T, int H,
           int device, cudaStream_t stream) {
  constexpr int smem = Bwd<HD>::kFloats * (int)sizeof(float);
  static unsigned opted_in = 0;   // devices whose attribute is set (bit)
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (smem > 48 * 1024 && !(opted_in & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_chunked<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= bit;
  }
  wkv_bwd_chunked<HD><<<B * H, kThreads, smem, stream>>>(
      r, k, v, w, u, states, dy, ds, dr, dk, dv, dw, du_part, ds0, T, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int hhd = H * HD;
  wkv_bwd_du<<<(hhd + 255) / 256, 256, 0, stream>>>(du_part, du, B, hhd);
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

// r, k, v, w, dy, dr, dk, dv, dw [B, T, H, hd]; u, du [H, hd]; states
// [B, ceil(T / 16), H, hd, hd] (the forward's chunk-entry states); ds, ds0
// [B, H, hd, hd]; du_part [B, H, hd] scratch.  Two launches.
extern "C" int wkv_bwd_launch(const void* r, const void* k, const void* v,
                              const void* w, const void* u,
                              const void* states, const void* dy,
                              const void* ds, void* dr, void* dk, void* dv,
                              void* dw, void* du_part, void* du, void* ds0,
                              int B, int T, int H, int hd, int device,
                              void* stream) {
  if (B == 0 || H == 0) return 0;
  const float *rp = (const float*)r, *kp = (const float*)k,
              *vp = (const float*)v, *wp = (const float*)w,
              *up = (const float*)u, *sp = (const float*)states,
              *dyp = (const float*)dy, *dsp = (const float*)ds;
  float *drp = (float*)dr, *dkp = (float*)dk, *dvp = (float*)dv,
        *dwp = (float*)dw, *pp = (float*)du_part, *dup = (float*)du,
        *d0p = (float*)ds0;
  const cudaStream_t st = (cudaStream_t)stream;
#define WKV_BWD_CASE(HD)                                                    \
  if (hd == HD)                                                             \
    return on_device(device, [&] {                                          \
      return launch<HD>(rp, kp, vp, wp, up, sp, dyp, dsp, drp, dkp, dvp,    \
                        dwp, pp, dup, d0p, B, T, H, device, st);            \
    });
  WKV_BWD_CASE(16) WKV_BWD_CASE(32) WKV_BWD_CASE(64) WKV_BWD_CASE(128)
#undef WKV_BWD_CASE
  return -1;
}
