// Backward of causal / sliding-window attention (sm_90a).
//
// The JAX package has no backward kernel: it differentiates its plain
// attention (repro/models/layers.py), and its Pallas forward
// repro/kernels/flash_attention.py:77 (flash_attention) is never
// differentiated.  This is the backward of the port's forward kernel
// (csrc/flash_attention.cu) on the same function.  q [B, H, S, hd], k, v
// [B, KV, T, hd] (query head h reads key head h / (H / KV)) and dO
// [B, H, S, hd], f32 or bf16, give dq, dk, dv in the inputs' dtype:
//
//   s  = (q . k) * scale, masked unless k <= q + off (causal) and
//        k > q + off - window (window > 0); off is the key position of
//        query 0, T - S by default (queries right-aligned), a shard's
//        first position when the queries are split over ranks
//   P  = softmax(s) over the visible keys           (f32)
//   dP = dO . v,  D = rowsum(P * dP),  dS = P (dP - D)
//   dq = scale dS k,  dk = scale dS^T q,  dv = P^T dO
//
// All of it is summed in f32 and rounded to the inputs' dtype once.  D is
// summed from P and dP, not as rowsum(dO * O) from the forward's output:
// a bf16 O is rounded, and D must be the f32 function's (its error
// multiplies every dS of the row).  No atomics, every sum in a fixed
// order, so two calls on one input give one bit pattern.  A causal row
// that sees no key (off < 0) is refused by the Python wrapper: the
// forward's softmax over an all-masked row has no gradient formed here.
// The bound counts 2 hd FLOPs a visible (query, key) pair for each of s,
// dP, dq, dk and dv (10 hd); at the recurrentgemma-2b train step (B 16,
// H 10, KV 1, S = T = 256, hd 256, causal: 5.26e6 pairs) its 71 MB of
// inputs and outputs take longer at 3.35 TB/s than its operations.
//
// The dtype picks one of two routes behind flash_attention_bwd_launch.
//
// bf16: the tensor cores (namespace tc), three launches.
//   * Every product is wgmma m64n64k16 with bf16 operands and f32 sums
//     (the forward's building blocks, csrc/wgmma.cuh).  s and dP have
//     exact bf16 operands.  P and dS are formed in f32 and enter dv, dq
//     and dk as two bf16 operands, hi = bf16(x) and lo = bf16(x - hi),
//     two products into one accumulator, as the forward splits P: one
//     bf16 rounding of each put dq / dk / dv at 3.7 / 6.1 / 11.3x the
//     check's tolerance in an emulation at hd 256 and ten heads on one
//     key head, the splits at 0.75x (tests/test_torch_attn_bwd_split.py).
//   * dq pass (attn_bwd_dq_wgmma): a block owns 64 query rows of one
//     (batch, head), two warpgroups.  Warpgroup 0 forms s = Q K^T,
//     warpgroup 1 dP = dO V^T, over the key tiles the rows may see
//     (double-buffered by cp.async), twice.  Walk 1 keeps each row's
//     running max and sum (warpgroup 0) and D in the same online form
//     (warpgroup 1, from P and the rescale handed over in shared
//     memory); it stores the row's log-sum-exp and D.  Walk 2 hands P
//     over, warpgroup 1 forms dS in place, and each warpgroup adds dS K
//     into half of dq's 64-column blocks (dq 64 registers a thread at hd
//     256).  Blocks start with the last query tiles, whose key ranges
//     are the longest.
//   * dk/dv pass (attn_bwd_dkv_wgmma): a block owns 64 keys of one
//     (batch, key head) and one part of the key head's group of query
//     heads, and walks the query tiles that may see its keys, head by
//     head in order.  Warpgroup 0 forms s^T = K Q^T and P^T and adds dV
//     += P^T dO; warpgroup 1 forms dP^T = V dO^T, takes P^T through
//     shared memory and adds dK += dS^T Q.  So each accumulator is 64
//     keys x hd in one warpgroup (128 registers a thread at hd 256), P
//     and dS are formed once, and the products' A operands stay in
//     registers.  With one part a block adds its whole group in order
//     and writes bf16; with more (the GQA sum spread over the card: the
//     train step's 4 key tiles x 16 (batch, key head) are 64 blocks on
//     132 SMs) each writes f32 partial sums, and attn_bwd_gqa_sum adds
//     the parts in order and rounds once.  The Python wrapper picks the
//     fewest parts that give two blocks an SM.
//   * Work: s and dP in both walks of the dq pass and in the dk/dv pass
//     (12 hd FLOPs a visible pair), dq, dk and dv split (12 hd): 24 hd
//     against the bound's 10 hd, all on the tensor cores.
//   * Shared memory at hd 256: six 32 KB tiles, a 16 KB f32 tile that
//     hands P and dS between the warpgroups, 3 KB more: 211 KB, one
//     block an SM.
//
// f32: the CUDA cores (the f32 reduced configs and the card / CPU check
// of the train step; the tensor cores cannot meet its 3e-5 tolerance).
// Two launches:
//
//   dq pass: a block owns 32 query rows of one (batch, head) and walks
//     the key tiles they may see twice.  The first walk keeps each row's
//     running max m, sum l and D in the online form of the forward (a
//     rescale when the max moves); it stores (m, l, D) for the key pass.
//     The second walk forms dS tile by tile and adds dS k into dq.
//   dk/dv pass: a block owns 32 keys of one (batch, key head) and walks,
//     for each query head of the group in order (ten heads on one key
//     head in recurrentgemma-2b), the query tiles that may see them; P
//     comes from the stored (m, l), dS from D, and dk and dv sum over the
//     group's heads in that order (the GQA sum, without atomics).
//
// A tile pair is 256 threads: thread (ty, tx) forms the scores and dP of
// rows ty, ty + 16 and keys tx, tx + 16 from float4 reads of tiles kept
// in shared memory as f32 (rows padded by 4 floats: the 8 lanes of a
// float4 phase read rows 0..7, banks 0, 4, .., 28); a row's max and sums
// are xor shuffles over its 16 lanes, which leave every lane the same
// bits.  The products into dq, dk, dv give each thread one column of hd
// and 32 hd / 256 rows (keys) of it, with the tile's P and dS broadcast
// from shared memory.  The walks form s and dP three times: 18 hd FLOPs
// a visible pair on the 67 TFLOP/s f32 units.
//
// Plain C interface, loaded with ctypes.  The launcher makes `device`
// current for the launches and restores the caller's device after them,
// and returns cudaGetLastError() (or -1 for a head size, dtype or part
// count it does not take); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 route: CUDA cores

constexpr float kNegInf = -1e30f;
constexpr int kBT = 32;        // query rows of a query tile, keys of a key tile
constexpr int kThreads = 256;
constexpr int kPS = kBT + 1;   // padded row of the P and dS tiles

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

__device__ __forceinline__ bool visible(int key, int qp, int causal,
                                        int window) {
  return (!causal || key <= qp) && (window <= 0 || key > qp - window);
}

// Rows r0 .. r0 + 31 of [n, HD] (row stride `rs`) into a [32][HD + 4] f32
// tile; rows past n are zero.
template <class T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int r0, int n) {
  constexpr int KP = HD + 4;
  for (int idx = threadIdx.x; idx < kBT * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    dst[r * KP + d] = r0 + r < n ? to_f32(src[(r0 + r) * rs + d]) : 0.f;
  }
}

// out[i][j] = A[ty + 16 i] . Bm[tx + 16 j] over HD, for two tiles at once
// (s from q and k, dP from dO and v), summed in d order.
template <int HD>
__device__ __forceinline__ void dots2(const float* A, const float* Bm,
                                      const float* C, const float* Dm, int ty,
                                      int tx, float s[2][2], float p[2][2]) {
  constexpr int KP = HD + 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = p[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[2], b[2], c[2], e[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * KP + d);
      c[i] = *reinterpret_cast<const float4*>(C + (ty + 16 * i) * KP + d);
      b[i] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * i) * KP + d);
      e[i] = *reinterpret_cast<const float4*>(Dm + (tx + 16 * i) * KP + d);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                   a[i].w * b[j].w;
        p[i][j] += c[i].x * e[j].x + c[i].y * e[j].y + c[i].z * e[j].z +
                   c[i].w * e[j].w;
      }
  }
}

// over the 16 lanes of a row group (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kBT * (HD + 4) + kBT * kPS);
}

template <int HD>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kBT * (HD + 4) + 2 * kBT * kPS + 3 * kBT);
}

// stats: m at [0, n), l at [n, 2n), D at [2n, 3n), n = B * H * S, row
// (b * H + h) * S + i.
template <class T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            T* __restrict__ dq, float* __restrict__ stats, int H, int group,
            int S, int Tk, Strides qs, Strides ks, Strides vs, Strides dos,
            Strides dqs, int causal, int window, int off, float scale) {
  constexpr int KP = HD + 4;
  constexpr int RPT = kBT * HD / kThreads;   // rows of dq a thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBT * KP;
  float* k_s = do_s + kBT * KP;
  float* v_s = k_s + kBT * KP;
  float* ds_s = v_s + kBT * KP;              // [32][33]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = blockIdx.x * kBT;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_tile<T, HD>(q_s, qb, qs.s, q0, S);
  load_tile<T, HD>(do_s, dob, dos.s, q0, S);

  const int qp_first = q0 + off;
  const int qp_last = min(q0 + kBT, S) - 1 + off;
  int k_begin = 0, k_end = Tk;
  if (causal) k_end = min(Tk, qp_last + 1);
  if (window > 0) k_begin = max(0, qp_first - window + 1);
  const int kt0 = (k_begin / kBT) * kBT;

  float m[2], l[2], dn[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    dn[i] = 0.f;
  }
  // walk 1: m, l and D = sum P dP, online
  for (int kt = kt0; kt < k_end; kt += kBT) {
    __syncthreads();
    load_tile<T, HD>(k_s, kb, ks.s, kt, Tk);
    load_tile<T, HD>(v_s, vb, vs.s, kt, Tk);
    __syncthreads();
    float s[2][2], dp[2][2];
    dots2<HD>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + ty + 16 * i + off;
      float sc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kt + tx + 16 * j;
        sc[j] = key < Tk && visible(key, qp, causal, window)
                    ? s[i][j] * scale : kNegInf;
      }
      const float m_new = fmaxf(m[i], row_max(fmaxf(sc[0], sc[1])));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool real = kt + tx + 16 * j < Tk;
        const float p = real ? expf(sc[j] - m_new) : 0.f;
        ps += p;
        pd += p * dp[i][j];
      }
      l[i] = l[i] * alpha + row_sum(ps);
      dn[i] = dn[i] * alpha + row_sum(pd);
      m[i] = m_new;
    }
  }
  float dsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dsum[i] = dn[i] / l[i];
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < S) {
      const long long n = (long long)gridDim.y * S;
      const long long at = (long long)bh * S + row;
      stats[at] = m[i];
      stats[n + at] = l[i];
      stats[2 * n + at] = dsum[i];
    }
  }

  // walk 2: dS tile by tile, dq += dS k
  const int c = tid % HD, rg = tid / HD;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
  for (int kt = kt0; kt < k_end; kt += kBT) {
    __syncthreads();
    load_tile<T, HD>(k_s, kb, ks.s, kt, Tk);
    load_tile<T, HD>(v_s, vb, vs.s, kt, Tk);
    __syncthreads();
    float s[2][2], dp[2][2];
    dots2<HD>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + ty + 16 * i + off;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kt + tx + 16 * j;
        const float p = key < Tk && visible(key, qp, causal, window)
                            ? expf(s[i][j] * scale - m[i]) / l[i] : 0.f;
        ds_s[(ty + 16 * i) * kPS + tx + 16 * j] = p * (dp[i][j] - dsum[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      const float kv = k_s[j * KP + c];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        acc[r] += ds_s[(rg * RPT + r) * kPS + j] * kv;
    }
  }
  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + rg * RPT + r;
    if (row < S) put(dqb + row * dqs.s + c, acc[r] * scale);
  }
}

template <class T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ stats, T* __restrict__ dk,
             T* __restrict__ dv, int H, int KV, int group, int S, int Tk,
             Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
             Strides dvs, int causal, int window, int off, float scale) {
  constexpr int KP = HD + 4;
  constexpr int KPT = kBT * HD / kThreads;   // keys of dk, dv a thread
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBT * KP;
  float* q_s = v_s + kBT * KP;
  float* do_s = q_s + kBT * KP;
  float* p_s = do_s + kBT * KP;              // [32][33]
  float* ds_s = p_s + kBT * kPS;             // [32][33]
  float* m_s = ds_s + kBT * kPS;             // [32] each
  float* l_s = m_s + kBT;
  float* d_s = l_s + kBT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bk = blockIdx.y, b = bk / KV, hk = bk - b * KV;
  const int k0 = blockIdx.x * kBT;
  const long long n = (long long)gridDim.y * group * S;   // B * H * S
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  load_tile<T, HD>(k_s, kb, ks.s, k0, Tk);
  load_tile<T, HD>(v_s, vb, vs.s, k0, Tk);

  // the query rows that may see a key of this tile
  const int k_last = min(k0 + kBT, Tk) - 1;
  const int r_begin = causal ? max(0, k0 - off) : 0;
  const int r_end = window > 0 ? min(S, k_last + window - off) : S;
  const int c = tid % HD, kg = tid / HD;
  float dk_acc[KPT], dv_acc[KPT];
#pragma unroll
  for (int r = 0; r < KPT; ++r) dk_acc[r] = dv_acc[r] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const long long srow = ((long long)b * H + h) * S;
    for (int qt = (r_begin / kBT) * kBT; qt < r_end; qt += kBT) {
      __syncthreads();
      load_tile<T, HD>(q_s, qb, qs.s, qt, S);
      load_tile<T, HD>(do_s, dob, dos.s, qt, S);
      if (tid < kBT) {
        const bool in = qt + tid < S;
        m_s[tid] = in ? stats[srow + qt + tid] : 0.f;
        l_s[tid] = in ? stats[n + srow + qt + tid] : 1.f;
        d_s[tid] = in ? stats[2 * n + srow + qt + tid] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      dots2<HD>(q_s, k_s, do_s, v_s, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = ty + 16 * i;
        const int qp = qt + row + off;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = k0 + tx + 16 * j;
          const float p = qt + row < S && key < Tk &&
                                  visible(key, qp, causal, window)
                              ? expf(s[i][j] * scale - m_s[row]) / l_s[row]
                              : 0.f;
          p_s[row * kPS + tx + 16 * j] = p;
          ds_s[row * kPS + tx + 16 * j] = p * (dp[i][j] - d_s[row]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kBT; ++i) {
        const float dov = do_s[i * KP + c], qv = q_s[i * KP + c];
#pragma unroll
        for (int r = 0; r < KPT; ++r) {
          dv_acc[r] += p_s[i * kPS + kg * KPT + r] * dov;
          dk_acc[r] += ds_s[i * kPS + kg * KPT + r] * qv;
        }
      }
    }
  }
  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < KPT; ++r) {
    const int key = k0 + kg * KPT + r;
    if (key < Tk) {
      put(dkb + key * dks.s + c, dk_acc[r] * scale);
      put(dvb + key * dvs.s + c, dv_acc[r]);
    }
  }
}

template <class T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats, int B, int H, int KV,
           int S, int Tk, Strides qs, Strides ks, Strides vs, Strides dos,
           Strides dqs, Strides dks, Strides dvs, int causal, int window,
           int off,
           float scale, cudaStream_t st) {
  constexpr size_t s1 = dq_smem<HD>(), s2 = dkv_smem<HD>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(attn_bwd_dq<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s1)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(attn_bwd_dkv<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s2)) != cudaSuccess)
    return (int)err;
  const int group = H / KV;
  const T *qp = (const T*)q, *kp = (const T*)k, *vp = (const T*)v,
          *dop = (const T*)dout;
  attn_bwd_dq<T, HD><<<dim3((S + kBT - 1) / kBT, B * H), kThreads, s1, st>>>(
      qp, kp, vp, dop, (T*)dq, stats, H, group, S, Tk, qs, ks, vs, dos, dqs,
      causal, window, off, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_bwd_dkv<T, HD><<<dim3((Tk + kBT - 1) / kBT, B * KV), kThreads, s2,
                        st>>>(qp, kp, vp, dop, stats, (T*)dk, (T*)dv, H, KV,
                              group, S, Tk, qs, ks, vs, dos, dks, dvs, causal,
                              window, off, scale);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* dout, void* dq, void* dk, void* dv, float* stats,
                int B, int H, int KV, int S, int Tk, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dqs, Strides dks,
                Strides dvs, int causal, int window, int off, float scale,
                cudaStream_t st) {
#define ATTN_BWD_HD(HD)                                                      \
  case HD:                                                                   \
    return launch<T, HD>(q, k, v, dout, dq, dk, dv, stats, B, H, KV, S, Tk,  \
                         qs, ks, vs, dos, dqs, dks, dvs, causal, window,     \
                         off, scale, st);
  switch (hd) {
    ATTN_BWD_HD(32)
    ATTN_BWD_HD(64)
    ATTN_BWD_HD(128)
    ATTN_BWD_HD(256)
    default:
      return -1;
  }
#undef ATTN_BWD_HD
}


// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma), cp.async double buffering

namespace tc {

constexpr int kB = 64;           // query rows or keys of a tile: wgmma's M
constexpr int kThreadsTC = 256;  // two warpgroups

template <int HD>
struct BwdTiles {
  static constexpr int kBlocks = HD < 64 ? 1 : HD / 64;
  static constexpr int kTile = kB * kBlocks * 128;  // one 64-row tile
  static constexpr int kX = 32 * 128 * 4;           // 64 x 64 f32
  // six tiles (dq pass: Q, dO and two stages of K and V; dk/dv pass: K,
  // V and two stages of Q and dO), the exchange tile, 2 KB of scalars and
  // room to align the start to 1024 bytes
  static constexpr int kSmem = 6 * kTile + kX + 2048 + 1024;
};

// named barriers over both warpgroups (0 is __syncthreads)
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// x = A B^T over HD, 16 at a time: A and B 64-row tiles, K-major
template <int HD>
__device__ __forceinline__ void mma_abt(float (&x)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
  hold(x);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t kc = (kk & 3) * 32;  // 16 elements on in the row
    mma_ss(x, sdesc(a + (kk >> 2) * kB * 128 + kc, 16, 1024),
           sdesc(b + (kk >> 2) * kB * 128 + kc, 16, 1024), kk > 0);
  }
  wg_commit();
  wg_wait_all();
  hold(x);
}

// acc[c] += (hi + lo) B[:, column block c]: A [64 x 64] as two bf16
// operands in registers, B the 64-row tile from column block b on, read
// MN-major (through the transpose bit), 16 rows an instruction
template <int NC>
__device__ __forceinline__ void mma_split(float (&acc)[NC][32],
                                          const uint32_t (&hi)[16],
                                          const uint32_t (&lo)[16],
                                          uint32_t b) {
#pragma unroll
  for (int c = 0; c < NC; ++c) hold(acc[c]);
  wg_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t bd =
          sdesc(b + c * kB * 128 + j * 16 * 128, kB * 128, 1024);
      mma_rs(acc[c], hi + 4 * j, bd);
      mma_rs(acc[c], lo + 4 * j, bd);
    }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int c = 0; c < NC; ++c) hold(acc[c]);
}

// Thread t of a warpgroup holds the 64 x 64 accumulator's entries
// x[i] at row 16 (t / 32) + (t % 32) / 4 + 8 ((i >> 1) & 1) and column
// col(i); the exchange tile keeps them at x_s[i * 128 + t], so the other
// warpgroup's thread t, which holds the same entries, reads them back
// without bank conflicts.
__device__ __forceinline__ int col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// stats: the log-sum-exp of each row's s * scale * log2(e) at [0, n) and
// D at [n, 2n), n = B * H * S, row (b * H + h) * S + i.
template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
attn_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  bf16* __restrict__ dq, float* __restrict__ stats, int H,
                  int group, int S, int Tk, Strides qs, Strides ks,
                  Strides vs, Strides dos, Strides dqs, int causal,
                  int window, int off, float scale) {
  using L = BwdTiles<HD>;
  constexpr int NB = L::kBlocks;
  constexpr int NH = NB > 1 ? NB / 2 : 1;  // dq column blocks a warpgroup
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  const uint32_t do_s = q_s + L::kTile;
  const uint32_t kv_s = do_s + L::kTile;  // stage j: K, then V
  float* x_s =
      reinterpret_cast<float*>(smem_raw + (q_s - raw) + 6 * L::kTile);
  float* a_s = x_s + 32 * 128;  // [2][128]: walk 1's rescale of a row
  float* l_s = a_s + 2 * 128;   // [2][128]: the row's sum
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5,
            lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, hk = h / group;
  // the last query tiles first: theirs are the longest key ranges
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  const int qp_first = q0 + off;
  const int qp_last = min(q0 + kB, S) - 1 + off;
  int k_begin = 0, k_end = Tk;
  if (causal) k_end = min(Tk, qp_last + 1);
  if (window > 0) k_begin = max(0, qp_first - window + 1);
  const int t0 = k_begin / kB;
  const int n = k_end > k_begin ? (k_end + kB - 1) / kB - t0 : 0;

  load_tile<HD, kB, kThreadsTC>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<HD, kB, kThreadsTC>(do_s, dout + b * dos.b + h * dos.h, dos.s,
                                q0, S);
  if (n > 0) {
    load_tile<HD, kB, kThreadsTC>(kv_s, kb, ks.s, t0 * kB, Tk);
    load_tile<HD, kB, kThreadsTC>(kv_s + L::kTile, vb, vs.s, t0 * kB, Tk);
  }
  cp_commit();

  float acc[NH][32];
#pragma unroll
  for (int c = 0; c < NH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const int cb0 = wg * NH;  // this warpgroup's first column block of dq
  const float scale2 = scale * kLog2e;  // softmax in base 2
  // this thread's first query row; its second is 8 rows on
  const int row = q0 + 16 * warp + (lane >> 2);
  const long long srow = (long long)bh * S;
  const long long nst = (long long)gridDim.x * S;  // B * H * S
  // warpgroup 0: running max and this thread's part of the sum, then
  // the log-sum-exp; warpgroup 1: this thread's part of D, then D
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, lse[2] = {0.f, 0.f};
  float dn[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};

  for (int it = 0; it < 2 * n; ++it) {
    const bool walk2 = it >= n;
    const int kt = (t0 + (walk2 ? it - n : it)) * kB;
    const uint32_t k_st = kv_s + (it & 1) * 2 * L::kTile;
    const uint32_t v_st = k_st + L::kTile;
    cp_wait_all();  // this thread's copies of tile it (and of Q, dO)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's copies; step it - 1 fully consumed
    if (it + 1 < 2 * n) {
      const int nt = (t0 + (it + 1 >= n ? it + 1 - n : it + 1)) * kB;
      const uint32_t nxt = kv_s + ((it + 1) & 1) * 2 * L::kTile;
      load_tile<HD, kB, kThreadsTC>(nxt, kb, ks.s, nt, Tk);
      load_tile<HD, kB, kThreadsTC>(nxt + L::kTile, vb, vs.s, nt, Tk);
    }
    cp_commit();
    if (it == n && wg == 1) {
      // walk 1 is over: D = (sum P~ dP) / l of each row
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dn[hh] += __shfl_xor_sync(0xffffffffu, dn[hh], 1);
        dn[hh] += __shfl_xor_sync(0xffffffffu, dn[hh], 2);
        dsum[hh] = dn[hh] / l_s[hh * 128 + t];
        const int r = row + 8 * hh;
        if ((lane & 3) == 0 && r < S) stats[nst + srow + r] = dsum[hh];
      }
    }

    // s = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1)
    float x[32];
    mma_abt<HD>(x, wg == 0 ? q_s : do_s, wg == 0 ? k_st : v_st);
    // element masks only on a tile that straddles an edge
    const bool edge = kt + kB > Tk || (causal && kt + kB - 1 > qp_first) ||
                      (window > 0 && kt <= qp_last - window);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x2 = x[i] * scale2;
        if (edge) {
          const int key = kt + col(i, lane);
          const int qp = row + 8 * ((i >> 1) & 1) + off;
          if (!(key < Tk && visible(key, qp, causal, window))) x2 = kNegInf;
        }
        x[i] = x2;
      }
      if (!walk2) {
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x[i]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float alpha = exp2f(m[hh] - mx[hh]);
          m[hh] = mx[hh];
          l[hh] *= alpha;
          a_s[hh * 128 + t] = alpha;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1;
          float p = exp2f(x[i] - m[hh]);
          // keys past T carry no weight, even before a row's first key
          if (edge && kt + col(i, lane) >= Tk) p = 0.f;
          l[hh] += p;
          x_s[i * 128 + t] = p;
        }
        bar_arrive(1);
        if (it == n - 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
            lse[hh] = m[hh] + log2f(l[hh]);
            l_s[hh * 128 + t] = l[hh];
            const int r = row + 8 * hh;
            if ((lane & 3) == 0 && r < S) stats[srow + r] = lse[hh];
          }
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x_s[i * 128 + t] = exp2f(x[i] - lse[(i >> 1) & 1]);
      bar_arrive(1);
      bar_sync(2);  // dS is in x_s
    } else {
      bar_sync(1);  // P~ (walk 1) or P (walk 2) is in x_s
      if (!walk2) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) dn[hh] *= a_s[hh * 128 + t];
#pragma unroll
        for (int i = 0; i < 32; ++i)
          dn[(i >> 1) & 1] += x_s[i * 128 + t] * x[i];
        continue;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x_s[i * 128 + t] *= x[i] - dsum[(i >> 1) & 1];
      bar_sync(2);
    }
    // dq += dS K over this warpgroup's column blocks, dS as hi + lo
    if (cb0 < NB) {
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = x_s[i * 128 + t];
      uint32_t hi[16], lo[16];
      split(x, hi, lo);
      mma_split<NH>(acc, hi, lo, k_st + cb0 * kB * 128);
    }
  }
  cp_wait_all();

  if (cb0 < NB) {
    bf16* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = row + 8 * ((i >> 1) & 1);
        const int cl = (cb0 + c) * 64 + col(i, lane);
        if (r < S && cl < HD)
          *reinterpret_cast<__nv_bfloat162*>(dqb + r * dqs.s + cl) =
              __floats2bfloat162_rn(acc[c][i] * scale,
                                    acc[c][i + 1] * scale);
      }
  }
}

// part: f32 partial sums [2][parts][B * KV * T * hd] (dk, then dv) when
// parts > 1.
template <int HD>
__global__ void __launch_bounds__(kThreadsTC, 1)
attn_bwd_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ stats, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, float* __restrict__ part, int H,
                   int KV, int group, int parts, int S, int Tk, Strides qs,
                   Strides ks, Strides vs, Strides dos, Strides dks,
                   Strides dvs, int causal, int window, int off, float scale) {
  using L = BwdTiles<HD>;
  constexpr int NB = L::kBlocks;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + L::kTile;
  const uint32_t qd_s = v_s + L::kTile;  // stage j: Q, then dO
  float* x_s =
      reinterpret_cast<float*>(smem_raw + (k_s - raw) + 6 * L::kTile);
  float* st_s = x_s + 32 * 128;  // stage j: lse [64], then D [64]
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, warp = t >> 5,
            lane = tid & 31;
  const int bk = blockIdx.x / parts, p = blockIdx.x - bk * parts;
  const int b = bk / KV, hk = bk - b * KV;
  // the first key tiles first: under the causal mask theirs are the
  // longest query ranges
  const int k0 = blockIdx.y * kB;
  const int hpp = group / parts;        // query heads of this part
  const int h0 = hk * group + p * hpp;  // the first of them
  const long long nbk = gridDim.x / parts;  // B * KV
  const long long nst = nbk / KV * H * S;   // B * H * S

  load_tile<HD, kB, kThreadsTC>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, Tk);
  load_tile<HD, kB, kThreadsTC>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, Tk);

  // the query rows that may see a key of this tile
  const int k_last = min(k0 + kB, Tk) - 1;
  const int r_begin = causal ? max(0, k0 - off) : 0;
  const int r_end = window > 0 ? min(S, k_last + window - off) : S;
  const int qt0 = r_begin / kB;
  const int nq = r_end > r_begin ? (r_end + kB - 1) / kB - qt0 : 0;
  const int n = hpp * nq;  // steps: the part's heads x the query tiles

  // Q, dO, lse and D of step i into stage j (the scalars by plain loads,
  // seen after the __syncthreads that starts the step)
  auto fetch = [&](int i, int j) {
    const int h = h0 + i / nq, qt = (qt0 + i % nq) * kB;
    const uint32_t dst = qd_s + j * 2 * L::kTile;
    load_tile<HD, kB, kThreadsTC>(dst, q + b * qs.b + h * qs.h, qs.s, qt, S);
    load_tile<HD, kB, kThreadsTC>(dst + L::kTile,
                                  dout + b * dos.b + h * dos.h, dos.s, qt,
                                  S);
    if (tid < 2 * kB) {
      const int r = qt + (tid & (kB - 1));
      const long long at = ((long long)b * H + h) * S + r;
      st_s[j * 2 * kB + tid] = r < S ? stats[(tid < kB ? 0 : nst) + at] : 0.f;
    }
  };
  if (n > 0) fetch(0, 0);
  cp_commit();

  float acc[NB][32];  // warpgroup 0: dV, warpgroup 1: dK (without scale)
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  const float scale2 = scale * kLog2e;
  // this thread's first key; its second is 8 keys on
  const int key = k0 + 16 * warp + (lane >> 2);

  for (int it = 0; it < n; ++it) {
    const int qt = (qt0 + it % nq) * kB;
    const uint32_t q_st = qd_s + (it & 1) * 2 * L::kTile;
    const uint32_t do_st = q_st + L::kTile;
    const float* lse_t = st_s + (it & 1) * 2 * kB;
    const float* d_t = lse_t + kB;
    cp_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's copies; step it - 1 fully consumed
    if (it + 1 < n) fetch(it + 1, (it + 1) & 1);
    cp_commit();

    // s^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    float x[32];
    mma_abt<HD>(x, wg == 0 ? k_s : v_s, wg == 0 ? q_st : do_st);
    const bool edge = qt + kB > S || k0 + kB > Tk ||
                      (causal && k0 + kB - 1 > qt + off) ||
                      (window > 0 && k0 <= qt + kB - 1 + off - window);
    if (wg == 0) {
      // P^T = exp2(s' - lse) of the visible pairs
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = col(i, lane);
        float pv = exp2f(x[i] * scale2 - lse_t[c]);
        if (edge) {
          const int kr = key + 8 * ((i >> 1) & 1), qr = qt + c;
          if (!(kr < Tk && qr < S && visible(kr, qr + off, causal, window)))
            pv = 0.f;
        }
        x[i] = pv;
        x_s[i * 128 + t] = pv;
      }
      bar_arrive(1);
    } else {
      bar_sync(1);  // P^T is in x_s
#pragma unroll
      for (int i = 0; i < 32; ++i)
        x[i] = x_s[i * 128 + t] * (x[i] - d_t[col(i, lane)]);
    }
    // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1), as hi + lo
    uint32_t hi[16], lo[16];
    split(x, hi, lo);
    mma_split<NB>(acc, hi, lo, wg == 0 ? do_st : q_st);
  }
  cp_wait_all();

#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = key + 8 * ((i >> 1) & 1);
      const int cl = c * 64 + col(i, lane);
      if (r >= Tk || cl >= HD) continue;
      if (parts == 1) {
        const float f = wg == 0 ? 1.f : scale;
        bf16* o = wg == 0 ? dv + b * dvs.b + hk * dvs.h + r * dvs.s
                          : dk + b * dks.b + hk * dks.h + r * dks.s;
        *reinterpret_cast<__nv_bfloat162*>(o + cl) =
            __floats2bfloat162_rn(acc[c][i] * f, acc[c][i + 1] * f);
      } else {
        float* o = part + ((long long)(1 - wg) * parts + p) * nbk * Tk * HD +
                   ((long long)bk * Tk + r) * HD + cl;
        *reinterpret_cast<float2*>(o) = make_float2(acc[c][i], acc[c][i + 1]);
      }
    }
}

// The GQA sum over parts: dk = scale sum_p part[0][p] and dv = sum_p
// part[1][p], the parts in order, rounded to bf16 once; n = B KV T hd,
// 8 elements a thread (blockIdx.y: 0 dk, 1 dv).
__global__ void __launch_bounds__(256)
attn_bwd_gqa_sum(const float* __restrict__ part, int parts, long long n,
                 int KV, int Tk, int hd, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, Strides dks, Strides dvs,
                 float scale) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  const int y = blockIdx.y;
  const float* src = part + (long long)y * parts * n + i;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(src + p * n);
    const float4 c = *reinterpret_cast<const float4*>(src + p * n + 4);
    s[0] += a.x;
    s[1] += a.y;
    s[2] += a.z;
    s[3] += a.w;
    s[4] += c.x;
    s[5] += c.y;
    s[6] += c.z;
    s[7] += c.w;
  }
  const long long row = i / hd, bk = row / Tk;
  const int d = (int)(i - row * hd), r = (int)(row - bk * Tk);
  const int b = (int)(bk / KV), hk = (int)(bk - (long long)b * KV);
  const Strides os = y ? dvs : dks;
  const float f = y ? 1.f : scale;
  uint4 w;
  w.x = pack(__floats2bfloat162_rn(s[0] * f, s[1] * f));
  w.y = pack(__floats2bfloat162_rn(s[2] * f, s[3] * f));
  w.z = pack(__floats2bfloat162_rn(s[4] * f, s[5] * f));
  w.w = pack(__floats2bfloat162_rn(s[6] * f, s[7] * f));
  *reinterpret_cast<uint4*>((y ? dv : dk) + b * os.b + hk * os.h +
                            r * os.s + d) = w;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats, float* part, int B,
           int H, int KV, int S, int Tk, int parts, Strides qs, Strides ks,
           Strides vs, Strides dos, Strides dqs, Strides dks, Strides dvs,
           int causal, int window, int off, float scale, cudaStream_t st) {
  constexpr int smem = BwdTiles<HD>::kSmem;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(attn_bwd_dq_wgmma<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(attn_bwd_dkv_wgmma<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  const bf16 *qp = (const bf16*)q, *kp = (const bf16*)k,
             *vp = (const bf16*)v, *dop = (const bf16*)dout;
  attn_bwd_dq_wgmma<HD><<<dim3(B * H, (S + kB - 1) / kB), kThreadsTC, smem,
                          st>>>(qp, kp, vp, dop, (bf16*)dq, stats, H, H / KV,
                                S, Tk, qs, ks, vs, dos, dqs, causal, window,
                                off,
                                scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_bwd_dkv_wgmma<HD><<<dim3(B * KV * parts, (Tk + kB - 1) / kB),
                           kThreadsTC, smem, st>>>(
      qp, kp, vp, dop, stats, (bf16*)dk, (bf16*)dv, part, H, KV, H / KV,
      parts, S, Tk, qs, ks, vs, dos, dks, dvs, causal, window, off, scale);
  if ((err = cudaGetLastError()) != cudaSuccess || parts == 1)
    return (int)err;
  const long long n = (long long)B * KV * Tk * HD;
  attn_bwd_gqa_sum<<<dim3((unsigned)((n / 8 + 255) / 256), 2), 256, 0,
                      st>>>(part, parts, n, KV, Tk, HD, (bf16*)dk, (bf16*)dv,
                            dks, dvs, scale);
  return (int)cudaGetLastError();
}

int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* dout, void* dq, void* dk, void* dv, float* stats,
                float* part, int B, int H, int KV, int S, int Tk, int parts,
                Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                Strides dks, Strides dvs, int causal, int window, int off,
                float scale,
                cudaStream_t st) {
#define ATTN_BWD_TC_HD(HD)                                                   \
  case HD:                                                                   \
    return launch<HD>(q, k, v, dout, dq, dk, dv, stats, part, B, H, KV, S,  \
                      Tk, parts, qs, ks, vs, dos, dqs, dks, dvs, causal,     \
                      window, off, scale, st);
  switch (hd) {
    ATTN_BWD_TC_HD(32)
    ATTN_BWD_TC_HD(64)
    ATTN_BWD_TC_HD(128)
    ATTN_BWD_TC_HD(256)
    default:
      return -1;
  }
#undef ATTN_BWD_TC_HD
}

}  // namespace tc

}  // namespace

// dtype 0 is f32 (CUDA cores), 1 is bf16 (tensor cores; q, k, v and dout
// 16-byte aligned with row, head and batch strides in multiples of 8);
// head sizes 32, 64, 128 and 256.  Strides are (batch, head, row) of q,
// k, v, dout, dq, dk, dv in elements, the last axis contiguous.  stats is
// f32 scratch of 3 B H S floats.  parts (bf16 only; 1 for f32) divides
// H / KV; with parts > 1, partial is f32 scratch of 2 parts B KV T hd
// floats.  B, H, S or T = 0 launches nothing.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* stats, void* partial, int B, int H, int KV,
    int S, int T, int hd, int dtype, int parts, const long long* strides,
    int causal, int window, int off, float scale, int device,
    void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (KV <= 0 || H % KV || parts < 1 || (H / KV) % parts ||
      (dtype == 0 && parts != 1) || (parts > 1 && partial == nullptr))
    return -1;
  if (B == 0 || H == 0 || S == 0 || T == 0) return 0;
  Strides s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc =
      dtype == 0
          ? dispatch_hd<float>(hd, q, k, v, dout, dq, dk, dv, (float*)stats,
                               B, H, KV, S, T, s[0], s[1], s[2], s[3], s[4],
                               s[5], s[6], causal, window, off, scale, st)
          : tc::dispatch_hd(hd, q, k, v, dout, dq, dk, dv, (float*)stats,
                            (float*)partial, B, H, KV, S, T, parts, s[0],
                            s[1], s[2], s[3], s[4], s[5], s[6], causal,
                            window, off, scale, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (rc == 0 && back != cudaSuccess) return (int)back;
  }
  return rc;
}
