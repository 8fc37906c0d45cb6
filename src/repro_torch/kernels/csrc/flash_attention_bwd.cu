// Backward of causal / sliding-window attention (sm_90a), on the CUDA
// cores.
//
// The JAX package has no backward kernel: it differentiates its plain
// attention (repro/models/layers.py), and its Pallas forward
// repro/kernels/flash_attention.py:77 (flash_attention) is never
// differentiated.  This is the backward of the port's forward kernel
// (csrc/flash_attention.cu) on the same function.  q [B, H, S, hd], k, v
// [B, KV, T, hd] (query head h reads key head h / (H / KV)) and dO
// [B, H, S, hd], f32 or bf16, give dq, dk, dv in the inputs' dtype:
//
//   s  = (q . k) * scale, masked unless k <= q + (T - S) (causal, queries
//        right-aligned) and k > q + (T - S) - window (window > 0)
//   P  = softmax(s) over the visible keys           (f32)
//   dP = dO . v,  D = rowsum(P * dP),  dS = P (dP - D)
//   dq = scale dS k,  dk = scale dS^T q,  dv = P^T dO
//
// All of it is summed in f32 and rounded to the inputs' dtype once.  D is
// summed from P and dP, not as rowsum(dO * O) from the forward's output:
// a bf16 O is rounded, and D must be the f32 function's (its error
// multiplies every dS of the row).
//
// Two launches on one stream, no atomics, every sum in a fixed order, so
// two calls on one input give one bit pattern:
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
// from shared memory.
//
// What bounds it on an H100: operations, on the CUDA cores (f32).  A
// visible (query, key) pair takes 2 hd FLOPs for each of s, dP, dq, dk and
// dv (10 hd); the walks here recompute s and dP twice more (14 hd).  At
// the recurrentgemma-2b train step (B 16, H 10, KV 1, S = T = 256, hd 256,
// causal) that is 5.26e6 pairs a call.  A causal row that sees no key (T
// < S) is refused by the Python wrapper: the forward's softmax over an
// all-masked row has no gradient this kernel forms.
//
// Plain C interface, loaded with ctypes.  The launcher makes `device`
// current for the launches and restores the caller's device after them,
// and returns cudaGetLastError() (or -1 for a head size or dtype it does
// not take); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBT = 32;        // query rows of a query tile, keys of a key tile
constexpr int kThreads = 256;
constexpr int kPS = kBT + 1;   // padded row of the P and dS tiles

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
            Strides dqs, int causal, int window, float scale) {
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
  const int off = Tk - S;
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
             Strides dvs, int causal, int window, float scale) {
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
  const int off = Tk - S;
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
      causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_bwd_dkv<T, HD><<<dim3((Tk + kBT - 1) / kBT, B * KV), kThreads, s2,
                        st>>>(qp, kp, vp, dop, stats, (T*)dk, (T*)dv, H, KV,
                              group, S, Tk, qs, ks, vs, dos, dks, dvs, causal,
                              window, scale);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                const void* dout, void* dq, void* dk, void* dv, float* stats,
                int B, int H, int KV, int S, int Tk, Strides qs, Strides ks,
                Strides vs, Strides dos, Strides dqs, Strides dks,
                Strides dvs, int causal, int window, float scale,
                cudaStream_t st) {
#define ATTN_BWD_HD(HD)                                                      \
  case HD:                                                                   \
    return launch<T, HD>(q, k, v, dout, dq, dk, dv, stats, B, H, KV, S, Tk,  \
                         qs, ks, vs, dos, dqs, dks, dvs, causal, window,     \
                         scale, st);
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

}  // namespace

// dtype 0 is f32, 1 is bf16; head sizes 32, 64, 128 and 256.  Strides are
// (batch, head, row) of each tensor in elements, the last axis contiguous.
// stats is f32 scratch of 3 B H S floats.  B, H, S or T = 0 launches
// nothing.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, void* stats, int B, int H, int KV, int S, int T,
    int hd, int dtype, const long long* strides, int causal, int window,
    float scale, int device, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
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
                               s[5], s[6], causal, window, scale, st)
          : dispatch_hd<__nv_bfloat16>(hd, q, k, v, dout, dq, dk, dv,
                                       (float*)stats, B, H, KV, S, T, s[0],
                                       s[1], s[2], s[3], s[4], s[5], s[6],
                                       causal, window, scale, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (rc == 0 && back != cudaSuccess) return (int)back;
  }
  return rc;
}
