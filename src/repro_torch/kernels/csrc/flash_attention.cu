// Causal / sliding-window attention with an online softmax (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel).  q [B, H, S, hd] and k, v
// [B, KV, T, hd] (query head h reads key head h / (H / KV)), f32 or bf16,
// give o [B, H, S, hd] in q's dtype:
//
//   s = (q . k) / sqrt(hd), masked to -1e30 unless
//       k <= q + (T - S)            (causal; queries right-aligned)
//       k >  q + (T - S) - window   (window > 0)
//   o = softmax(s) v, with the running max m, sum l and acc in f32.
//
// Every tensor is addressed through (batch, head, row) strides with a
// contiguous last axis, so the model's [B, S, H, hd] projections and its
// [B, S, H, hd] output need no transpose, and the single key head of
// multi-query attention is read in place of H copies.
//
// Design.  The TPU kernel ran a (batch * head, q block, kv block) grid
// whose kv axis is sequential and carried m, l and acc in VMEM from one
// kv step to the next.  Blocks on a GPU run in no order, so here one
// block owns a tile of 32 queries of one (batch, head) and loops over
// the 32-key tiles itself, visiting only the tiles that hold a key some
// row of the tile may see (the causal edge and the window's lower edge
// cut the loop).  Four warps, 8 query rows each.  Q, K and V tiles sit in
// shared memory as f32 (K rows padded by 4 floats so that neighbouring
// lanes' float4 reads of different key rows hit different banks):
//   scores: lane j computes the 8 scores of key j for its warp's rows,
//           from float4 reads of its K row and broadcast Q rows;
//   softmax: warp shuffles give each row's max and sum over the tile;
//   P V:    lane j keeps acc for its warp's 8 rows at columns j + 32 c,
//           and takes each P entry from the lane that computed it.
// Shared memory is 99 KB at hd = 256 (two blocks per SM), acc 64
// registers a thread.
//
// What bounds it on an H100: operations.  At the recurrentgemma-2b
// prefill (B = 4, H = 10, KV = 1, S = T = 3072, hd = 256, window 2048,
// bf16) the visible (query, key) pairs take 1.7e11 FLOPs (4 hd per
// pair, for q.k and p v): 0.17 ms at the 989 TFLOP/s bf16 tensor-core
// rate, while its 139 MB of inputs and output take 0.04 ms.  It does the
// products on the CUDA cores in f32 (67 TFLOP/s at best), so it sits
// far above that bound; the tensor cores (wgmma) are later work.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() and the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;       // queries per block
constexpr int kBK = 32;       // keys per tile (one per lane)
constexpr int kThreads = 128;
constexpr int kRows = kBQ / (kThreads / 32);  // query rows per warp
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + kBK) * (HD + 4) + kBK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int group,
             int S, int Tk, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int window, float scale) {
  constexpr int KP = HD + 4;  // padded row of the Q and K tiles
  constexpr int NC = HD / 32; // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;            // [kBQ][KP]
  float* k_s = q_s + kBQ * KP;  // [kBK][KP]
  float* v_s = k_s + kBK * KP;  // [kBK][HD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = blockIdx.x * kBQ;
  const int off = Tk - S;  // right alignment of the queries
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    q_s[r * KP + d] = (q0 + r < S) ? to_f(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  // the keys some row of this tile may see
  const int qp_first = q0 + off;
  const int qp_last = min(q0 + kBQ, S) - 1 + off;
  int k_begin = 0, k_end = Tk;
  if (causal) k_end = min(Tk, qp_last + 1);
  if (window > 0) k_begin = max(0, qp_first - window + 1);
  if (causal && qp_first < 0) {
    // a row that sees no key averages every key, as the reference's
    // softmax over an all-masked row does
    k_begin = 0;
    k_end = Tk;
  }

  float acc[kRows][NC];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx - r * HD;
      const bool in = kt + r < Tk;
      k_s[r * KP + d] = in ? to_f(kb[(kt + r) * ks.s + d]) : 0.f;
      v_s[r * HD + d] = in ? to_f(vb[(kt + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * KP;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(
            q_s + (warp * kRows + r) * KP + d);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    const int key = kt + lane;
    const bool real = key < Tk;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r + off;
      bool ok = real;
      if (causal) ok = ok && key <= qp;
      if (window > 0) ok = ok && key > qp - window;
      const float sc = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      const float p = real ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      s[r] = p;
    }

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = v_s[j * HD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] += pr * vv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[row * os.s + lane + 32 * c] = from_f<T>(acc[r][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int Tk, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H / KV, S, Tk, qs, ks,
      vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* o, int B, int H, int KV, int S, int Tk, Strides qs,
                Strides ks, Strides vs, Strides os, int causal, int window,
                float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, S, Tk, qs, ks, vs, os,
                           causal, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, S, Tk, qs, ks, vs, os,
                           causal, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, S, Tk, qs, ks, vs, os,
                            causal, window, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KV, S, Tk, qs, ks, vs, os,
                            causal, window, scale, st);
    default:
      return -1;
  }
}

}  // namespace

// dtype 0 is f32, 1 is bf16; head sizes 32, 64, 128 and 256.  Any other
// returns -1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int T, int hd, int dtype, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int window, float scale,
    void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, KV, S, T, qs, ks, vs, os,
                              causal, window, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, S, T, qs, ks,
                                      vs, os, causal, window, scale, st);
  return -1;
}
