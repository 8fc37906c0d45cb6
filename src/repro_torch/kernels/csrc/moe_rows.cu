// K8 moe_rows: the held-expert MoE's dispatch and combine, forward and
// backward (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's MoE (models/moe.py) gathers
// into capacity buffers with XLA; the port's drop-free sigmoid MoE over
// held experts (models/moe.py moe_ffn_held, moonlight-16b-a3b) sorts the
// T k assignments by held expert into a buffer of N = T k rows, of which
// the first n_held = offs[nh - 1] are the held experts' runs (the rest are
// room for any routing and are never read).  Four entry points, each one
// pass that touches the held assignments only:
//
//   dispatch      x_buf[p] = x[src[p]] for p < n_held (row-major; a copy)
//   combine       out[t] = rnd( (sum over j in slot order, held[t, j], of
//                 fl(y_buf[slot[t, j]]) *rn w[t, j]) +rn fl(shared[t]) )
//   combine_bwd   d_buf[slot[t, j]] = rnd(w[t, j] *rn fl(g[t])) and
//                 dw[t, j] = <fl(g[t]), fl(y_buf[slot[t, j]])> where held,
//                 else dw[t, j] = 0 (token-major)
//   dispatch_bwd  dx[t] = rnd(sum over held j, in slot order, of
//                 fl(d_xbuf[slot[t, j]]))
//
// held[t, j] is slot[t, j] < N (N marks an assignment to another chip's
// expert).  Sums are f32 from +0.0; rnd rounds to the buffers' type (bf16
// or f32) to nearest even.  Every function but dw is bitwise the plain
// version (kernels/moe_rows.py) and the earlier gather formulation: the
// products and sums are __fmul_rn / __fadd_rn, so nvcc cannot contract
// them into an FMA, and an unheld slot, which added +0.0 there, is skipped
// (the same bits, up to the sign of a zero).  dw is a dot product over d in
// the kernel's own fixed order (per-lane FMA chains, then a butterfly over
// the warp): f32 rounding of the plain version's sum, the same bits every
// run.  No atomics: each row of d_buf belongs to one (t, j).  n_held is
// read on the device, so nothing waits for the host.
//
// What bounds it on an H100: bytes; there is no arithmetic to speak of.
// At moonlight-silos (T 32768, k 6, d 2048, bf16, about H = 24576 held
// rows a layer) one layer's step moves 2 H d 2 (dispatch) + 2 H d + 4 T d
// (combine) + 2 H d 2 + Th d 2 (combine_bwd; Th tokens with a held slot)
// + H d 2 + T d 2 (dispatch_bwd) bytes, about 1.65 GB with the remat's
// second forward, 0.49 ms at 3.35 TB/s; the gathers it replaces ran over
// all T k rows in f32, about 24 ms a layer.  Design: one warp a row or a
// token, 16-byte loads and stores (8 bf16 or 4 f32 a lane, so a warp
// covers 256 bf16 of a row a pass, 8 passes at d 2048); a token's k slot
// rows and weights in registers (the slot loop unrolled to kMaxK, so
// nothing spills to local memory), its accumulators in registers across
// the slots; a pass's row loads are independent, so a lane keeps them in
// flight together.  The dispatch, a copy, loads kCopyPasses passes before
// it stores any: one pass at a time it ran at 22 % of its bound, eight at
// 87 % (an H100 at 700 W).  The token-major kernels keep one pass: two or
// four at a time cost them registers and occupancy and ran 1.1-2.4x
// slower.  A grid-stride loop over rows or tokens with at most 16 blocks
// an SM.  Rows or tokens off 16-byte alignment take the same kernels one
// element a lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;       // slots a token the kernels hold in registers
constexpr int kThreads = 256;  // 8 warps a block, a row or a token each
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 16;
// passes over d (32 V elements each) whose loads the dispatch's lane
// issues together before it stores any of them
constexpr int kCopyPasses = 8;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f(float v) {
  return v;
}

// V elements of T moved as one load or store (16 bytes when V = 16 /
// sizeof(T))
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& x) {
  *reinterpret_cast<Pack<T, V>*>(p) = x;
}

// A token's slots: held[j], its row and its weight, j < kMaxK (j >= k is
// never held).  The loops over j are unrolled, so the arrays stay in
// registers.
struct Slots {
  bool held[kMaxK];
  long long row[kMaxK];
  float w[kMaxK];
  bool any;
};

__device__ __forceinline__ Slots token_slots(const int64_t* __restrict__ slot,
                                             const float* __restrict__ w,
                                             long long t, int k,
                                             long long n_rows) {
  Slots s;
  s.any = false;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    const long long r = j < k ? slot[t * k + j] : n_rows;
    s.held[j] = r < n_rows;
    s.row[j] = s.held[j] ? r : 0;
    s.w[j] = (s.held[j] && w != nullptr) ? w[t * k + j] : 0.0f;
    s.any |= s.held[j];
  }
  return s;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_rows_dispatch(const T* __restrict__ x, const int64_t* __restrict__ src,
                      const int* __restrict__ n_held, T* __restrict__ out,
                      int d) {
  const long long n = *n_held;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long p = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       p < n; p += warps) {
    const T* a = x + src[p] * d;
    T* b = out + p * d;
    for (int c0 = lane * V; c0 < d; c0 += 32 * V * kCopyPasses) {
      Pack<T, V> buf[kCopyPasses];
#pragma unroll
      for (int u = 0; u < kCopyPasses; ++u)
        if (c0 + u * 32 * V < d) buf[u] = load<T, V>(a + c0 + u * 32 * V);
#pragma unroll
      for (int u = 0; u < kCopyPasses; ++u)
        if (c0 + u * 32 * V < d) store<T, V>(b + c0 + u * 32 * V, buf[u]);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_rows_combine(const T* __restrict__ y, const float* __restrict__ w,
                     const int64_t* __restrict__ slot,
                     const T* __restrict__ shared, T* __restrict__ out,
                     long long n_tok, int k, long long n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       t < n_tok; t += warps) {
    const Slots s = token_slots(slot, w, t, k, n_rows);
    for (int c = lane * V; c < d; c += 32 * V) {
      Pack<T, V> rows[kMaxK];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (s.held[j]) rows[j] = load<T, V>(y + s.row[j] * d + c);
      const Pack<T, V> sh = load<T, V>(shared + t * d + c);
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (s.held[j]) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f(rows[j].v[i]), s.w[j]));
        }
      Pack<T, V> o;
#pragma unroll
      for (int i = 0; i < V; ++i)
        o.v[i] = from_f<T>(__fadd_rn(acc[i], to_f(sh.v[i])));
      store<T, V>(out + t * d + c, o);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_rows_combine_bwd(const T* __restrict__ g, const T* __restrict__ y,
                         const float* __restrict__ w,
                         const int64_t* __restrict__ slot,
                         T* __restrict__ d_buf, float* __restrict__ dw,
                         long long n_tok, int k, long long n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       t < n_tok; t += warps) {
    const Slots s = token_slots(slot, w, t, k, n_rows);
    float part[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) part[j] = 0.0f;
    if (s.any) {                 // a token with no held slot reads nothing
      for (int c = lane * V; c < d; c += 32 * V) {
        Pack<T, V> rows[kMaxK];
#pragma unroll
        for (int j = 0; j < kMaxK; ++j)
          if (s.held[j]) rows[j] = load<T, V>(y + s.row[j] * d + c);
        const Pack<T, V> gv = load<T, V>(g + t * d + c);
        float gf[V];
#pragma unroll
        for (int i = 0; i < V; ++i) gf[i] = to_f(gv.v[i]);
#pragma unroll
        for (int j = 0; j < kMaxK; ++j)
          if (s.held[j]) {
            Pack<T, V> o;
#pragma unroll
            for (int i = 0; i < V; ++i) {
              part[j] = fmaf(gf[i], to_f(rows[j].v[i]), part[j]);
              o.v[i] = from_f<T>(__fmul_rn(s.w[j], gf[i]));
            }
            store<T, V>(d_buf + s.row[j] * d + c, o);
          }
      }
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (s.held[j]) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
        }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (j < k) dw[t * k + j] = s.held[j] ? part[j] : 0.0f;
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_rows_dispatch_bwd(const T* __restrict__ g_buf,
                          const int64_t* __restrict__ slot,
                          T* __restrict__ dx, long long n_tok, int k,
                          long long n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
       t < n_tok; t += warps) {
    const Slots s = token_slots(slot, nullptr, t, k, n_rows);
    for (int c = lane * V; c < d; c += 32 * V) {
      Pack<T, V> rows[kMaxK];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (s.held[j]) rows[j] = load<T, V>(g_buf + s.row[j] * d + c);
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (s.held[j]) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[i] = __fadd_rn(acc[i], to_f(rows[j].v[i]));
        }
      Pack<T, V> o;
#pragma unroll
      for (int i = 0; i < V; ++i) o.v[i] = from_f<T>(acc[i]);
      store<T, V>(dx + t * d + c, o);
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

unsigned blocks_for(long long items) {
  const long long b = (items + kWarps - 1) / kWarps;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Runs the statement that follows with T, V the buffers' type (bf16
// when bf16 is 1, else f32) and width (16 bytes a lane when vec, else one
// element).
#define K8_TYPED(bf16, vec, ...)                          \
  do {                                                    \
    if ((bf16) && (vec)) {                                \
      using T = __nv_bfloat16;                            \
      constexpr int V = 8;                                \
      __VA_ARGS__;                                        \
    } else if (bf16) {                                    \
      using T = __nv_bfloat16;                            \
      constexpr int V = 1;                                \
      __VA_ARGS__;                                        \
    } else if (vec) {                                     \
      using T = float;                                    \
      constexpr int V = 4;                                \
      __VA_ARGS__;                                        \
    } else {                                              \
      using T = float;                                    \
      constexpr int V = 1;                                \
      __VA_ARGS__;                                        \
    }                                                     \
  } while (0)

}  // namespace

// Each returns a cudaError_t.  x, y, shared, g, d_buf, dx: row-major [*, d]
// of the buffers' type; w [n_tok, k] f32; slot [n_tok, k] and src [n_rows]
// int64; n_held: one int32 on the device (offs[nh - 1]).

extern "C" int moe_dispatch_launch(const void* x, const void* src,
                                   const void* n_held, void* out,
                                   long long n_rows, int d, int bf16,
                                   int vec, int device, void* stream) {
  if (n_rows == 0 || d == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return on_device(device, [&] {
    K8_TYPED(bf16, vec,
             moe_rows_dispatch<T, V><<<blocks_for(n_rows), kThreads, 0, st>>>(
                 (const T*)x, (const int64_t*)src, (const int*)n_held,
                 (T*)out, d));
  });
}

extern "C" int moe_combine_launch(const void* y, const void* w,
                                  const void* slot, const void* shared,
                                  void* out, long long n_tok, int k,
                                  long long n_rows, int d, int bf16, int vec,
                                  int device, void* stream) {
  if (n_tok == 0 || d == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return on_device(device, [&] {
    K8_TYPED(bf16, vec,
             moe_rows_combine<T, V><<<blocks_for(n_tok), kThreads, 0, st>>>(
                 (const T*)y, (const float*)w, (const int64_t*)slot,
                 (const T*)shared, (T*)out, n_tok, k, n_rows, d));
  });
}

extern "C" int moe_combine_bwd_launch(const void* g, const void* y,
                                      const void* w, const void* slot,
                                      void* d_buf, void* dw, long long n_tok,
                                      int k, long long n_rows, int d,
                                      int bf16, int vec, int device,
                                      void* stream) {
  if (n_tok == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return on_device(device, [&] {
    K8_TYPED(bf16, vec,
             moe_rows_combine_bwd<T, V><<<blocks_for(n_tok), kThreads, 0,
                                          st>>>(
                 (const T*)g, (const T*)y, (const float*)w,
                 (const int64_t*)slot, (T*)d_buf, (float*)dw, n_tok, k,
                 n_rows, d));
  });
}

extern "C" int moe_dispatch_bwd_launch(const void* g_buf, const void* slot,
                                       void* dx, long long n_tok, int k,
                                       long long n_rows, int d, int bf16,
                                       int vec, int device, void* stream) {
  if (n_tok == 0 || d == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return on_device(device, [&] {
    K8_TYPED(bf16, vec,
             moe_rows_dispatch_bwd<T, V><<<blocks_for(n_tok), kThreads, 0,
                                           st>>>(
                 (const T*)g_buf, (const int64_t*)slot, (T*)dx, n_tok, k,
                 n_rows, d));
  });
}
