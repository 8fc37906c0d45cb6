// K7 head_split: an f32 tensor as three bf16 terms, hi + (mid + lo) == d
// exactly (sm_90a).
//
// Replaces no TPU kernel.  The JAX package multiplies the LM head in f32
// and leaves the products to XLA; on an H100 an f32 product runs on the
// CUDA cores at 67 TFLOP/s, the bf16 tensor cores at 989.  The head's
// operands (the final norm's output and the head's weight) are bf16 before
// the model casts them up, so a bf16 product with f32 accumulation forms
// the very products the f32 one does.  The backward's cotangent dlogits is
// f32; this kernel splits it into
//
//   hi  = bf16(d)
//   mid = bf16(d - hi)
//   lo  = bf16(d - hi - mid)
//
// each rounded to nearest even.  Both differences are exact in f32 (each
// is a multiple of d's ulp no larger than half a bf16 step of what it is
// taken from), and three 8-bit significands cover f32's 24 bits, so lo is
// the whole of the rest and hi + (mid + lo) == d bitwise, for
// |d| >= 2^-110 up to bf16's largest finite value.  Below 2^-110, lo's
// bits fall under bf16's least subnormal, 2^-133, and the sum is d to
// within 2^-134.  A non-finite d gives hi = d and mid = lo = 0, so an inf
// or NaN reaches the products as it would in f32.  A product of one term
// with a bf16 operand is exact in f32, so the three products on the
// tensor cores sum in f32 to what the f32 product sums, in another order
// (kernels/head_split.py).
//
// What bounds it on an H100: bytes.  4 read and 6 written an element, 10;
// the rwkv6-3b head chunk of 8192 x 65536 is 5.4 GB, 1.6 ms at 3.35 TB/s.
// Design: a grid-stride loop over groups of four elements, one 16-byte
// load and three 8-byte stores a group (the planes are n elements apart,
// so the stores stay aligned when n is a multiple of 4 and d is 16-byte
// aligned); otherwise one element a step.  Bitwise equal to the plain
// version (kernels/head_split.py split3_ref): the same roundings, no
// contraction (no products).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void split1(float d, __nv_bfloat16& h,
                                       __nv_bfloat16& m, __nv_bfloat16& l) {
  h = __float2bfloat16_rn(d);
  if (!isfinite(d)) {
    m = l = __float2bfloat16_rn(0.0f);
    return;
  }
  const float r = d - __bfloat162float(h);
  m = __float2bfloat16_rn(r);
  l = __float2bfloat16_rn(r - __bfloat162float(m));
}

struct alignas(8) bf16x4 {
  __nv_bfloat16 v[4];
};

__global__ void head_split_vec(const float4* __restrict__ d,
                               bf16x4* __restrict__ out, long long groups) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < groups; i += stride) {
    const float4 x = __ldcs(d + i);
    bf16x4 h, m, l;
    split1(x.x, h.v[0], m.v[0], l.v[0]);
    split1(x.y, h.v[1], m.v[1], l.v[1]);
    split1(x.z, h.v[2], m.v[2], l.v[2]);
    split1(x.w, h.v[3], m.v[3], l.v[3]);
    out[i] = h;
    out[i + groups] = m;
    out[i + 2 * groups] = l;
  }
}

__global__ void head_split_scalar(const float* __restrict__ d,
                                  __nv_bfloat16* __restrict__ out,
                                  long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    split1(d[i], out[i], out[i + n], out[i + 2 * n]);
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

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks an SM, then stride

long long blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

// d: n f32 values; out: [3, n] bf16 (hi, mid, lo).  Returns a cudaError_t.
extern "C" int head_split_launch(const void* d, void* out, long long n,
                                 int device, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = n % 4 == 0 && (uintptr_t)d % 16 == 0 &&
                   (uintptr_t)out % 8 == 0;
  return on_device(device, [&] {
    if (vec) {
      const long long groups = n / 4;
      head_split_vec<<<(unsigned)blocks_for(groups), kThreads, 0, st>>>(
          (const float4*)d, (bf16x4*)out, groups);
    } else {
      head_split_scalar<<<(unsigned)blocks_for(n), kThreads, 0, st>>>(
          (const float*)d, (__nv_bfloat16*)out, n);
    }
  });
}
