// Eq. 10 sigma-hat for a softmax-CE head, batched over devices (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/persample_gradnorm.py:65
// (persample_gradnorm_pallas, body _psg_kernel).  For device v with
// penultimate features h [B, d], logits [B, C] and labels [B]:
//
//   e_i      = softmax(logits_i) - onehot(y_i)
//   gi_sq_i  = ||h_i||^2 * ||e_i||^2           (per-sample grad norm^2)
//   gbar     = H^T E / B                        ([d, C] mean gradient)
//   sigma    = sqrt(mean_i ||h_i e_i^T - gbar||^2)
//
// without ever forming the [B, d, C] per-sample gradients.  h and logits
// are f32; labels int64 (as the FL round passes them) or int32, read as
// they come.
//
// sigma is summed in two passes, over the deviations h_ik e_ic - gbar_kc
// themselves, as the plain version sums them.  The TPU kernel's one pass,
// mean_i gi_sq_i - ||gbar||^2, cancels: where the per-sample gradients
// share a large common part (a model far into training, or diverging,
// mean gi_sq / sigma^2 reached 1e4 on the FL round's data) its f32 result
// lost three digits, against under 1e-5 for the two passes
// (tests/test_torch_kernels_ref.py::test_sigma_two_pass_needed).
//
// What bounds it on an H100: neither bytes nor operations.  At the
// round's shape (23 devices of B = 32, d = 120, C = 10) the inputs are
// 0.4 MB (0.12 us at 3.35 TB/s) and the work 0.3 MFLOP a device, far
// under the ~2 us any launch takes.  What the time is made of is latency:
// one load from device memory, a few barriers, and the serial steps of a
// block.
//
// Design: one block of 256 threads a device, one launch a round.  The
// TPU kernel walked 128-row blocks in a sequential grid and carried H^T E
// in VMEM; blocks on a GPU run in no order, so one block owns a device:
//   1. cp.async stages the device's logits (one flat 16-byte stream,
//      shifted so that shared and global addresses agree mod 16) and its
//      features, in column tiles of all B rows (the whole [B, d] at the
//      round's shape, 15 KB; narrower tiles where B * d does not fit), all
//      loads in flight at once.  The logits land first, as their own group.
//   2. Softmax errors, 8 lanes a row: each lane takes classes q, q + 8, ..
//      of its row; max, sum and ||e_i||^2 are 3-step shuffles inside the
//      8 lanes.  E goes to shared memory, rows padded to a multiple of 4
//      classes with zeros.
//   3. Per feature tile: ||h_i||^2, 8 lanes a row, summed over the tiles;
//      and H^T E, a thread a column k holding 16 classes in registers: per
//      row one h load and four 16-byte E loads that the whole warp shares
//      (a broadcast), 16 FMAs.  The same thread then walks the rows again
//      and adds (h_ik e_ic - gbar_kc)^2, one FMA's rounding each, to its
//      share of the deviations' sum.
//   4. gi_sq_i = ||h_i||^2 ||e_i||^2; a block sum in a fixed order of the
//      deviations gives sigma.
// The deviations' sum is kept in f64: a thread sums a row's (up to 16)
// classes in f32 and adds that to its f64 total, and the block sums the
// threads' totals in f64.  At the ResNet18-GN head (d = 512, C = 100) a
// thread adds 6400 squares, and an f32 total of them was 3-5e-6 off
// relative, 1.0-2.3 times the FL round's tolerance against Eq. 10 in f64
// (in an emulation of this order, and on the card's first ResNet round);
// the f64 total stays under 1e-7.  At the paper CNN's head (d = 120,
// C = 10) a thread adds 320.
// No atomics; every sum has a fixed order, so two calls on one input
// give one bit pattern (the FL round's determinism rests on it).
//
// Where the time goes (PERF.md has the numbers): 23 blocks on 132 SMs,
// each a chain of one load of its 16 KB, the softmax, the H^T E loop and
// the deviations' loop over the B rows (the longest serial parts), and
// five barriers; on an H100 the warp-a-row kernel before it took 2.5x as
// long, its rows' global loads waited on one after another.  A call's host path (validation,
// two outputs, the ctypes call) costs several times the kernel.
//
// Plain C interface, loaded with ctypes.  The launcher makes `device`
// current for the launch and restores the caller's device after it, and
// returns cudaGetLastError(); the Python wrapper raises when it is not 0.
// The Python wrapper picks the feature tile and the shared memory
// (kernels/persample_gradnorm.py:_plan, with the layout of step 1).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowLanes = 8;                       // lanes a row
constexpr int kRowsAtOnce = kThreads / kRowLanes;  // 32
constexpr int kCB = 16;                            // classes a thread holds

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum / max over the 8 lanes of a row (xor 4, 2, 1: a fixed order).
__device__ __forceinline__ float row_sum(float x) {
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Sum of one double per thread over the block, in a fixed order; every
// thread gets it.
__device__ double block_sum(double x, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < kWarps; ++w) t += scratch[w];
  return t;
}

// Copies n floats from src to dst with cp.async, 16 bytes a copy where
// dst and src agree mod 16 (4 bytes a copy at the ragged ends).
__device__ void stage_flat(float* dst, const float* src, int n) {
  const int head =
      min(n, (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2));
  const int body = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kThreads)
    cp_async4(dst + i, src + i);
  for (int i = threadIdx.x; i < body; i += kThreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * body + threadIdx.x; i < n; i += kThreads)
    cp_async4(dst + i, src + i);
}

// Columns k0 .. k0 + kt - 1 of the B rows of h [B, d] into h_s [B, kt].
// kVec: d % 4 == 0 and h 16-byte aligned (then kt % 4 == 0 too).
template <bool kVec>
__device__ void stage_tile(float* h_s, const float* h, int B, int d, int k0,
                           int kt) {
  if (kVec) {
    const int q = kt >> 2;
    for (int i = threadIdx.x; i < B * q; i += kThreads) {
      const int row = i / q, c = 4 * (i - row * q);
      cp_async16(h_s + row * kt + c, h + (size_t)row * d + k0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < B * kt; i += kThreads) {
      const int row = i / kt, c = i - row * kt;
      cp_async4(h_s + i, h + (size_t)row * d + k0 + c);
    }
  }
}

template <typename Label, bool kVec>
__global__ void __launch_bounds__(kThreads)
psg_kernel(const float* __restrict__ h, const float* __restrict__ logits,
           const Label* __restrict__ labels, float* __restrict__ gi_sq,
           float* __restrict__ sigma, int B, int d, int C, int kt) {
  extern __shared__ float4 smem4[];
  __shared__ double scratch[kWarps];
  const int cp = round4(C);                     // E's padded row
  float* lg_s = reinterpret_cast<float*>(smem4);  // [B * C] + 4
  float* e_s = lg_s + round4(B * C + 4);        // [B, cp] + kCB
  float* h_s = e_s + B * cp + kCB;              // [B, kt]
  float* hh_s = h_s + round4(B * kt);           // [B]
  float* ee_s = hh_s + B;                       // [B]
  const int v = blockIdx.x, tid = threadIdx.x;
  const int q = tid % kRowLanes, row0 = tid / kRowLanes;
  h += (size_t)v * B * d;
  logits += (size_t)v * B * C;
  labels += (size_t)v * B;
  gi_sq += (size_t)v * B;

  // 1. logits (group 0), the first feature tile (group 1)
  float* lg = lg_s + (((uintptr_t)logits >> 2) & 3);   // agrees mod 16
  stage_flat(lg, logits, B * C);
  cp_commit();
  stage_tile<kVec>(h_s, h, B, d, 0, kt);
  cp_commit();
  cp_wait<1>();
  __syncthreads();

  // 2. softmax errors, 8 lanes a row
  for (int base = 0; base < B; base += kRowsAtOnce) {
    const int i = base + row0;
    const bool live = i < B;                    // all lanes shuffle
    const float* l = lg + (size_t)(live ? i : 0) * C;
    float m = -INFINITY;
    for (int c = q; c < C; c += kRowLanes) m = fmaxf(m, l[c]);
    m = row_max(m);
    float z = 0.f;
    for (int c = q; c < C; c += kRowLanes) z += expf(l[c] - m);
    z = row_sum(z);
    const int y = live ? (int)labels[i] : -1;
    float ee = 0.f;
    for (int c = q; c < cp; c += kRowLanes) {
      const float e = c < C ? expf(l[c] - m) / z - (c == y ? 1.f : 0.f)
                            : 0.f;
      if (live) e_s[i * cp + c] = e;
      ee += e * e;
    }
    ee = row_sum(ee);
    if (live && q == 0) ee_s[i] = ee;
  }

  // 3. per feature tile: ||h_i||^2, this tile's columns of H^T E, and the
  //    squared deviations from them
  const float inv_b = 1.f / (float)B;
  double dev = 0.0;
  for (int k0 = 0; k0 < d; k0 += kt) {
    const int w = min(kt, d - k0);
    if (k0 > 0) {
      __syncthreads();                          // the last tile is read
      stage_tile<kVec>(h_s, h, B, d, k0, w);
      cp_commit();
    }
    cp_wait<0>();
    __syncthreads();
    for (int base = 0; base < B; base += kRowsAtOnce) {
      const int i = base + row0;
      const bool live = i < B;
      const float* hr = h_s + (size_t)(live ? i : 0) * w;
      float s = 0.f;
      for (int k = q; k < w; k += kRowLanes) s += hr[k] * hr[k];
      s = row_sum(s);
      if (live && q == 0) hh_s[i] = (k0 == 0 ? 0.f : hh_s[i]) + s;
    }
    for (int k = tid; k < w; k += kThreads) {
      for (int c0 = 0; c0 < C; c0 += kCB) {
        float acc[kCB];
#pragma unroll
        for (int j = 0; j < kCB; ++j) acc[j] = 0.f;
        for (int i = 0; i < B; ++i) {
          const float hv = h_s[i * w + k];
          const float4* er = reinterpret_cast<const float4*>(e_s + i * cp + c0);
#pragma unroll
          for (int j4 = 0; j4 < kCB / 4; ++j4) {
            const float4 e = er[j4];
            acc[4 * j4] += hv * e.x;
            acc[4 * j4 + 1] += hv * e.y;
            acc[4 * j4 + 2] += hv * e.z;
            acc[4 * j4 + 3] += hv * e.w;
          }
        }
        const int nc = min(kCB, C - c0);         // classes of this chunk
#pragma unroll
        for (int j = 0; j < kCB; ++j) acc[j] = -acc[j] * inv_b;   // -gbar
        for (int i = 0; i < B; ++i) {
          const float hv = h_s[i * w + k];
          const float4* er = reinterpret_cast<const float4*>(e_s + i * cp + c0);
          float row = 0.f;                      // this row's <= 16 classes
#pragma unroll
          for (int j4 = 0; j4 < kCB / 4; ++j4) {
            const float4 e = er[j4];
            const float x[4] = {fmaf(hv, e.x, acc[4 * j4]),
                                fmaf(hv, e.y, acc[4 * j4 + 1]),
                                fmaf(hv, e.z, acc[4 * j4 + 2]),
                                fmaf(hv, e.w, acc[4 * j4 + 3])};
#pragma unroll
            for (int t = 0; t < 4; ++t)
              if (4 * j4 + t < nc) row = fmaf(x[t], x[t], row);
          }
          dev += (double)row;
        }
      }
    }
  }
  __syncthreads();

  // 4. gi_sq and sigma
  for (int i = tid; i < B; i += kThreads) gi_sq[i] = hh_s[i] * ee_s[i];
  dev = block_sum(dev, scratch);
  if (tid == 0) sigma[v] = (float)sqrt(dev / (double)B);
}

template <class F>
int on_device(int device, F launch) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = (cudaError_t)launch();
  if (err == cudaSuccess) err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

template <typename Label, bool kVec>
int launch(const float* h, const float* logits, const void* labels,
           float* gi_sq, float* sigma, int V, int B, int d, int C, int kt,
           int smem, cudaStream_t st) {
  auto kernel = psg_kernel<Label, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<V, kThreads, smem, st>>>(h, logits, (const Label*)labels, gi_sq,
                                     sigma, B, d, C, kt);
  return 0;
}

}  // namespace

// labels64 != 0: labels are int64, else int32.  kt: the feature tile's
// columns (d, or a multiple of 4 under d); smem: its dynamic shared
// memory in bytes (kernels/persample_gradnorm.py:_plan).  V = 0 launches
// nothing.
extern "C" int psg_sigma_launch(const void* h, const void* logits,
                                const void* labels, void* gi_sq, void* sigma,
                                int V, int B, int d, int C, int labels64,
                                int kt, int smem, int device, void* stream) {
  if (V == 0) return 0;
  const bool vec = d % 4 == 0 && (uintptr_t)h % 16 == 0;
  const float *hp = (const float*)h, *lp = (const float*)logits;
  float *gp = (float*)gi_sq, *sp = (float*)sigma;
  const cudaStream_t st = (cudaStream_t)stream;
  return on_device(device, [&] {
    if (labels64)
      return vec ? launch<long long, true>(hp, lp, labels, gp, sp, V, B, d,
                                           C, kt, smem, st)
                 : launch<long long, false>(hp, lp, labels, gp, sp, V, B, d,
                                            C, kt, smem, st);
    return vec ? launch<int, true>(hp, lp, labels, gp, sp, V, B, d, C, kt,
                                   smem, st)
               : launch<int, false>(hp, lp, labels, gp, sp, V, B, d, C, kt,
                                    smem, st);
  });
}
