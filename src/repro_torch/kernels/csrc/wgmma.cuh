// Tensor-core building blocks shared by the bf16 routes of the attention
// kernels (flash_attention.cu, flash_attention_bwd.cu), sm_90a.
//
// Tiles live in shared memory in 128-byte column blocks of 64 bf16
// (hd 32 takes one block, half of it unused), each block R rows of 128
// bytes whose 16-byte chunks are XORed with the row: the 128-byte
// swizzle that the wgmma descriptors name, so neither cp.async nor the
// tensor cores meet bank conflicts.  A source that includes this file is
// rebuilt when it changes (kernels/common.py hashes the includes).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 elements) of row r in a tile of R
// rows: the chunk's 128-byte column block, its row, and its place in
// the row XORed with r % 8 (the 128-byte swizzle of wgmma and TMA).
__device__ __forceinline__ uint32_t swizzled(int r, int c, int R) {
  return (uint32_t)((c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
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

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows r0 .. r0 + R - 1 of a [rows, HD] matrix (row stride in elements)
// into a swizzled tile by the NT threads of the block; rows at or past
// nrows are zeros.
template <int HD, int R, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int nrows) {
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int i = threadIdx.x; i < R * kChunks; i += NT) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool in = r0 + r < nrows;
    cp_async16(dst + swizzled(r, c, R),
               in ? src + (r0 + r) * row_stride + c * 8 : src, in);
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units) and layout type 1, the 128-byte
// swizzle.  K-major (rows of 128 bytes, the next 8 rows 1024 bytes on):
// sdesc(tile + column block + 32 bytes a 16-column step, 16, 1024).
// MN-major through the transpose bit (the next 8 rows 1024 bytes on, the
// next 64 columns one column block on): sdesc(tile + 16 rows a step,
// R * 128, 1024).
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it
__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define WG_OUT(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d = A B (accumulate 0) or d += A B: m64n64k16, A [64 x 16] and B
// [16 x 64] K-major in shared memory.  Thread t of the warpgroup holds
// d[4 i + 2 h + c] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 i + 2 (t % 4) + c].
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B: m64n64k16, A [64 x 16] bf16 in registers (a[0..3], laid out
// as d's pairs of columns: a[2 j + h] = A rows + 8 h, columns 8 j + 2 (t %
// 4) + {0, 1}), B [16 x 64] MN-major in shared memory (transpose bit).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// An f32 accumulator x as two bf16 A operands in its own layout, hi =
// bf16(x) and lo = bf16(x - hi): hi + lo keeps x to about 2^-16 where
// one bf16 rounding keeps 2^-8.
__device__ __forceinline__ void split(const float (&x)[32], uint32_t (&hi)[16],
                                      uint32_t (&lo)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[2 * r], x[2 * r + 1]);
    hi[r] = pack(h2);
    lo[r] = pack(__floats2bfloat162_rn(x[2 * r] - __low2float(h2),
                                       x[2 * r + 1] - __high2float(h2)));
  }
}

}  // namespace tc
}  // namespace
