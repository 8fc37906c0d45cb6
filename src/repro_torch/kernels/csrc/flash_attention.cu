// Causal / sliding-window attention with an online softmax (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel).  q [B, H, S, hd] and k, v
// [B, KV, T, hd] (query head h reads key head h / (H / KV)), f32 or bf16,
// give o [B, H, S, hd] in q's dtype:
//
//   s = (q . k) / sqrt(hd), masked to -1e30 unless
//       k <= q + off            (causal)
//       k >  q + off - window   (window > 0)
//   off is the key position of query 0: T - S by default (queries
//   right-aligned), a shard's first position when the queries are split
//   over ranks (context parallelism) and every rank holds all T keys.
//   o = softmax(s) v, with the running max m, sum l and acc in f32.
//
// Every tensor is addressed through (batch, head, row) strides with a
// contiguous last axis, so the model's [B, S, H, hd] projections and its
// [B, S, H, hd] output need no transpose, and the single key head of
// multi-query attention is read in place of H copies.
//
// The TPU kernel ran a (batch * head, q block, kv block) grid whose kv
// axis is sequential and carried m, l and acc in VMEM from one kv step
// to the next.  Blocks on a GPU run in no order, so here one block owns
// a tile of queries of one (batch, head) and loops over the key tiles
// itself, visiting only the tiles that hold a key some row of the tile
// may see (the causal edge and the window's lower edge cut the loop).
// A causal row that sees no key (off < 0) averages every key, as the
// reference's softmax over an all-masked row does.
//
// The dtype picks one of two routes behind flash_attention_launch.
//
// bf16: the tensor cores (namespace tc).  What bounds it on an H100 is
// operations: at the recurrentgemma-2b prefill (B = 4, H = 10, KV = 1,
// S = T = 3072, hd = 256, window 2048) the visible (query, key) pairs
// take 1.72e11 FLOPs counted at 4 hd a pair (q.k and p v), 0.174 ms at
// the 989 TFLOP/s bf16 dense rate; its 139 MB of inputs and output take
// 0.04 ms.  The design, for each thing that stands between it and that:
//   * Only wgmma reaches the tensor-core rate.  A block is 128 query rows
//     of one (batch, head), two warpgroups of 64 (wgmma's M), looping
//     over 64-key tiles.  S = Q K^T is m64n64k16 wgmma with both operands
//     in shared memory; O += P V is m64n64k16 wgmma with P from registers
//     and V (keys x hd, hd contiguous) read through the transpose bit,
//     one instruction per 64 output columns.  S and O stay in f32
//     registers (O: hd / 2 a thread, S: 32), and so do m and l.
//   * P is an operand, so it must be bf16, but the Pallas kernel keeps P
//     in f32, and one bf16 rounding of P (FlashAttention-2's choice)
//     puts outputs over one bf16 step of that f32 function (1.97x the
//     check's tolerance in an emulation at hd 256).  So P is split into
//     hi = bf16(p) and lo = bf16(p - hi), two products against the same
//     V tile summed in f32 (0.60x the tolerance in the same emulation;
//     q.k of bf16 inputs is exact per product and needs no split).  That
//     is 6 hd FLOPs a visible pair instead of 4 hd: the tensor cores do
//     1.5x the counted work, and the bound above does not count it.
//   * Loads must overlap the products.  K and V tiles are double-buffered
//     in shared memory and fetched by cp.async (16 bytes a thread, zero
//     fill past T) one tile ahead of the one being multiplied; Q is
//     fetched once.  Tiles are stored in 128-byte rows (64 columns of
//     hd) whose 16-byte chunks are XORed with the row (the 128-byte
//     swizzle the wgmma descriptors name), so neither the copies nor the
//     tensor cores meet bank conflicts.  hd 256: Q 64 KB and two stages
//     of K and V 128 KB, one block an SM, 960 blocks at the prefill.
//   * Masks cost ALU work the tensor cores do not do.  The element masks
//     run only on the tiles that straddle the causal or window edge or
//     T; whole tiles outside them are never visited.  Blocks start with
//     the last query tiles, whose key ranges are the longest.
//
// f32: the CUDA cores (the f32 reduced configs and the f32 check; the
// tensor cores' bf16 and TF32 products cannot meet its 3e-5 tolerance).
// Four warps own a tile of 32 queries, 8 rows each, and loop over 32-key
// tiles.  Q, K and V tiles sit in shared memory as f32 (K rows padded by
// 4 floats so that neighbouring lanes' float4 reads of different key
// rows hit different banks):
//   scores: lane j computes the 8 scores of key j for its warp's rows,
//           from float4 reads of its K row and broadcast Q rows;
//   softmax: warp shuffles give each row's max and sum over the tile;
//   P V:    lane j keeps acc for its warp's 8 rows at columns j + 32 c,
//           and takes each P entry from the lane that computed it.
// Shared memory is 99 KB at hd = 256, acc 64 registers a thread.  It is
// bound by the 67 TFLOP/s f32 rate.
//
// Head sizes.  q and k share one head size HD and v and o have HDV: HD =
// HDV in 32, 64, 128 and 256, and the pair HD 192, HDV 128, added for
// latent attention (MLA, moonlight-16b-a3b: q and k are [nope 128 | rope
// 64], v 128, the scale 1/sqrt(192)).  Both routes are templates over
// the pair; an HD = HDV instance compiles the code it compiled before.  At
// the pair the tensor-core route keeps Q in three column blocks (48 KB),
// a stage of K and V in 24 + 16 KB, 129 KB in all, and O in two column
// blocks (64 registers a thread, as at hd 128); S = Q K^T takes 12 k-steps
// where hd 128 takes 8, and P V the same 8 instructions a key tile.  It is
// bound by operations as the equal sizes are: 2 (HD + HDV) = 640 FLOPs a
// visible pair, 6.9e11 a layer at the train step (B 8, H 16, S = T =
// 4096, causal: 1.07e9 visible pairs), 0.69 ms at the bf16 rate, against
// 0.67 GB of inputs and output (0.2 ms).  The f32 route keeps Q and K rows
// of HD + 4 floats and V rows of HDV (66 KB).
//
// Plain C interface, loaded with ctypes.  The launcher makes `device`
// current for the launch and restores the caller's device after it, and
// returns cudaGetLastError() (or -1 for a head size or dtype it does not
// take); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// f32 route: CUDA cores

constexpr int kBQ = 32;       // queries per block
constexpr int kBK = 32;       // keys per tile (one per lane)
constexpr int kThreads = 128;
constexpr int kRows = kBQ / (kThreads / 32);  // query rows per warp

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, int HDV>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + kBK) * (HD + 4) + kBK * HDV);
}

// HD: the head size of q and k, HDV: that of v and o
template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H,
             int group, int S, int Tk, Strides qs, Strides ks, Strides vs,
             Strides os, int causal, int window, int off, float scale) {
  constexpr int KP = HD + 4;  // padded row of the Q and K tiles
  constexpr int NC = HDV / 32; // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;            // [kBQ][KP]
  float* k_s = q_s + kBQ * KP;  // [kBK][KP]
  float* v_s = k_s + kBK * KP;  // [kBK][HDV]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx - r * HD;
    q_s[r * KP + d] = (q0 + r < S) ? qb[(q0 + r) * qs.s + d] : 0.f;
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
    if constexpr (HD == HDV) {
      for (int idx = tid; idx < kBK * HD; idx += kThreads) {
        const int r = idx / HD, d = idx - r * HD;
        const bool in = kt + r < Tk;
        k_s[r * KP + d] = in ? kb[(kt + r) * ks.s + d] : 0.f;
        v_s[r * HD + d] = in ? vb[(kt + r) * vs.s + d] : 0.f;
      }
    } else {
      for (int idx = tid; idx < kBK * HD; idx += kThreads) {
        const int r = idx / HD, d = idx - r * HD;
        k_s[r * KP + d] = kt + r < Tk ? kb[(kt + r) * ks.s + d] : 0.f;
      }
      for (int idx = tid; idx < kBK * HDV; idx += kThreads) {
        const int r = idx / HDV, d = idx - r * HDV;
        v_s[r * HDV + d] = kt + r < Tk ? vb[(kt + r) * vs.s + d] : 0.f;
      }
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
      for (int c = 0; c < NC; ++c) vv[c] = v_s[j * HDV + lane + 32 * c];
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
      ob[row * os.s + lane + 32 * c] = acc[r][c] / denom;
  }
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int Tk, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, int off, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, HDV>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<HD, HDV><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H,
      H / KV, S, Tk, qs, ks, vs, os, causal, window, off, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma), cp.async double buffering

namespace tc {

constexpr int kBM = 128;  // query rows a block: two warpgroups of 64
constexpr int kBN = 64;   // keys a tile
constexpr int kThreads = 256;

// Shared memory: every tile is kept in 128-byte column blocks of 64
// elements (hd 32 takes one block, half of it unused), each block R rows
// of 128 bytes.  HD is the head size of q and k, HDV that of v and o.
template <int HD, int HDV>
struct Tiles {
  static constexpr int kBlocks = HD < 64 ? 1 : HD / 64;
  static constexpr int kVBlocks = HDV < 64 ? 1 : HDV / 64;
  static constexpr int kQBytes = kBM * kBlocks * 128;
  static constexpr int kKBytes = kBN * kBlocks * 128;   // one K tile
  static constexpr int kVBytes = kBN * kVBlocks * 128;  // one V tile
  static constexpr int kStage = kKBytes + kVBytes;
  // Q, two stages of K and V, and room to align the start to 1024 bytes
  static constexpr int kSmem = kQBytes + 2 * kStage + 1024;
};

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ o, int H,
            int group, int S, int Tk, Strides qs, Strides ks, Strides vs,
            Strides os, int causal, int window, int off, float scale) {
  using L = Tiles<HD, HDV>;
  constexpr int NB = L::kVBlocks;  // output column blocks
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::kQBytes;  // stage j: K, then V
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3,
            lane = tid & 31;
  // the last query tiles first: theirs are the longest key ranges
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, hk = h / group;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  const int qp_first = q0 + off;
  const int qp_last = min(q0 + kBM, S) - 1 + off;
  int k_begin = 0, k_end = Tk;
  if (causal) k_end = min(Tk, qp_last + 1);
  if (window > 0) k_begin = max(0, qp_first - window + 1);
  if (causal && qp_first < 0) {
    k_begin = 0;
    k_end = Tk;
  }
  const int t0 = k_begin / kBN;
  const int n = k_end > k_begin ? (k_end + kBN - 1) / kBN - t0 : 0;

  load_tile<HD, kBM, kThreads>(q_s, qb, qs.s, q0, S);
  if (n > 0) {
    load_tile<HD, kBN, kThreads>(kv_s, kb, ks.s, t0 * kBN, Tk);
    load_tile<HDV, kBN, kThreads>(kv_s + L::kKBytes, vb, vs.s, t0 * kBN,
                                  Tk);
  }
  cp_commit();

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part
  const float scale2 = scale * kLog2e;  // softmax in base 2
  // this thread's first query row; its second is 8 rows on
  const int row = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const uint32_t q_wg = q_s + wg * 64 * 128;  // this warpgroup's 64 rows

  for (int it = 0; it < n; ++it) {
    const int kt = (t0 + it) * kBN;
    const uint32_t k_st = kv_s + (it & 1) * L::kStage;
    const uint32_t v_st = k_st + L::kKBytes;
    cp_wait_all();  // this thread's copies of tile it (and of Q)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's copies; tile it - 1 fully consumed
    if (it + 1 < n) {
      const uint32_t nxt = kv_s + ((it + 1) & 1) * L::kStage;
      load_tile<HD, kBN, kThreads>(nxt, kb, ks.s, kt + kBN, Tk);
      load_tile<HDV, kBN, kThreads>(nxt + L::kKBytes, vb, vs.s, kt + kBN,
                                    Tk);
    }
    cp_commit();

    // S = Q K^T over hd, 16 at a time
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hold(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;  // 16 elements on in the row
      mma_ss(s, sdesc(q_wg + (kk >> 2) * kBM * 128 + col, 16, 1024),
             sdesc(k_st + (kk >> 2) * kBN * 128 + col, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    hold(s);

    // online softmax; element masks only on a tile that straddles an edge
    const bool edge = kt + kBN > Tk || (causal && kt + kBN - 1 > qp_first) ||
                      (window > 0 && kt <= qp_last - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale2;
      if (edge) {
        const int key = kt + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = row + 8 * ((i >> 1) & 1) + off;
        bool ok = key < Tk;
        if (causal) ok = ok && key <= qp;
        if (window > 0) ok = ok && key > qp - window;
        if (!ok) x = kNegInf;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = exp2f(m[hh] - mx[hh]);
      m[hh] = mx[hh];
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      float p = exp2f(s[i] - m[hh]);
      // keys past T carry no weight, even in a row that sees no key
      if (edge && kt + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) >= Tk) p = 0.f;
      s[i] = p;
      l[hh] += p;
    }
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] *= alpha[(i >> 1) & 1];

    // P as two bf16 operands, hi + lo, in the layout of its accumulator
    uint32_t hi[16], lo[16];
    split(s, hi, lo);

    // O += P V, 16 keys and 64 output columns an instruction
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hold(acc[cb]);
    wg_fence();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t vd =
            sdesc(v_st + cb * kBN * 128 + j * 16 * 128, kBN * 128, 1024);
        mma_rs(acc[cb], hi + 4 * j, vd);
        mma_rs(acc[cb], lo + 4 * j, vd);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) hold(acc[cb]);
  }
  cp_wait_all();

  float den[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    den[hh] = fmaxf(l[hh], 1e-30f);
  }
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hh = (i >> 1) & 1, r = row + 8 * hh;
      const int col = cb * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      if (r < S && col < HDV)
        *reinterpret_cast<__nv_bfloat162*>(ob + r * os.s + col) =
            __floats2bfloat162_rn(acc[cb][i] / den[hh],
                                  acc[cb][i + 1] / den[hh]);
    }
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int Tk, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, int off, float scale,
           cudaStream_t stream) {
  constexpr int smem = Tiles<HD, HDV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBM - 1) / kBM, B * H);
  flash_wgmma<HD, HDV><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, H / KV,
      S, Tk, qs, ks, vs, os, causal, window, off, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// the f32 route (DT = 0) or the bf16 route (DT = 1) at head sizes HD (q,
// k) and HDV (v, o)
template <int DT, int HD, int HDV>
int route(const void* q, const void* k, const void* v, void* o, int B, int H,
          int KV, int S, int Tk, Strides qs, Strides ks, Strides vs,
          Strides os, int causal, int window, int off, float scale,
          cudaStream_t st) {
  if constexpr (DT == 0)
    return launch<HD, HDV>(q, k, v, o, B, H, KV, S, Tk, qs, ks, vs, os,
                           causal, window, off, scale, st);
  else
    return tc::launch<HD, HDV>(q, k, v, o, B, H, KV, S, Tk, qs, ks, vs, os,
                               causal, window, off, scale, st);
}

template <int DT>
int dispatch_hd(int hd, int hdv, const void* q, const void* k, const void* v,
                void* o, int B, int H, int KV, int S, int Tk, Strides qs,
                Strides ks, Strides vs, Strides os, int causal, int window,
                int off, float scale, cudaStream_t st) {
#define ATTN_HD(HD, HDV)                                                     \
  if (hd == HD && hdv == HDV)                                                \
    return route<DT, HD, HDV>(q, k, v, o, B, H, KV, S, Tk, qs, ks, vs, os,  \
                              causal, window, off, scale, st);
  ATTN_HD(32, 32)
  ATTN_HD(64, 64)
  ATTN_HD(128, 128)
  ATTN_HD(256, 256)
  ATTN_HD(192, 128)
#undef ATTN_HD
  return -1;
}

template <int HD>
int smem_of(int dtype) {
  return dtype == 0 ? (int)smem_bytes<HD, HD>() : tc::Tiles<HD, HD>::kSmem;
}

}  // namespace

// Dynamic shared memory a block of the route for dtype (0 or 1) at head
// size hd takes (ptxas reports static shared memory only); -1 for any
// other head size or dtype.
extern "C" int flash_attention_smem_bytes(int hd, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (hd) {
    case 32:
      return smem_of<32>(dtype);
    case 64:
      return smem_of<64>(dtype);
    case 128:
      return smem_of<128>(dtype);
    case 256:
      return smem_of<256>(dtype);
    default:
      return -1;
  }
}

// dtype 0 is f32 (CUDA cores), 1 is bf16 (tensor cores; q, k and v
// 16-byte aligned with row, head and batch strides in multiples of 8);
// head sizes (hd of q and k, hdv of v and o) 32, 64, 128 and 256 with hdv
// = hd, and the pair hd 192, hdv 128.  Any other returns -1.  `device` is
// the tensors' device and `stream` a stream on it.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int T, int hd, int hdv, int dtype, long long qsb,
    long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int window, int off,
    float scale, int device, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc =
      dtype == 0 ? dispatch_hd<0>(hd, hdv, q, k, v, o, B, H, KV, S, T, qs, ks,
                                  vs, os, causal, window, off, scale, st)
                 : dispatch_hd<1>(hd, hdv, q, k, v, o, B, H, KV, S, T, qs, ks,
                                  vs, os, causal, window, off, scale, st);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (rc == 0 && back != cudaSuccess) return (int)back;
  }
  return rc;
}
