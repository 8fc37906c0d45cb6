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
// them never overflows where the true value does not (at w = 1e-8, -lc
// reaches 425 in 16 steps, and 2^425 is no f32).  With S0 the saved
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
// What bounds it on an H100: at the rwkv6-3b train shape [16, 256, 40, 64]
// it must read r, k, v, w, dy, the saved states and dS_T and write dr, dk,
// dv, dw and dS_0 (0.566 GB: 0.169 ms at 3.35 TB/s).  Its chunk products
// (SD, GV, dv's two terms, G's update, B: 0.29 M multiply-adds a chunk of
// a (batch, head) at hd 64) take three tensor-core passes each (0.037 ms
// at 495 TFLOP/s); the rest, A and the dr/dk/dw block, is 0.26 M f32
// operations a chunk on the CUDA cores (0.039 ms at 67 TFLOP/s;
// chip_smoke.py's wkv_bwd_chunk_ops counts both).  So bytes bound it.
//
// What held the first design back (12.7 % of that bound): every
// product was a loop of a thread over shared memory, one or two loads an
// FMA, which caps an SM at about an eighth of its FMA rate.  Here:
//
// Layout: one block a (batch, head), 256 threads (512 at hd 128), the
// chunks walked from the last.  Per chunk, between four barriers:
//   A. Log-space decays, four threads a channel (wkv.cu's scan): lc, b r
//      (RD), k a (KD, stored transposed) and 2^lct.  Beside them, on the
//      tensor cores, warp w takes state rows 8w .. 8w + 7: SD = dy S0^T and
//      GV = v G^T for those columns, and X = rowsum(G * S0) from the same
//      fragments; two warps form B = dy v^T.
//   B. cp.async stages the chunk before's r, k, v, dy, w rows [16, hd]
//      (rows padded by 8 floats) into the other of two stages, zero filled
//      past T (where w's decay is taken as 1): issued here, its copies
//      overlap this chunk's CUDA-core work.  The forward's A (two threads
//      a pair below the diagonal, four at hd 128, as wkv.cu; a thread a
//      diagonal element), then dr, dk, dw: a thread takes a channel d and
//      steps t paired as t and 15 - t, so every thread has the same work.
//      Each t's factors e[t][q] k_q (q < t) are formed once and kept in
//      registers, each e a running product of the steps' decays 2^(lc[i]
//      - lc[i-1]) <= 1 (one ex2 a step and channel, not one a factor);
//      the sums walk only q < t and s > t, with B's rows read four at a
//      time.
//   C. The chunk before's saved state S0 from device memory into the
//      registers of the warps that use it (it lands by the next A).  dv =
//      KD G + A^T dy on the tensor cores (warp w: columns 8w .. 8w + 7),
//      stored; and G's update, 2^lct G + RD^T dy, into the registers of
//      the warps that own its tiles.
//   D. After a barrier, the new G into shared memory; once this thread's
//      copies of the chunk before have landed, its pieces of v and dy are
//      split into TF32 hi (in place) + lo (VL, DYL): every warp then reads
//      the split fragments instead of splitting them again.
// Every tensor-core product is mma.sync m16n8k8 in TF32 with each f32
// operand split as hi + lo (TF32 each) and lo hi + hi lo + hi hi summed in
// f32 (3xTF32; for all but G's update, each of the three terms in an
// accumulator of its own, so a product is three short chains of dependent
// mma): one TF32 product keeps about three decimal digits, far from the
// f32 plain version's error that the card holds this kernel to
// (tests/test_torch_wkv_bwd_design.py emulates both).  Fragments load from
// shared memory without bank conflicts: a row's k pair (q, q + 4) is read
// as the adjacent columns 2q, 2q + 1 (a float2), and rows are padded to
// 8 mod 32 floats.  At hd 64 a block takes 103 KB of shared memory and 128
// registers a thread, so two blocks share an SM: the 640 blocks of the
// train shape run in 2.4 waves over 264 slots (three blocks an SM would
// need 75 KB and 80 registers, which G, the two stages and the fragments
// of the split products do not fit).  Where the time goes
// (scripts/wkv_ablation.py --bwd takes each phase out): the dr/dk/dw
// block, then the loads and the products; PERF.md has the numbers.
//
// Plain C interface, loaded with ctypes.  The launcher makes `device`
// current for the launch and restores the caller's device after it, and
// returns cudaGetLastError() (or -1 for a head size it is not built for);
// the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kL = 16;                     // steps a chunk
constexpr float kLo = 1e-8f;               // the decay's clip
constexpr int kPairs = kL * (kL - 1) / 2;  // (t, s) pairs below the diagonal
constexpr int kSS = kL + 8;                // row stride of B, A and KD^T

template <int HD>
struct Bwd {
  static constexpr int kThreads = HD == 128 ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int RS = HD + 8;          // row stride of tiles and G
  static constexpr int kTile = kL * RS;      // a chunk's [16][hd] tile
  static constexpr int kStage = 5 * kTile;   // r, k, v, dy, w
  static constexpr int NT = HD / 8;          // 8-column tiles of hd
  static constexpr int NG = kThreads / HD;   // step groups of dr/dk/dw
  static constexpr int SPLIT = kThreads / 128;  // threads a pair of A
  // G's update: tiles of 16 rows by 8 columns, kPer a warp
  static constexpr int kGTiles = (HD / 16) * NT;
  static constexpr int kPer = kGTiles > kWarps ? kGTiles / kWarps : 1;
  // two stages; G; LC, RD, SD, GV; the lo parts of v, dy; KD^T; B, A; X,
  // 2^lct, u; du's parts
  static constexpr int kFloats = 2 * kStage + HD * RS + 6 * kTile +
                                 HD * kSS + 2 * kL * kSS + 3 * HD + kThreads;
  static_assert(NT <= kWarps && NG * HD == kThreads, "warp roles");
  static_assert(4 * HD <= kThreads, "four threads a channel in the scan");
  static_assert(kPairs * SPLIT + kL <= kThreads, "threads for A");
  static_assert(HD % (4 * SPLIT) == 0, "pair threads split d in float4s");
  static_assert(NT % kPer == 0, "a warp's G tiles share their rows");
};

// the step group that owns step t: t and 15 - t together, and at four
// groups the pairs (0, 7), (1, 6), (2, 5), (3, 4) of those, so that every
// group has the same sum over s > t of t products
template <int NG>
__device__ __forceinline__ constexpr int owner(int t) {
  const int p = t < kL - 1 - t ? t : kL - 1 - t;
  return NG == 16 ? t : NG == 8 ? p : (p < 4 ? p : 7 - p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
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

// A finite f32 x as TF32 hi + lo: hi is x rounded to TF32 (10 bits of
// mantissa) to nearest, ties away from 0, as cvt.rna.tf32.f32 rounds, on
// the bits (two integer instructions where cvt takes four); lo is x - hi
// (exact in f32) rounded the same way, its low 13 bits left as they fall:
// the tensor cores ignore them.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// an mma operand fragment of N f32 values as TF32 hi + lo
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ explicit Split(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      hi[i] = tf32_hi(x[i]);
      lo[i] = tf32_lo(x[i], hi[i]);
    }
  }
  // from values split before (hi, lo as floats)
  __device__ __forceinline__ Split(const float (&h)[N], const float (&l)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      hi[i] = __float_as_uint(h[i]);
      lo[i] = __float_as_uint(l[i]);
    }
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// The same with the three terms in accumulators of their own, so that a
// product over many k steps is three short chains of dependent mma and not
// one long one; sum adds them, the small terms first.
struct Acc3 {
  float c[3][4] = {};
  __device__ __forceinline__ void add(const Split<4>& a, const Split<2>& b) {
    mma_tf32(c[0], a.lo, b.hi);
    mma_tf32(c[1], a.hi, b.lo);
    mma_tf32(c[2], a.hi, b.hi);
  }
  __device__ __forceinline__ float sum(int i) const {
    return (c[0][i] + c[1][i]) + c[2][i];
  }
};

// Fragments of m16n8k8 (g = lane / 4, q = lane % 4): A (m, k) holds
// (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B (k, n) holds (q, g),
// (q + 4, g); C (m, n) holds (g, 2q), (g, 2q + 1), (g + 8, 2q),
// (g + 8, 2q + 1).  Where both operands are read along rows, k = q and
// k = q + 4 are taken from columns 2q and 2q + 1 (the same order for both
// operands, so the sum is the same), one float2 each.

template <int HD>
__global__ void __launch_bounds__(Bwd<HD>::kThreads, HD == 128 ? 1 : 2)
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
  constexpr int kThreads = C::kThreads, RS = C::RS, NT = C::NT, NG = C::NG,
                SPLIT = C::SPLIT, kPer = C::kPer;
  extern __shared__ __align__(16) float smem[];
  float* const Gs = smem + 2 * C::kStage;  // [d][j] the carried gradient
  float* const LC = Gs + HD * RS;          // [t][d] lc
  float* const RD = LC + C::kTile;         // [t][d] r[t,d] b[t,d]
  float* const SD = RD + C::kTile;         // [t][d]
  float* const GV = SD + C::kTile;         // [t][d]
  float* const VL = GV + C::kTile;         // [t][j] v's lo part (the stage
  float* const DYL = VL + C::kTile;        // holds hi), and dy's
  float* const KDT = DYL + C::kTile;       // [d][t] k[t,d] a[t,d]
  float* const Bm = KDT + HD * kSS;        // [t][s]
  float* const Am = Bm + kL * kSS;         // [t][s], zero above the diagonal
  float* const X = Am + kL * kSS;
  float* const sdec = X + HD;              // 2^lct
  float* const us = sdec + HD;
  float* const dup = us + HD;              // [NG][HD] du's parts

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;  // the fragments' g and q
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const size_t step = (size_t)H * HD;
  const size_t base = ((size_t)b * T * H + h) * HD;
  const int nch = (T + kL - 1) / kL;

  {
    const float* dsp = ds + (size_t)bh * HD * HD;
    for (int i = tid; i < HD * HD; i += kThreads)
      Gs[(i / HD) * RS + i % HD] = dsp[i];
  }
  for (int i = tid; i < HD; i += kThreads) us[i] = u[h * HD + i];
  for (int i = tid; i < kL * kSS; i += kThreads) Am[i] = 0.f;

  // this thread's role in A: pair (pt, ps), part of d; or diagonal element
  const int pair = tid / SPLIT, part = tid - pair * SPLIT;
  const int diag = tid - kPairs * SPLIT;
  int pt = 1;
  while (pair < kPairs && (pt + 1) * pt / 2 <= pair) ++pt;
  const int ps = pair - pt * (pt - 1) / 2;
  // this thread's channel and step group in dr/dk/dw
  const int dd = tid % HD, tg = tid / HD;

  // chunk n's five tiles into stage `buf`, 16 bytes a copy
  constexpr int kRow = HD / 4, kAll = 5 * kL * kRow;
  const uint32_t smem_base = (uint32_t)__cvta_generic_to_shared(smem);
  auto load = [&](int n, int buf) {
    const int t0 = n * kL;
    const uint32_t sa = smem_base + 4u * buf * C::kStage;
    for (int i = tid; i < kAll; i += kThreads) {
      const int a = i / (kL * kRow), rem = i - a * (kL * kRow);
      const int t = rem / kRow, c = 4 * (rem - t * kRow);
      const float* p = a == 0 ? r : a == 1 ? k : a == 2 ? v : a == 3 ? dy : w;
      const bool in = t0 + t < T;
      cp_async16(sa + 4u * (a * C::kTile + t * RS + c),
                 in ? p + base + (size_t)(t0 + t) * step + c : r, in);
    }
    cp_commit();
  };
  // once this thread's copies into stage `buf` have landed: its pieces of
  // v and dy as TF32 hi (in the stage) + lo (VL, DYL), the operands the
  // tensor cores take
  auto split_vdy = [&](int buf) {
    float* const st = smem + buf * C::kStage;
    for (int i = tid; i < 4 * kL * kRow; i += kThreads) {
      if (i < 2 * kL * kRow) continue;
      const int a = i / (kL * kRow), rem = i - a * (kL * kRow);
      const int t = rem / kRow, c = 4 * (rem - t * kRow);
      float* const x = st + a * C::kTile + t * RS + c;
      float* const lo = (a == 2 ? VL : DYL) + t * RS + c;
      const float4 v4 = ld4(x);
      const float f[4] = {v4.x, v4.y, v4.z, v4.w};
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t hb = tf32_hi(f[e]);
        h[e] = __uint_as_float(hb);
        l[e] = __uint_as_float(tf32_lo(f[e], hb));
      }
      *reinterpret_cast<float4*>(x) = make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(lo) = make_float4(l[0], l[1], l[2], l[3]);
    }
  };
  // the A fragment (rows t = g, g + 8; k = q, q + 4 at columns c, c + 1)
  // of a tile split into hi (the stage) and lo
  auto frag_a = [&](const float* hi, const float* lo, int c) {
    const float2 h0 = ld2(hi + g * RS + c), h1 = ld2(hi + (g + 8) * RS + c);
    const float2 l0 = ld2(lo + g * RS + c), l1 = ld2(lo + (g + 8) * RS + c);
    const float fh[4] = {h0.x, h1.x, h0.y, h1.y};
    const float fl[4] = {l0.x, l1.x, l0.y, l1.y};
    return Split<4>(fh, fl);
  };
  // chunk n's saved state into the registers of warp wp < NT: rows
  // 8 wp + g, columns 8 i + 2 q and 8 i + 2 q + 1 (the B fragments of SD)
  float s0r[HD / 4];
  auto load_s0 = [&](int n) {
    if (wp < NT) {
      const float* sp = states + (((size_t)b * nch + n) * H + h) * HD * HD +
                        (size_t)(8 * wp + g) * HD + 2 * q4;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float2 x = ld2(sp + 8 * i);
        s0r[2 * i] = x.x;
        s0r[2 * i + 1] = x.y;
      }
    }
  };

  float duacc = 0.f;                       // du[dd] over this thread's steps
  if (nch > 0) {
    load(nch - 1, (nch - 1) & 1);
    load_s0(nch - 1);
    cp_wait<0>();
    split_vdy((nch - 1) & 1);
  }
  for (int n = nch - 1; n >= 0; --n) {
    const int t0 = n * kL;
    __syncthreads();                 // chunk n staged and split, G current
    const float* const rs = smem + (n & 1) * C::kStage;
    const float* const ks = rs + C::kTile;
    const float* const vs = ks + C::kTile;
    const float* const dys = vs + C::kTile;
    const float* const ws = dys + C::kTile;

    // A.1 decays: thread (d, q) takes steps q, q + 4, q + 8, q + 12; the
    // four rounds are scanned over q side by side (csrc/wkv.cu's step 2)
    if (tid < 4 * HD) {
      const int d = tid >> 2, q = tid & 3;
      float lc[4], tot[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = q + 4 * i;
        lc[i] = t0 + t < T ? lg2(fminf(fmaxf(ws[t * RS + d], kLo), 1.f))
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
      float carry[4];
      carry[0] = 0.f;
#pragma unroll
      for (int i = 1; i < 4; ++i) carry[i] = carry[i - 1] + tot[i - 1];
      const float lct = carry[3] + tot[3];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lc[i] = carry[i] + lc[i];
        const float up = __shfl_up_sync(0xffffffffu, lc[i], 1, 4);
        const float lp = q ? up : carry[i];
        const int t = q + 4 * i;
        LC[t * RS + d] = lc[i];
        RD[t * RS + d] = rs[t * RS + d] * ex2(lp);
        KDT[d * kSS + t] = ks[t * RS + d] * ex2(lct - lc[i]);
      }
      if (q == 0) sdec[d] = ex2(lct);
    }

    // A.2 SD = dy S0^T, GV = v G^T and X on state rows 8 wp .. 8 wp + 7
    if (wp < NT) {                   // SD, GV, X
      const int n0 = 8 * wp;
      Acc3 sd, gv;
      float xs = 0.f;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int c = 8 * i + 2 * q4;
        const float2 gg = ld2(Gs + (n0 + g) * RS + c);
        xs += s0r[2 * i] * gg.x + s0r[2 * i + 1] * gg.y;
        const float fs[2] = {s0r[2 * i], s0r[2 * i + 1]};
        const float fg[2] = {gg.x, gg.y};
        sd.add(frag_a(dys, DYL, c), Split<2>(fs));
        gv.add(frag_a(vs, VL, c), Split<2>(fg));
      }
      st2(SD + g * RS + n0 + 2 * q4, sd.sum(0), sd.sum(1));
      st2(SD + (g + 8) * RS + n0 + 2 * q4, sd.sum(2), sd.sum(3));
      st2(GV + g * RS + n0 + 2 * q4, gv.sum(0), gv.sum(1));
      st2(GV + (g + 8) * RS + n0 + 2 * q4, gv.sum(2), gv.sum(3));
      xs += __shfl_xor_sync(0xffffffffu, xs, 1);
      xs += __shfl_xor_sync(0xffffffffu, xs, 2);
      if (q4 == 0) X[n0 + g] = xs;
    }
    // A.3 B = dy v^T: columns s = 8 ns .. 8 ns + 7 on the last two warps
    if (wp >= C::kWarps - 2) {       // B
      const int ns = wp - (C::kWarps - 2);
      Acc3 bb;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int c = 8 * i + 2 * q4;
        const int o = (8 * ns + g) * RS + c;
        const float2 vh = ld2(vs + o), vl = ld2(VL + o);
        const float fh[2] = {vh.x, vh.y}, fl[2] = {vl.x, vl.y};
        bb.add(frag_a(dys, DYL, c), Split<2>(fh, fl));
      }
      st2(Bm + g * kSS + 8 * ns + 2 * q4, bb.sum(0), bb.sum(1));
      st2(Bm + (g + 8) * kSS + 8 * ns + 2 * q4, bb.sum(2), bb.sum(3));
    }
    __syncthreads();

    // the chunk before into the other stage (read last by chunk n + 1):
    // issued here, its copies overlap this chunk's CUDA-core work
    if (n > 0) load(n - 1, (n - 1) & 1);

    // B.1 the forward's A
    {
      const bool is_pair = pair < kPairs, is_diag = diag >= 0 && diag < kL;
      float acc = 0.f;
      if (is_pair) {
        const float *ra = rs + pt * RS, *kb = ks + ps * RS,
                    *la = LC + (pt - 1) * RS, *lb = LC + ps * RS;
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
      } else if (is_diag) {
        const float *ra = rs + diag * RS, *kb = ks + diag * RS;
        float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 a = ld4(ra + d), kk = ld4(kb + d), uu = ld4(us + d);
          p4[0] += a.x * uu.x * kk.x;
          p4[1] += a.y * uu.y * kk.y;
          p4[2] += a.z * uu.z * kk.z;
          p4[3] += a.w * uu.w * kk.w;
        }
        acc = (p4[0] + p4[1]) + (p4[2] + p4[3]);
      }
      float sum = acc;
#pragma unroll
      for (int off = 1; off < SPLIT; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (is_pair) {
        if (part == 0) Am[pt * kSS + ps] = sum;
      } else if (is_diag) {
        Am[diag * kSS + diag] = acc;
      }
    }

    // B.2 dr, dk, dw at channel dd for the steps of group tg, a pair of
    // steps t and 15 - t at a time (one straight run of code, so the two
    // chains interleave)
    {
      const int d = dd;
      float lcd[kL], dec[kL];                // lc of channel d; 2^lw
#pragma unroll
      for (int t = 0; t < kL; ++t) lcd[t] = LC[t * RS + d];
#pragma unroll
      for (int t = 1; t < kL; ++t) dec[t] = ex2(lcd[t] - lcd[t - 1]);
      const float ud = us[d], lct = lcd[kL - 1], xd = X[d];
      auto grads_at = [&](int t) {
        const float lc_t = lcd[t];
        const float lp_t = t ? lcd[t - 1] : 0.f;
        const float at = ex2(lct - lc_t), bt = ex2(lp_t);
        float ek[kL];                        // e[t][q] k_q, q < t
        float e = 1.f;                       // e[t][t - 1] = 2^0
#pragma unroll
        for (int q = t - 1; q >= 0; --q) {
          ek[q] = e * ks[q * RS + d];
          if (q) e *= dec[q];
        }
        float brow[kL];                      // B[t][q], q < t
#pragma unroll
        for (int q = 0; q < t; q += 4) {
          const float4 x = ld4(Bm + t * kSS + q);
          brow[q] = x.x;
          brow[q + 1] = x.y;
          brow[q + 2] = x.z;
          brow[q + 3] = x.w;
        }
        const float bd = Bm[t * kSS + t];
        const float kt = ks[t * RS + d], rt = rs[t * RS + d];
        float drv = bt * SD[t * RS + d] + ud * kt * bd;
        float inner = bt * xd;
#pragma unroll
        for (int q = 0; q < t; ++q) {
          drv += brow[q] * ek[q];
          inner += ek[q] * GV[q * RS + d];
        }
        float dkv = at * GV[t * RS + d] + rt * ud * bd;
        float dwv = at * inner;
        e = 1.f;                             // e[t + 1][t] = 2^0
#pragma unroll
        for (int s = t + 1; s < kL; ++s) {
          if (s > t + 1) e *= dec[s - 1];    // e[s][t]
          const float er = e * rs[s * RS + d];
#pragma unroll
          for (int q = 0; q < t; q += 4) {
            const float4 x = ld4(Bm + s * kSS + q);
            brow[q] = x.x;
            brow[q + 1] = x.y;
            brow[q + 2] = x.z;
            brow[q + 3] = x.w;
          }
          dkv += Bm[s * kSS + t] * er;
          float z = bt * SD[s * RS + d];
#pragma unroll
          for (int q = 0; q < t; ++q) z += ek[q] * brow[q];
          dwv += er * z;
        }
        duacc += rt * kt * bd;
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
      };
#pragma unroll
      for (int p = 0; p < kL / 2; ++p) {
        if (NG == 16) {                      // hd 16: a step a group
          if (p == tg) grads_at(p);
          if (kL - 1 - p == tg) grads_at(kL - 1 - p);
        } else if (owner<NG>(p) == tg) {
          grads_at(p);
          grads_at(kL - 1 - p);
        }
      }
    }
    __syncthreads();                 // A complete
    if (n > 0) load_s0(n - 1);       // lands while this chunk ends

    // C.1 dv = KD G + A^T dy, columns 8 wp .. 8 wp + 7
    if (wp < NT) {                   // dv
      const int j0 = 8 * wp;
      Acc3 acc;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float* kd = KDT + (8 * i + q4) * kSS + g;
        const float* gs = Gs + (8 * i + q4) * RS + j0 + g;
        const float fa[4] = {kd[0], kd[8], kd[4 * kSS], kd[4 * kSS + 8]};
        const float fb[2] = {gs[0], gs[4 * RS]};
        acc.add(Split<4>(fa), Split<2>(fb));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* am = Am + (8 * i + q4) * kSS + g;
        const int o = (8 * i + q4) * RS + j0 + g;
        const float fa[4] = {am[0], am[8], am[4 * kSS], am[4 * kSS + 8]};
        const float fh[2] = {dys[o], dys[o + 4 * RS]};
        const float fl[2] = {DYL[o], DYL[o + 4 * RS]};
        acc.add(Split<4>(fa), Split<2>(fh, fl));
      }
      const size_t off = base + j0 + 2 * q4;
      if (t0 + g < T)
        st2(dv + off + (size_t)(t0 + g) * step, acc.sum(0), acc.sum(1));
      if (t0 + g + 8 < T)
        st2(dv + off + (size_t)(t0 + g + 8) * step, acc.sum(2), acc.sum(3));
    }
    // C.2 G's update, 2^lct G + RD^T dy, into registers: rows d0 .. d0 +
    // 15, column tiles nt0 .. nt0 + kPer - 1
    const int tile0 = wp * kPer;
    const bool gw = tile0 < C::kGTiles;
    const int d0 = 16 * (tile0 / NT), nt0 = tile0 % NT;
    float gn[kPer][4];
    if (gw) {                        // G's update
      float fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* rd = RD + (8 * i + q4) * RS + d0 + g;
        fa[i][0] = rd[0];
        fa[i][1] = rd[8];
        fa[i][2] = rd[4 * RS];
        fa[i][3] = rd[4 * RS + 8];
      }
      const Split<4> a0(fa[0]), a1(fa[1]);
      const float s_lo = sdec[d0 + g], s_hi = sdec[d0 + g + 8];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int j0 = 8 * (nt0 + p);
        const float2 x0 = ld2(Gs + (d0 + g) * RS + j0 + 2 * q4);
        const float2 x1 = ld2(Gs + (d0 + g + 8) * RS + j0 + 2 * q4);
        gn[p][0] = s_lo * x0.x;
        gn[p][1] = s_lo * x0.y;
        gn[p][2] = s_hi * x1.x;
        gn[p][3] = s_hi * x1.y;
        const int o = q4 * RS + j0 + g;
        const float h0[2] = {dys[o], dys[o + 4 * RS]};
        const float l0[2] = {DYL[o], DYL[o + 4 * RS]};
        const float h1[2] = {dys[o + 8 * RS], dys[o + 12 * RS]};
        const float l1[2] = {DYL[o + 8 * RS], DYL[o + 12 * RS]};
        mma3(gn[p], a0, Split<2>(h0, l0));
        mma3(gn[p], a1, Split<2>(h1, l1));
      }
    }
    __syncthreads();                 // every read of G and of the stage done

    // D. the new G; the chunk before, landed, split
    if (gw) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int j0 = 8 * (nt0 + p);
        st2(Gs + (d0 + g) * RS + j0 + 2 * q4, gn[p][0], gn[p][1]);
        st2(Gs + (d0 + g + 8) * RS + j0 + 2 * q4, gn[p][2], gn[p][3]);
      }
    }
    if (n > 0) {
      cp_wait<0>();
      split_vdy((n - 1) & 1);
    }
  }

  dup[tg * HD + dd] = duacc;
  __syncthreads();
  {
    float* o = ds0 + (size_t)bh * HD * HD;
    for (int i = tid; i < HD * HD; i += kThreads)
      o[i] = Gs[(i / HD) * RS + i % HD];
  }
  if (tid < HD) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < NG; ++p) acc += dup[p * HD + tid];
    du_part[(size_t)bh * HD + tid] = acc;
  }
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
  using C = Bwd<HD>;
  constexpr int smem = C::kFloats * (int)sizeof(float);
  static unsigned opted_in = 0;   // devices whose attribute is set (bit)
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (smem > 48 * 1024 && !(opted_in & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_chunked<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= bit;
  }
  wkv_bwd_chunked<HD><<<B * H, C::kThreads, smem, stream>>>(
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
// [B, H, hd, hd]; du_part [B, H, hd] scratch.  r, k, v, w and dy 16-byte
// aligned (cp.async), states 8-byte aligned.  Two launches.
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
