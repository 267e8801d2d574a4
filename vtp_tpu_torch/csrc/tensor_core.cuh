// Tensor-core pieces shared by the attention kernels on Hopper (sm_90a): the
// fused forward's bf16 and bf16x3 arms (fused_attention.cu), its backward
// (fused_attention_bwd.cu) and the strided attention (flash_attention.cu):
// bf16 tiles in shared memory filled by cp.async, the in-place qk-RMSNorm +
// RoPE prologue on such a tile, ldmatrix fragment loads, mma.sync.m16n8k16
// bf16 products with fp32 accumulators and the online softmax.
//
// Layout: a block of four warps covers a tile of 64 token rows, warp w the
// rows [16w, 16w+16). A tile is 64 rows of D bf16 in shared memory (the
// head dim D, 32, 64 or 128, is a template parameter of every kernel),
// each row padded to kRowOf<D> = D + 8 elements:
// 80, 144 or 272 bytes, odd multiples of 16, so the eight 16-byte rows one
// ldmatrix phase reads fall in eight distinct groups of four banks.
// load_a_rows takes the row stride as a second parameter, for the bf16x3
// arm's split tiles (a row of hi | lo halves, 136 elements). An accumulator of 16 rows x 8n columns is float[n][4]: in
// column block j, lane (g = lane/4, t = lane%4) holds rows g and g+8 at
// columns 8j+2t and 8j+2t+1, elements [0], [1] (row g) and [2], [3] (row
// g+8).

#pragma once

#include "attention_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;               // warps a block, 16 rows of the tile each
constexpr int kTcThreads = 32 * kWarps;
template <int D>
constexpr int kRowOf = D + 8;           // padded bf16 row of a tile of head dim D
template <int D>
constexpr int kTileOf = kTile * kRowOf<D>;  // bf16 elements of one tile
template <int D>
constexpr size_t kTileBytesOf = kTileOf<D> * sizeof(bf16);
// Streamed tiles go through a ring of three stages: the copy of step i + 2
// is issued at step i, and step i + 1's tile is roped at the end of step i
// while other warps still multiply, so a step takes one barrier.
constexpr int kStages = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Starts the copy of token rows [n0, n0+64) of one head into a tile of
// head dim D: `src` points at the head's first column in token row 0, rows
// `row_stride` elements apart; rows at or past N are zero-filled. Each
// thread copies the 16-byte chunks that a prologue then rewrites in the
// same thread: row threadIdx.x/2, half f, the chunks of columns
// [D/4 f, D/4 (f+1)) and D/2 + the same (at D = 64: chunks 2f, 2f+1, 4+2f,
// 5+2f), so the rotate-half pairs (j, j + D/2) stay in one thread and the
// prologue needs only the thread's own cp.async wait, no barrier.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* __restrict__ dst,
                                                const bf16* __restrict__ src,
                                                size_t row_stride, int n0, int N) {
  constexpr int kPer = D / 32;  // chunks a thread copies in each half of the row
  const int row = threadIdx.x >> 1, f = threadIdx.x & 1;
  const int n = n0 + row;
  const bool valid = n < N;
  const bf16* s = src + static_cast<size_t>(valid ? n : 0) * row_stride;
  bf16* d = dst + row * kRowOf<D>;
#pragma unroll
  for (int i = 0; i < 2 * kPer; ++i) {
    const int chunk = (i < kPer ? kPer * f : D / 16 + kPer * f) + i % kPer;
    cp_async16(d + 8 * chunk, s + 8 * chunk, valid);
  }
}

// load_tile_async for a kernel with no prologue: consecutive threads copy
// consecutive 16-byte chunks of a row, so a warp's copy covers whole rows.
template <int D>
__device__ __forceinline__ void load_tile_rows_async(bf16* __restrict__ dst,
                                                     const bf16* __restrict__ src,
                                                     size_t row_stride, int n0, int N) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kTcThreads; ++it) {
    const int id = threadIdx.x + kTcThreads * it;
    const int row = id / kChunks, chunk = id % kChunks;
    const int n = n0 + row;
    const bool valid = n < N;
    cp_async16(dst + row * kRowOf<D> + 8 * chunk,
               src + static_cast<size_t>(valid ? n : 0) * row_stride + 8 * chunk, valid);
  }
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* dst) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 16-byte chunk of a RoPE table row that part i of one thread's
// columns reads (load_tile_async's map): i < D/32 in the row's first half,
// the rest in its second.
template <int D>
__device__ __forceinline__ int rope_chunk(int i, int f) {
  constexpr int kPer = D / 32;
  return (i < kPer ? kPer * f : D / 16 + kPer * f) + i % kPer;
}

// The RoPE table rows that one thread's prologue needs: its columns of sin
// and cos for token row n. At D <= 64 they are fetched into registers ahead
// of the tile they rope; at D = 128 (64 more registers beside accumulators
// twice as wide) the row's table pointers are kept and each part is read
// from global memory (L2) as it is roped.
template <int D, bool kHeld = (D <= 64)>
struct RopeRow {
  uint4 s[D / 16], c[D / 16];
  __device__ __forceinline__ uint4 sin(int i) const { return s[i]; }
  __device__ __forceinline__ uint4 cos(int i) const { return c[i]; }
};

template <int D>
struct RopeRow<D, false> {
  const uint4* sr;
  const uint4* cr;
  int f;
  __device__ __forceinline__ uint4 sin(int i) const { return sr[rope_chunk<D>(i, f)]; }
  __device__ __forceinline__ uint4 cos(int i) const { return cr[rope_chunk<D>(i, f)]; }
};

template <int D>
__device__ __forceinline__ void rope_fetch(RopeRow<D>& t, const bf16* __restrict__ sin_t,
                                           const bf16* __restrict__ cos_t, int n0, int N) {
  const int n = n0 + (threadIdx.x >> 1), f = threadIdx.x & 1;
  if constexpr (D <= 64) {
    if (sin_t == nullptr || n >= N) return;
    const uint4* sr = reinterpret_cast<const uint4*>(sin_t + static_cast<size_t>(n) * D);
    const uint4* cr = reinterpret_cast<const uint4*>(cos_t + static_cast<size_t>(n) * D);
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const int chunk = rope_chunk<D>(i, f);
      t.s[i] = sr[chunk];
      t.c[i] = cr[chunk];
    }
  } else {
    const bool roped = sin_t != nullptr && n < N;
    const size_t at = roped ? static_cast<size_t>(n) * D : 0;
    t.sr = roped ? reinterpret_cast<const uint4*>(sin_t + at) : nullptr;
    t.cr = roped ? reinterpret_cast<const uint4*>(cos_t + at) : nullptr;
    t.f = f;
  }
}

// The bf16 prologue (qk-RMSNorm, RoPE) of the fused forward, in place on a
// bf16 tile of token rows [n0, n0+64), two threads a row: half f of row
// threadIdx.x/2 owns columns [D/4 f, D/4 (f+1)) and D/2 + the same (the
// chunks load_tile_async gave it; at D = 64, [16f, 16f+16) and
// [32+16f, 32+16f+16)), so the rotate-half pairs (j, j+D/2) stay inside one
// thread and a row's mean of squares is one shuffle. `w` (the (D,) fp32
// RMSNorm scales, or null) and the bf16 (N, D) sin/cos tables (or null);
// the rounding points are the plain version's (fused_attention.cu's note):
// bf16 after the normalisation and again after the scale, and RoPE's as
// the fused forward's note gives them. The table rows come from `pre`
// (rope_fetch) or, when it is null, from global memory as each part is
// roped. Rows at or past N are zeros and stay zeros. Columns go in bf16
// pairs, eight pairs at a time (few registers live beside the caller's
// accumulators): a product of two bf16 values is exact in fp32, so the
// packed bf16 multiply rounds it once, as bf16(x * cos) does; each sum is
// an fp32 add rounded once.
template <int D>
__device__ void prologue_tile(bf16* __restrict__ tile, int n0, int N,
                              const float* __restrict__ w, const bf16* __restrict__ sin_t,
                              const bf16* __restrict__ cos_t, const RopeRow<D>* pre) {
  constexpr int kPer = D / 32;  // parts of eight columns in each half of the thread's columns
  const int row = threadIdx.x >> 1, f = threadIdx.x & 1;
  const int n = n0 + row;
  bf16* p = tile + row * kRowOf<D>;
  uint4* lo_half = reinterpret_cast<uint4*>(p + D / 4 * f);          // columns D/4 f + [0, D/4)
  uint4* hi_half = reinterpret_cast<uint4*>(p + D / 2 + D / 4 * f);  // columns D/2 + the same
  float inv = 0.f;
  if (w != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * kPer; ++i) {
      float x[8];
      unpack8(i < kPer ? lo_half[i] : hi_half[i - kPer], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += x[e] * x[e];
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    inv = 1.0f / sqrtf(ss / D + 1e-5f);
  }
  const bool roped = sin_t != nullptr && n < N;
  const size_t at = roped ? static_cast<size_t>(n) * D : 0;
  const uint4* sr = roped ? reinterpret_cast<const uint4*>(sin_t + at) : nullptr;
  const uint4* cr = roped ? reinterpret_cast<const uint4*>(cos_t + at) : nullptr;
#pragma unroll
  for (int part = 0; part < kPer; ++part) {
    // pairs of columns D/4 f + 8 part + [0, 8) (a) and D/2 + the same (b)
    uint4 ra = lo_half[part], rb = hi_half[part];
    __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&ra);
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&rb);
    if (w != nullptr) {
      const float* wa = w + D / 4 * f + 8 * part;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xa = __bfloat1622float2(a[e]), xb = __bfloat1622float2(b[e]);
        const float2 na = __bfloat1622float2(__floats2bfloat162_rn(xa.x * inv, xa.y * inv));
        const float2 nb = __bfloat1622float2(__floats2bfloat162_rn(xb.x * inv, xb.y * inv));
        a[e] = __floats2bfloat162_rn(na.x * wa[2 * e], na.y * wa[2 * e + 1]);
        b[e] = __floats2bfloat162_rn(nb.x * wa[D / 2 + 2 * e], nb.y * wa[D / 2 + 2 * e + 1]);
      }
    }
    if (roped) {
      uint4 rsa, rca, rsb, rcb;
      if (pre != nullptr) {
        rsa = pre->sin(part);
        rca = pre->cos(part);
        rsb = pre->sin(kPer + part);
        rcb = pre->cos(kPer + part);
      } else {
        rsa = sr[kPer * f + part];
        rca = cr[kPer * f + part];
        rsb = sr[D / 16 + kPer * f + part];
        rcb = cr[D / 16 + kPer * f + part];
      }
      const __nv_bfloat162* sa = reinterpret_cast<const __nv_bfloat162*>(&rsa);
      const __nv_bfloat162* ca = reinterpret_cast<const __nv_bfloat162*>(&rca);
      const __nv_bfloat162* sb = reinterpret_cast<const __nv_bfloat162*>(&rsb);
      const __nv_bfloat162* cb = reinterpret_cast<const __nv_bfloat162*>(&rcb);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rotate-half: rot[j] = -x[j+D/2] for j < D/2, x[j-D/2] for j >= D/2
        const float2 ac = __bfloat1622float2(__hmul2(a[e], ca[e]));
        const float2 bs = __bfloat1622float2(__hmul2(__hneg2(b[e]), sa[e]));
        const float2 bc = __bfloat1622float2(__hmul2(b[e], cb[e]));
        const float2 as = __bfloat1622float2(__hmul2(a[e], sb[e]));
        a[e] = __floats2bfloat162_rn(ac.x + bs.x, ac.y + bs.y);
        b[e] = __floats2bfloat162_rn(bc.x + as.x, bc.y + as.y);
      }
    }
    lo_half[part] = ra;
    hi_half[part] = rb;
  }
}

// The two (D,) RMSNorm scale vectors into shared memory, q_scale then
// k_scale, one value a thread (two at D = 128).
template <int D>
__device__ __forceinline__ void load_scales(float* __restrict__ s_w,
                                            const float* __restrict__ q_scale,
                                            const float* __restrict__ k_scale) {
  if constexpr (2 * D <= kTcThreads) {
    if (threadIdx.x < 2 * D)
      s_w[threadIdx.x] = threadIdx.x < D ? q_scale[threadIdx.x] : k_scale[threadIdx.x - D];
  } else {
#pragma unroll
    for (int it = 0; it < 2 * D / kTcThreads; ++it) {
      const int i = threadIdx.x + kTcThreads * it;
      s_w[i] = i < D ? q_scale[i] : k_scale[i - D];
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of rows [row0, row0+16) of a tile, head-dim steps of 16.
template <int D, int kRow = kRowOf<D>>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], const bf16* tile, int row0,
                                            int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(a[ks], tile + (row0 + (lane & 15)) * kRow + 16 * ks + (lane >> 4) * 8);
}

// acc[j] = a . tile[n0 + 8j .. +8]^T over the head dim: a holds 16 rows of
// D (load_a_rows), the tile is row-major [n][head dim]. kNb column blocks.
template <int kNb, int D>
__device__ __forceinline__ void mma_a_tileT(float (&acc)[kNb][4], const uint32_t (&a)[D / 16][4],
                                            const bf16* tile, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < kNb; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int p = 0; p < kNb / 2; ++p) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + (n0 + 16 * p + (lane & 7) + ((lane >> 4) << 3)) * kRowOf<D> + 16 * ks +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * p], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[ks], b[2], b[3]);
    }
  }
}

// mma_a_tileT with the A operand read from rows [row0, row0+16) of a tile
// in shared memory at each head-dim step, not held in registers (the
// backward's dk/dv pass at D = 128, whose K and V fragments would not fit
// beside its accumulators).
template <int kNb, int D>
__device__ __forceinline__ void mma_tile_tileT(float (&acc)[kNb][4], const bf16* a_tile, int row0,
                                               const bf16* tile, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < kNb; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int p = 0; p < kNb / 2; ++p) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, a_tile + (row0 + (lane & 15)) * kRowOf<D> + 16 * ks + (lane >> 4) * 8);
      ldmatrix_x4(b, tile + (n0 + 16 * p + (lane & 7) + ((lane >> 4) << 3)) * kRowOf<D> + 16 * ks +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D head-dim columns) += a . tile[k0 .. k0 + 16 kKs]: a holds kKs
// steps of 16 of the shared dimension, the tile is row-major [k][head dim].
template <int kKs, int D>
__device__ __forceinline__ void mma_a_tile(float (&acc)[D / 8][4], const uint32_t (&a)[kKs][4],
                                           const bf16* tile, int k0, int lane) {
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (k0 + 16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               kRowOf<D> +
                               16 * p + (lane >> 4) * 8);
      mma_bf16(acc[2 * p], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[ks], b[2], b[3]);
    }
  }
}

// Scales the scores of this lane's rows (`row`, row + 8) and key columns
// k0 + 8j + 2t + e by `scale` (the caller's d^-1/2) and masks keys >= n_valid
// and, if causal, keys past the row, as -inf.
template <int kNb>
__device__ __forceinline__ void mask_and_scale_acc(float (&s)[kNb][4], int k0, int row, int t,
                                                   int n_valid, int causal, float scale) {
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      const int r = row + 8 * (e >> 1);
      s[j][e] = (col >= n_valid || (causal && col > r)) ? -INFINITY : s[j][e] * scale;
    }
  }
}

// One key tile of the online softmax (FlashAttention-2's form), on a warp's
// 16 x 64 scores `s` (scaled and masked): m is each row's running max (the
// same in the row's four lanes), l this lane's part of the running sum of
// exp(s - m), o the running P V of kNbO column blocks. When the max moves,
// o and l are rescaled by exp(m_old - m_new); s is replaced by
// p = exp(s - m_new) in fp32 (0 where masked). A row with no unmasked key
// yet keeps m = -inf, l = 0, o = 0.
template <int kNbO>
__device__ __forceinline__ void online_softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                                    float (&o)[kNbO][4]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[hr], mt);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float rescale = expf(m[hr] - base);  // 0 while m is -inf
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
        const float p = expf(s[j][e] - base);  // 0 where masked
        part += p;
        s[j][e] = p;
      }
#pragma unroll
      for (int jo = j * kNbO / 8; jo < (j + 1) * kNbO / 8; ++jo) {  // o's blocks, spread over j
        o[jo][2 * hr] *= rescale;
        o[jo][2 * hr + 1] *= rescale;
      }
    }
    l[hr] = l[hr] * rescale + part;
    m[hr] = m_new;
  }
}

// The end of the online softmax: sums l over the row's four lanes and
// divides o by it. Every row a caller finishes has an unmasked key, so
// l > 0.
template <int kNbO>
__device__ __forceinline__ void online_softmax_finish(float (&l)[2], float (&o)[kNbO][4]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const float inv = 1.0f / l[hr];
#pragma unroll
    for (int j = 0; j < kNbO; ++j) {
      o[j][2 * hr] *= inv;
      o[j][2 * hr + 1] *= inv;
    }
  }
}

// The A fragments of the accumulator c (16 x 8 kNb, already bf16 values in
// fp32) as the left operand of the next product: step j spans c's column
// blocks 2j and 2j+1.
template <int kNb>
__device__ __forceinline__ void acc_to_a(const float (&c)[kNb][4], uint32_t (&a)[kNb / 2][4]) {
#pragma unroll
  for (int j = 0; j < kNb / 2; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// Writes a 16 x D fp32 accumulator into rows [row0, row0+16) of an fp32
// tile of row stride D + 4.
template <int D>
__device__ __forceinline__ void stage_acc(const float (&acc)[D / 8][4], float* tile, int row0,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(tile + (row0 + g) * (D + 4) + 8 * j + 2 * t) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(tile + (row0 + g + 8) * (D + 4) + 8 * j + 2 * t) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// Writes a 16 x D accumulator, rounded to bf16, into rows [row0, row0+16)
// of a bf16 tile (row stride kRowOf<D>), for a 16-byte copy-out.
template <int D>
__device__ __forceinline__ void stage_acc_bf16(const float (&acc)[D / 8][4], bf16* tile, int row0,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + (row0 + g) * kRowOf<D> + col) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(tile + (row0 + g + 8) * kRowOf<D> + col) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
}

}  // namespace
