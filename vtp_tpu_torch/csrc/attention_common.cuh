// Pieces of the attention kernels for Hopper (sm_90a): the tile geometry
// and bf16 rounding, used by all of them (the tensor-core kernels add
// tensor_core.cuh); the bf16x3 split; and, for the scalar exact fp32 arm of
// the fused forward (fused_attention.cu), the row loader that applies
// qk-RMSNorm and RoPE exactly as the plain PyTorch version rounds them and
// the score loop.
//
// Layout of the scalar kernel: a block of 256 threads covers a tile of 64
// token rows, four threads per row; thread quarter c owns head-dim columns
// [8c, 8c+8) and [32+8c, 32+8c+8) when it loads a row, so rotate-half pairs
// (j, j+32) stay inside one thread. The tensor-core backward's epilogues
// keep that layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;             // query rows per block, key rows per tile
constexpr int kThreads = 256;         // four threads per row
constexpr int kStride = kHeadDim + 4; // padded shared-memory row, float4-aligned

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bf16x3 split of an fp32 value: hi = bf16(x), lo = bf16(x - hi), both
// held in fp32. A product of two halves is exact in fp32, so
// a*b ~ hi_a*hi_b + hi_a*lo_b + lo_a*hi_b (the lo*lo term dropped).
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = bf16_round(x);
  lo = bf16_round(x - hi);
}

__device__ __forceinline__ void load8(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Loads token row `n` of one head's Q or K (or V, with no prologue) into
// `dst`, a padded shared-memory row. Thread quarter `c` owns columns
// [8c, 8c+8) and [32+8c, 32+8c+8). Rows at or past N load as zeros.
__device__ void load_row(const float* __restrict__ row, bool in_range,
                         const float* __restrict__ norm_w,
                         const __nv_bfloat16* __restrict__ sin_row,
                         const __nv_bfloat16* __restrict__ cos_row,
                         float* __restrict__ dst, int c) {
  float x[16];
  if (in_range) {
    load8(row + 8 * c, x);
    load8(row + 32 + 8 * c, x + 8);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = 0.f;
  }
  if (norm_w != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) ss += x[i] * x[i];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    const float inv = 1.0f / sqrtf(ss / kHeadDim + 1e-5f);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = (i < 8 ? 8 * c : 32 + 8 * c) + (i & 7);
      x[i] = x[i] * inv * norm_w[col];
    }
  }
  if (sin_row != nullptr && in_range) {
    float s[16], co[16];
    load8(sin_row + 8 * c, s);
    load8(sin_row + 32 + 8 * c, s + 8);
    load8(cos_row + 8 * c, co);
    load8(cos_row + 32 + 8 * c, co + 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float lo = bf16_round(x[i]);
      const float hi = bf16_round(x[i + 8]);
      // rotate-half: rot[j] = -x[j+32] for j < 32, x[j-32] for j >= 32
      x[i] = bf16_round(bf16_round(lo * co[i]) + bf16_round(-hi * s[i]));
      x[i + 8] = bf16_round(bf16_round(hi * co[i + 8]) + bf16_round(lo * s[i + 8]));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dst[8 * c + i] = x[i];
    dst[32 + 8 * c + i] = x[i + 8];
  }
}

__device__ __forceinline__ void mask_and_scale(int k0, int c, int qrow, int n_valid,
                                               int causal, float (&s)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = k0 + c + 4 * j;
    s[j] = (col >= n_valid || (causal && col > qrow)) ? -INFINITY : s[j] * 0.125f;  // 64^-1/2
  }
}

// Scores of this thread's query row (`sq`, in shared memory) against key
// columns c + 4j of the tile in `sk`, scaled and masked. The sixteen sums are
// independent, and each runs over the head dim in order.
__device__ __forceinline__ void tile_scores(const float* __restrict__ sq,
                                            const float* __restrict__ sk, int c,
                                            int k0, int qrow, int n_valid,
                                            int causal, float (&s)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int i = 0; i < kHeadDim; i += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(sq + i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(sk + (c + 4 * j) * kStride + i);
      s[j] = fmaf(qv.x, kv.x, s[j]);
      s[j] = fmaf(qv.y, kv.y, s[j]);
      s[j] = fmaf(qv.z, kv.z, s[j]);
      s[j] = fmaf(qv.w, kv.w, s[j]);
    }
  }
  mask_and_scale(k0, c, qrow, n_valid, causal, s);
}

}  // namespace
