// Pieces of the attention kernels for Hopper (sm_90a): the tile geometry
// and bf16 rounding, used by all of them (the tensor-core kernels add
// tensor_core.cuh), and the bf16x3 split.
//
// The backward's epilogues (fused_attention_bwd.cu) stage fp32 tiles of 64
// token rows in shared memory, kStride floats a row, four threads a row;
// the fused forward's fp32 arms keep their tiles at the same row stride.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;             // query rows per block, key rows per tile
constexpr int kStride = kHeadDim + 4; // padded fp32 row in shared memory, float4-aligned

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

}  // namespace
