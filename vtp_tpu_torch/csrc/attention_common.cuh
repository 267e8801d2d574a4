// Pieces of the attention kernels for Hopper (sm_90a): the tile geometry
// and bf16 rounding, used by all of them (the tensor-core kernels add
// tensor_core.cuh), and the bf16x3 split.
//
// Every kernel is a template on the head dim D (32, 64 or 128). The
// backward's epilogues (fused_attention_bwd.cu) stage fp32 tiles of 64
// token rows in shared memory, kStrideOf<D> floats a row, four threads a
// row; the fused forward's fp32 arms keep their tiles at the same row
// stride.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // query rows per block, key rows per tile
// Padded fp32 row of head dim D in shared memory: 36, 68 or 132 floats,
// odd multiples of 16 bytes, so eight rows read at once fall in eight
// distinct groups of four banks.
template <int D>
constexpr int kStrideOf = D + 4;
// The softmax scale D^-1/2, as the plain version's fp32 constant.
template <int D>
constexpr float kScaleOf = D == 32 ? 0.17677669529663688f
                                   : (D == 64 ? 0.125f : 0.08838834764831845f);

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
