// Fused DINO/iBOT soft-target cross-entropy over wide prototype rows, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels vtp_tpu/ops/fused_ce.py::_fwd_kernel (run by
// _run_fwd, pallas_call at :173) and _bwd_kernel (run by _run_bwd,
// pallas_call at :215), the two halves of the custom VJP fused_ce_rows
// (:234). The plain PyTorch versions are fused_ce_fwd_reference and
// fused_ce_bwd_reference in vtp_tpu_torch/ops/fused_ce.py.
//
// Forward, per row of the teacher logits t and student logits s (R, C),
// bf16 or fp32, with an fp32 center (C,):
//   t' = (t - center) / T_t,  s' = s / T_s               (fp32)
//   m_t = max t',  z_t = sum exp(t' - m_t),  u = sum exp(t' - m_t) s'
//   m_s = max s',  l_s = sum exp(s' - m_s)
//   ce  = -u / z_t + m_s + log l_s
// and it saves (m_t, z_t, m_s, l_s) for the backward. Backward, elementwise:
//   ds = g_row * (exp(s' - m_s) / l_s - exp(t' - m_t) / z_t) / T_s,
// in s's dtype. The teacher and the center get no gradient.
//
// Design. Forward: one block of 256 threads per row. Threads stride over
// the row in chunks of 8 columns (one 16-byte load of bf16, two of fp32,
// when C % 8 == 0; scalar loads otherwise), keep online (max, sum) states
// for both softmaxes, and merge them with warp shuffles and then shared
// memory. The TPU kernel's gates (R % 8, C % 2048) become bounds checks, so
// any R and C are taken.
//
// Backward: a grid of as many blocks of 256 threads as the SMs hold at
// once (fewer when there is less work). The rows are cut into spans of
// 2 x 256 chunks of 8 columns (4096 columns), and each block walks one
// contiguous run of spans, so its consecutive spans share a row: the row's
// constants (m_t, m_s and (g / T_s) / z_t, (g / T_s) / l_s) are loaded and
// divided once a row, 1 / T_t and 1 / T_s once a thread, and no element
// takes an IEEE division. A thread issues both of a span's 16-byte loads of
// t and of s (and of the L2-resident center) before it computes, four
// 16-byte loads of t and s in flight a thread, ~48 KB an SM at three blocks
// an SM; each exponential is one exp2f of (x - m) log2(e), with
// x - m = (t - c) / T_t - m_t or s / T_s - m_s one fused multiply-add from
// the hoisted reciprocal; 8 outputs go as one 16-byte store (bf16; two
// for fp32). Rows whose length is no multiple of 8 (not 16-byte aligned)
// take one column at a time, a block a row, with the same arithmetic.
// Error: the plain version divides by T, by the sum and by T_s where the
// kernel multiplies by rounded reciprocals, and rounds x / T before it
// subtracts m; each is within a few fp32 ulps of p or of the exponent's
// argument, where p is large (the argument near 0), so ds stays within
// ~1e-6 of max|ref| in fp32 (chip_smoke.py's gate: 1e-5; bf16: 1e-2).
//
// Bound on an H100: both passes read t and s once (the backward also writes
// ds), so they are bound by bytes: at the iBOT shape (R=2048, C=65536, bf16)
// the forward moves 537 MB (0.16 ms) and the backward 805 MB (0.24 ms). The
// backward's two exponentials an element go to the SFU (16 a cycle an SM),
// ~0.08 ms at that shape, below the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// Online softmax state: max m, sum z of exp(x - m), and (teacher only) the
// weighted sum u of exp(x - m) * w.
struct Online {
  float m = -INFINITY, z = 0.f, u = 0.f;

  // Adds n values x[i] (weights w[i] for u).
  __device__ void add(const float* x, const float* w, int n) {
    float mx = m;
    for (int i = 0; i < n; ++i) mx = fmaxf(mx, x[i]);
    if (mx == -INFINITY) return;
    const float rescale = m == -INFINITY ? 0.f : expf(m - mx);
    float zs = 0.f, us = 0.f;
    for (int i = 0; i < n; ++i) {
      const float e = expf(x[i] - mx);
      zs += e;
      if (w != nullptr) us += e * w[i];
    }
    z = z * rescale + zs;
    u = u * rescale + us;
    m = mx;
  }

  __device__ void merge(float m2, float z2, float u2) {
    const float mx = fmaxf(m, m2);
    if (mx == -INFINITY) return;
    const float a = m == -INFINITY ? 0.f : expf(m - mx);
    const float b = m2 == -INFINITY ? 0.f : expf(m2 - mx);
    z = z * a + z2 * b;
    u = u * a + u2 * b;
    m = mx;
  }

  __device__ void warp_merge() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float z2 = __shfl_xor_sync(0xffffffffu, z, off);
      const float u2 = __shfl_xor_sync(0xffffffffu, u, off);
      merge(m2, z2, u2);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const T* __restrict__ t, const T* __restrict__ s,
                    const float* __restrict__ center, float* __restrict__ ce,
                    float* __restrict__ m_t, float* __restrict__ z_t,
                    float* __restrict__ m_s, float* __restrict__ l_s, int C,
                    float t_temp, float s_temp, int vec) {
  const int row = blockIdx.x;
  const T* tr = t + static_cast<size_t>(row) * C;
  const T* sr = s + static_cast<size_t>(row) * C;
  Online teacher, student;
  float tv[kVec], sv[kVec];
  if (vec) {
    for (int c0 = threadIdx.x * kVec; c0 < C; c0 += kThreads * kVec) {
      load8(tr + c0, tv);
      load8(sr + c0, sv);
      float cv[kVec];
      load8(center + c0, cv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        tv[i] = (tv[i] - cv[i]) / t_temp;
        sv[i] = sv[i] / s_temp;
      }
      teacher.add(tv, sv, kVec);
      student.add(sv, nullptr, kVec);
    }
  } else {
    for (int col = threadIdx.x; col < C; col += kThreads) {
      tv[0] = (to_f(tr[col]) - center[col]) / t_temp;
      sv[0] = to_f(sr[col]) / s_temp;
      teacher.add(tv, sv, 1);
      student.add(sv, nullptr, 1);
    }
  }
  teacher.warp_merge();
  student.warp_merge();

  __shared__ float part[2][3][kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][0][warp] = teacher.m; part[0][1][warp] = teacher.z; part[0][2][warp] = teacher.u;
    part[1][0][warp] = student.m; part[1][1][warp] = student.z; part[1][2][warp] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Online tt, ss;
    for (int w = 0; w < kThreads / 32; ++w) {
      tt.merge(part[0][0][w], part[0][1][w], part[0][2][w]);
      ss.merge(part[1][0][w], part[1][1][w], 0.f);
    }
    ce[row] = -(tt.u / tt.z) + ss.m + logf(ss.z);
    m_t[row] = tt.m;
    z_t[row] = tt.z;
    m_s[row] = ss.m;
    l_s[row] = ss.z;
  }
}

// The backward's row constants: the maxima, and g / T_s over each sum.
struct RowGrad {
  float m_t, m_s, a_t, a_s;  // a_t = (g / T_s) / z_t, a_s = (g / T_s) / l_s
};

__device__ __forceinline__ RowGrad row_grad(const float* __restrict__ g,
                                            const float* __restrict__ m_t,
                                            const float* __restrict__ z_t,
                                            const float* __restrict__ m_s,
                                            const float* __restrict__ l_s, int row,
                                            float inv_ts) {
  const float gs = g[row] * inv_ts;
  return {m_t[row], m_s[row], gs / z_t[row], gs / l_s[row]};
}

constexpr float kLog2e = 1.4426950408889634f;

// ds = (g / T_s) (exp(s' - m_s) / l_s - exp(t' - m_t) / z_t) of one element,
// t' - m_t = (t - c) / T_t - m_t and s' - m_s = s / T_s - m_s each one fused
// multiply-add (the reciprocals hoisted), each exponential an exp2f of its
// argument times log2(e).
__device__ __forceinline__ float ce_grad(float t, float s, float c, const RowGrad& k,
                                         float inv_tt, float inv_ts) {
  const float e_t = exp2f(fmaf(t - c, inv_tt, -k.m_t) * kLog2e);
  const float e_s = exp2f(fmaf(s, inv_ts, -k.m_s) * kLog2e);
  return fmaf(e_s, k.a_s, -(e_t * k.a_t));
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 raw;
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store_value(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The backward walks spans of kBwdGroups * kThreads chunks of 8 columns of
// one row; the grid (a few blocks an SM) splits the R * spans-per-row spans
// into contiguous runs, one a block, so a block's consecutive spans share a
// row and its constants. A thread loads its kBwdGroups chunks of t, s and
// the center before it computes any, so 2 x kBwdGroups 16-byte loads of t
// and s are in flight a thread.
constexpr int kBwdGroups = 2;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_bwd_kernel(const T* __restrict__ t, const T* __restrict__ s,
                    const float* __restrict__ center, const float* __restrict__ g,
                    const float* __restrict__ m_t, const float* __restrict__ z_t,
                    const float* __restrict__ m_s, const float* __restrict__ l_s,
                    T* __restrict__ ds, int R, int C, float t_temp, float s_temp) {
  const float inv_tt = 1.0f / t_temp, inv_ts = 1.0f / s_temp;
  if (C % kVec != 0) {
    // Rows not 16-byte aligned: one column at a time, a block a row.
    for (int row = blockIdx.x; row < R; row += gridDim.x) {
      const RowGrad k = row_grad(g, m_t, z_t, m_s, l_s, row, inv_ts);
      const size_t off = static_cast<size_t>(row) * C;
      for (int col = threadIdx.x; col < C; col += kThreads)
        store_value(ds + off + col, ce_grad(to_f(t[off + col]), to_f(s[off + col]), center[col],
                                            k, inv_tt, inv_ts));
    }
    return;
  }
  constexpr int kSpan = kBwdGroups * kThreads;  // chunks of 8 columns a span
  const int chunks = C / kVec;
  const int per_row = (chunks + kSpan - 1) / kSpan;
  const long long spans = static_cast<long long>(R) * per_row;
  const long long first = spans * blockIdx.x / gridDim.x;
  const long long last = spans * (blockIdx.x + 1) / gridDim.x;
  int row = static_cast<int>(first / per_row);
  int c0 = static_cast<int>(first - static_cast<long long>(row) * per_row) * kSpan;
  RowGrad k = row_grad(g, m_t, z_t, m_s, l_s, row, inv_ts);
  for (long long sp = first; sp < last; ++sp) {
    const size_t base = static_cast<size_t>(row) * C;
    float tv[kBwdGroups][kVec], sv[kBwdGroups][kVec], cv[kBwdGroups][kVec];
#pragma unroll
    for (int u = 0; u < kBwdGroups; ++u) {
      const int col = (c0 + u * kThreads + threadIdx.x) * kVec;
      if (col < C) {
        load8(t + base + col, tv[u]);
        load8(s + base + col, sv[u]);
        load8(center + col, cv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdGroups; ++u) {
      const int col = (c0 + u * kThreads + threadIdx.x) * kVec;
      if (col < C) {
        float d[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) d[i] = ce_grad(tv[u][i], sv[u][i], cv[u][i], k, inv_tt, inv_ts);
        store8(ds + base + col, d);
      }
    }
    c0 += kSpan;
    if (c0 >= chunks && sp + 1 < last) {
      ++row;
      c0 = 0;
      k = row_grad(g, m_t, z_t, m_s, l_s, row, inv_ts);
    }
  }
}

template <typename T>
int launch_fwd(const void* t, const void* s, const void* center, void* ce, void* m_t,
               void* z_t, void* m_s, void* l_s, int R, int C, float t_temp, float s_temp,
               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_fwd_kernel<T><<<R, kThreads, 0, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s), static_cast<const float*>(center),
      static_cast<float*>(ce), static_cast<float*>(m_t), static_cast<float*>(z_t),
      static_cast<float*>(m_s), static_cast<float*>(l_s), C, t_temp, s_temp, C % kVec == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* t, const void* s, const void* center, const void* g,
               const void* m_t, const void* z_t, const void* m_s, const void* l_s, void* ds,
               int R, int C, float t_temp, float s_temp, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_ce_bwd_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as the SMs hold at once, and no more than there are spans
  // (rows, with unaligned rows)
  const int span_cols = kBwdGroups * kThreads * kVec;
  const long long work =
      C % kVec ? R : static_cast<long long>(R) * ((C + span_cols - 1) / span_cols);
  const int blocks = static_cast<int>(std::min<long long>(work, static_cast<long long>(sms) * per_sm));
  fused_ce_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s), static_cast<const float*>(center),
      static_cast<const float*>(g), static_cast<const float*>(m_t),
      static_cast<const float*>(z_t), static_cast<const float*>(m_s),
      static_cast<const float*>(l_s), static_cast<T*>(ds), R, C, t_temp, s_temp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t, s: (R, C) contiguous, both bf16 or both fp32, 16-byte aligned; center:
// (C,) fp32; ce, m_t, z_t, m_s, l_s: (R,) fp32. Returns the cudaError_t of
// the launch.
extern "C" int vtp_fused_ce_fwd_bf16(const void* t, const void* s, const void* center, void* ce,
                                     void* m_t, void* z_t, void* m_s, void* l_s, int R, int C,
                                     float t_temp, float s_temp, int device,
                                     cudaStream_t stream) {
  return launch_fwd<__nv_bfloat16>(t, s, center, ce, m_t, z_t, m_s, l_s, R, C, t_temp, s_temp,
                                   device, stream);
}

extern "C" int vtp_fused_ce_fwd_f32(const void* t, const void* s, const void* center, void* ce,
                                    void* m_t, void* z_t, void* m_s, void* l_s, int R, int C,
                                    float t_temp, float s_temp, int device,
                                    cudaStream_t stream) {
  return launch_fwd<float>(t, s, center, ce, m_t, z_t, m_s, l_s, R, C, t_temp, s_temp, device,
                           stream);
}

// g: (R,) fp32 row cotangent; the saved stats as the forward wrote them; ds:
// (R, C) in the dtype of s.
extern "C" int vtp_fused_ce_bwd_bf16(const void* t, const void* s, const void* center,
                                     const void* g, const void* m_t, const void* z_t,
                                     const void* m_s, const void* l_s, void* ds, int R, int C,
                                     float t_temp, float s_temp, int device,
                                     cudaStream_t stream) {
  return launch_bwd<__nv_bfloat16>(t, s, center, g, m_t, z_t, m_s, l_s, ds, R, C, t_temp,
                                   s_temp, device, stream);
}

extern "C" int vtp_fused_ce_bwd_f32(const void* t, const void* s, const void* center,
                                    const void* g, const void* m_t, const void* z_t,
                                    const void* m_s, const void* l_s, void* ds, int R, int C,
                                    float t_temp, float s_temp, int device,
                                    cudaStream_t stream) {
  return launch_bwd<float>(t, s, center, g, m_t, z_t, m_s, l_s, ds, R, C, t_temp, s_temp,
                           device, stream);
}
