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
// any R and C are taken. Backward: a grid of (column blocks of 2048, rows),
// 256 threads each handling 8 consecutive columns.
//
// Bound on an H100: both passes read t and s once (the backward also writes
// ds), so they are bound by bytes: at the iBOT shape (R=2048, C=65536, bf16)
// the forward moves 537 MB (0.16 ms) and the backward 805 MB (0.24 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ void store_value(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_bwd_kernel(const T* __restrict__ t, const T* __restrict__ s,
                    const float* __restrict__ center, const float* __restrict__ g,
                    const float* __restrict__ m_t, const float* __restrict__ z_t,
                    const float* __restrict__ m_s, const float* __restrict__ l_s,
                    T* __restrict__ ds, int C, float t_temp, float s_temp, int vec) {
  const int row = blockIdx.y;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (c0 >= C) return;
  const size_t off = static_cast<size_t>(row) * C + c0;
  const float gr = g[row], mt = m_t[row], zt = z_t[row], ms = m_s[row], ls = l_s[row];
  float tv[kVec], sv[kVec], cv[kVec];
  const int n = min(kVec, C - c0);
  if (vec) {
    load8(t + off, tv);
    load8(s + off, sv);
    load8(center + c0, cv);
  } else {
    for (int i = 0; i < n; ++i) {
      tv[i] = to_f(t[off + i]);
      sv[i] = to_f(s[off + i]);
      cv[i] = center[c0 + i];
    }
  }
  for (int i = 0; i < n; ++i) {
    const float tp = (tv[i] - cv[i]) / t_temp;
    const float sp = sv[i] / s_temp;
    const float p_t = expf(tp - mt) / zt;
    const float p_s = expf(sp - ms) / ls;
    store_value(ds + off + i, gr * (p_s - p_t) / s_temp);
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
  const dim3 grid((C + kThreads * kVec - 1) / (kThreads * kVec), R);
  fused_ce_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(t), static_cast<const T*>(s), static_cast<const float*>(center),
      static_cast<const float*>(g), static_cast<const float*>(m_t),
      static_cast<const float*>(z_t), static_cast<const float*>(m_s),
      static_cast<const float*>(l_s), static_cast<T*>(ds), C, t_temp, s_temp, C % kVec == 0);
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
