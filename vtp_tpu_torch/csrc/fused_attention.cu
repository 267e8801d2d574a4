// Fused qkv-split + qk-RMSNorm + RoPE + softmax attention for Hopper (sm_90a).
//
// Replaces the TPU kernel vtp_tpu/ops/flash_attention.py::_fused_kernel_call
// (pallas_call at :617), entered through fused_qkv_rope_attention (:398).
// Its plain PyTorch version is
// vtp_tpu_torch/ops/flash_attention.py::fused_qkv_rope_attention_reference.
//
// What it computes, per (batch b, head h), from the packed qkv GEMM output
// (B, N, 3*H*64) laid out [Q | K | V], head h at columns h*64 of each third:
//   q, k = optional RMSNorm over the head dim (eps 1e-5, (64,) fp32 scales),
//          rounded to the input dtype after the normalisation and again after
//          the scale;
//   q, k = optional RoPE rotate-half: inputs rounded to bf16, then
//          bf16(bf16(x*cos) + bf16(rot(x)*sin)), every product and the sum
//          rounded to bf16 as the reference's eager bf16 arithmetic does;
//   s    = q.k * 64^-1/2 in fp32; key columns >= n_valid masked; optional
//          causal mask (column > row);
//   p    = exp(s - max) / sum in fp32, rounded to the value dtype;
//   out  = p.v accumulated in fp32, rounded to the output dtype (B, N, H*64).
// Three arms: bf16 in/out (fp32 scores and softmax); exact fp32 with plain
// fp32 FMAs (no TF32, no tensor cores); and fp32 bf16x3 (the TPU kernel's
// dot_mode "bf16_3x", :466-475 and mxu_dot :516-526, which backs the JAX
// package's decode_precision="high"): every fp32 operand of the two dots,
// q and k, then p and v, is split into bf16 halves hi + lo, and each
// product is hi*hi + hi*lo + lo*hi summed in fp32 (the lo*lo term is
// dropped); the qk-RMSNorm's mean of squares sums the split halves of each
// square, as the TPU kernel's statistics dot does; p stays fp32.
//
// Design. One block per (query tile of 64 rows, head, batch row); 256
// threads, four per row, each owning 16 of the row's 64 head-dim columns
// (the pairs j and j+32, so rotate-half stays inside the thread). The block
// reads Q, K and V straight from the packed input, so no split copy exists.
// The Q tile is normalised and roped once into shared memory; each key
// tile of 64 is normalised and roped on load into shared memory too. Each
// thread keeps 16 scores in flight, one per key column it owns. Softmax
// takes two passes over the key tiles: the first finds the row max and the
// fp32 sum of exp(s - max), the second forms p, rounds it to the value dtype
// as the reference does and accumulates p.v. Keys are masked by bounds, so N needs
// no padding and has no cap. The lane roll with sign-folded sin tables and
// the block-diagonal statistics matrix of the TPU kernel were workarounds for
// its vector unit: here rotate-half is an index and the RMS is a reduction
// over four lanes.
//
// Bound on an H100: at the VTP-L shapes (B=8, N=257, H=16) the bf16 arm
// moves 16.8 MB and does 2.2 GFLOP (bytes-bound, 5 us); the fp32 arm moves
// 33.6 MB and does 2.15 GFLOP of fp32 FMAs (operations-bound at the 67
// TFLOP/s non-tensor rate, 32 us). The bf16x3 arm at the decode's shape
// (B=8, N=256) moves the same 33.6 MB and does 3 x 2.15 GFLOP, which at the
// bf16 tensor-core rate it was defined for is 6.5 us: bytes-bound, 10 us.
// This first version computes the scores twice and uses scalar FMAs from
// shared memory (the bf16x3 arm three per product, on CUDA cores); wgmma on
// the bf16 halves and TMA are later work.
//
// The bf16x3 arm keeps each split row as two fp32 rows (hi, lo) in shared
// memory. To stay at two blocks an SM it holds five tiles, not seven: in
// its second pass V's halves are loaded into K's buffers once a tile's
// scores are taken.

#include "attention_common.cuh"

namespace {

// Shared memory: Q, K, V and P tiles; the bf16x3 arm holds Q, K (then V),
// P and the lo halves of Q and of K (then V).
template <bool kSplit>
constexpr size_t smem_bytes() {
  return (kSplit ? 5 : 4) * kTile * kStride * sizeof(float);
}

template <typename T, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2)
fused_qkv_rope_attention_kernel(const T* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ sin_t,
                                const __nv_bfloat16* __restrict__ cos_t,
                                const float* __restrict__ q_scale,
                                const float* __restrict__ k_scale,
                                T* __restrict__ out, int N, int H, int n_valid,
                                int causal) {
  static_assert(!kSplit || sizeof(T) == sizeof(float), "the bf16x3 arm takes fp32");
  constexpr int kT = kTile * kStride;
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_k = s_q + kT;
  float* s_p = s_k + kT;
  float* s_v = kSplit ? s_k : s_p + kT;        // the bf16x3 arm loads V over K
  float* s_q_lo = kSplit ? s_p + kT : nullptr;
  float* s_k_lo = kSplit ? s_p + 2 * kT : nullptr;
  float* s_v_lo = s_k_lo;

  const int r = threadIdx.x >> 2;  // row within the tile
  const int c = threadIdx.x & 3;   // quarter of the row
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const T* base = qkv + static_cast<size_t>(b) * N * row_stride;
  const int qrow = q0 + r;

  auto tables = [&](int n, const __nv_bfloat16*& sr, const __nv_bfloat16*& cr) {
    sr = sin_t == nullptr ? nullptr : sin_t + static_cast<size_t>(n) * kHeadDim;
    cr = cos_t == nullptr ? nullptr : cos_t + static_cast<size_t>(n) * kHeadDim;
  };
  auto lo_row = [&](float* buf) { return kSplit ? buf + r * kStride : nullptr; };

  // Q tile: prologue into shared memory, where it stays.
  {
    const __nv_bfloat16 *sr, *cr;
    tables(qrow, sr, cr);
    load_row<T, kSplit>(base + static_cast<size_t>(qrow) * row_stride + h * kHeadDim,
                        qrow < N, q_scale, sr, cr, s_q + r * kStride, c, lo_row(s_q_lo));
  }
  const float* q = s_q + r * kStride;
  const float* q_lo = kSplit ? s_q_lo + r * kStride : nullptr;

  // Key tiles that hold any unmasked column for this block's rows.
  int n_kt = (n_valid + kTile - 1) / kTile;
  if (causal) {
    const int last_row = min(q0 + kTile, N) - 1;
    n_kt = min(n_kt, last_row / kTile + 1);
  }

  auto load_k = [&](int k0) {
    const int n = k0 + r;
    const __nv_bfloat16 *sr, *cr;
    tables(n, sr, cr);
    load_row<T, kSplit>(base + static_cast<size_t>(n) * row_stride + D + h * kHeadDim,
                        n < N, k_scale, sr, cr, s_k + r * kStride, c, lo_row(s_k_lo));
  };
  auto load_v = [&](int k0) {
    const int n = k0 + r;
    load_row<T, kSplit>(base + static_cast<size_t>(n) * row_stride + 2 * D + h * kHeadDim,
                        n < N, nullptr, nullptr, nullptr, s_v + r * kStride, c,
                        lo_row(s_v_lo));
  };
  auto scores = [&](int k0, float (&s)[16]) {
    if constexpr (kSplit) {
      tile_scores_split(q, q_lo, s_k, s_k_lo, c, k0, qrow, n_valid, causal, s);
    } else {
      tile_scores(q, s_k, c, k0, qrow, n_valid, causal, s);
    }
  };

  // Pass 1: row max and the fp32 sum of exp(s - max).
  float m = -INFINITY, l = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_k(kt * kTile);
    __syncthreads();
    float s[16];
    scores(kt * kTile, s);
    float mt = s[0];
#pragma unroll
    for (int j = 1; j < 16; ++j) mt = fmaxf(mt, s[j]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    if (m_new != -INFINITY) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) part += expf(s[j] - m_new);
      l = (m == -INFINITY ? 0.f : l * expf(m - m_new)) + part;
      m = m_new;
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // Pass 2: p = exp(s - max) / sum, rounded to the value dtype; out += p.v.
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_k(k0);
    if constexpr (!kSplit) load_v(k0);
    __syncthreads();
    float s[16];
    scores(k0, s);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : Io<T>::round(expf(s[j] - m) / l);
      s_p[r * kStride + c + 4 * j] = p;
    }
    if constexpr (kSplit) {
      __syncthreads();  // every thread's scores are taken: V may overwrite K
      load_v(k0);
    }
    __syncthreads();
    const float* prow = s_p + r * kStride;
    for (int kk = 0; kk < kTile; ++kk) {
      const float* vrow = s_v + kk * kStride;
      if constexpr (kSplit) {
        float ph, pl;
        split_bf16(prow[kk], ph, pl);
        const float* vrow_lo = s_v_lo + kk * kStride;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 vh = *reinterpret_cast<const float4*>(vrow + 4 * c + 16 * i);
          const float4 vl = *reinterpret_cast<const float4*>(vrow_lo + 4 * c + 16 * i);
          acc[4 * i] = fmaf(ph, vh.x, fmaf(ph, vl.x, fmaf(pl, vh.x, acc[4 * i])));
          acc[4 * i + 1] = fmaf(ph, vh.y, fmaf(ph, vl.y, fmaf(pl, vh.y, acc[4 * i + 1])));
          acc[4 * i + 2] = fmaf(ph, vh.z, fmaf(ph, vl.z, fmaf(pl, vh.z, acc[4 * i + 2])));
          acc[4 * i + 3] = fmaf(ph, vh.w, fmaf(ph, vl.w, fmaf(pl, vh.w, acc[4 * i + 3])));
        }
      } else {
        const float p = prow[kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(vrow + 4 * c + 16 * i);
          acc[4 * i] = fmaf(p, v.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(p, v.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, v.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, v.w, acc[4 * i + 3]);
        }
      }
    }
  }

  if (qrow < N) {
    T* orow = out + (static_cast<size_t>(b) * N + qrow) * D + h * kHeadDim;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[4 * c + 16 * i + e] = Io<T>::store_value(acc[4 * i + e]);
    }
  }
}

template <typename T, bool kSplit = false>
int launch(const void* qkv, const void* sin_t, const void* cos_t,
           const void* q_scale, const void* k_scale, void* out, int B, int N,
           int H, int n_valid, int causal, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t kSmemBytes = smem_bytes<kSplit>();
  err = cudaFuncSetAttribute(fused_qkv_rope_attention_kernel<T, kSplit>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_qkv_rope_attention_kernel<T, kSplit><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const __nv_bfloat16*>(sin_t),
      static_cast<const __nv_bfloat16*>(cos_t),
      static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<T*>(out), N, H, n_valid, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, N, 3*H*64) contiguous, bf16 or fp32; sin/cos: (N, 64) bf16 or
// null; q_scale/k_scale: (64,) fp32 or null; out: (B, N, H*64), the dtype of
// qkv; 1 <= n_valid <= N. Returns the cudaError_t of the launch.
extern "C" int vtp_fused_qkv_rope_attention_bf16(
    const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
    const void* k_scale, void* out, int B, int N, int H, int n_valid,
    int causal, int device, cudaStream_t stream) {
  return launch<__nv_bfloat16>(qkv, sin_t, cos_t, q_scale, k_scale, out, B, N,
                               H, n_valid, causal, device, stream);
}

extern "C" int vtp_fused_qkv_rope_attention_f32(
    const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
    const void* k_scale, void* out, int B, int N, int H, int n_valid,
    int causal, int device, cudaStream_t stream) {
  return launch<float>(qkv, sin_t, cos_t, q_scale, k_scale, out, B, N, H,
                       n_valid, causal, device, stream);
}

// The fp32 bf16x3 arm: the same arguments as the fp32 arm.
extern "C" int vtp_fused_qkv_rope_attention_f32_bf16x3(
    const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
    const void* k_scale, void* out, int B, int N, int H, int n_valid,
    int causal, int device, cudaStream_t stream) {
  return launch<float, true>(qkv, sin_t, cos_t, q_scale, k_scale, out, B, N,
                             H, n_valid, causal, device, stream);
}
