// Non-causal, unmasked softmax attention over separate strided q, k and v,
// with no prologue, for Hopper (sm_90a).
//
// Replaces two TPU kernels of vtp_tpu/ops/flash_attention.py, one C entry
// point each:
//   vtp_flash_attention_bnhd_bf16: _flash_bnhd_impl (:953, pallas_call :992),
//     entered through flash_attention_bnhd (:1024): q, k, v (B, N, H, d),
//     output (B, N, H*d). The head-major VTP trunk's attention.
//   vtp_flash_attention_bhnd_bf16: flash_attention (:1081) with _attn_kernel
//     (:179, pallas_call :1114): q, k, v (B, H, N, d), output (B, H, N, d).
//     The non-causal CLIP text tower's attention, through ops/attention.sdpa.
// Their plain PyTorch versions are flash_attention_bnhd_reference and
// flash_attention_reference in vtp_tpu_torch/ops/flash_attention.py.
//
// What it computes, per (batch b, head h), as both TPU kernels do:
//   s   = q.k * d^-1/2, fp32 products of the bf16 inputs summed in fp32;
//   p   = exp(s - row max) / (fp32 sum of exp), rounded to bf16;
//   out = p.v accumulated in fp32, rounded to bf16.
// No RoPE, no qk-norm, no causal mask, no n_valid. Keys past N are masked
// by bounds, so N needs no padding (the TPU flash_attention pads N to a
// multiple of 128 and masks the pad).
//
// Inputs. Each of q, k and v has its own (batch, token, head) strides in
// elements and a contiguous head dim; a row must start 16-byte aligned
// (the wrapper checks, and copies an input that is not). The text path
// passes the permuted views of its packed qkv GEMM output with no copy.
//
// Design: the fused kernel's bf16 arm without its prologue, templated on the
// head dim (32, 64, 128). One block per (query tile of 64 rows, head, batch
// row); 256 threads, four per row. A thread loads a quarter of a row's head
// dim, computes 16 scores per key tile (the key columns c + 4j) over the
// whole head dim from shared memory, and accumulates the output columns
// 4c + 16i + e. Softmax takes two passes over the key tiles: the first finds
// the row max and the fp32 sum of exp(s - max), the second forms p, rounds it
// to bf16 and accumulates p.v.
//
// Bound on an H100: at the head-major trunk's shape (B=8, N=257, H=16, d=64)
// the call moves 16.8 MB and does 2.16 GFLOP; at the text tower's
// (B=32, H=12, N=77, d=64), 15.1 MB and 0.58 GFLOP. Both are bytes-bound
// (5 us and 4.5 us at 3.35 TB/s). This first version computes the scores
// twice with scalar FMAs from shared memory on CUDA cores; mma/wgmma with an
// online softmax and TMA loads are later work.

#include "attention_common.cuh"

namespace {

constexpr int kPStride = kTile + 4;  // padded row of the probability tile

struct Strides {
  long long b, n, h;
};

// Shared memory: the Q, K and V tiles (fp32 rows of d + 4) and the P tile.
template <int D>
constexpr size_t flash_smem_bytes() {
  return (3 * kTile * (D + 4) + kTile * kPStride) * sizeof(float);
}

// Loads one token row of one head into `dst`, a padded shared-memory row:
// thread quarter c loads the columns [c*D/4, (c+1)*D/4), eight at a time.
// Rows at or past N load as zeros.
template <int D>
__device__ __forceinline__ void load_plain_row(const __nv_bfloat16* __restrict__ row,
                                               bool in_range, float* __restrict__ dst,
                                               int c) {
  constexpr int kPer = D / 4;
#pragma unroll
  for (int g = 0; g < kPer / 8; ++g) {
    const int col = c * kPer + 8 * g;
    float x[8];
    if (in_range) {
      Io<__nv_bfloat16>::load8(row + col, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
    *reinterpret_cast<float4*>(dst + col) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(dst + col + 4) = make_float4(x[4], x[5], x[6], x[7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int N, Strides sq,
                       Strides sk, Strides sv, Strides so, float scale) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kS = D + 4;
  constexpr int kT = kTile * kS;
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_k = s_q + kT;
  float* s_v = s_k + kT;
  float* s_p = s_v + kT;

  const int r = threadIdx.x >> 2;  // row within the tile
  const int c = threadIdx.x & 3;   // quarter of the row
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qrow = q0 + r;
  auto row_of = [&](const __nv_bfloat16* base, const Strides& s, int n) {
    return base + b * s.b + static_cast<long long>(n) * s.n + h * s.h;
  };

  load_plain_row<D>(row_of(q, sq, qrow), qrow < N, s_q + r * kS, c);
  const float* qr = s_q + r * kS;
  const int n_kt = (N + kTile - 1) / kTile;

  auto load_k = [&](int k0) {
    load_plain_row<D>(row_of(k, sk, k0 + r), k0 + r < N, s_k + r * kS, c);
  };
  auto load_v = [&](int k0) {
    load_plain_row<D>(row_of(v, sv, k0 + r), k0 + r < N, s_v + r * kS, c);
  };
  // Scores of this thread's query row against key columns k0 + c + 4j; the
  // sixteen sums are independent, each over the head dim in order.
  auto scores = [&](int k0, float (&s)[16]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int i = 0; i < D; i += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + i);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(s_k + (c + 4 * j) * kS + i);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = (k0 + c + 4 * j < N) ? s[j] * scale : -INFINITY;
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

  // Pass 2: p = exp(s - max) / sum, rounded to bf16; out += p.v.
  constexpr int kAcc = D / 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_k(k0);
    load_v(k0);
    __syncthreads();
    float s[16];
    scores(k0, s);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s_p[r * kPStride + c + 4 * j] = s[j] == -INFINITY ? 0.f : bf16_round(expf(s[j] - m) / l);
    }
    __syncthreads();
    const float* prow = s_p + r * kPStride;
    for (int kk = 0; kk < kTile; ++kk) {
      const float p = prow[kk];
      const float* vrow = s_v + kk * kS;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * c + 16 * i);
        acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (qrow < N) {
    __nv_bfloat16* orow = out + b * so.b + static_cast<long long>(qrow) * so.n + h * so.h;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[4 * c + 16 * i + e] = __float2bfloat16_rn(acc[4 * i + e]);
    }
  }
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* out, int B, int N, int H,
                 Strides sq, Strides sk, Strides sv, Strides so, float scale,
                 cudaStream_t stream) {
  constexpr size_t kSmemBytes = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  flash_attention_kernel<D><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), N, sq, sk,
      sv, so, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B, int N, int H,
             int d, Strides sq, Strides sk, Strides sv, Strides so, float scale, int device,
             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (d) {
    case 32: return launch_flash<32>(q, k, v, out, B, N, H, sq, sk, sv, so, scale, stream);
    case 64: return launch_flash<64>(q, k, v, out, B, N, H, sq, sk, sv, so, scale, stream);
    case 128: return launch_flash<128>(q, k, v, out, B, N, H, sq, sk, sv, so, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: bf16, logical (B, N, H, d), each with the given (batch, token,
// head) strides in elements and a contiguous head dim, every row 16-byte
// aligned; out: (B, N, H*d) contiguous bf16; d in {32, 64, 128}; scale
// d^-1/2. Returns the cudaError_t of the launch.
extern "C" int vtp_flash_attention_bnhd_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int N, int H, int d,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, float scale,
    int device, cudaStream_t stream) {
  const long long hd = static_cast<long long>(H) * d;
  return dispatch(q, k, v, out, B, N, H, d, {q_sb, q_sn, q_sh}, {k_sb, k_sn, k_sh},
                  {v_sb, v_sn, v_sh}, {N * hd, hd, d}, scale, device, stream);
}

// The same arguments, the inputs' logical order (B, H, N, d) given by the
// same (batch, token, head) strides; out: (B, H, N, d) contiguous bf16.
extern "C" int vtp_flash_attention_bhnd_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int N, int H, int d,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, float scale,
    int device, cudaStream_t stream) {
  const long long nd = static_cast<long long>(N) * d;
  return dispatch(q, k, v, out, B, N, H, d, {q_sb, q_sn, q_sh}, {k_sb, k_sn, k_sh},
                  {v_sb, v_sn, v_sh}, {H * nd, d, nd}, scale, device, stream);
}
