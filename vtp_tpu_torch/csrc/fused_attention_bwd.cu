// Backward of the fused qkv-split + qk-RMSNorm + RoPE + softmax attention for
// Hopper (sm_90a), bf16, head dim 64.
//
// Replaces the TPU kernel vtp_tpu/ops/flash_attention.py::_fused_bwd_kernel_call
// (pallas_call at :914), entered through the custom VJP _fused_with_vjp.bwd
// (:351), in both of its arms: without qk-norm (the VTP trunk, decoder and
// text tower) and with qk-norm (the DiT training path). The plain PyTorch
// versions are vtp_tpu_torch/ops/flash_attention.py::
// fused_qkv_rope_attention_bwd_reference and
// fused_qkv_rope_attention_qk_norm_bwd_reference.
//
// What it computes, per (batch b, head h), from the saved packed qkv
// (B, N, 3*H*64) and the output cotangent g (B, N, H*64):
//   q, k  = with qk-norm, bf16(bf16(x r) w) with r = rsqrt(mean(x^2) + 1e-5)
//           and the (64,) fp32 scales w, as the forward rounds them; then
//           RoPE(q), RoPE(k) recomputed as the forward rounds them;
//   p     = softmax(q.k * 64^-1/2) in fp32 (keys >= n_valid and, if causal,
//           keys past the query row masked);
//   dv    = bf16(p) ^T g                          (fp32 sums, bf16 out)
//   dp    = g v^T,  delta = rowsum(p * dp)        (fp32)
//   ds    = bf16(p * (dp - delta) * 64^-1/2)
//   dq~   = bf16(ds k),  dk~ = bf16(ds^T q)       (fp32 sums)
//   dq,dk = the RoPE adjoint of dq~, dk~: dx[j] = dx~[j] cos[j] + dx~[j+32]
//           sin[j+32] for j < 32 and dx~[j] cos[j] - dx~[j-32] sin[j-32]
//           above, in fp32, rounded once;
//   with qk-norm, the RMSNorm adjoint of each row, in fp32 from the rounded
//   dsc = dq (or dk): dn = dsc w, dx = r dn - x r^3 mean(dn x), rounded once,
//   and the scales' gradient dw = sum over rows of dsc (x r);
// and writes d(qkv) in the packed (B, N, 3*H*64) layout. These are the
// rounding points of the TPU kernel, whose block-diagonal mean dot also
// rounds the operands of mean(dn x) to bf16: here that mean is fp32.
//
// Design: two passes, deterministic, no atomics.
//   dq pass, one block per (query tile of 64, head, batch row): the Q and dO
//     tiles stay in shared memory; key tiles stream through. A first sweep
//     finds the row max m, the sum l of exp(s - m) and w = sum exp(s - m) dp
//     online, so delta = w / l; a second sweep forms ds into shared memory
//     and accumulates dq = ds k. It writes dq and the per-row (m, l, delta)
//     into an fp32 workspace of shape (3, B, H, N).
//   dk/dv pass, one block per (key tile of 64, head, batch row): the K and V
//     tiles stay in shared memory and in registers (four threads per key,
//     16 columns each); query tiles stream through with their saved row
//     statistics, and each query row adds its p and ds terms to the key's
//     dk and dv.
//   qk-norm: Q and K rows are normalised and scaled on load, with r a
//     four-lane shuffle, as in the forward. In each pass's epilogue a row's
//     four threads reload its raw input, recompute r, and apply the RoPE
//     adjoint and then the norm adjoint (mean(dn x) is again a four-lane
//     shuffle). Each block sums its rows' dw terms through shared memory in
//     a fixed order and writes one fp32 row of 64 into a workspace
//     (2, B, H, tiles, 64); the wrapper sums that workspace with torch, as
//     the JAX caller sums the TPU kernel's per-batch dw rows.
// Keys and rows are masked by bounds, so N needs no padding.
//
// Bound on an H100: at the trunk's global-crop shape (B=16, N=257, H=16) the
// function moves 7*B*N*H*64*2 bytes (qkv and g in, d(qkv) out: 58.9 MB,
// 17.6 us) and does 10*B*H*N^2*64 FLOP (scores recomputed, dv, dp, dq, dk:
// 10.8 GFLOP, 10.9 us at the bf16 tensor-core peak), so it is bound by
// bytes; the qk-norm arm at DiT-XL/1's shape (B=32, N=256, H=18) moves
// 132 MB (39.4 us) and does 24.2 GFLOP (24.4 us), also bound by bytes. This
// first version uses scalar fp32 FMAs from shared memory and recomputes the
// scores in both passes; tensor cores are later work.

#include "attention_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr size_t kSmemDq = 5 * kTile * kStride * sizeof(float);
constexpr size_t kSmemDkv = (4 * kTile * kStride + 3 * kTile) * sizeof(float);

// Sixteen unscaled dots of the row `sa` with rows c + 4j of the tile `sb`.
__device__ __forceinline__ void tile_dots(const float* __restrict__ sa,
                                          const float* __restrict__ sb, int c,
                                          float (&s)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int i = 0; i < kHeadDim; i += 4) {
    const float4 av = *reinterpret_cast<const float4*>(sa + i);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(sb + (c + 4 * j) * kStride + i);
      s[j] = fmaf(av.x, bv.x, s[j]);
      s[j] = fmaf(av.y, bv.y, s[j]);
      s[j] = fmaf(av.z, bv.z, s[j]);
      s[j] = fmaf(av.w, bv.w, s[j]);
    }
  }
}

// The accumulator layout of both passes: acc[4i + e] holds head-dim column
// 4c + 16i + e, so columns j and j+32 (acc[e], acc[8+e] and acc[4+e],
// acc[12+e]) sit in one thread. Rounds to bf16 and applies the RoPE adjoint
// when tables are given, in fp32, into x.
__device__ void grad_row(const float (&acc)[16], const bf16* __restrict__ sin_row,
                         const bf16* __restrict__ cos_row, bool rope, int c, float (&x)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = bf16_round(acc[i]);
  if (rope) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lo = 4 * c + 16 * i + e;  // < 32
        const int hi = lo + 32;
        const float xl = x[4 * i + e], xh = x[4 * (i + 2) + e];
        const float sl = __bfloat162float(sin_row[lo]), sh = __bfloat162float(sin_row[hi]);
        const float cl = __bfloat162float(cos_row[lo]), ch = __bfloat162float(cos_row[hi]);
        x[4 * i + e] = xl * cl + xh * sh;
        x[4 * (i + 2) + e] = xh * ch - xl * sl;
      }
    }
  }
}

// Stores the 16 columns of one row, in the accumulator layout, rounded to bf16.
__device__ __forceinline__ void store_row(const float (&x)[16], int c, bf16* __restrict__ dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[4 * c + 16 * i + e] = __float2bfloat16_rn(x[4 * i + e]);
  }
}

// The qk-RMSNorm adjoint of one row, in the accumulator layout, called by
// all four threads of the row (it shuffles among them). On entry dx holds
// the cotangent of the scaled, normed row after the RoPE adjoint; it is
// rounded to bf16 (dsc), then dx = r dn - x r^3 mean(dn x) with dn = dsc w,
// and dsc (x r) is added to dw. xrow is the row's raw Q or K input (not read
// when the row is out of range, which then adds nothing).
__device__ void norm_adjoint_row(float (&dx)[16], const bf16* __restrict__ xrow, bool in_range,
                                 const float* __restrict__ w, int c, float (&dw)[16]) {
  float x[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (in_range) {
      const uint2 raw = *reinterpret_cast<const uint2*>(xrow + 4 * c + 16 * i);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(v[0]);
      const float2 b = __bfloat1622float2(v[1]);
      x[4 * i] = a.x;
      x[4 * i + 1] = a.y;
      x[4 * i + 2] = b.x;
      x[4 * i + 3] = b.y;
    } else {
      x[4 * i] = x[4 * i + 1] = x[4 * i + 2] = x[4 * i + 3] = 0.f;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) ss += x[j] * x[j];
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float r = 1.0f / sqrtf(ss / kHeadDim + 1e-5f);
  float dn[16], t = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float dsc = in_range ? bf16_round(dx[j]) : 0.f;
    dn[j] = dsc * w[4 * c + 16 * (j >> 2) + (j & 3)];
    dw[j] = fmaf(dsc, x[j] * r, dw[j]);
    t = fmaf(dn[j], x[j], t);
  }
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  t *= 1.0f / kHeadDim;
  const float r3 = r * r * r;
#pragma unroll
  for (int j = 0; j < 16; ++j) dx[j] = r * dn[j] - x[j] * r3 * t;
}

// Sums the block's 64 rows of dw terms (this thread's 16 columns of row r, in
// the accumulator layout) through the shared tile s_dw, rows in order, and
// writes the block's row of 64 to dst. Called by every thread of the block
// after the shared tile is free.
__device__ void block_dw_row(const float (&dw)[16], float* __restrict__ s_dw, int r, int c,
                             float* __restrict__ dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s_dw[r * kStride + 4 * c + 16 * i + e] = dw[4 * i + e];
  }
  __syncthreads();
  if (threadIdx.x < kHeadDim) {
    float sum = 0.f;
    for (int row = 0; row < kTile; ++row) sum += s_dw[row * kStride + threadIdx.x];
    dst[threadIdx.x] = sum;
  }
}

// The workspace row of block (tile, h, b) for arm a (0: dw_q, 1: dw_k) in
// the (2, B, H, tiles, 64) dw workspace.
__device__ __forceinline__ float* dw_row(float* dws, int a) {
  const size_t at = ((static_cast<size_t>(a) * gridDim.z + blockIdx.z) * gridDim.y + blockIdx.y) *
                        gridDim.x + blockIdx.x;
  return dws + at * kHeadDim;
}

__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                        const bf16* __restrict__ sin_t, const bf16* __restrict__ cos_t,
                        const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                        bf16* __restrict__ dqkv, float* __restrict__ stats,
                        float* __restrict__ dws, int N, int H, int n_valid, int causal) {
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_g = s_q + kTile * kStride;
  float* s_k = s_g + kTile * kStride;
  float* s_v = s_k + kTile * kStride;
  float* s_ds = s_v + kTile * kStride;

  const int r = threadIdx.x >> 2;
  const int c = threadIdx.x & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * N * row_stride;
  const int qrow = q0 + r;
  const bool rope = sin_t != nullptr;
  auto sin_row = [&](int n) { return rope ? sin_t + static_cast<size_t>(n) * kHeadDim : nullptr; };
  auto cos_row = [&](int n) { return rope ? cos_t + static_cast<size_t>(n) * kHeadDim : nullptr; };

  const bf16* q_in = base + static_cast<size_t>(qrow) * row_stride + h * kHeadDim;
  load_row<bf16>(q_in, qrow < N, q_scale, sin_row(qrow), cos_row(qrow), s_q + r * kStride, c);
  load_row<bf16>(g + (static_cast<size_t>(b) * N + qrow) * D + h * kHeadDim, qrow < N,
                 nullptr, nullptr, nullptr, s_g + r * kStride, c);
  const float* q = s_q + r * kStride;
  const float* go = s_g + r * kStride;

  int n_kt = (n_valid + kTile - 1) / kTile;
  if (causal) {
    const int last_row = min(q0 + kTile, N) - 1;
    n_kt = min(n_kt, last_row / kTile + 1);
  }
  auto load_kv = [&](int k0) {
    const int n = k0 + r;
    const bf16* row = base + static_cast<size_t>(n) * row_stride + h * kHeadDim;
    load_row<bf16>(row + D, n < N, k_scale, sin_row(n), cos_row(n), s_k + r * kStride, c);
    load_row<bf16>(row + 2 * D, n < N, nullptr, nullptr, nullptr, s_v + r * kStride, c);
  };

  // Sweep 1: m, l = sum exp(s - m) and w = sum exp(s - m) dp, online.
  float m = -INFINITY, l = 0.f, w = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_kv(kt * kTile);
    __syncthreads();
    float s[16], dp[16];
    tile_scores(q, s_k, c, kt * kTile, qrow, n_valid, causal, s);
    tile_dots(go, s_v, c, dp);
    float mt = s[0];
#pragma unroll
    for (int j = 1; j < 16; ++j) mt = fmaxf(mt, s[j]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    if (m_new != -INFINITY) {
      float part = 0.f, wpart = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float e = expf(s[j] - m_new);
        part += e;
        wpart += e * dp[j];
      }
      const float rescale = m == -INFINITY ? 0.f : expf(m - m_new);
      l = l * rescale + part;
      w = w * rescale + wpart;
      m = m_new;
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  w += __shfl_xor_sync(0xffffffffu, w, 1);
  w += __shfl_xor_sync(0xffffffffu, w, 2);
  const float delta = w / l;

  // Sweep 2: ds into shared memory, dq += ds k.
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_kv(k0);
    __syncthreads();
    float s[16], dp[16];
    tile_scores(q, s_k, c, k0, qrow, n_valid, causal, s);
    tile_dots(go, s_v, c, dp);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m) / l;
      s_ds[r * kStride + c + 4 * j] = bf16_round(p * (dp[j] - delta) * 0.125f);
    }
    __syncthreads();
    const float* dsrow = s_ds + r * kStride;
    for (int kk = 0; kk < kTile; ++kk) {
      const float ds = dsrow[kk];
      const float* krow = s_k + kk * kStride;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + 4 * c + 16 * i);
        acc[4 * i] = fmaf(ds, kv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(ds, kv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(ds, kv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(ds, kv.w, acc[4 * i + 3]);
      }
    }
  }

  float dq[16], dw[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dq[i] = dw[i] = 0.f;
  if (qrow < N) grad_row(acc, sin_row(qrow), cos_row(qrow), rope, c, dq);
  if (q_scale != nullptr) norm_adjoint_row(dq, q_in, qrow < N, q_scale, c, dw);
  if (qrow < N) {
    store_row(dq, c, dqkv + (static_cast<size_t>(b) * N + qrow) * row_stride + h * kHeadDim);
    if (c == 0) {
      const size_t bhn = static_cast<size_t>(gridDim.z) * H * N;
      const size_t at = (static_cast<size_t>(b) * H + h) * N + qrow;
      stats[at] = m;
      stats[bhn + at] = l;
      stats[2 * bhn + at] = delta;
    }
  }
  if (q_scale != nullptr) {
    __syncthreads();  // the last key tile's ds rows are read no more
    block_dw_row(dw, s_ds, r, c, dw_row(dws, 0));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                         const bf16* __restrict__ sin_t, const bf16* __restrict__ cos_t,
                         const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                         const float* __restrict__ stats, bf16* __restrict__ dqkv,
                         float* __restrict__ dws, int N, int H, int n_valid, int causal) {
  extern __shared__ float4 smem4[];
  float* s_k = reinterpret_cast<float*>(smem4);
  float* s_v = s_k + kTile * kStride;
  float* s_q = s_v + kTile * kStride;
  float* s_g = s_q + kTile * kStride;
  float* s_m = s_g + kTile * kStride;
  float* s_l = s_m + kTile;
  float* s_d = s_l + kTile;

  const int r = threadIdx.x >> 2;
  const int c = threadIdx.x & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * N * row_stride;
  const int key = k0 + r;
  const bool rope = sin_t != nullptr;
  auto sin_row = [&](int n) { return rope ? sin_t + static_cast<size_t>(n) * kHeadDim : nullptr; };
  auto cos_row = [&](int n) { return rope ? cos_t + static_cast<size_t>(n) * kHeadDim : nullptr; };
  const size_t bhn = static_cast<size_t>(gridDim.z) * H * N;
  const size_t stat0 = (static_cast<size_t>(b) * H + h) * N;

  const bf16* k_in = base + static_cast<size_t>(key) * row_stride + D + h * kHeadDim;
  load_row<bf16>(k_in, key < N, k_scale, sin_row(key), cos_row(key), s_k + r * kStride, c);
  load_row<bf16>(k_in + D, key < N, nullptr, nullptr, nullptr, s_v + r * kStride, c);
  __syncthreads();
  // This thread's 16 columns of its key's k and v, in the accumulator layout.
  float kreg[16], vreg[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kreg[4 * i + e] = s_k[r * kStride + 4 * c + 16 * i + e];
      vreg[4 * i + e] = s_v[r * kStride + 4 * c + 16 * i + e];
    }
  }
  const bool key_masked = key >= n_valid;  // n_valid <= N also masks key >= N

  float dk[16], dv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dk[i] = dv[i] = 0.f;

  const int n_qt = (N + kTile - 1) / kTile;
  const int qt0 = causal ? k0 / kTile : 0;
  for (int qt = (k0 < n_valid ? qt0 : n_qt); qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    const int n = q0 + r;
    __syncthreads();
    {
      const bf16* row = base + static_cast<size_t>(n) * row_stride + h * kHeadDim;
      load_row<bf16>(row, n < N, q_scale, sin_row(n), cos_row(n), s_q + r * kStride, c);
      load_row<bf16>(g + (static_cast<size_t>(b) * N + n) * D + h * kHeadDim, n < N, nullptr,
                     nullptr, nullptr, s_g + r * kStride, c);
      if (c == 0) {
        s_m[r] = n < N ? stats[stat0 + n] : 0.f;
        s_l[r] = n < N ? stats[bhn + stat0 + n] : 1.f;
        s_d[r] = n < N ? stats[2 * bhn + stat0 + n] : 0.f;
      }
    }
    __syncthreads();
    const int rows = min(kTile, N - q0);
    for (int i = 0; i < rows; ++i) {
      const int qi = q0 + i;
      const float* qv = s_q + i * kStride;
      const float* gv = s_g + i * kStride;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 a = *reinterpret_cast<const float4*>(qv + 4 * c + 16 * x);
        const float4 o = *reinterpret_cast<const float4*>(gv + 4 * c + 16 * x);
        s = fmaf(a.x, kreg[4 * x], s);
        s = fmaf(a.y, kreg[4 * x + 1], s);
        s = fmaf(a.z, kreg[4 * x + 2], s);
        s = fmaf(a.w, kreg[4 * x + 3], s);
        dp = fmaf(o.x, vreg[4 * x], dp);
        dp = fmaf(o.y, vreg[4 * x + 1], dp);
        dp = fmaf(o.z, vreg[4 * x + 2], dp);
        dp = fmaf(o.w, vreg[4 * x + 3], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const bool masked = key_masked || (causal && key > qi);
      const float p = masked ? 0.f : expf(s * 0.125f - s_m[i]) / s_l[i];
      const float p_lo = bf16_round(p);
      const float ds = bf16_round(p * (dp - s_d[i]) * 0.125f);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 a = *reinterpret_cast<const float4*>(qv + 4 * c + 16 * x);
        const float4 o = *reinterpret_cast<const float4*>(gv + 4 * c + 16 * x);
        dk[4 * x] = fmaf(ds, a.x, dk[4 * x]);
        dk[4 * x + 1] = fmaf(ds, a.y, dk[4 * x + 1]);
        dk[4 * x + 2] = fmaf(ds, a.z, dk[4 * x + 2]);
        dk[4 * x + 3] = fmaf(ds, a.w, dk[4 * x + 3]);
        dv[4 * x] = fmaf(p_lo, o.x, dv[4 * x]);
        dv[4 * x + 1] = fmaf(p_lo, o.y, dv[4 * x + 1]);
        dv[4 * x + 2] = fmaf(p_lo, o.z, dv[4 * x + 2]);
        dv[4 * x + 3] = fmaf(p_lo, o.w, dv[4 * x + 3]);
      }
    }
  }

  float dkx[16], dw[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dkx[i] = dw[i] = 0.f;
  if (key < N) grad_row(dk, sin_row(key), cos_row(key), rope, c, dkx);
  if (k_scale != nullptr) norm_adjoint_row(dkx, k_in, key < N, k_scale, c, dw);
  if (key < N) {
    bf16* row = dqkv + (static_cast<size_t>(b) * N + key) * row_stride + h * kHeadDim;
    store_row(dkx, c, row + D);
    grad_row(dv, nullptr, nullptr, false, c, dkx);
    store_row(dkx, c, row + 2 * D);
  }
  if (k_scale != nullptr) {
    __syncthreads();  // the last query tile is read no more
    block_dw_row(dw, s_q, r, c, dw_row(dws, 1));
  }
}

int launch_bwd(const void* qkv, const void* g, const void* sin_t, const void* cos_t,
               const void* q_scale, const void* k_scale, void* stats, void* dws, void* dqkv,
               int B, int N, int H, int n_valid, int causal, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemDq));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemDkv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* go = static_cast<const bf16*>(g);
  const bf16* s = static_cast<const bf16*>(sin_t);
  const bf16* co = static_cast<const bf16*>(cos_t);
  const float* qs = static_cast<const float*>(q_scale);
  const float* ks = static_cast<const float*>(k_scale);
  attention_bwd_dq_kernel<<<grid, kThreads, kSmemDq, stream>>>(
      q, go, s, co, qs, ks, static_cast<bf16*>(dqkv), static_cast<float*>(stats),
      static_cast<float*>(dws), N, H, n_valid, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<<<grid, kThreads, kSmemDkv, stream>>>(
      q, go, s, co, qs, ks, static_cast<const float*>(stats), static_cast<bf16*>(dqkv),
      static_cast<float*>(dws), N, H, n_valid, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, N, 3*H*64) bf16 contiguous, the forward's input; g: (B, N, H*64)
// bf16 contiguous; sin/cos: (N, 64) bf16 or null; stats: (3, B, H, N) fp32
// scratch; dqkv: (B, N, 3*H*64) bf16, fully written; 1 <= n_valid <= N.
// Launches the dq pass, then the dk/dv pass, on `stream`. Returns the
// cudaError_t of the launches.
extern "C" int vtp_fused_qkv_rope_attention_bwd_bf16(
    const void* qkv, const void* g, const void* sin_t, const void* cos_t, void* stats,
    void* dqkv, int B, int N, int H, int n_valid, int causal, int device,
    cudaStream_t stream) {
  return launch_bwd(qkv, g, sin_t, cos_t, nullptr, nullptr, stats, nullptr, dqkv, B, N, H,
                    n_valid, causal, device, stream);
}

// The qk-norm arm: as above, plus q_scale/k_scale, (64,) fp32, and dws, the
// (2, B, H, ceil(N/64), 64) fp32 workspace of per-block dw_q (0) and dw_k (1)
// rows, fully written.
extern "C" int vtp_fused_qkv_rope_attention_qk_norm_bwd_bf16(
    const void* qkv, const void* g, const void* sin_t, const void* cos_t, const void* q_scale,
    const void* k_scale, void* stats, void* dws, void* dqkv, int B, int N, int H, int n_valid,
    int causal, int device, cudaStream_t stream) {
  if (q_scale == nullptr || k_scale == nullptr || dws == nullptr) return 1;  // cudaErrorInvalidValue
  return launch_bwd(qkv, g, sin_t, cos_t, q_scale, k_scale, stats, dws, dqkv, B, N, H, n_valid,
                    causal, device, stream);
}
