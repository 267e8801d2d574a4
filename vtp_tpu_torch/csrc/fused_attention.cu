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
// Design of the bf16 arm (tensor cores). One block per (query tile of 64
// rows, head, batch row): four warps, warp w owning query rows [16w, 16w+16).
// Q, K and V are read straight from the packed input, so no split copy
// exists. Every tile is bf16 in shared memory (rows padded to 72). Tiles are
// copied raw with cp.async; the Q tile and each K tile are then normalised
// and roped in place (prologue_tile, tensor_core.cuh: two threads a row,
// load_row's rounding points), so the operands of both products are the
// bf16 values the reference multiplies. The Q tile's A fragments then stay
// in registers. K and V tiles stream through a ring of three stages: the
// copy of step i + 2 is issued at step i, and each thread ropes its own
// chunks of step i + 1's K tile (its RoPE table rows fetched before step
// i's products) while the warps multiply step i's tiles, so a step takes
// one barrier. Products: mma.sync.m16n8k16 bf16 with fp32 accumulators,
// fragments by ldmatrix (.trans for V); a warp's scores are a 16 x 64
// accumulator. Softmax is one sweep with a rescaled accumulator (FlashAttention-2's
// online form): per key tile the row max m moves, o and the fp32 sum l are
// rescaled by exp(m_old - m_new), p = exp(s - m) is rounded to bf16 as the
// A operand of o += P V, and o is divided by l (the sum of the unrounded
// exponentials, as the reference's) at the end. The rounding point of p
// differs from the reference's there: the kernel rounds exp(s - m_running)
// before the row's final max and sum are known and divides afterwards,
// where the reference rounds exp(s - max) / sum. bf16 keeps 8 significant
// bits, so each rounding is off by up to 2^-8 of p and the two weights of a
// key differ by up to 2^-7 of p; an output before its own rounding differs
// from the plain version's by up to 2^-7 * sum_k p_k |v_k|. That is no
// bound by one output ulp, nor by 2^-7 of max|ref| where v's values cancel:
// the 1e-2-of-max|ref| gate holds because the per-key errors have random
// signs and largely cancel, which chip_smoke.py's edge cases measure over
// several seeds (two sweeps, rounding where the reference does, cost 2x).
// Keys are masked by bounds, so N needs no padding and has no cap; with
// `causal`, key tiles past the block's last row are skipped. The output
// tile is staged through shared memory into 16-byte stores. The lane roll
// with sign-folded sin tables and the block-diagonal statistics matrix of
// the TPU kernel were workarounds for its vector unit: here rotate-half is
// an index and the RMS a shuffle between two lanes.
//
// The fp32 arms (exact, and bf16x3) keep the first version's scalar body:
// 256 threads, four a row, each owning 16 of the row's 64 head-dim columns
// (the pairs j and j+32); Q in shared memory, key tiles normalised and roped
// on load, scalar fp32 FMAs from shared memory, two sweeps (p formed at the
// reference's rounding point). The bf16x3 arm keeps each split row as two
// fp32 rows (hi, lo) in shared memory; to stay at two blocks an SM it holds
// five tiles, not seven: in its second pass V's halves are loaded into K's
// buffers once a tile's scores are taken.
//
// Bound on an H100: at the VTP-L shapes (B=8, N=257, H=16) the bf16 arm
// moves 16.8 MB and does 2.2 GFLOP (bytes-bound, 5 us); with qk-norm at
// DiT-XL/1's (B=32, N=256, H=18) it moves 75.5 MB and does 9.7 GFLOP
// (bytes-bound, 22.5 us). The bf16 arm redoes each K tile's prologue in
// every query tile (N/64 times), and its issue slots go to that prologue
// and the softmax's exponentials more than to the products; the K and V
// tiles are re-read from L2 by every query tile. The fp32 arm moves 33.6 MB
// and does 2.15 GFLOP of fp32 FMAs (operations-bound at the 67 TFLOP/s
// non-tensor rate, 32 us). The bf16x3 arm at the decode's shape (B=8,
// N=256) moves the same 33.6 MB and does 3 x 2.15 GFLOP, which at the bf16
// tensor-core rate it was defined for is 6.5 us: bytes-bound, 10 us; it
// runs on CUDA cores, three FMAs a product.

#include "tensor_core.cuh"

namespace {

// Shared memory: Q, K, V and P tiles; the bf16x3 arm holds Q, K (then V),
// P and the lo halves of Q and of K (then V).
template <bool kSplit>
constexpr size_t smem_bytes() {
  return (kSplit ? 5 : 4) * kTile * kStride * sizeof(float);
}

// The fp32 arms' scalar body: kSplit false is the exact arm, true the
// bf16x3 arm.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 2)
fused_qkv_rope_attention_kernel(const float* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ sin_t,
                                const __nv_bfloat16* __restrict__ cos_t,
                                const float* __restrict__ q_scale,
                                const float* __restrict__ k_scale,
                                float* __restrict__ out, int N, int H, int n_valid,
                                int causal) {
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
  const float* base = qkv + static_cast<size_t>(b) * N * row_stride;
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
    load_row<float, kSplit>(base + static_cast<size_t>(qrow) * row_stride + h * kHeadDim,
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
    load_row<float, kSplit>(base + static_cast<size_t>(n) * row_stride + D + h * kHeadDim,
                            n < N, k_scale, sr, cr, s_k + r * kStride, c, lo_row(s_k_lo));
  };
  auto load_v = [&](int k0) {
    const int n = k0 + r;
    load_row<float, kSplit>(base + static_cast<size_t>(n) * row_stride + 2 * D + h * kHeadDim,
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

  // Pass 2: p = exp(s - max) / sum, kept in fp32; out += p.v.
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
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m) / l;
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
    float* orow = out + (static_cast<size_t>(b) * N + qrow) * D + h * kHeadDim;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[4 * c + 16 * i + e] = acc[4 * i + e];
    }
  }
}

template <bool kSplit = false>
int launch(const void* qkv, const void* sin_t, const void* cos_t,
           const void* q_scale, const void* k_scale, void* out, int B, int N,
           int H, int n_valid, int causal, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t kSmemBytes = smem_bytes<kSplit>();
  err = cudaFuncSetAttribute(fused_qkv_rope_attention_kernel<kSplit>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_qkv_rope_attention_kernel<kSplit><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<const __nv_bfloat16*>(sin_t),
      static_cast<const __nv_bfloat16*>(cos_t),
      static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<float*>(out), N, H, n_valid, causal);
  return static_cast<int>(cudaGetLastError());
}


// The bf16 arm on tensor cores (see the note above). Shared memory: a ring
// of three stages, each a K and a V tile (the Q tile is copied into the
// third stage's K buffer before the ring starts, and the output tile is
// staged in the first stage's K buffer at the end), and the two (64,)
// RMSNorm scale vectors.
constexpr size_t kSmemBf16 = 2 * kStages * kTileBytes + 2 * kHeadDim * sizeof(float);

__global__ void __launch_bounds__(kTcThreads, 3)
fused_qkv_rope_attention_bf16_kernel(const bf16* __restrict__ qkv,
                                     const bf16* __restrict__ sin_t,
                                     const bf16* __restrict__ cos_t,
                                     const float* __restrict__ q_scale,
                                     const float* __restrict__ k_scale, bf16* __restrict__ out,
                                     int N, int H, int n_valid, int causal) {
  extern __shared__ float4 smem4[];
  bf16* s_k = reinterpret_cast<bf16*>(smem4);  // kStages K tiles
  bf16* s_v = s_k + kStages * kTileB;          // kStages V tiles
  float* s_w = reinterpret_cast<float*>(s_v + kStages * kTileB);  // q_scale, then k_scale
  bf16* s_q = s_k + (kStages - 1) * kTileB;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const bf16* q_src = qkv + static_cast<size_t>(b) * N * row_stride + h * kHeadDim;
  const bf16* k_src = q_src + D;
  const bf16* v_src = q_src + 2 * D;
  const bool norm = q_scale != nullptr;
  const bool rope = sin_t != nullptr;
  const bool prologue = norm || rope;
  const int row = q0 + 16 * warp + g;  // this lane's rows: row and row + 8

  // Key tiles that hold any unmasked column for this block's rows.
  int n_kt = (n_valid + kTile - 1) / kTile;
  if (causal) {
    const int last_row = min(q0 + kTile, N) - 1;
    n_kt = min(n_kt, last_row / kTile + 1);
  }
  // One sweep over the key tiles: step i uses stage i % kStages; its copy is
  // issued two steps ahead and its K tile roped one step ahead.
  const int steps = n_kt;
  auto issue = [&](int i) {
    if (i < steps) {
      const int st = i % kStages;
      load_tile_async(s_k + st * kTileB, k_src, row_stride, i * kTile, N);
      load_tile_async(s_v + st * kTileB, v_src, row_stride, i * kTile, N);
    }
    cp_async_commit();
  };

  load_tile_async(s_q, q_src, row_stride, q0, N);
  cp_async_commit();
  issue(0);
  issue(1);
  if (norm) {
    if (threadIdx.x < 2 * kHeadDim)
      s_w[threadIdx.x] = threadIdx.x < kHeadDim ? q_scale[threadIdx.x] : k_scale[threadIdx.x - kHeadDim];
    __syncthreads();
  }
  RopeRow tab;
  if (prologue) {
    rope_fetch(tab, sin_t, cos_t, q0, N);
    cp_async_wait<2>();  // this thread's Q chunks
    prologue_tile(s_q, q0, N, norm ? s_w : nullptr, sin_t, cos_t, &tab);
    rope_fetch(tab, sin_t, cos_t, 0, N);
    cp_async_wait<1>();  // and its chunks of step 0
    prologue_tile(s_k, 0, N, norm ? s_w + kHeadDim : nullptr, sin_t, cos_t, &tab);
  } else {
    cp_async_wait<1>();
  }
  __syncthreads();
  uint32_t qa[4][4];
  load_a_rows(qa, s_q, 16 * warp, lane);
  __syncthreads();  // s_q is the stage that step 2 refills

  // Online softmax: m is each row's running max (the same in the row's four
  // lanes), l this lane's part of the running sum of exp(s - m), o the
  // running P V, rescaled by exp(m_old - m_new) when the max moves.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < steps; ++i) {
    issue(i + 2);
    const bool next = prologue && i + 1 < steps;
    if (next) rope_fetch(tab, sin_t, cos_t, (i + 1) * kTile, N);
    cp_async_wait<1>();  // this thread's chunks of step i + 1
    const int st = i % kStages;
    float s[8][4];
    mma_a_tileT<8>(s, qa, s_k + st * kTileB, 0, lane);
    mask_and_scale_acc(s, i * kTile, row, t, n_valid, causal);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[hr], mt);
      // a row with no unmasked key yet keeps m = -inf, l = 0, o = 0
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
        o[j][2 * hr] *= rescale;
        o[j][2 * hr + 1] *= rescale;
      }
      l[hr] = l[hr] * rescale + part;
      m[hr] = m_new;
    }
    uint32_t pa[4][4];
    acc_to_a<8>(s, pa);  // p rounded to bf16 here, before its row's final max and sum are known
    mma_a_tile<4>(o, pa, s_v + st * kTileB, 0, lane);
    // Rope step i + 1's K tile (this thread's own chunks) while other warps
    // still multiply; the barrier publishes it and frees stage i's buffers.
    if (next) {
      prologue_tile(s_k + ((i + 1) % kStages) * kTileB, (i + 1) * kTile, N,
                    norm ? s_w + kHeadDim : nullptr, sin_t, cos_t, &tab);
    }
    __syncthreads();
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const float inv = 1.0f / l[hr];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][2 * hr] *= inv;
      o[j][2 * hr + 1] *= inv;
    }
  }

  // Output tile: bf16 rows through shared memory, 16-byte stores.
  bf16* s_o = s_k;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(s_o + (16 * warp + g) * kRowB + col) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(s_o + (16 * warp + g + 8) * kRowB + col) =
        pack_bf16(o[j][2], o[j][3]);
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kTile * 8 / kTcThreads; ++it) {
    const int id = threadIdx.x + kTcThreads * it;
    const int r = id >> 3, chunk = id & 7;
    const int n = q0 + r;
    if (n < N) {
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * N + n) * D + h * kHeadDim +
                                8 * chunk) =
          *reinterpret_cast<const uint4*>(s_o + r * kRowB + 8 * chunk);
    }
  }
}

int launch_bf16(const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
                const void* k_scale, void* out, int B, int N, int H, int n_valid, int causal,
                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_qkv_rope_attention_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBf16));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_qkv_rope_attention_bf16_kernel<<<grid, kTcThreads, kSmemBf16, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(sin_t),
      static_cast<const bf16*>(cos_t), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<bf16*>(out), N, H, n_valid, causal);
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
  return launch_bf16(qkv, sin_t, cos_t, q_scale, k_scale, out, B, N, H, n_valid, causal,
                     device, stream);
}

extern "C" int vtp_fused_qkv_rope_attention_f32(
    const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
    const void* k_scale, void* out, int B, int N, int H, int n_valid,
    int causal, int device, cudaStream_t stream) {
  return launch(qkv, sin_t, cos_t, q_scale, k_scale, out, B, N, H, n_valid, causal, device,
                stream);
}

// The fp32 bf16x3 arm: the same arguments as the fp32 arm.
extern "C" int vtp_fused_qkv_rope_attention_f32_bf16x3(
    const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
    const void* k_scale, void* out, int B, int N, int H, int n_valid,
    int causal, int device, cudaStream_t stream) {
  return launch<true>(qkv, sin_t, cos_t, q_scale, k_scale, out, B, N, H, n_valid, causal,
                      device, stream);
}
