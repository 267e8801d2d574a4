// Backward of the fused qkv-split + qk-RMSNorm + RoPE + softmax attention for
// Hopper (sm_90a), bf16, head dims 32, 64 and 128 (the JAX gate's; every
// kernel is a template on the head dim d, one instantiation per d, reached
// through the entries below, which take d).
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
// (B, N, 3*H*d) and the output cotangent g (B, N, H*d):
//   q, k  = with qk-norm, bf16(bf16(x r) w) with r = rsqrt(mean(x^2) + 1e-5)
//           and the (d,) fp32 scales w, as the forward rounds them; then
//           RoPE(q), RoPE(k) recomputed as the forward rounds them;
//   p     = softmax(q.k * d^-1/2) in fp32 (keys >= n_valid and, if causal,
//           keys past the query row masked);
//   dv    = bf16(p) ^T g                          (fp32 sums, bf16 out)
//   dp    = g v^T,  delta = rowsum(p * dp)        (fp32)
//   ds    = bf16(p * (dp - delta) * d^-1/2)
//   dq~   = bf16(ds k),  dk~ = bf16(ds^T q)       (fp32 sums)
//   dq,dk = the RoPE adjoint of dq~, dk~: dx[j] = dx~[j] cos[j] +
//           dx~[j+d/2] sin[j+d/2] for j < d/2 and dx~[j] cos[j] -
//           dx~[j-d/2] sin[j-d/2] above, in fp32, rounded once;
//   with qk-norm, the RMSNorm adjoint of each row, in fp32 from the rounded
//   dsc = dq (or dk): dn = dsc w, dx = r dn - x r^3 mean(dn x), rounded once,
//   and the scales' gradient dw = sum over rows of dsc (x r);
// and writes d(qkv) in the packed (B, N, 3*H*d) layout. These are the
// rounding points of the TPU kernel, whose block-diagonal mean dot also
// rounds the operands of mean(dn x) to bf16: here that mean is fp32.
//
// Design: two passes, deterministic, no atomics, on tensor cores. Both
// are blocks of four warps over a tile of 64 rows, warp w owning rows
// [16w, 16w+16); every product is mma.sync.m16n8k16 bf16 with fp32
// accumulators on bf16 tiles in shared memory (tensor_core.cuh), and its
// operands are the reference's bf16 values: q and k after the prologue, v,
// g, bf16(p), ds = bf16(p (dp - delta) d^-1/2). Only the order of the fp32
// sums differs from the plain version.
//   dq pass, one block per (query tile, head, batch row): the Q tile
//     (normalised and roped in place after its cp.async copy) and the dO
//     tile are loaded once, their A fragments kept in registers; key tiles
//     (K, roped in place, and V) stream through a ring. A first sweep
//     computes S = Q K^T and dP = dO V^T, 32 keys at a time, and from them
//     the row max m, the sum l of exp(s - m) and w = sum exp(s - m) dp
//     online, so delta = w / l; a second sweep recomputes S and dP and forms
//     ds at its rounding point as the A operand of dQ += dS K. It writes dq
//     and the per-row (m, l, delta) into an fp32 workspace of shape
//     (3, B, H, N).
//   dk/dv pass, one block per (key tile, head, batch row): the K tile
//     (normalised and roped) and the V tile are loaded once into A
//     fragments; query tiles (Q normalised and roped in place, dO, and the
//     rows' saved m, l, delta) stream through a ring. For 16 queries at a
//     time it computes S^T = K Q^T and dP^T = V dO^T, forms bf16(p^T) and
//     ds^T, and accumulates dV += bf16(P)^T dO and dK += dS^T Q. Holding dk,
//     dv and the K and V fragments, it takes up to 255 registers at two
//     blocks an SM at d = 64 (at three it spilled), and its prologue reads
//     the RoPE tables as it goes. At d = 128 the fragments would not fit
//     beside dk and dv (64 registers each): K and V keep tiles of their own
//     in shared memory, each product reads its A fragments from them
//     (ldmatrix), and the ring has two stages (the copy of step i + 1
//     issued at step i, waited for after its products), two blocks an SM.
//   The rings have three stages (but the dk/dv pass's at d = 128): the
//   copy of step i + 2 is issued at step i,
//   and each thread ropes its own chunks of step i + 1's streamed Q or K
//   tile at the end of step i while other warps still multiply, so a step
//   takes one barrier.
//   Epilogues: each pass stages its fp32 accumulators (dq~; dk~ and dv)
//     through shared memory into the layout of four threads a row (d/4
//     columns a thread, the rotate-half pairs (j, j + d/2) in one), where the
//     RoPE adjoint (grad_row), the qk-norm adjoint (norm_adjoint_row: the
//     row's raw input reloaded, r recomputed, mean(dn x) a four-lane
//     shuffle) and the stores (store_row) run, 32 rows at a time. With
//     qk-norm each block sums its rows' dw terms through shared memory in a
//     fixed order (block_dw_row) and writes one fp32 row of d into a
//     workspace (2, B, H, tiles, d); the wrapper sums that workspace with
//     torch, as the JAX caller sums the TPU kernel's per-batch dw rows.
// Keys and rows are masked by bounds, so N needs no padding; with causal
// masking the dq pass skips key tiles past its last row and the dk/dv pass
// query tiles before its first key.
//
// Bound on an H100: at the trunk's global-crop shape (B=16, N=257, H=16) the
// function moves 7*B*N*H*d*2 bytes (qkv and g in, d(qkv) out: 58.9 MB,
// 17.6 us) and does 10*B*H*N^2*d FLOP (scores recomputed, dv, dp, dq, dk:
// 10.8 GFLOP, 10.9 us at the bf16 tensor-core peak), so it is bound by
// bytes; the qk-norm arm at DiT-XL/1's shape (B=32, N=256, H=18) moves
// 132 MB (39.4 us) and does 24.2 GFLOP (24.4 us), also bound by bytes. The
// kernels do 14*B*H*N^2*d FLOP (S and dP twice in the dq pass, once more
// in the dk/dv pass), re-read each streamed tile from L2 once per tile of
// the other side, and redo the prologue of every streamed tile (three
// times a pair of tiles); their issue slots go to that prologue, the
// exponentials and the epilogues more than to the products.

#include "tensor_core.cuh"

namespace {

// dq pass: the ring of (K, V) stages (Q and dO are first copied into the
// last stage; the dq tile and the dw rows are staged in it at the end),
// the scales.
template <int D>
constexpr size_t kSmemDq = 2 * kStages * kTileBytesOf<D> + 2 * D * sizeof(float);
template <int D>
constexpr int kDqBlocks = D == 128 ? 2 : 3;
// dk/dv pass. At D <= 64 the K and V fragments stay in registers through
// the pass, and K and V are first copied into the last stage of a ring of
// three (Q, dO, (m, l, delta) rows) stages. At D = 128 they would not fit
// beside dk and dv (64 registers each): K and V keep two tiles of their own
// and their fragments are read from them at each product, and the ring has
// two stages, so that two blocks fit an SM. The dk and dv tiles and the dw
// rows are staged at the start of shared memory at the end; then the
// scales.
template <int D>
constexpr bool kHeldKV = D <= 64;
template <int D>
constexpr int kStagesKv = kHeldKV<D> ? kStages : 2;
template <int D>
constexpr size_t kSmemDkv = (2 * kStagesKv<D> + (kHeldKV<D> ? 0 : 2)) * kTileBytesOf<D> +
                            (kStagesKv<D> * 3 * kTile + 2 * D) * sizeof(float);
template <int D>
constexpr int kDkvBlocks = D == 32 ? 3 : 2;
constexpr int kChunk = 32;     // keys a product step of the dq pass takes
constexpr int kChunkKv = 16;   // queries a product step of the dk/dv pass takes
template <int D>
constexpr size_t kStageFloats = kTile * kStrideOf<D>;  // an fp32 staging tile
template <int D>
constexpr size_t kDwAt = 4 * kTileBytesOf<D> / sizeof(float);  // the dw rows, past two staging tiles

template <int D>
struct BwdFits {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static_assert(2 * kStageFloats<D> * sizeof(float) <= 4 * kTileBytesOf<D>, "staging fits");
  static_assert((kTcThreads / 4) * kStrideOf<D> * sizeof(float) <= 2 * kTileBytesOf<D>,
                "dw rows fit");
  static_assert(2 * kStagesKv<D> + (kHeldKV<D> ? 0 : 2) >= 6, "the dk/dv epilogue has 6 tiles");
  static constexpr bool ok = true;
};

// The accumulator layout of both passes' epilogues, four threads a row:
// acc[4i + e] holds head-dim column 4c + 16i + e (i < D/16), so columns j
// and j + D/2 (acc[4i + e] and acc[4(i + D/32) + e]) sit in one thread.
// Rounds to bf16 and applies the RoPE adjoint when tables are given, in
// fp32, into x.
template <int D>
__device__ void grad_row(const float (&acc)[D / 4], const bf16* __restrict__ sin_row,
                         const bf16* __restrict__ cos_row, bool rope, int c, float (&x)[D / 4]) {
#pragma unroll
  for (int i = 0; i < D / 4; ++i) x[i] = bf16_round(acc[i]);
  if (rope) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lo = 4 * c + 16 * i + e;  // < D/2
        const int hi = lo + D / 2;
        const float xl = x[4 * i + e], xh = x[4 * (i + D / 32) + e];
        const float sl = __bfloat162float(sin_row[lo]), sh = __bfloat162float(sin_row[hi]);
        const float cl = __bfloat162float(cos_row[lo]), ch = __bfloat162float(cos_row[hi]);
        x[4 * i + e] = xl * cl + xh * sh;
        x[4 * (i + D / 32) + e] = xh * ch - xl * sl;
      }
    }
  }
}

// Stores the D/4 columns of one row, in the accumulator layout, rounded to bf16.
template <int D>
__device__ __forceinline__ void store_row(const float (&x)[D / 4], int c, bf16* __restrict__ dst) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
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
template <int D>
__device__ void norm_adjoint_row(float (&dx)[D / 4], const bf16* __restrict__ xrow, bool in_range,
                                 const float* __restrict__ w, int c, float (&dw)[D / 4]) {
  float x[D / 4];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
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
  for (int j = 0; j < D / 4; ++j) ss += x[j] * x[j];
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float r = 1.0f / sqrtf(ss / D + 1e-5f);
  float dn[D / 4], t = 0.f;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float dsc = in_range ? bf16_round(dx[j]) : 0.f;
    dn[j] = dsc * w[4 * c + 16 * (j >> 2) + (j & 3)];
    dw[j] = fmaf(dsc, x[j] * r, dw[j]);
    t = fmaf(dn[j], x[j], t);
  }
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  t *= 1.0f / D;
  const float r3 = r * r * r;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) dx[j] = r * dn[j] - x[j] * r3 * t;
}

// Sums the block's `rows` rows of dw terms (this thread's D/4 columns of
// row r, in the accumulator layout) through the shared tile s_dw, rows in
// order, and writes the block's row of D to dst. Called by every thread of
// the block after the shared tile is free.
template <int D>
__device__ void block_dw_row(const float (&dw)[D / 4], float* __restrict__ s_dw, int r, int c,
                             int rows, float* __restrict__ dst) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s_dw[r * kStrideOf<D> + 4 * c + 16 * i + e] = dw[4 * i + e];
  }
  __syncthreads();
  if (threadIdx.x < D) {
    float sum = 0.f;
    for (int row = 0; row < rows; ++row) sum += s_dw[row * kStrideOf<D> + threadIdx.x];
    dst[threadIdx.x] = sum;
  }
}

// The workspace row of block (tile, h, b) for arm a (0: dw_q, 1: dw_k) in
// the (2, B, H, tiles, D) dw workspace.
template <int D>
__device__ __forceinline__ float* dw_row(float* dws, int a) {
  const size_t at = ((static_cast<size_t>(a) * gridDim.z + blockIdx.z) * gridDim.y + blockIdx.y) *
                        gridDim.x + blockIdx.x;
  return dws + at * D;
}


// Loads the D/4 staged fp32 columns of row r that thread quarter c owns in
// the accumulator layout (column 4c + 16i + e at acc[4i + e]).
template <int D>
__device__ __forceinline__ void unstage_row(const float* __restrict__ tile, int r, int c,
                                            float (&acc)[D / 4]) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(tile + r * kStrideOf<D> + 4 * c + 16 * i);
    acc[4 * i] = v.x;
    acc[4 * i + 1] = v.y;
    acc[4 * i + 2] = v.z;
    acc[4 * i + 3] = v.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kDqBlocks<D>)
attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                        const bf16* __restrict__ sin_t, const bf16* __restrict__ cos_t,
                        const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                        bf16* __restrict__ dqkv, float* __restrict__ stats,
                        float* __restrict__ dws, int N, int H, int n_valid, int causal) {
  static_assert(BwdFits<D>::ok, "");
  constexpr int kTileB = kTileOf<D>;
  extern __shared__ float4 smem4[];
  bf16* s_k = reinterpret_cast<bf16*>(smem4);  // kStages K tiles
  bf16* s_v = s_k + kStages * kTileB;          // kStages V tiles
  float* s_w = reinterpret_cast<float*>(s_v + kStages * kTileB);  // q_scale, then k_scale
  bf16* s_q = s_k + (kStages - 1) * kTileB;
  bf16* s_g = s_v + (kStages - 1) * kTileB;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int width = H * D;
  const size_t row_stride = 3 * static_cast<size_t>(width);
  const bf16* q_src = qkv + static_cast<size_t>(b) * N * row_stride + h * D;
  const bf16* k_src = q_src + width;
  const bf16* v_src = q_src + 2 * width;
  const bool norm = q_scale != nullptr;
  const bool rope = sin_t != nullptr;
  const bool prologue = norm || rope;
  const int row = q0 + 16 * warp + (lane >> 2);  // this lane's rows: row and row + 8

  int n_kt = (n_valid + kTile - 1) / kTile;
  if (causal) {
    const int last_row = min(q0 + kTile, N) - 1;
    n_kt = min(n_kt, last_row / kTile + 1);
  }
  const int steps = 2 * n_kt;  // two sweeps over the key tiles; step i uses stage i % kStages
  auto key0 = [&](int i) { return (i < n_kt ? i : i - n_kt) * kTile; };
  auto issue = [&](int i) {
    if (i < steps) {
      const int st = i % kStages;
      load_tile_async<D>(s_k + st * kTileB, k_src, row_stride, key0(i), N);
      load_tile_async<D>(s_v + st * kTileB, v_src, row_stride, key0(i), N);
    }
    cp_async_commit();
  };

  load_tile_async<D>(s_q, q_src, row_stride, q0, N);
  load_tile_async<D>(s_g, g + static_cast<size_t>(b) * N * width + h * D, width, q0, N);
  cp_async_commit();
  issue(0);
  issue(1);
  if (norm) {
    load_scales<D>(s_w, q_scale, k_scale);
    __syncthreads();
  }
  RopeRow<D> tab;
  if (prologue) {
    rope_fetch<D>(tab, sin_t, cos_t, q0, N);
    cp_async_wait<2>();  // this thread's Q chunks
    prologue_tile<D>(s_q, q0, N, norm ? s_w : nullptr, sin_t, cos_t, &tab);
    rope_fetch<D>(tab, sin_t, cos_t, key0(0), N);
    cp_async_wait<1>();  // and its chunks of step 0
    prologue_tile<D>(s_k, key0(0), N, norm ? s_w + D : nullptr, sin_t, cos_t, &tab);
  } else {
    cp_async_wait<1>();
  }
  __syncthreads();
  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_a_rows<D>(qa, s_q, 16 * warp, lane);
  load_a_rows<D>(ga, s_g, 16 * warp, lane);
  __syncthreads();  // the last stage is refilled at step 0

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, w[2] = {0.f, 0.f}, delta[2];
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int i = 0; i < steps; ++i) {
    issue(i + 2);
    const bool next = prologue && i + 1 < steps;
    if (next) rope_fetch<D>(tab, sin_t, cos_t, key0(i + 1), N);
    cp_async_wait<1>();  // this thread's chunks of step i + 1
    const int k0 = key0(i);
    const bf16* kb = s_k + (i % kStages) * kTileB;
    const bf16* vb = s_v + (i % kStages) * kTileB;
#pragma unroll
    for (int ch = 0; ch < kTile / kChunk; ++ch) {
      float s[kChunk / 8][4], dp[kChunk / 8][4];
      mma_a_tileT<kChunk / 8, D>(s, qa, kb, kChunk * ch, lane);
      mma_a_tileT<kChunk / 8, D>(dp, ga, vb, kChunk * ch, lane);
      mask_and_scale_acc(s, k0 + kChunk * ch, row, t, n_valid, causal, kScaleOf<D>);
      if (i < n_kt) {
        // Sweep 1: m, l = sum exp(s - m) and w = sum exp(s - m) dp, online.
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float m_new = fmaxf(m[hr], mt);
          if (m_new != -INFINITY) {
            float part = 0.f, wpart = 0.f;
#pragma unroll
            for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
              for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
                const float x = expf(s[j][e] - m_new);
                part += x;
                wpart += x * dp[j][e];
              }
            }
            const float rescale = m[hr] == -INFINITY ? 0.f : expf(m[hr] - m_new);
            l[hr] = l[hr] * rescale + part;
            w[hr] = w[hr] * rescale + wpart;
            m[hr] = m_new;
          }
        }
      } else {
        // Sweep 2: ds = bf16(p (dp - delta) d^-1/2); dq += ds k.
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1;
            const float p = s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m[hr]) / l[hr];
            s[j][e] = bf16_round(p * (dp[j][e] - delta[hr]) * kScaleOf<D>);
          }
        }
        uint32_t da[kChunk / 16][4];
        acc_to_a<kChunk / 8>(s, da);
        mma_a_tile<kChunk / 16, D>(dq, da, kb, kChunk * ch, lane);
      }
    }
    if (i == n_kt - 1) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
        l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
        w[hr] += __shfl_xor_sync(0xffffffffu, w[hr], 1);
        w[hr] += __shfl_xor_sync(0xffffffffu, w[hr], 2);
        delta[hr] = w[hr] / l[hr];
      }
    }
    if (next) {
      prologue_tile<D>(s_k + ((i + 1) % kStages) * kTileB, key0(i + 1), N,
                       norm ? s_w + D : nullptr, sin_t, cos_t, &tab);
    }
    __syncthreads();  // publishes step i + 1's K tile; frees stage i
  }

  if (t == 0) {
    const size_t bhn = static_cast<size_t>(gridDim.z) * H * N;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int n = row + 8 * hr;
      if (n < N) {
        const size_t at = (static_cast<size_t>(b) * H + h) * N + n;
        stats[at] = m[hr];
        stats[bhn + at] = l[hr];
        stats[2 * bhn + at] = delta[hr];
      }
    }
  }

  // Epilogue, four threads a row, 32 rows at a time: the RoPE adjoint, the
  // norm adjoint, the stores.
  float* stage = reinterpret_cast<float*>(smem4);
  stage_acc<D>(dq, stage, 16 * warp, lane);
  __syncthreads();
  const int c = threadIdx.x & 3;
  float dw[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dw[i] = 0.f;
#pragma unroll 1
  for (int half = 0; half < kTile / (kTcThreads / 4); ++half) {
    const int r = (threadIdx.x >> 2) + half * (kTcThreads / 4);
    const int qrow = q0 + r;
    float acc[D / 4], dx[D / 4];
    unstage_row<D>(stage, r, c, acc);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dx[i] = 0.f;
    const bf16* q_in = q_src + static_cast<size_t>(qrow) * row_stride;
    const bf16* sr = rope ? sin_t + static_cast<size_t>(qrow) * D : nullptr;
    const bf16* cr = rope ? cos_t + static_cast<size_t>(qrow) * D : nullptr;
    if (qrow < N) grad_row<D>(acc, sr, cr, rope, c, dx);
    if (norm) norm_adjoint_row<D>(dx, q_in, qrow < N, q_scale, c, dw);
    if (qrow < N) store_row<D>(dx, c, dqkv + (static_cast<size_t>(b) * N + qrow) * row_stride + h * D);
  }
  if (norm) block_dw_row<D>(dw, stage + kDwAt<D>, threadIdx.x >> 2, c, kTcThreads / 4, dw_row<D>(dws, 0));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kDkvBlocks<D>)
attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                         const bf16* __restrict__ sin_t, const bf16* __restrict__ cos_t,
                         const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                         const float* __restrict__ stats, bf16* __restrict__ dqkv,
                         float* __restrict__ dws, int N, int H, int n_valid, int causal) {
  static_assert(BwdFits<D>::ok, "");
  constexpr int kTileB = kTileOf<D>;
  constexpr int kSt = kStagesKv<D>;
  constexpr bool kHeld = kHeldKV<D>;
  extern __shared__ float4 smem4[];
  bf16* s_q = reinterpret_cast<bf16*>(smem4);  // kSt Q tiles
  bf16* s_g = s_q + kSt * kTileB;              // kSt dO tiles
  // K and V: the last stage's Q and dO tiles at D <= 64, two tiles of their own past the ring at D = 128
  bf16* s_k = kHeld ? s_q + (kSt - 1) * kTileB : s_g + kSt * kTileB;
  bf16* s_v = kHeld ? s_g + (kSt - 1) * kTileB : s_k + kTileB;
  float* s_stat = reinterpret_cast<float*>(s_q + (2 * kSt + (kHeld ? 0 : 2)) * kTileB);  // kSt (m, l, delta) rows
  float* s_w = s_stat + kSt * 3 * kTile;                                                // q_scale, then k_scale

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int width = H * D;
  const size_t row_stride = 3 * static_cast<size_t>(width);
  const bf16* q_src = qkv + static_cast<size_t>(b) * N * row_stride + h * D;
  const bf16* k_src = q_src + width;
  const bf16* v_src = q_src + 2 * width;
  const bf16* g_src = g + static_cast<size_t>(b) * N * width + h * D;
  const bool norm = q_scale != nullptr;
  const bool rope = sin_t != nullptr;
  const bool prologue = norm || rope;
  const int key = k0 + 16 * warp + (lane >> 2);  // this lane's keys: key and key + 8
  const size_t bhn = static_cast<size_t>(gridDim.z) * H * N;
  const float* stat_src = stats + (static_cast<size_t>(b) * H + h) * N;

  const int n_qt = (N + kTile - 1) / kTile;
  const int qt0 = k0 >= n_valid ? n_qt : (causal ? k0 / kTile : 0);
  const int steps = n_qt - qt0;  // query tiles; step i uses stage i % kSt
  auto query0 = [&](int i) { return (qt0 + i) * kTile; };
  auto issue = [&](int i) {
    if (i < steps) {
      const int st = i % kSt;
      const int q0 = query0(i);
      load_tile_async<D>(s_q + st * kTileB, q_src, row_stride, q0, N);
      load_tile_async<D>(s_g + st * kTileB, g_src, width, q0, N);
      float* dst = s_stat + st * 3 * kTile;
      for (int id = threadIdx.x; id < 3 * kTile; id += kTcThreads) {
        const int a = id / kTile, r = id % kTile;
        const bool valid = q0 + r < N;
        cp_async4(dst + id, stat_src + a * bhn + (valid ? q0 + r : 0), valid);
      }
    }
    cp_async_commit();
  };

  load_tile_async<D>(s_k, k_src, row_stride, k0, N);
  load_tile_async<D>(s_v, v_src, row_stride, k0, N);
  cp_async_commit();
  issue(0);
  if constexpr (kSt == 3) issue(1);
  if (norm) {
    load_scales<D>(s_w, q_scale, k_scale);
    __syncthreads();
  }
  // This pass holds dk and dv (and at D <= 64 the K and V fragments) across
  // a step, so its prologue reads the RoPE tables as it goes (no prefetched
  // rows).
  if (prologue) {
    cp_async_wait<kSt - 1>();  // this thread's K chunks
    prologue_tile<D>(s_k, k0, N, norm ? s_w + D : nullptr, sin_t, cos_t, nullptr);
    cp_async_wait<kSt - 2>();  // and its chunks of step 0
    if (steps > 0) prologue_tile<D>(s_q, query0(0), N, norm ? s_w : nullptr, sin_t, cos_t, nullptr);
  } else {
    cp_async_wait<kSt - 2>();
  }
  __syncthreads();
  uint32_t ka[kHeld ? D / 16 : 1][4], va[kHeld ? D / 16 : 1][4];
  if constexpr (kHeld) {
    load_a_rows<D>(ka, s_k, 16 * warp, lane);
    load_a_rows<D>(va, s_v, 16 * warp, lane);
    __syncthreads();  // the last stage is refilled at step 0
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }

  for (int i = 0; i < steps; ++i) {
    issue(i + kSt - 1);  // into the stage that step i - 1 used, freed by its closing barrier
    const bool next = prologue && i + 1 < steps;
    if constexpr (kSt == 3) cp_async_wait<1>();  // this thread's chunks of step i + 1
    const int q0 = query0(i);
    const bf16* qb = s_q + (i % kSt) * kTileB;
    const bf16* gb = s_g + (i % kSt) * kTileB;
    const float* st = s_stat + (i % kSt) * 3 * kTile;
    // at D = 128 one chunk at a time: four unrolled chunks' fragments spill
#pragma unroll(kHeld ? kTile / kChunkKv : 1)
    for (int ch = 0; ch < kTile / kChunkKv; ++ch) {
      float s[kChunkKv / 8][4], dp[kChunkKv / 8][4];
      if constexpr (kHeld) {
        mma_a_tileT<kChunkKv / 8, D>(s, ka, qb, kChunkKv * ch, lane);
        mma_a_tileT<kChunkKv / 8, D>(dp, va, gb, kChunkKv * ch, lane);
      } else {
        mma_tile_tileT<kChunkKv / 8, D>(s, s_k, 16 * warp, qb, kChunkKv * ch, lane);
        mma_tile_tileT<kChunkKv / 8, D>(dp, s_v, 16 * warp, gb, kChunkKv * ch, lane);
      }
#pragma unroll
      for (int j = 0; j < kChunkKv / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = kChunkKv * ch + 8 * j + 2 * t + (e & 1);  // query row within the tile
          const int kk = key + 8 * (e >> 1);
          const bool masked = kk >= n_valid || q0 + qr >= N || (causal && kk > q0 + qr);
          const float p = masked ? 0.f : expf(s[j][e] * kScaleOf<D> - st[qr]) / st[kTile + qr];
          s[j][e] = bf16_round(p);
          dp[j][e] = bf16_round(p * (dp[j][e] - st[2 * kTile + qr]) * kScaleOf<D>);
        }
      }
      uint32_t pa[kChunkKv / 16][4], da[kChunkKv / 16][4];
      acc_to_a<kChunkKv / 8>(s, pa);
      acc_to_a<kChunkKv / 8>(dp, da);
      mma_a_tile<kChunkKv / 16, D>(dv, pa, gb, kChunkKv * ch, lane);
      mma_a_tile<kChunkKv / 16, D>(dk, da, qb, kChunkKv * ch, lane);
    }
    if constexpr (kSt == 2) cp_async_wait<0>();  // this thread's chunks of step i + 1
    if (next) {
      prologue_tile<D>(s_q + ((i + 1) % kSt) * kTileB, query0(i + 1), N,
                       norm ? s_w : nullptr, sin_t, cos_t, nullptr);
    }
    __syncthreads();  // publishes step i + 1's Q tile; frees stage i
  }

  // Epilogue, four threads a row, 32 rows at a time: dk through the RoPE and
  // norm adjoints, dv as it stands.
  float* stage_k = reinterpret_cast<float*>(smem4);
  float* stage_v = stage_k + kStageFloats<D>;
  stage_acc<D>(dk, stage_k, 16 * warp, lane);
  stage_acc<D>(dv, stage_v, 16 * warp, lane);
  __syncthreads();
  const int c = threadIdx.x & 3;
  float dw[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dw[i] = 0.f;
#pragma unroll 1
  for (int half = 0; half < kTile / (kTcThreads / 4); ++half) {
    const int r = (threadIdx.x >> 2) + half * (kTcThreads / 4);
    const int n = k0 + r;
    float acc[D / 4], dx[D / 4];
    unstage_row<D>(stage_k, r, c, acc);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) dx[i] = 0.f;
    const bf16* k_in = k_src + static_cast<size_t>(n) * row_stride;
    const bf16* sr = rope ? sin_t + static_cast<size_t>(n) * D : nullptr;
    const bf16* cr = rope ? cos_t + static_cast<size_t>(n) * D : nullptr;
    if (n < N) grad_row<D>(acc, sr, cr, rope, c, dx);
    if (norm) norm_adjoint_row<D>(dx, k_in, n < N, k_scale, c, dw);
    if (n < N) {
      bf16* out = dqkv + (static_cast<size_t>(b) * N + n) * row_stride + h * D;
      store_row<D>(dx, c, out + width);
      unstage_row<D>(stage_v, r, c, acc);
      grad_row<D>(acc, nullptr, nullptr, false, c, dx);
      store_row<D>(dx, c, out + 2 * width);
    }
  }
  if (norm) block_dw_row<D>(dw, stage_k + kDwAt<D>, threadIdx.x >> 2, c, kTcThreads / 4, dw_row<D>(dws, 1));
}

template <int D>
int launch_bwd(const void* qkv, const void* g, const void* sin_t, const void* cos_t,
               const void* q_scale, const void* k_scale, void* stats, void* dws, void* dqkv,
               int B, int N, int H, int n_valid, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemDq<D>));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemDkv<D>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* go = static_cast<const bf16*>(g);
  const bf16* s = static_cast<const bf16*>(sin_t);
  const bf16* co = static_cast<const bf16*>(cos_t);
  const float* qs = static_cast<const float*>(q_scale);
  const float* ks = static_cast<const float*>(k_scale);
  attention_bwd_dq_kernel<D><<<grid, kTcThreads, kSmemDq<D>, stream>>>(
      q, go, s, co, qs, ks, static_cast<bf16*>(dqkv), static_cast<float*>(stats),
      static_cast<float*>(dws), N, H, n_valid, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkv_kernel<D><<<grid, kTcThreads, kSmemDkv<D>, stream>>>(
      q, go, s, co, qs, ks, static_cast<const float*>(stats), static_cast<bf16*>(dqkv),
      static_cast<float*>(dws), N, H, n_valid, causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bwd(const void* qkv, const void* g, const void* sin_t, const void* cos_t,
                 const void* q_scale, const void* k_scale, void* stats, void* dws, void* dqkv,
                 int B, int N, int H, int d, int n_valid, int causal, int device,
                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (d) {
    case 32:
      return launch_bwd<32>(qkv, g, sin_t, cos_t, q_scale, k_scale, stats, dws, dqkv, B, N, H,
                            n_valid, causal, stream);
    case 64:
      return launch_bwd<64>(qkv, g, sin_t, cos_t, q_scale, k_scale, stats, dws, dqkv, B, N, H,
                            n_valid, causal, stream);
    case 128:
      return launch_bwd<128>(qkv, g, sin_t, cos_t, q_scale, k_scale, stats, dws, dqkv, B, N, H,
                             n_valid, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// qkv: (B, N, 3*H*d) bf16 contiguous, the forward's input; g: (B, N, H*d)
// bf16 contiguous; sin/cos: (N, d) bf16 or null; stats: (3, B, H, N) fp32
// scratch; dqkv: (B, N, 3*H*d) bf16, fully written; d in {32, 64, 128};
// 1 <= n_valid <= N. Launches the dq pass, then the dk/dv pass, on
// `stream`. Returns the cudaError_t of the launches.
extern "C" int vtp_fused_qkv_rope_attention_bwd_bf16(
    const void* qkv, const void* g, const void* sin_t, const void* cos_t, void* stats,
    void* dqkv, int B, int N, int H, int d, int n_valid, int causal, int device,
    cudaStream_t stream) {
  return dispatch_bwd(qkv, g, sin_t, cos_t, nullptr, nullptr, stats, nullptr, dqkv, B, N, H, d,
                      n_valid, causal, device, stream);
}

// The qk-norm arm: as above, plus q_scale/k_scale, (d,) fp32, and dws, the
// (2, B, H, ceil(N/64), d) fp32 workspace of per-block dw_q (0) and dw_k (1)
// rows, fully written.
extern "C" int vtp_fused_qkv_rope_attention_qk_norm_bwd_bf16(
    const void* qkv, const void* g, const void* sin_t, const void* cos_t, const void* q_scale,
    const void* k_scale, void* stats, void* dws, void* dqkv, int B, int N, int H, int d,
    int n_valid, int causal, int device, cudaStream_t stream) {
  if (q_scale == nullptr || k_scale == nullptr || dws == nullptr) return 1;  // cudaErrorInvalidValue
  return dispatch_bwd(qkv, g, sin_t, cos_t, q_scale, k_scale, stats, dws, dqkv, B, N, H, d,
                      n_valid, causal, device, stream);
}
