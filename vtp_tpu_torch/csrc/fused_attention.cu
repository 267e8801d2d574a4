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
// Three arms: bf16 in/out (fp32 scores and softmax), on tensor cores; exact
// fp32 with plain fp32 FMAs (no TF32, no tensor cores); and fp32 bf16x3,
// on tensor cores (the TPU kernel's
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
// the rounding points above), so the operands of both products are the
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
// Design of the bf16x3 arm (tensor cores, the same block and ring). Each
// fp32 tile (Q, then K and V per step) is copied raw by cp.async into a
// split tile of 64 rows of 272 bytes; split_tile then rewrites it in place,
// two threads a row (the rotate-half pairs in one thread, a row's mean of
// squares one shuffle): the prologue at the rounding points above
// (prologue_f32_row; the qk-norm's mean of squares summed over the split
// halves of each square, as _rms_norm_high, x = (x r) w in fp32; RoPE in bf16 as the
// reference rounds it), then hi = bf16(x) in the row's first 128 bytes and
// lo = bf16(x - hi) in the next 128. cp.async into shared memory, not a
// register prefetch, brings the fp32 rows: the copy is issued two steps
// ahead and holds no registers beside the accumulators, and the split lands
// where the copy did, so the ring needs no staging tiles (104,960 bytes,
// two blocks an SM). K and V are split one step ahead, while other warps
// multiply. Products: mma.sync bf16 into fp32 accumulators, hi.hi + hi.lo +
// lo.hi (lo.lo dropped) for each of S = Q K^T and O += P V, the three terms
// summed in one accumulator k-step by k-step, where the plain version
// (matmul_high_reference) sums three whole products: the fp32 sums differ
// in order only. With RoPE, q and k are bf16-valued after the prologue, so
// their lo halves are 0 and S takes the one product hi.hi, bit for bit the
// same sum. Softmax: one sweep, online; p = exp(s - m_running) stays fp32 and
// is split into (hi, lo) as the A operand of P V, o and l are rescaled by
// exp(m_old - m_new) in fp32 and o is divided by l at the end. The plain
// version splits the normalised p instead: the two differ in that split
// and in the rescales, at about 2^-16 of p, and no bf16 rounding point
// moves (tests/test_torch_tensor_core.py holds a torch emulation of this
// sweep within 1e-5 of max|ref| to the plain arm; chip_smoke.py holds the
// kernel to 1e-4 abs at every edge case).
//
// Design of the exact fp32 arm (plain FFMA: no TF32, no tensor-core
// instruction; chip_smoke.py fails if its SASS holds one). It is built as a
// SIMT SGEMM is, over the same block of four warps and 64 query rows. The
// Q tile and every K and V tile are fp32 rows in shared memory (68 floats,
// 272 bytes, as the split tiles), copied raw by cp.async (K and V through a
// ring of two stages: the copy of step i + 1 is issued at the start of step
// i and lands while the warps multiply) and normalised and roped in place
// by the thread that copied each chunk (prologue_f32_tile, at the rounding
// points above; the Q tile once, each K tile at the end of the step before
// its own, its RoPE rows fetched at the start of that step; RoPE on packed
// bf16 pairs, as the bf16 arm's prologue, ~7% faster than one value at a
// time at the decode's shape). Lane
// (rg = lane / 8, cg = lane % 8) of warp w owns the scores of query rows
// 16w + rg + 4r (r < 4) against keys cg + 8e (e < 8) and the outputs of the
// same rows at head-dim columns 4cg + [0, 4) and 32 + 4cg + [0, 4): a 4 x 8
// micro-tile of S and of O in registers. Each product step reads its
// operands as 16-byte shared loads into registers and reuses each across
// the micro-tile: S takes 12 loads (4 of q rows, 8 of k rows, each 4
// head-dim columns) for 128 FFMA, P.V 12 loads (4 of p rows, 8 of v rows)
// for 128. Every load is one wavefront: the eight rows a warp reads at
// once are 272 bytes apart (eight distinct groups of four banks), and the
// four q or p rows are broadcast to the eight lanes that share them. The
// P tile goes through the warp's own 16 rows of shared memory (72 floats a
// row, so the scalar stores of a warp fall in 32 distinct banks) behind a
// __syncwarp, not a block barrier. The scores are masked only in a tile
// that holds a key past n_valid, or under the causal mask. Softmax is one
// sweep, online: per key
// tile the row max m moves (a shuffle over the row's eight lanes), o and
// this lane's part of the fp32 sum l are rescaled by exp(m_old - m_new),
// p = exp(s - m) stays fp32, and o is multiplied by 1 / l at the end. No
// rounding point moves: the kernel differs from the plain version only in
// the order of its fp32 sums (each score and each output summed over its
// head dim or keys in order, the rescales) and in applying 1 / l to o
// rather than to p, each a few fp32 ulps of the output
// (tests/test_torch_exact_sweep.py holds a torch emulation of this sweep
// within 1e-5 of max|ref| to the plain arm; chip_smoke.py holds the kernel
// to 1e-4 abs at every edge case).
//
// Bound on an H100: at the VTP-L shapes (B=8, N=257, H=16) the bf16 arm
// moves 16.8 MB and does 2.2 GFLOP (bytes-bound, 5 us); with qk-norm at
// DiT-XL/1's (B=32, N=256, H=18) it moves 75.5 MB and does 9.7 GFLOP
// (bytes-bound, 22.5 us). The bf16 arm redoes each K tile's prologue in
// every query tile (N/64 times), and its issue slots go to that prologue
// and the softmax's exponentials more than to the products; the K and V
// tiles are re-read from L2 by every query tile. The fp32 arm moves 33.6 MB
// and does 2.15 GFLOP of fp32 FMAs (operations-bound at the 67 TFLOP/s
// non-tensor rate, 32 us). At the decode's shape its two products take
// ~48 us together, and a serial chain a step takes the rest, which the
// eight warps an SM do not hide: the wait for the step's K and V copy,
// each K tile's prologue (redone in every query tile), the softmax and the
// barrier (experiments/torch_exact_arm_variants.py drops each in turn).
// The bf16x3 arm at the decode's shape (B=8,
// N=256) moves the same 33.6 MB and does 3 x 2.15 GFLOP of bf16 products
// (6.5 us at the tensor-core rate): bytes-bound, 10 us; like the bf16 arm
// it redoes the prologue and split of each K and V tile in every query
// tile.
//
// ptxas (sm_90a; chip_smoke.py prints every kernel's registers and fails on
// a spill): bf16 arm 164 registers, 55,808 bytes of dynamic shared memory
// (three blocks an SM); bf16x3 arm 238 registers, 104,960 bytes (two);
// exact fp32 arm 206 registers, 105,984 bytes (two), no stack.

#include "tensor_core.cuh"

namespace {

// fp32 tiles: 64 token rows of kStride = 68 floats (272 bytes, an odd
// multiple of 16), the bf16x3 arm's split tiles and the exact arm's Q, K
// and V tiles.
constexpr int kF32Tile = kTile * kStride;  // floats of an fp32 tile
static_assert(kRowOf<2 * kHeadDim> * sizeof(bf16) == kStride * sizeof(float),
              "an fp32 row fills a row of 128 bf16");

// Starts the raw copy of fp32 token rows [n0, n0+64) of one head into an
// fp32 tile: a row's 256 bytes go as 128 bf16-sized elements through
// load_tile_async<128>, so half f of row threadIdx.x/2 copies the fp32
// columns [16f, 16f+16) and [32+16f, 32+16f+16), the ones its prologue then
// rewrites in the same thread. `row_stride` is in floats.
__device__ __forceinline__ void load_f32_tile_async(void* __restrict__ dst,
                                                    const float* __restrict__ src,
                                                    size_t row_stride, int n0, int N) {
  load_tile_async<2 * kHeadDim>(static_cast<bf16*>(dst), reinterpret_cast<const bf16*>(src),
                                2 * row_stride, n0, N);
}

// The fp32 arms' prologue on one thread's half of a row: x[i] is column
// 16f + i and x[16 + i] column 32 + 16f + i (the chunks load_f32_tile_async
// gave it), so the rotate-half pairs (j, j+32) are the thread's own and the
// row's other half is in the neighbouring lane: every lane of the warp
// calls this. With `w` (the (64,) fp32 RMSNorm scales): x = (x r) w in
// fp32, r = 1 / sqrt(mean of squares + 1e-5), the mean over the row summed
// from the squares or, with kHigh, from the bf16x3 halves of each square
// (the plain version's _rms_norm_high). With `rope` (`tab`: the row's RoPE
// tables, rope_fetch): rotate-half RoPE in bf16, the inputs, every product
// and each sum rounded to bf16 as the plain version's eager bf16
// arithmetic rounds them, so the row comes out bf16-valued.
template <bool kHigh>
__device__ __forceinline__ void prologue_f32_row(float (&x)[32], int f,
                                                 const float* __restrict__ w,
                                                 const RopeRow& tab, bool rope) {
  if (w != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (kHigh) {
        float hi, lo;
        split_bf16(x[i] * x[i], hi, lo);
        ss += hi + lo;
      } else {
        ss += x[i] * x[i];
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    const float inv = 1.0f / sqrtf(ss / kHeadDim + 1e-5f);
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = (x[i] * inv) * w[(i < 16 ? 16 * f : 32 + 16 * f) + (i & 15)];
  }
  if (rope) {
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      // bf16 pairs of the table rows: columns 16f + 8 part + [0, 8) (a) and 32 + the same (b)
      const __nv_bfloat162* sa = reinterpret_cast<const __nv_bfloat162*>(&tab.s[part]);
      const __nv_bfloat162* ca = reinterpret_cast<const __nv_bfloat162*>(&tab.c[part]);
      const __nv_bfloat162* sb = reinterpret_cast<const __nv_bfloat162*>(&tab.s[2 + part]);
      const __nv_bfloat162* cb = reinterpret_cast<const __nv_bfloat162*>(&tab.c[2 + part]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // rotate-half: rot[j] = -x[j+32] for j < 32, x[j-32] for j >= 32. The inputs
        // rounded to bf16 pairs; a product of two bf16 values is exact in fp32, so the
        // packed bf16 multiply rounds it once, as bf16(x * cos) does; each sum is an
        // fp32 add rounded once.
        const int i = 8 * part + 2 * e;
        const __nv_bfloat162 a = __floats2bfloat162_rn(x[i], x[i + 1]);
        const __nv_bfloat162 b = __floats2bfloat162_rn(x[16 + i], x[17 + i]);
        const float2 ac = __bfloat1622float2(__hmul2(a, ca[e]));
        const float2 bs = __bfloat1622float2(__hmul2(__hneg2(b), sa[e]));
        const float2 bc = __bfloat1622float2(__hmul2(b, cb[e]));
        const float2 as = __bfloat1622float2(__hmul2(a, sb[e]));
        const float2 ra = __bfloat1622float2(__floats2bfloat162_rn(ac.x + bs.x, ac.y + bs.y));
        const float2 rb = __bfloat1622float2(__floats2bfloat162_rn(bc.x + as.x, bc.y + as.y));
        x[i] = ra.x;
        x[i + 1] = ra.y;
        x[16 + i] = rb.x;
        x[17 + i] = rb.y;
      }
    }
  }
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

  // Online softmax state (online_softmax_tile): row max, this lane's part of
  // the row sum, the running P V.
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
    mask_and_scale_acc(s, i * kTile, row, t, n_valid, causal, 0.125f);  // 64^-1/2
    online_softmax_tile(s, m, l, o);
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
  online_softmax_finish(l, o);

  // Output tile: bf16 rows through shared memory, 16-byte stores.
  bf16* s_o = s_k;
  stage_acc_bf16<kHeadDim>(o, s_o, 16 * warp, lane);
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

// The bf16x3 arm on tensor cores (see the note above). A split tile is 64
// rows of kSplitRow = 136 bf16 (272 bytes, an odd multiple of 16, so
// ldmatrix reads it without bank conflicts): row r holds hi = bf16(x) in
// columns [0, 64) and lo = bf16(x - hi) in [64, 128) of the fp32 row x,
// which cp.async first copies raw into the same 256 bytes and split_tile
// rewrites in place. Shared memory: a ring of three stages, each a K and a
// V split tile (the Q tile is copied into the third stage's K tile before
// the ring starts, and the fp32 output tile, rows of 68 floats, is staged
// in the first stage's K tile at the end), and the two (64,) RMSNorm scale
// vectors: 104,960 bytes, two blocks an SM.
constexpr int kSplitRow = kRowOf<2 * kHeadDim>;
constexpr int kSplitTile = kTile * kSplitRow;
constexpr size_t kSmemBf16x3 =
    2 * kStages * kSplitTile * sizeof(bf16) + 2 * kHeadDim * sizeof(float);

// hi = bf16(x) and lo = bf16(x - hi) of two fp32 values, as packed pairs.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// The prologue at the bf16x3 arm's rounding points (prologue_f32_row<true>),
// then the split, in place on a split tile of token rows [n0, n0+64) that
// holds the raw fp32 rows (load_f32_tile_async). Two threads a row: half f
// of row threadIdx.x/2 owns the fp32 columns [16f, 16f+16) and
// [32+16f, 32+16f+16). With RoPE the row comes out bf16-valued and its lo
// half 0. Then hi goes to bf16 column j and lo to 64 + j. The two threads
// of a row are neighbouring lanes, and each one's bf16 columns overlap the
// other's fp32 bytes: both read before a __syncwarp and write after it, so
// every lane of the warp must call this. Rows at or past N are zeros and
// stay zeros.
__device__ __forceinline__ void split_tile(bf16* __restrict__ tile, int n0, int N,
                                           const float* __restrict__ w, const RopeRow& tab,
                                           bool rope) {
  const int row = threadIdx.x >> 1, f = threadIdx.x & 1;
  bf16* p = tile + row * kSplitRow;
  float x[32];  // x[i]: column 16f + i; x[16 + i]: column 32 + 16f + i
  const float4* src = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = src[4 * f + i], b = src[8 + 4 * f + i];
    x[4 * i] = a.x; x[4 * i + 1] = a.y; x[4 * i + 2] = a.z; x[4 * i + 3] = a.w;
    x[16 + 4 * i] = b.x; x[17 + 4 * i] = b.y; x[18 + 4 * i] = b.z; x[19 + 4 * i] = b.w;
  }
  __syncwarp();
  prologue_f32_row<true>(x, f, w, tab, rope && n0 + row < N);
  uint4* hi_out = reinterpret_cast<uint4*>(p);
  uint4* lo_out = reinterpret_cast<uint4*>(p + kHeadDim);
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // x[8q .. 8q+8): bf16 chunk (q < 2 ? 2f : 4 + 2f) + q % 2
    uint32_t hw[4], lw[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_pack(x[8 * q + 2 * e], x[8 * q + 2 * e + 1], hw[e], lw[e]);
    const int chunk = (q < 2 ? 2 * f : 4 + 2 * f) + (q & 1);
    hi_out[chunk] = make_uint4(hw[0], hw[1], hw[2], hw[3]);
    lo_out[chunk] = make_uint4(lw[0], lw[1], lw[2], lw[3]);
  }
}

// s = q . k^T over the head dim for the 64 keys of a split K tile, q given
// by the A fragments of its halves (qh, ql): qh k_hi^T, and with kThree
// also + qh k_lo^T + ql k_hi^T, all into one fp32 accumulator (the lo.lo
// term is dropped). Without kThree the caller knows q and k are
// bf16-valued (roped), so the two other terms are exact zeros.
template <bool kThree>
__device__ __forceinline__ void scores_split(float (&s)[8][4], const uint32_t (&qh)[4][4],
                                             const uint32_t (&ql)[4][4], const bf16* tile,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const bf16* at = tile + (16 * p + (lane & 7) + ((lane >> 4) << 3)) * kSplitRow + 16 * ks +
                       ((lane >> 3) & 1) * 8;
      uint32_t bh[4];
      ldmatrix_x4(bh, at);
      mma_bf16(s[2 * p], qh[ks], bh[0], bh[1]);
      mma_bf16(s[2 * p + 1], qh[ks], bh[2], bh[3]);
      if constexpr (kThree) {
        uint32_t bl[4];
        ldmatrix_x4(bl, at + kHeadDim);
        mma_bf16(s[2 * p], qh[ks], bl[0], bl[1]);
        mma_bf16(s[2 * p + 1], qh[ks], bl[2], bl[3]);
        mma_bf16(s[2 * p], ql[ks], bh[0], bh[1]);
        mma_bf16(s[2 * p + 1], ql[ks], bh[2], bh[3]);
      }
    }
  }
}

// o += p . v over the 64 keys of a split V tile: p (fp32, in this lane's
// accumulator layout) split into bf16 halves as the A operand, and
// p_hi v_hi + p_hi v_lo + p_lo v_hi into o.
__device__ __forceinline__ void pv_split(float (&o)[8][4], const float (&p)[8][4],
                                         const bf16* tile, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t ah[4], al[4];
    split_pack(p[2 * ks][0], p[2 * ks][1], ah[0], al[0]);
    split_pack(p[2 * ks][2], p[2 * ks][3], ah[1], al[1]);
    split_pack(p[2 * ks + 1][0], p[2 * ks + 1][1], ah[2], al[2]);
    split_pack(p[2 * ks + 1][2], p[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bf16* at = tile + (16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) * kSplitRow +
                       16 * q + (lane >> 4) * 8;
      uint32_t bh[4], bl[4];
      ldmatrix_x4_trans(bh, at);
      ldmatrix_x4_trans(bl, at + kHeadDim);
      mma_bf16(o[2 * q], ah, bh[0], bh[1]);
      mma_bf16(o[2 * q + 1], ah, bh[2], bh[3]);
      mma_bf16(o[2 * q], ah, bl[0], bl[1]);
      mma_bf16(o[2 * q + 1], ah, bl[2], bl[3]);
      mma_bf16(o[2 * q], al, bh[0], bh[1]);
      mma_bf16(o[2 * q + 1], al, bh[2], bh[3]);
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
fused_qkv_rope_attention_bf16x3_kernel(const float* __restrict__ qkv,
                                       const bf16* __restrict__ sin_t,
                                       const bf16* __restrict__ cos_t,
                                       const float* __restrict__ q_scale,
                                       const float* __restrict__ k_scale,
                                       float* __restrict__ out, int N, int H, int n_valid,
                                       int causal) {
  extern __shared__ float4 smem4[];
  bf16* s_k = reinterpret_cast<bf16*>(smem4);  // kStages K split tiles
  bf16* s_v = s_k + kStages * kSplitTile;      // kStages V split tiles
  float* s_w = reinterpret_cast<float*>(s_v + kStages * kSplitTile);  // q_scale, then k_scale
  bf16* s_q = s_k + (kStages - 1) * kSplitTile;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const float* q_src = qkv + static_cast<size_t>(b) * N * row_stride + h * kHeadDim;
  const float* k_src = q_src + D;
  const float* v_src = q_src + 2 * D;
  const bool norm = q_scale != nullptr;
  const bool rope = sin_t != nullptr;
  const int row = q0 + 16 * warp + g;  // this lane's rows: row and row + 8

  // Key tiles that hold any unmasked column for this block's rows.
  int n_kt = (n_valid + kTile - 1) / kTile;
  if (causal) {
    const int last_row = min(q0 + kTile, N) - 1;
    n_kt = min(n_kt, last_row / kTile + 1);
  }
  // One sweep over the key tiles: step i uses stage i % kStages; its copy is
  // issued two steps ahead and its K and V tiles split one step ahead.
  const int steps = n_kt;
  auto issue = [&](int i) {
    if (i < steps) {
      const int st = i % kStages;
      load_f32_tile_async(s_k + st * kSplitTile, k_src, row_stride, i * kTile, N);
      load_f32_tile_async(s_v + st * kSplitTile, v_src, row_stride, i * kTile, N);
    }
    cp_async_commit();
  };
  RopeRow tab;
  auto split_step = [&](int i) {  // this thread's rows of step i's K and V tiles
    const int st = i % kStages;
    split_tile(s_k + st * kSplitTile, i * kTile, N, norm ? s_w + kHeadDim : nullptr, tab, rope);
    split_tile(s_v + st * kSplitTile, i * kTile, N, nullptr, tab, false);
  };

  load_f32_tile_async(s_q, q_src, row_stride, q0, N);
  cp_async_commit();
  issue(0);
  issue(1);
  if (norm) {
    if (threadIdx.x < 2 * kHeadDim)
      s_w[threadIdx.x] = threadIdx.x < kHeadDim ? q_scale[threadIdx.x] : k_scale[threadIdx.x - kHeadDim];
    __syncthreads();
  }
  rope_fetch(tab, sin_t, cos_t, q0, N);
  cp_async_wait<2>();  // this thread's Q chunks
  split_tile(s_q, q0, N, norm ? s_w : nullptr, tab, rope);
  rope_fetch(tab, sin_t, cos_t, 0, N);
  cp_async_wait<1>();  // and its chunks of step 0
  split_step(0);
  __syncthreads();
  uint32_t qh[4][4], ql[4][4];
  load_a_rows<kHeadDim, kSplitRow>(qh, s_q, 16 * warp, lane);
  load_a_rows<kHeadDim, kSplitRow>(ql, s_q + kHeadDim, 16 * warp, lane);
  __syncthreads();  // s_q is the stage that step 2 refills

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < steps; ++i) {
    issue(i + 2);
    const bool next = i + 1 < steps;
    if (next) rope_fetch(tab, sin_t, cos_t, (i + 1) * kTile, N);
    cp_async_wait<1>();  // this thread's chunks of step i + 1
    const int st = i % kStages;
    float s[8][4];
    if (rope) {
      scores_split<false>(s, qh, ql, s_k + st * kSplitTile, lane);
    } else {
      scores_split<true>(s, qh, ql, s_k + st * kSplitTile, lane);
    }
    mask_and_scale_acc(s, i * kTile, row, t, n_valid, causal, 0.125f);  // 64^-1/2
    online_softmax_tile(s, m, l, o);  // p stays fp32
    pv_split(o, s, s_v + st * kSplitTile, lane);
    // Split step i + 1's tiles (this thread's own chunks) while other warps
    // still multiply; the barrier publishes them and frees stage i's buffers.
    if (next) split_step(i + 1);
    __syncthreads();
  }
  online_softmax_finish(l, o);

  // Output tile: fp32 rows through shared memory, 16-byte stores.
  float* s_o = reinterpret_cast<float*>(s_k);
  stage_acc(o, s_o, 16 * warp, lane);
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kTile * 16 / kTcThreads; ++it) {
    const int id = threadIdx.x + kTcThreads * it;
    const int r = id >> 4, chunk = id & 15;
    const int n = q0 + r;
    if (n < N) {
      *reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * N + n) * D + h * kHeadDim +
                                 4 * chunk) =
          *reinterpret_cast<const float4*>(s_o + r * kStride + 4 * chunk);
    }
  }
}

int launch_bf16x3(const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
                  const void* k_scale, void* out, int B, int N, int H, int n_valid, int causal,
                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_qkv_rope_attention_bf16x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBf16x3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_qkv_rope_attention_bf16x3_kernel<<<grid, kTcThreads, kSmemBf16x3, stream>>>(
      static_cast<const float*>(qkv), static_cast<const bf16*>(sin_t),
      static_cast<const bf16*>(cos_t), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<float*>(out), N, H, n_valid, causal);
  return static_cast<int>(cudaGetLastError());
}

// The exact fp32 arm (see the note above). A lane owns kF32Rows query rows,
// a warp 4 kF32Rows, a block kF32Q. Shared memory: the Q tile, a ring of
// two stages each a K and a V tile, the warps' P rows (kF32Q rows of 64
// keys, kPRow floats a row) and the two (64,) RMSNorm scale vectors:
// 105,984 bytes, two blocks an SM. (Eight rows a lane spill at 255
// registers.)
constexpr int kF32Rows = 4;
constexpr int kF32Q = 16 * kF32Rows;  // query rows a block
constexpr int kF32Stages = 2;
constexpr int kPRow = kTile + 8;  // 72 floats: a warp's scalar P stores fall in 32 banks
constexpr size_t kSmemF32 =
    ((kF32Q / kTile + 2 * kF32Stages) * kF32Tile + kF32Q * kPRow + 2 * kHeadDim) * sizeof(float);
static_assert(kF32Q % kTile == 0, "the Q tile is whole 64-row tiles");

// The exact arm's prologue (prologue_f32_row) in place on an fp32 tile of
// token rows [n0, n0+64) that holds the raw rows: each thread rewrites the
// chunks it copied (load_f32_tile_async), so it needs only its own
// cp.async wait; every lane of the warp calls this. Rows at or past N are
// zeros and stay zeros.
__device__ __forceinline__ void prologue_f32_tile(float* __restrict__ tile, int n0, int N,
                                                  const float* __restrict__ w,
                                                  const RopeRow& tab, bool rope) {
  const int row = threadIdx.x >> 1, f = threadIdx.x & 1;
  float4* a = reinterpret_cast<float4*>(tile + row * kStride + 16 * f);
  float4* b = reinterpret_cast<float4*>(tile + row * kStride + 32 + 16 * f);
  float x[32];  // x[i]: column 16f + i; x[16 + i]: column 32 + 16f + i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 u = a[i], v = b[i];
    x[4 * i] = u.x; x[4 * i + 1] = u.y; x[4 * i + 2] = u.z; x[4 * i + 3] = u.w;
    x[16 + 4 * i] = v.x; x[17 + 4 * i] = v.y; x[18 + 4 * i] = v.z; x[19 + 4 * i] = v.w;
  }
  prologue_f32_row<false>(x, f, w, tab, rope && n0 + row < N);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    b[i] = make_float4(x[16 + 4 * i], x[17 + 4 * i], x[18 + 4 * i], x[19 + 4 * i]);
  }
}

__device__ __forceinline__ float float4_at(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// s[r][e] = q_r . k_e over the head dim, in order, by plain FFMA: q_r is the
// fp32 row at q + 4r kStride and k_e the row at k + 8e kStride (this lane's
// query rows and keys). Each step of four head-dim columns loads the
// kF32Rows q rows and the eight k rows once (16-byte loads) for
// 32 kF32Rows FFMA.
__device__ __forceinline__ void scores_f32(float (&s)[kF32Rows][8], const float* __restrict__ q,
                                           const float* __restrict__ k) {
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[r][e] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 4) {
    float4 qv[kF32Rows];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) qv[r] = *reinterpret_cast<const float4*>(q + 4 * r * kStride + d);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float4 kv = *reinterpret_cast<const float4*>(k + 8 * e * kStride + d);
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        s[r][e] = fmaf(qv[r].x, kv.x, s[r][e]);
        s[r][e] = fmaf(qv[r].y, kv.y, s[r][e]);
        s[r][e] = fmaf(qv[r].z, kv.z, s[r][e]);
        s[r][e] = fmaf(qv[r].w, kv.w, s[r][e]);
      }
    }
  }
}

// o[r][c] += sum_j p_r[j] v_j[c] over the tile's 64 keys, in order, by plain
// FFMA: p_r is the warp's P row at p + 4r kPRow, v_j the row at v + j kStride
// read at its columns [0, 4) (o[r][0..4)) and [32, 36) (o[r][4..8)). Each
// step of four keys loads the kF32Rows p rows and the eight v row pieces
// once (16-byte loads) for 32 kF32Rows FFMA.
__device__ __forceinline__ void pv_f32(float (&o)[kF32Rows][8], const float* __restrict__ p,
                                       const float* __restrict__ v) {
#pragma unroll
  for (int j = 0; j < kTile; j += 4) {
    float4 pv[kF32Rows];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) pv[r] = *reinterpret_cast<const float4*>(p + 4 * r * kPRow + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 va = *reinterpret_cast<const float4*>(v + (j + jj) * kStride);
      const float4 vb = *reinterpret_cast<const float4*>(v + (j + jj) * kStride + 32);
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const float pr = float4_at(pv[r], jj);
        o[r][0] = fmaf(pr, va.x, o[r][0]);
        o[r][1] = fmaf(pr, va.y, o[r][1]);
        o[r][2] = fmaf(pr, va.z, o[r][2]);
        o[r][3] = fmaf(pr, va.w, o[r][3]);
        o[r][4] = fmaf(pr, vb.x, o[r][4]);
        o[r][5] = fmaf(pr, vb.y, o[r][5]);
        o[r][6] = fmaf(pr, vb.z, o[r][6]);
        o[r][7] = fmaf(pr, vb.w, o[r][7]);
      }
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
fused_qkv_rope_attention_f32_kernel(const float* __restrict__ qkv,
                                    const bf16* __restrict__ sin_t,
                                    const bf16* __restrict__ cos_t,
                                    const float* __restrict__ q_scale,
                                    const float* __restrict__ k_scale,
                                    float* __restrict__ out, int N, int H, int n_valid,
                                    int causal) {
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);   // kF32Q / 64 tiles
  float* s_k = s_q + kF32Q / kTile * kF32Tile;     // kF32Stages K tiles
  float* s_v = s_k + kF32Stages * kF32Tile;        // kF32Stages V tiles
  float* s_p = s_v + kF32Stages * kF32Tile;        // the warps' P rows
  float* s_w = s_p + kF32Q * kPRow;                // q_scale, then k_scale

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int q0 = blockIdx.x * kF32Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * kHeadDim;
  const size_t row_stride = 3 * static_cast<size_t>(D);
  const float* q_src = qkv + static_cast<size_t>(b) * N * row_stride + h * kHeadDim;
  const float* k_src = q_src + D;
  const float* v_src = q_src + 2 * D;
  const bool norm = q_scale != nullptr;
  const bool rope = sin_t != nullptr;
  const bool prologue = norm || rope;
  const int row0 = q0 + 4 * kF32Rows * warp + rg;  // this lane's query rows: row0 + 4r

  // Key tiles that hold any unmasked column for this block's rows.
  int n_kt = (n_valid + kTile - 1) / kTile;
  if (causal) {
    const int last_row = min(q0 + kF32Q, N) - 1;
    n_kt = min(n_kt, last_row / kTile + 1);
  }
  // One sweep over the key tiles: step i uses stage i % kF32Stages; its copy
  // is issued at the start of step i - 1 and its K tile roped at that step's end.
  auto issue = [&](int i) {
    if (i < n_kt) {
      const int st = i % kF32Stages;
      load_f32_tile_async(s_k + st * kF32Tile, k_src, row_stride, i * kTile, N);
      load_f32_tile_async(s_v + st * kF32Tile, v_src, row_stride, i * kTile, N);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kF32Q / kTile; ++t)
    load_f32_tile_async(s_q + t * kF32Tile, q_src, row_stride, q0 + t * kTile, N);
  cp_async_commit();
  issue(0);
  if (norm) {
    if (threadIdx.x < 2 * kHeadDim)
      s_w[threadIdx.x] = threadIdx.x < kHeadDim ? q_scale[threadIdx.x] : k_scale[threadIdx.x - kHeadDim];
    __syncthreads();
  }
  RopeRow tab;
  if (prologue) {
    cp_async_wait<1>();  // this thread's Q chunks
#pragma unroll
    for (int t = 0; t < kF32Q / kTile; ++t) {
      rope_fetch(tab, sin_t, cos_t, q0 + t * kTile, N);
      prologue_f32_tile(s_q + t * kF32Tile, q0 + t * kTile, N, norm ? s_w : nullptr, tab, rope);
    }
    rope_fetch(tab, sin_t, cos_t, 0, N);
    cp_async_wait<0>();  // and its chunks of step 0
    prologue_f32_tile(s_k, 0, N, norm ? s_w + kHeadDim : nullptr, tab, rope);
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  const float* q = s_q + (4 * kF32Rows * warp + rg) * kStride;
  float* p_rows = s_p + 4 * kF32Rows * warp * kPRow;  // this warp's P rows
  // Online softmax state: each row's running max (the same in the row's
  // eight lanes), this lane's part of its running sum of exp(s - m), and the
  // running P V.
  float m[kF32Rows], l[kF32Rows], o[kF32Rows][8];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[r][c] = 0.f;
  }

  for (int i = 0; i < n_kt; ++i) {
    issue(i + 1);  // into the stage that step i - 1 used, freed by its closing barrier
    const bool next = prologue && i + 1 < n_kt;
    if (next) rope_fetch(tab, sin_t, cos_t, (i + 1) * kTile, N);
    const int st = i % kF32Stages;
    float s[kF32Rows][8];
    scores_f32(s, q, s_k + st * kF32Tile + cg * kStride);
    if (causal || (i + 1) * kTile > n_valid) {
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = i * kTile + cg + 8 * e;
          s[r][e] = (col >= n_valid || (causal && col > row0 + 4 * r)) ? -INFINITY
                                                                       : s[r][e] * 0.125f;  // 64^-1/2
        }
      }
    } else {  // every key of the tile is valid for every row
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
#pragma unroll
        for (int e = 0; e < 8; ++e) s[r][e] *= 0.125f;
      }
    }
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      float mt = s[r][0];
#pragma unroll
      for (int e = 1; e < 8; ++e) mt = fmaxf(mt, s[r][e]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[r], mt);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float rescale = expf(m[r] - base);  // 0 while m is -inf
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float p = expf(s[r][e] - base);  // 0 where masked; stays fp32
        part += p;
        p_rows[(rg + 4 * r) * kPRow + cg + 8 * e] = p;
      }
      l[r] = l[r] * rescale + part;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[r][c] *= rescale;
    }
    __syncwarp();
    pv_f32(o, p_rows + rg * kPRow, s_v + st * kF32Tile + 4 * cg);
    cp_async_wait<0>();  // this thread's chunks of step i + 1
    if (next) {
      prologue_f32_tile(s_k + ((i + 1) % kF32Stages) * kF32Tile, (i + 1) * kTile, N,
                        norm ? s_w + kHeadDim : nullptr, tab, rope);
    }
    __syncthreads();  // publishes step i + 1's tiles; frees stage i and the P rows
  }

#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
    const float inv = 1.0f / l[r];  // every row has an unmasked key (key 0), so l > 0
    const int n = row0 + 4 * r;
    if (n < N) {
      float* orow = out + (static_cast<size_t>(b) * N + n) * D + h * kHeadDim + 4 * cg;
      *reinterpret_cast<float4*>(orow) =
          make_float4(o[r][0] * inv, o[r][1] * inv, o[r][2] * inv, o[r][3] * inv);
      *reinterpret_cast<float4*>(orow + 32) =
          make_float4(o[r][4] * inv, o[r][5] * inv, o[r][6] * inv, o[r][7] * inv);
    }
  }
}

int launch_f32(const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
               const void* k_scale, void* out, int B, int N, int H, int n_valid, int causal,
               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_qkv_rope_attention_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemF32));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kF32Q - 1) / kF32Q, H, B);
  fused_qkv_rope_attention_f32_kernel<<<grid, kTcThreads, kSmemF32, stream>>>(
      static_cast<const float*>(qkv), static_cast<const bf16*>(sin_t),
      static_cast<const bf16*>(cos_t), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<float*>(out), N, H, n_valid, causal);
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
  return launch_f32(qkv, sin_t, cos_t, q_scale, k_scale, out, B, N, H, n_valid, causal, device,
                    stream);
}

// The fp32 bf16x3 arm: the same arguments as the fp32 arm.
extern "C" int vtp_fused_qkv_rope_attention_f32_bf16x3(
    const void* qkv, const void* sin_t, const void* cos_t, const void* q_scale,
    const void* k_scale, void* out, int B, int N, int H, int n_valid,
    int causal, int device, cudaStream_t stream) {
  return launch_bf16x3(qkv, sin_t, cos_t, q_scale, k_scale, out, B, N, H, n_valid, causal,
                       device, stream);
}
