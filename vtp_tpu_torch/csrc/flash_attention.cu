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
// Design: the fused forward's bf16 arm on tensor cores (tensor_core.cuh)
// without its prologue, templated on the head dim D (32, 64, 128). One block
// per (query tile of 64 rows, head, batch row): four warps, warp w owning
// query rows [16w, 16w+16). Q, K and V tiles are copied raw by cp.async
// into bf16 tiles in shared memory (rows padded to D + 8), each from its own
// strided source: the batch and head go into the base pointer, the token
// stride is the row stride, so views are read in place. The Q tile's A
// fragments stay in registers; K and V tiles stream through a ring of
// three stages (the copy of step i + 2 is issued at step i, one barrier a
// step). Products: mma.sync.m16n8k16 bf16 with fp32 accumulators, S = Q K^T
// a 16 x 64 accumulator a warp, O += P V a 16 x D one, fragments by
// ldmatrix (.trans for V). Softmax is one sweep (FlashAttention-2's online
// form, online_softmax_tile): per key tile the row max m moves, o and the
// fp32 sum l are rescaled, p = exp(s - m) is rounded to bf16 as the A
// operand of P V, and o is divided by l (the sum of the unrounded
// exponentials) at the end. Keys past N are masked by bounds (n_valid = N,
// no causal mask); warps whose 16 rows all lie at or past N (three of the
// four in the text path's second query tile, N = 77) skip their products
// and keep the block's barriers. The output tile is staged through shared
// memory into 16-byte stores.
//
// Rounding. Both products take the plain version's bf16 operands exactly
// (q, k, v and the bf16 p), so they differ from it only in the order of
// their fp32 sums, except at one point: the plain version rounds
// p = exp(s - max) / sum to bf16, the kernel rounds exp(s - m_running)
// before the row's final max and sum are known and divides afterwards.
// bf16 keeps 8 significant bits, so each rounding is off by up to 2^-8 of
// p, a key's two weights differ by up to 2^-7 of p, and an output before
// its own rounding differs from the plain version's by up to
// 2^-7 * sum_k p_k |v_k|. That is no bound by one output ulp, nor by 2^-7
// of max|ref| where v's values cancel: the 1e-2-of-max|ref| gate holds
// because the per-key errors have random signs and largely cancel, which
// chip_smoke.py's check_edges_flash measures at every head dim, both
// entries and N in EDGE_N over several seeds. At N = 1 the output is v
// exactly (p = 1).
//
// Resources (ptxas, sm_90a; chip_smoke.py prints them from the build's
// report): D = 32, 64, 128 take 128, 155 and 240 registers, no stack, and
// 2 * 3 * 64 * (D + 8) * 2 bytes of dynamic shared memory (30,720, 55,296,
// 104,448); __launch_bounds__ asks for 4, 3 and 2 blocks an SM.
//
// Bound on an H100: at the head-major trunk's shape (B=8, N=257, H=16, d=64)
// the call moves 16.8 MB and does 2.16 GFLOP; at the text tower's
// (B=32, H=12, N=77, d=64), 15.1 MB and 0.58 GFLOP. Both are bytes-bound
// (5 us and 4.5 us at 3.35 TB/s). The kernel re-reads K and V from L2 once
// per query tile, and a block runs only ceil(N/64) steps, so its time goes
// to the latency of each step (copy, products, exponentials, barrier) more
// than to bytes or products.

#include "tensor_core.cuh"

namespace {

struct Strides {
  long long b, n, h;
};

// Blocks an SM that __launch_bounds__ asks for: the shared memory of D = 128
// admits two; D = 64 keeps the fused forward's three (at most 170
// registers a thread).
template <int D>
constexpr int kFlashBlocks = D == 128 ? 2 : (D == 64 ? 3 : 4);

// Shared memory: a ring of three stages, each a K and a V tile (the Q tile
// is copied into the third stage's K tile before the ring starts, and the
// output tile is staged in the first stage's K tile at the end).
template <int D>
constexpr size_t flash_smem_bytes() {
  return 2 * kStages * kTile * kRowOf<D> * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kFlashBlocks<D>)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int N, Strides sq,
                       Strides sk, Strides sv, Strides so, float scale) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kT = kTile * kRowOf<D>;
  extern __shared__ float4 smem4[];
  bf16* s_k = reinterpret_cast<bf16*>(smem4);  // kStages K tiles
  bf16* s_v = s_k + kStages * kT;              // kStages V tiles
  bf16* s_q = s_k + (kStages - 1) * kT;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* q_src = q + b * sq.b + h * sq.h;
  const bf16* k_src = k + b * sk.b + h * sk.h;
  const bf16* v_src = v + b * sv.b + h * sv.h;
  const int row = q0 + 16 * warp + (lane >> 2);  // this lane's rows: row and row + 8
  const bool active = q0 + 16 * warp < N;        // the warp has a row below N

  const int steps = (N + kTile - 1) / kTile;  // key tiles; step i uses stage i % kStages
  auto issue = [&](int i) {
    if (i < steps) {
      const int st = i % kStages;
      load_tile_rows_async<D>(s_k + st * kT, k_src, sk.n, i * kTile, N);
      load_tile_rows_async<D>(s_v + st * kT, v_src, sv.n, i * kTile, N);
    }
    cp_async_commit();
  };

  load_tile_rows_async<D>(s_q, q_src, sq.n, q0, N);
  cp_async_commit();
  issue(0);
  issue(1);
  cp_async_wait<1>();  // the Q tile and step 0
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_a_rows<D>(qa, s_q, 16 * warp, lane);
  __syncthreads();  // s_q is the stage that step 2 refills

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < steps; ++i) {
    issue(i + 2);
    if (active) {
      const int st = i % kStages;
      float s[8][4];
      mma_a_tileT<8, D>(s, qa, s_k + st * kT, 0, lane);
      mask_and_scale_acc(s, i * kTile, row, t, N, 0, scale);
      online_softmax_tile(s, m, l, o);
      uint32_t pa[4][4];
      acc_to_a<8>(s, pa);  // p rounded to bf16 here, before its row's final max and sum are known
      mma_a_tile<4, D>(o, pa, s_v + st * kT, 0, lane);
    }
    cp_async_wait<1>();  // this thread's chunks of step i + 1
    __syncthreads();     // publishes step i + 1; frees stage i
  }
  if (active) online_softmax_finish(l, o);

  // Output tile: bf16 rows through shared memory, 16-byte stores.
  bf16* s_o = s_k;
  stage_acc_bf16<D>(o, s_o, 16 * warp, lane);
  __syncthreads();
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kTcThreads; ++it) {
    const int id = threadIdx.x + kTcThreads * it;
    const int r = id / kChunks, chunk = id % kChunks;
    const int n = q0 + r;
    if (n < N) {
      *reinterpret_cast<uint4*>(out + b * so.b + static_cast<long long>(n) * so.n + h * so.h +
                                8 * chunk) =
          *reinterpret_cast<const uint4*>(s_o + r * kRowOf<D> + 8 * chunk);
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
  flash_attention_kernel<D><<<grid, kTcThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), N, sq, sk, sv, so, scale);
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
