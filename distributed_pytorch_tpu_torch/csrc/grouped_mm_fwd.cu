// grouped_mm_fwd: the ragged grouped matmul of a dropless MoE dispatch,
// y[r] = x_pad[r] @ W[tile_group[r / bm]] (times the row's fp32 gate in the
// scaled form, applied at the output write, then rounded once), with fp32
// accumulation over operands in their own dtype. Built and bound by
// ops/cuda_build.py; wrapped by ops/grouped_matmul.py.
//
// Replaces: `_fwd_kernel` :111 and `_fwd_kernel_scaled` :105 -> `_fwd_call`
// :148 (pallas_call :169) of distributed_pytorch_tpu/ops/grouped_matmul.py.
// The TPU's grid (token tiles, N tiles) with the tile's expert taken from a
// scalar-prefetched tile_group becomes one CTA per (128-row tile, block of
// output columns) that reads tile_group from device memory itself. Every
// row tile is computed, trailing ones included, as the plain version does.
//
// Bound on the H100: operations — 2 P K N FLOP (80.5 GFLOP, 0.081 ms in
// bf16 for the flagship's fc product at P 25600, K 768, N 2048; 40.3 GFLOP
// for proj).
//
// The dtype picks the kernel before launch; it is not a fallback (a launch
// that fails returns its error, and the wrapper raises):
// * fp32 (`gmm_kernel<float, FWD>`): the FMA design of
//   grouped_mm_common.cuh (tensor cores take fp32 only as TF32).
// * bf16 (`fwd_kernel_sm90`): tensor cores, the design of the bf16 dx
//   (grouped_mm_bwd.cu). One CTA of two consumer warpgroups and one
//   producer warp (288 threads) per 128 x 256 block of y; warpgroup w owns
//   rows m0 + 64 w .. m0 + 64 w + 63, all 256 columns (m64n256k16
//   products, 128 accumulator registers a thread). The producer streams
//   64-column k-steps through a 4-stage TMA ring of 48 KB stages (192 KB:
//   one CTA an SM); `full` barriers count the bytes in, `empty` barriers
//   (one arrival per consumer warp) hand a stage back once its products
//   are done. A = the x row tile [128 rows][64 columns of K], a 2-D map
//   read K-major. B = W_e [64 rows of K][256 columns of N]: N is
//   contiguous and the contraction runs along the rows, so it is read
//   MN-major (the transpose bit, as the dW kernel reads dy), as four
//   64-column boxes of a 3-D map over (E, K, N): a box running past K of
//   expert e is zero-filled instead of reading expert e + 1's rows, and
//   the x box past K is zero-filled too, so widths off the tiles stay
//   exact. A box wholly past N is not requested: what it would feed is
//   not stored. Each warpgroup keeps one k-step's products in flight
//   while it waits for the next (wgmma wait 1), with no C++ branch between
//   a product's issue and its wait (mbarrier waits and the release are
//   PTX): ptxas serializes wgmmas in flight across a branch. The grid
//   runs the column blocks on its fastest axis, so the CTAs of one x row
//   tile run together and x is read from device memory about once (the
//   mma.sync design before it read x once per 128 columns: 16x for fc, 6x
//   for proj) while the W stacks (<= 28 MB) stay in the 50 MB L2. The gate
//   is a template parameter, applied in the epilogue: the fp32 row times
//   its fp32 gate, rounded once to bf16, as the reference's
//   `_fwd_kernel_scaled` does; nothing touches the tiles in shared memory.
//   The epilogue stages the bf16 block of y in the (then idle) ring and
//   writes it as whole 16-byte vectors along the rows, bounded at N (P is
//   whole row tiles): y is the largest operand (105 MB for fc), and on the
//   H100 a first build that wrote the accumulator fragments straight to
//   device memory, 4 bytes a thread, ran about a third slower.

#include "grouped_mm_common.cuh"
#include "sm90_common.cuh"

namespace gmm {

constexpr int kFwdBN = 256;                      // y columns of a CTA
constexpr int kFwdBK = 64;                       // K columns a stage (W rows)
constexpr int kFwdStages = 4;
constexpr int kFwdConsumers = 256;               // two consumer warpgroups
constexpr int kFwdThreads = kFwdConsumers + 32;  // + the producer warp

struct FwdSmem {
  // [stage][128 rows][64 columns], swizzled
  alignas(1024) __nv_bfloat16 x[kFwdStages][BM * kFwdBK];
  // [stage][sub-tile of 64 N-columns][64 K-rows][64 columns], swizzled
  alignas(1024) __nv_bfloat16 w[kFwdStages][kFwdBK * kFwdBN];
  uint64_t full[kFwdStages], empty[kFwdStages];
};

struct FwdMaps {
  CUtensorMap x, w;
};

template <bool SCALED>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_kernel_sm90(const __grid_constant__ FwdMaps mp, const Params p) {
  using namespace ::sm90;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = smem_aligned<FwdSmem>(smem_raw);
  const int n0 = blockIdx.x * kFwdBN;  // y columns (over N): the fastest axis
  const int m0 = blockIdx.y * BM;      // y rows (over P)
  const int e = p.tile_group[m0 / p.bm];
  const int nk = (p.K + kFwdBK - 1) / kFwdBK;
  const int nb = min(kFwdBN / 64, (p.N - n0 + 63) / 64);  // W boxes inside N
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kFwdConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kFwdConsumers / 32) {  // the producer warp: one lane issues
    if (lane == 0)
      for (int c = 0; c < nk; ++c) {
        const int s = c % kFwdStages;
        if (c >= kFwdStages) mbar_wait(&sm.empty[s], (c / kFwdStages - 1) & 1);
        mbar_expect_tx(&sm.full[s], (BM + 64 * nb) * kFwdBK * 2);
        tma_load_2d(sm.x[s], &mp.x, &sm.full[s], c * kFwdBK, m0);
        for (int i = 0; i < nb; ++i)
          tma_load_3d(sm.w[s] + i * kFwdBK * 64, &mp.w, &sm.full[s], n0 + 64 * i, c * kFwdBK, e);
      }
    return;
  }

  const int wg = tid >> 7, w = warp & 3;
  static_assert(BM * (kFwdBN + 8) * 2 <= sizeof(FwdSmem), "the epilogue's rows fit the ring");
  float acc[kFwdBN / 2];
#pragma unroll
  for (int i = 0; i < kFwdBN / 2; ++i) acc[i] = 0.f;

  for (int c = 0; c < nk; ++c) {
    const int s = c % kFwdStages;
    mbar_wait(&sm.full[s], (c / kFwdStages) & 1);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdBK / 16; ++kk)
      wgmma_ss<kFwdBN, 0, 1>(acc, desc_kmajor<BM>(sm.x[s] + wg * 64 * kFwdBK, kk),
                             desc_mnmajor<kFwdBK>(sm.w[s], kk), 1);
    wg_commit();
    wg_wait<1>();  // the products of k-step c - 1 are done: free its stage
    fence_regs(acc);
    mbar_arrive_if(&sm.empty[(c + kFwdStages - 1) % kFwdStages], lane == 0 && c > 0);
  }
  wg_wait<0>();
  fence_regs(acc);

  // The epilogue goes through shared memory (the ring is free once both
  // warpgroups are done with it), so that the 64 KB block of y leaves as
  // whole 16-byte vectors along its rows. Rows are padded by 16 bytes
  // (132 words: 4 banks on), so a warp's fragment writes hit 32 banks.
  constexpr int LDY = kFwdBN + 8;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(&sm);  // [BM][LDY]
  bar_sync(1, kFwdConsumers);
  const int r0 = 64 * wg + w * 16 + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);                  // and columns 8 j + c0 + {0, 1}
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int r = r0 + 8 * ih;
    const float gate = SCALED ? p.scale[m0 + r] : 1.f;
#pragma unroll
    for (int jj = 0; jj < kFwdBN / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(ys + r * LDY + 8 * jj + c0) = __floats2bfloat162_rn(
          acc[4 * jj + 2 * ih] * gate, acc[4 * jj + 2 * ih + 1] * gate);
  }
  bar_sync(1, kFwdConsumers);
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.out);
  for (int i = tid; i < BM * kFwdBN / 8; i += kFwdConsumers) {
    const int r = i / (kFwdBN / 8), c = (i % (kFwdBN / 8)) * 8;
    if (n0 + c < p.N)
      *reinterpret_cast<uint4*>(y + (long long)(m0 + r) * p.N + n0 + c) =
          *reinterpret_cast<const uint4*>(ys + r * LDY + c);
  }
}

template <bool SCALED>
int launch_fwd(const Params& p, const FwdMaps& mp, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(FwdSmem) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(fwd_kernel_sm90<SCALED>, smem, cap);
  if (err) return err;
  const dim3 grid((p.N + kFwdBN - 1) / kFwdBN, p.P / BM);
  fwd_kernel_sm90<SCALED><<<grid, kFwdThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

int launch_fwd_sm90(const Params& p, void* stream) {
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  if (p.P == 0) return 0;
  FwdMaps mp;
  if (!::sm90::mat_map(&mp.x, p.a, p.P, p.K, BM) ||
      !::sm90::experts_map(&mp.w, p.b, p.E, p.K, p.N, kFwdBK))
    return (int)cudaErrorInvalidValue;
  return p.scale != nullptr ? launch_fwd<true>(p, mp, stream) : launch_fwd<false>(p, mp, stream);
}

}  // namespace gmm

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the wgmma kernel),
// for x (P, K), w (E, K, N) and y (P, N), all contiguous and 16-byte
// aligned; scale (P,) fp32 or null; tile_group (P / bm,) int32. K and N
// multiples of 8, bm a multiple of 128 dividing P. Returns the launch's
// cudaError_t (0 = success).
extern "C" int grouped_mm_fwd(int dtype, const void* x, const void* w, const float* scale,
                              const int* tile_group, void* y, int P, int K, int N, int E, int bm,
                              void* stream) {
  gmm::Params p{};
  p.a = x;
  p.b = w;
  p.scale = scale;
  p.tile_group = tile_group;
  p.out = y;
  p.P = P;
  p.K = K;
  p.N = N;
  p.E = E;
  p.bm = bm;
  if (dtype == 0) return gmm::launch<float, gmm::FWD>(p, stream);
  if (dtype == 1) return gmm::launch_fwd_sm90(p, stream);
  return (int)cudaErrorInvalidValue;
}
