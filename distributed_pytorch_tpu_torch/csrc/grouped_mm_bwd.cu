// grouped_mm_bwd_dx / grouped_mm_bwd_dw: the gradients of grouped_mm_fwd
// with respect to the packed rows and the expert weights,
//   dx[r] = (dy[r] * gate[r]) @ W[tile_group[r / bm]]^T   (P, K), dy's dtype
//   dW[e] = sum over e's rows r of x_pad[r]^T (dy[r] * gate[r])  (E, K, N), fp32
// where dy * gate is rounded to the operand dtype before the product, as
// the reference rounds it (gate = 1 in the unscaled form). Built and bound
// by ops/cuda_build.py; wrapped by ops/grouped_matmul.py.
//
// Replaces: `_dx_kernel` :122 / `_dx_kernel_scaled` :116 -> `_dx_call` :178
// (pallas_call :199), and `_dw_kernel` :127 -> `_dw_call_impl` :208
// (pallas_call :231) of distributed_pytorch_tpu/ops/grouped_matmul.py.
// dx runs token-major as on the TPU: one CTA per (128-row tile, 128
// columns of K), the tile's expert read from tile_group; every row tile is
// computed, trailing ones included (the plain version computes them too).
// The TPU's dW sums over a sequential token-tile grid axis,
// resetting its VMEM block at each expert's first tile; here one CTA per
// (expert, 128 x 128 block of dW) loops over that expert's own rows and
// writes its fp32 sum once — no atomics, deterministic, and zeros for an
// expert with no rows (the reference masks those after the call).
// Trailing tiles past the last expert's rows are never visited: they hold
// gate-0 rows (proj) or zero dy rows (fc), which add nothing.
//
// Bound on the H100: operations — 2 P K N FLOP each (80.5 / 40.3 GFLOP,
// 0.081 / 0.041 ms in bf16 for the flagship's fc / proj).
//
// The dtype picks each kernel before launch; it is not a fallback (a
// launch that fails returns its error, and the wrapper raises):
// * fp32 dx and dW (`gmm_kernel<float, DX / DW>`): the FMA design of
//   grouped_mm_common.cuh (tensor cores take fp32 only as TF32).
// * bf16 dx (`dx_kernel_sm90`): tensor cores. Both operands are K-major
//   (dy rows [m][n], W_e [k][n] read as W_e^T), the plain wgmma case. One
//   CTA of two consumer warpgroups and one producer warp (288 threads) per
//   128 x 256 block of dx; warpgroup w owns rows m0 + 64 w .. m0 + 64 w +
//   63, all 256 columns (m64n256k16 products, 128 accumulator registers a
//   thread). The producer streams 64-column k-steps of the dy tile (a 2-D
//   map) and of W_e (a 3-D map over (E, K, N), so a box running past K of
//   expert e is zero-filled instead of reading expert e + 1's rows)
//   through a 4-stage TMA ring of 48 KB stages (192 KB: one CTA an SM);
//   `full` barriers count the bytes in, `empty` barriers (one arrival per
//   consumer warp) hand a stage back once its products are done. Each
//   warpgroup keeps one k-step's products in flight while it waits for the
//   next (wgmma wait 1), with no C++ branch between a product's issue and
//   its wait (mbarrier waits and the release are PTX): ptxas serializes
//   wgmmas in flight across a branch. The tiles' traffic from L2 into
//   shared memory is what the block size trades: a 256-column block reads
//   each dy tile once for twice the columns (the fc product reads ~0.9 GB
//   of tiles a call instead of ~1.2 GB at 128 x 128), and on the H100 it
//   ran faster than a 128 x 128 block with two CTAs an SM. The grid runs
//   the column blocks on its fastest axis, so the CTAs of one dy row tile
//   run together and dy is read from device memory about once (the first
//   design read it once per 128 columns: 6x for fc, 8x for proj) while
//   the W stacks (<= 28 MB) stay in the 50 MB L2. The gate is a template
//   parameter: proj's consumer threads scale
//   each landed dy tile in place, bf16(dy * gate) as the reference rounds
//   it; thread t takes one half-row of row t / 2, so each warpgroup scales
//   exactly its own 64 rows (the swizzle only permutes 16-byte chunks
//   within a row) and meets only its own 128 threads at a named barrier
//   after fencing the async proxy.
// * bf16 dW (`dw_kernel_sm90`): tensor cores. One CTA of two warpgroups
//   (256 threads) per (K block, N block, expert), experts on the grid's
//   slowest axis so that the shared expert (every token's row) starts
//   first; warpgroup w owns dW rows m0 + 64 w .. m0 + 64 w + 63. Thread 0
//   streams the expert's rows through a 3-stage TMA ring, a stage being
//   one 128-row tile: the x tile [128 rows][128 K-columns] and the dy tile
//   [128 rows][128 N-columns], 32 KB each as two 64-column sub-tiles with
//   the 128-byte swizzle (192 KB in all: one CTA an SM). The product
//   dW += x^T dy reads both tiles MN-major (the contraction runs along
//   the rows): x^T through the A operand's transpose bit, dy through
//   B's, 8 m64n128k16 wgmmas a tile and warpgroup. Each tile is summed
//   into a fresh fp32 partial (scale-d 0 on its first k-step) that is
//   then added to the accumulator, the plain version's per-tile order, so
//   the tensor cores never accumulate over more than 128 rows. gstart is
//   a multiple of bm (itself a multiple of 128), so tiles start aligned;
//   TMA zero-fills rows past P and columns past K and N, and a 64-column
//   box wholly past K or N is not requested (what it would feed is not
//   stored). Each dW block is written once, bounded at K and N.
//   The gate is a template parameter (fc unscaled, proj scaled). proj's
//   consumer threads scale each landed dy tile in place, bf16(dy * gate)
//   as the reference rounds it (the swizzle only permutes 16-byte chunks
//   within a row, so each row keeps its gate; a thread takes one
//   half-row, its gate read a tile ahead into a register), fence the
//   async proxy and meet at the barrier that also frees the previous
//   stage. Tile c + 1 is scaled while the products of tile c run, with
//   no branch in the C++ code between a product's issue and its wait
//   (the mbarrier wait is a PTX loop): ptxas serializes wgmmas that are
//   in flight across a branch. (On the H100, scaling each tile before
//   its own products, and waits written as C++ loops, were both slower.)

#include "grouped_mm_common.cuh"
#include "sm90_common.cuh"

namespace gmm {

constexpr int kDwRows = 128;     // rows a stage: one tile
constexpr int kDwStages = 3;
constexpr int kDwThreads = 256;  // two consumer warpgroups

struct DwSmem {
  // [stage][sub-tile of 64 columns][128 rows][64 columns], swizzled
  alignas(1024) __nv_bfloat16 x[kDwStages][kDwRows * BM];
  alignas(1024) __nv_bfloat16 dy[kDwStages][kDwRows * BN];
  uint64_t full[kDwStages];
};

struct DwMaps {
  CUtensorMap x, dy;
};

template <bool SCALED>
__global__ void __launch_bounds__(kDwThreads, 1)
    dw_kernel_sm90(const __grid_constant__ DwMaps mp, const Params p) {
  using namespace ::sm90;
  extern __shared__ uint8_t smem_raw[];
  DwSmem& sm = smem_aligned<DwSmem>(smem_raw);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int r_begin = p.gstart[e];
  const int r_end = min(r_begin + (p.counts[e] + p.bm - 1) / p.bm * p.bm, p.P);
  const int nk = r_end > r_begin ? (r_end - r_begin) / kDwRows : 0;
  // the 64-column boxes that lie (partly) inside the matrices; a
  // warpgroup whose rows lie past K multiplies stale shared memory and
  // stores nothing
  const int nx = m0 + 64 < p.K ? 2 : 1, ny = n0 + 64 < p.N ? 2 : 1;

  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int c, int s) {  // tile c into stage s (one thread)
    const int r = r_begin + c * kDwRows;
    mbar_expect_tx(&sm.full[s], (nx + ny) * kDwRows * 64 * 2);
    for (int i = 0; i < nx; ++i)
      tma_load_2d(sm.x[s] + i * kDwRows * 64, &mp.x, &sm.full[s], m0 + 64 * i, r);
    for (int i = 0; i < ny; ++i)
      tma_load_2d(sm.dy[s] + i * kDwRows * 64, &mp.dy, &sm.full[s], n0 + 64 * i, r);
  };
  if (tid == 0)
    for (int c = 0; c < kDwStages && c < nk; ++c) load(c, c);

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  // issue the products of the tile in stage s into a fresh partial
  auto mma = [&](int s) {
    const __nv_bfloat16* xa = sm.x[s] + wg * kDwRows * 64;
    fence_regs(part);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDwRows / 16; ++kk)
      wgmma_ss<BN, 1, 1>(part, desc_mnmajor<kDwRows>(xa, kk), desc_mnmajor<kDwRows>(sm.dy[s], kk),
                         kk > 0);
    wg_commit();
  };
  // wait for them, add the partial, and refill the stage with tile c + 3
  auto finish = [&](int c, int s) {
    wg_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    __syncthreads();  // every product on stage s is done (and, for proj, tile c + 1 scaled)
    if (tid == 0 && c + kDwStages < nk) load(c + kDwStages, s);
  };

  if constexpr (SCALED) {
    // proj's gate pass: thread t scales half-row t & 1 (a 64-column
    // sub-tile) of row t / 2 of a landed dy tile in place, 128 bytes, and
    // fences the async proxy; a barrier follows before the products read
    // it. Tile c + 1 is scaled while the products of tile c run, with no
    // branch between their issue and their wait.
    const int gr = tid >> 1, gh = tid & 1;
    auto scale_tile = [&](int s, float gate) {
      uint4* hrow = reinterpret_cast<uint4*>(sm.dy[s] + gh * kDwRows * 64 + gr * 64);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jj = (j + gr) & 7;  // rows start their walk on other banks
        uint4 v = hrow[jj];
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
          u[i] = pack_bf16(f.x * gate, f.y * gate);
        }
        hrow[jj] = v;
      }
      fence_proxy_async();
    };
    if (nk > 0) {
      mbar_wait(&sm.full[0], 0);
      scale_tile(0, p.scale[r_begin + gr]);
      __syncthreads();
    }
    float gate_next = nk > 1 ? p.scale[r_begin + kDwRows + gr] : 0.f;
    for (int c = 0; c + 1 < nk; ++c) {
      const int s = c % kDwStages, s1 = (c + 1) % kDwStages;
      mma(s);
      const float gate = gate_next;  // tile c + 1's; read tile c + 2's
      gate_next = p.scale[r_begin + min(c + 2, nk - 1) * kDwRows + gr];
      mbar_wait(&sm.full[s1], ((c + 1) / kDwStages) & 1);
      scale_tile(s1, gate);
      finish(c, s);
    }
    if (nk > 0) {
      mma((nk - 1) % kDwStages);
      finish(nk - 1, (nk - 1) % kDwStages);
    }
  } else {
    for (int c = 0; c < nk; ++c) {
      const int s = c % kDwStages;
      mbar_wait(&sm.full[s], (c / kDwStages) & 1);
      mma(s);
      finish(c, s);
    }
  }

  const int r0 = w * 16 + (lane >> 2);  // this thread's dW rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);        // and columns 8 j + c0 + {0, 1}
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int m = m0 + 64 * wg + r0 + 8 * ih;
    if (m >= p.K) continue;
    float* o = static_cast<float*>(p.out) + ((long long)e * p.K + m) * p.N + n0 + c0;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
      if (n0 + 8 * jj + c0 < p.N)
        *reinterpret_cast<float2*>(o + 8 * jj) =
            make_float2(acc[4 * jj + 2 * ih], acc[4 * jj + 2 * ih + 1]);
  }
}

template <bool SCALED>
int launch_dw(const Params& p, const DwMaps& mp, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(DwSmem) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(dw_kernel_sm90<SCALED>, smem, cap);
  if (err) return err;
  const dim3 grid((p.K + BM - 1) / BM, (p.N + BN - 1) / BN, p.E);
  dw_kernel_sm90<SCALED><<<grid, kDwThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

int launch_dw_sm90(const Params& p, void* stream) {
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  if (p.P == 0) {  // no rows: every expert's dW is zero
    cudaMemsetAsync(p.out, 0, (size_t)p.E * p.K * p.N * sizeof(float), (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  DwMaps mp;
  if (!::sm90::mat_map(&mp.x, p.a, p.P, p.K, kDwRows) ||
      !::sm90::mat_map(&mp.dy, p.b, p.P, p.N, kDwRows))
    return (int)cudaErrorInvalidValue;
  return p.scale != nullptr ? launch_dw<true>(p, mp, stream) : launch_dw<false>(p, mp, stream);
}

// ---- bf16 dx: wgmma on a TMA ring fed by a producer warp ------------------

constexpr int kDxBN = 256;                     // dx columns of a CTA
constexpr int kDxBK = 64;                      // N columns a stage (one box)
constexpr int kDxStages = 4;
constexpr int kDxCtas = 1;                     // CTAs an SM
constexpr int kDxConsumers = 256;              // two consumer warpgroups
constexpr int kDxThreads = kDxConsumers + 32;  // + the producer warp

struct DxSmem {
  // [stage][128 rows][64 columns], swizzled
  alignas(1024) __nv_bfloat16 dy[kDxStages][BM * kDxBK];
  alignas(1024) __nv_bfloat16 w[kDxStages][kDxBN * kDxBK];
  uint64_t full[kDxStages], empty[kDxStages];
};

struct DxMaps {
  CUtensorMap dy, w;
};

template <bool SCALED>
__global__ void __launch_bounds__(kDxThreads, kDxCtas)
    dx_kernel_sm90(const __grid_constant__ DxMaps mp, const Params p) {
  using namespace ::sm90;
  extern __shared__ uint8_t smem_raw[];
  DxSmem& sm = smem_aligned<DxSmem>(smem_raw);
  const int n0 = blockIdx.x * kDxBN;  // dx columns (over K): the fastest axis
  const int m0 = blockIdx.y * BM;  // dx rows (over P)
  const int e = p.tile_group[m0 / p.bm];
  const int nk = (p.N + kDxBK - 1) / kDxBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kDxConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kDxConsumers / 32) {  // the producer warp: one lane issues
    if (lane == 0)
      for (int c = 0; c < nk; ++c) {
        const int s = c % kDxStages;
        if (c >= kDxStages) mbar_wait(&sm.empty[s], (c / kDxStages - 1) & 1);
        mbar_expect_tx(&sm.full[s], (BM + kDxBN) * kDxBK * 2);
        tma_load_2d(sm.dy[s], &mp.dy, &sm.full[s], c * kDxBK, m0);
        tma_load_3d(sm.w[s], &mp.w, &sm.full[s], c * kDxBK, n0, e);
      }
    return;
  }

  const int wg = tid >> 7, w = warp & 3;
  float acc[kDxBN / 2];
#pragma unroll
  for (int i = 0; i < kDxBN / 2; ++i) acc[i] = 0.f;
  // proj: thread t scales 64 bytes (half of row t / 2) of each landed dy
  // tile, so warpgroup wg scales its own rows 64 wg ..
  const float gate = SCALED ? p.scale[m0 + (tid >> 1)] : 1.f;

  for (int c = 0; c < nk; ++c) {
    const int s = c % kDxStages;
    mbar_wait(&sm.full[s], (c / kDxStages) & 1);
    if constexpr (SCALED) {
      uint4* half = reinterpret_cast<uint4*>(sm.dy[s] + (tid >> 1) * kDxBK) + 4 * (tid & 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = (j + (tid >> 1)) & 3;  // rows start their walk on other banks
        uint4 v = half[jj];
        uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
          u[i] = pack_bf16(f.x * gate, f.y * gate);
        }
        half[jj] = v;
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);  // this warpgroup's rows are scaled
    }
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDxBK / 16; ++kk)
      wgmma_ss<kDxBN, 0, 0>(acc, desc_kmajor<BM>(sm.dy[s] + wg * 64 * kDxBK, kk),
                         desc_kmajor<kDxBN>(sm.w[s], kk), 1);
    wg_commit();
    wg_wait<1>();  // the products of k-step c - 1 are done: free its stage
    fence_regs(acc);
    mbar_arrive_if(&sm.empty[(c + kDxStages - 1) % kDxStages], lane == 0 && c > 0);
  }
  wg_wait<0>();
  fence_regs(acc);

  const int r0 = w * 16 + (lane >> 2);  // this thread's dx rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);        // and columns 8 j + c0 + {0, 1}
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int m = m0 + 64 * wg + r0 + 8 * ih;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + (long long)m * p.K + n0 + c0;
#pragma unroll
    for (int jj = 0; jj < kDxBN / 8; ++jj)
      if (n0 + 8 * jj + c0 < p.K)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * ih], acc[4 * jj + 2 * ih + 1]);
  }
}

template <bool SCALED>
int launch_dx(const Params& p, const DxMaps& mp, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(DxSmem) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(dx_kernel_sm90<SCALED>, smem, cap);
  if (err) return err;
  const dim3 grid((p.K + kDxBN - 1) / kDxBN, p.P / BM);
  dx_kernel_sm90<SCALED><<<grid, kDxThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

int launch_dx_sm90(const Params& p, void* stream) {
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  if (p.P == 0) return 0;
  DxMaps mp;
  if (!::sm90::mat_map(&mp.dy, p.a, p.P, p.N, BM) ||
      !::sm90::experts_map(&mp.w, p.b, p.E, p.K, p.N, kDxBN))
    return (int)cudaErrorInvalidValue;
  return p.scale != nullptr ? launch_dx<true>(p, mp, stream) : launch_dx<false>(p, mp, stream);
}

}  // namespace gmm

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the wgmma kernel),
// for dy (P, N), w (E, K, N) and dx (P, K), all contiguous and 16-byte
// aligned; scale (P,) fp32 or null; tile_group (P / bm,) int32. Returns
// the launch's cudaError_t (0 = success).
extern "C" int grouped_mm_bwd_dx(int dtype, const void* dy, const void* w, const float* scale,
                                 const int* tile_group, void* dx, int P, int K, int N, int E,
                                 int bm, void* stream) {
  gmm::Params p{};
  p.a = dy;
  p.b = w;
  p.scale = scale;
  p.tile_group = tile_group;
  p.out = dx;
  p.P = P;
  p.K = K;
  p.N = N;
  p.E = E;
  p.bm = bm;
  if (dtype == 0) return gmm::launch<float, gmm::DX>(p, stream);
  if (dtype == 1) return gmm::launch_dx_sm90(p, stream);
  return (int)cudaErrorInvalidValue;
}

// dtype as above (0: the FMA kernel, 1: the wgmma kernel) for x (P, K)
// and dy (P, N); scale (P,) fp32 or null;
// counts and gstart (E,) int32: each expert's rows and its first padded
// row (a multiple of bm); dw (E, K, N) fp32. Returns the launch's
// cudaError_t (0 = success).
extern "C" int grouped_mm_bwd_dw(int dtype, const void* x, const void* dy, const float* scale,
                                 const int* counts, const int* gstart, float* dw, int P, int K,
                                 int N, int E, int bm, void* stream) {
  gmm::Params p{};
  p.a = x;
  p.b = dy;
  p.scale = scale;
  p.counts = counts;
  p.gstart = gstart;
  p.out = dw;
  p.P = P;
  p.K = K;
  p.N = N;
  p.E = E;
  p.bm = bm;
  if (dtype == 0) return gmm::launch<float, gmm::DW>(p, stream);
  if (dtype == 1) return gmm::launch_dw_sm90(p, stream);
  return (int)cudaErrorInvalidValue;
}
