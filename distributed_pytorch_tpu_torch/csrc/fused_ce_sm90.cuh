// The bf16 fused cross-entropy kernels on Hopper (sm_90a): the forward of
// fused_ce_fwd.cu and dx and dW of fused_ce_bwd.cu for bf16 operands with
// C <= 1024, as one template `ce_kernel_sm90<MODE>` (MODE FWD, DX or DW)
// that shares the resident load, the producer and the ring; the forward
// has its own consumer loop. fp32 keeps the FMA kernel and bf16 at C >
// 1024 the mma.sync kernel (`ce_kernel`, fused_ce_common.cuh): the C
// entries pick by dtype and shape before launch, never as a fallback.
//
// Replaces: `_fwd_kernel` :84 -> `_fwd` :112, `_bwd_dx_kernel` :153 and
// `_bwd_dw_kernel` :171 -> `_bwd` :190 of
// distributed_pytorch_tpu/ops/fused_ce.py, as the mma.sync kernel did.
//
// Bound on the H100: operations. At n 8192, C 768, V 50304 the forward
// needs 2 n V C = 633 GFLOP (0.64 ms at the bf16 peak), each backward
// kernel 4 n V C = 1.27 TFLOP (1.28 ms). The first design ran all three at
// ~125-129 TFLOP/s: 32-64 resident rows a CTA (~64 FLOP per byte of
// streamed tile read from L2), mma.sync fed by ldmatrix, each tile's load
// waited for before its products, one CTA an SM.
//
// Design. One CTA owns 64 RESIDENT rows (forward and dx: tokens of x; dW:
// vocab rows of W) and, in the backward, one block of output columns
// (grid.y), and walks every 128-row tile of the STREAMED operand (forward
// and dx: W; dW: x). Each CTA owns its output rows: no atomics, sums in a
// fixed order, so two calls are bitwise equal.
// * The resident tile (64 rows x C, C / 64 TMA boxes of 64 x 64 with the
//   128-byte swizzle: 128 KB at C 1024) is loaded once for the whole walk.
// * A producer warp (of a warpgroup that gives its registers to the
//   consumers with setmaxnreg: 232 a consumer thread, 40 a producer one)
//   streams each tile as C / 64 k-chunks of 128 rows x 64
//   columns (16 KB), in the backward then its output chunks again (below),
//   through a ring of `stages` (5-8, as many as shared memory holds: the
//   forward 8 at C 768 and 6 at C 1024, the backward 7 and 5); `full`
//   barriers count the bytes in, `empty` barriers (one arrival per
//   consumer warp) hand a stage back. Waits are PTX-only
//   mbarrier loops, so ptxas sees no branch between a wgmma's issue and
//   its wait. Each side steps its place in the ring (`Slot`: stage and
//   phase parity) load by load: the stage count is known only at run time,
//   and a `%` or `/` by it is an integer division on every chunk (PERF.md
//   §6 records what that cost).
// * Two consumer warpgroups. Warpgroup w forms its 64 x 64 block of the
//   score tile, rows = the resident rows, columns = streamed rows
//   [64 w, 64 w + 64) of the tile: s = R S^T, m64n64k16 SS wgmma with both
//   operands K-major, fp32 accumulators.
// * Forward (ops/fused_ce.py:71-109): each warpgroup keeps two score
//   accumulators (2 x 32 fp32 registers a thread) and issues the first
//   kAhead chunks of tile j + 1 into one before it folds tile j, in the
//   other, into its running softmax, so the exp work runs beside tensor
//   work; later chunks keep kAhead in flight, and each tile is waited for
//   before the next begins (a product in flight across the tile loop
//   made ptxas serialize them all, C7514). Each thread keeps, for its
//   two rows over its own 16 columns of each tile, a running max m, sum l
//   (l = l e^(m_old - m_new) + sum e^(s - m_new), `expf` as the first
//   design) and the target logit, picked from the accumulator where the
//   column equals the target: the value that entered the max and the sum.
//   Only the last vocab tile can hold columns past V (TMA zero-fills
//   those W rows, s = 0), and only its fold masks them to -1e30; it runs
//   after the last wait, so no branch sits between a wgmma and its wait.
//   At the end the 4 lanes of a row merge by quad shuffles, and the two
//   warpgroups once through shared memory in a fixed order: lse = m +
//   log(max(l, 1e-30)), nll = lse - s[t], written once per row (a target
//   outside [0, V), as the -2 of an ignored row, gives nll = lse).
// * Backward dlogits, as the reference (ops/fused_ce.py:99-127): columns
//   past V (dx; only the last vocab tile has them, so only it is masked)
//   set to -1e30 before the exp, p = exp(s - lse), dl = (p -
//   onehot(t)) * coef, rounded to bf16. Each warpgroup writes its half once
//   into a 64 x 128 bf16 tile in shared memory (swizzled as the A operand
//   wants); the two halves meet behind a named barrier of the 256 consumer
//   threads. dlogits never reach device memory.
// * The backward's second product acc(64 x 64 b) += dl(64 x 128) S(128 x
//   64 b) over the CTA's output boxes (64 columns each): warpgroup w owns
//   `nu` of the CTA's 2 nu boxes (nu <= 3, 96 fp32 accumulator registers a
//   thread), m64n64k16 SS wgmma with the streamed chunk read MN-major (the
//   transpose bit). The producer loads the tile's output chunks a second
//   time after the walk over C, so no stage is held for the second product
//   and the whole ring keeps loading across the dlogits and the second
//   product (holding them instead leaves one stage to load into at C 768);
//   each box's stage goes back as soon as its products are done.
// * Backward output columns: the CTA of grid.y = y owns 128-column units
//   [y u / ny, (y + 1) u / ny) of u = C / 128, ny = ceil(u / 3): 2 at C
//   768, 3 at C 1024. Each CTA recomputes the whole score product, so a
//   kernel does (ny + 1) 2 n V C FLOP: 1.9 TFLOP at C 768 (1.92 ms at the
//   peak).
// * L2 traffic: every CTA reads the whole streamed operand (and, in the
//   backward, its output columns twice): 64 FLOP per byte of it (W is 77
//   MB, more than the 50 MB L2). Multicasting each chunk to a 2-CTA
//   cluster along the resident axis halves the L2 reads but did not make
//   the backward faster on the H100 (PERF.md §6), so CTAs work alone.
// * Ragged edges come from TMA's zero fill: a streamed row past V
//   (forward, dx) is masked to -1e30 before the max or the exp (a zero row
//   gives s = 0, and exp(0 - lse) is not 0); a token past n (dW) has coef 0
//   and target -2, lse 0, never read from past the end; a resident row
//   past n or V is never written. An ignored row (target -2, coef 0) has
//   dlogits exactly 0.
// * Limit: the resident tile and a ring of at least 5 stages fit the
//   227 KB of shared memory up to C 1024 (`kMaxC`); past it the mma.sync
//   kernel runs (it streams C in chunks of at most 768 columns).

#pragma once

#include "fused_ce_common.cuh"
#include "sm90_common.cuh"

namespace fce {
namespace s90 {

using ::sm90::bf16;

constexpr int kRows = 64;         // resident rows a CTA
constexpr int kTile = 128;        // streamed rows a tile
constexpr int kBK = 64;           // columns a chunk: one 128-byte swizzle box
constexpr int kMaxNu = 3;         // output boxes a warpgroup
constexpr int kMaxStages = 8;
constexpr int kMinStages = 5;
constexpr int kMaxC = 1024;
constexpr int kAhead = 2;         // forward: chunks in flight beside the fold
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread after `setmaxnreg`: 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kStageElems = kTile * kBK;
constexpr int kStageBytes = kStageElems * 2;
constexpr size_t kSmemMax = 232448;

struct Maps {
  CUtensorMap res, str;
};

// Ring stages, output-column blocks (grid.y) and dynamic shared memory of
// the kernel at width C; stages 0 where it does not fit.
struct Plan {
  int stages, ny;
  size_t smem;
};

// the ring's full and empty barriers and the resident tile's
constexpr size_t kBarBytes = 8 * (2 * kMaxStages + 1);

// Shared memory besides the ring and the resident tile. Forward: the
// barriers, then both warpgroups' (m, l, target) per row. Backward: the
// dlogits tile, the barriers, the tile's per-token t, lse and coef (dW).
constexpr size_t tail_bytes(int mode) {
  return mode == FWD ? kBarBytes + 2 * kRows * 3 * 4
                     : kRows * kTile * 2 + kBarBytes + 3 * 4 * kTile;
}

inline Plan plan(int mode, int C) {
  // + 1024 to align the base
  const size_t fixed = 1024 + (size_t)kRows * C * 2 + tail_bytes(mode);
  Plan pl{0, 0, 0};
  if (C <= 0 || C % kUnit != 0 || C > kMaxC) return pl;
  pl.stages = (int)((kSmemMax - fixed) / kStageBytes);
  if (pl.stages > kMaxStages) pl.stages = kMaxStages;
  if (pl.stages < kMinStages) return Plan{0, 0, 0};
  pl.ny = mode == FWD ? 1 : (C / kUnit + kMaxNu - 1) / kMaxNu;
  pl.smem = fixed + (size_t)pl.stages * kStageBytes;
  return pl;
}
static_assert(1024 + kRows * kMaxC * 2 + tail_bytes(DX) + kMinStages * kStageBytes <= kSmemMax,
              "C 1024 fits with the smallest ring");
static_assert(kAhead < kMinStages && kAhead <= kUnit / kBK,
              "the forward holds at most kAhead + 1 stages; every tile has kAhead chunks");

// A load's place in the ring: its stage and the parity of that stage's
// use, stepped load by load (no division by the runtime stage count)
struct Slot {
  int st, ph;
  __device__ __forceinline__ void next(int stages) {
    const int wrap = st + 1 == stages;
    st = wrap ? 0 : st + 1;
    ph ^= wrap;
  }
  __device__ __forceinline__ Slot after(int k, int stages) const {
    Slot o = *this;
    for (int i = 0; i < k; ++i) o.next(stages);
    return o;
  }
};

// ---- forward -------------------------------------------------------------

// A forward consumer's view of the ring: the next load to consume (`cur`)
// and the oldest one not yet handed back (`rel`)
struct FwdRing {
  const bf16* res;
  const bf16* ring;
  uint64_t* full;
  uint64_t* empty;
  int stages, nck, wg, lane;
  Slot cur, rel;
};

// The running softmax of this thread's rows ra, ra + 8 (h) over its own
// columns: max m, sum l, target logit; t the target, -1 outside [0, V)
struct FwdRows {
  float m[2], l[2], tgt[2];
  int t[2];
};

// Chunk kk of the score product into s: wait for its load, issue its four
// k-steps (m64n64k16 SS, both operands K-major), commit them as one group.
__device__ __forceinline__ void score_chunk(FwdRing& r, float (&s)[32], int kk) {
  using namespace ::sm90;
  const int st = r.cur.st;
  mbar_wait(&r.full[st], r.cur.ph);
  fence_regs(s);
  wg_fence();
#pragma unroll
  for (int q = 0; q < kBK / 16; ++q)
    wgmma_ss<64, 0, 0>(s, desc_kmajor<kRows>(r.res + kk * kRows * kBK, q),
                       desc_kmajor<kRows>(r.ring + st * kStageElems + r.wg * 64 * kBK, q),
                       kk > 0 || q > 0);
  wg_commit();
  r.cur.next(r.stages);
}

// one arrival of this warp on the oldest unreturned load's empty barrier
__device__ __forceinline__ void release_one(FwdRing& r) {
  ::sm90::mbar_arrive_if(&r.empty[r.rel.st], r.lane == 0);
  r.rel.next(r.stages);
}

// Fold a finished score tile s (register 4 j + 2 h + e: row ra + 8 h,
// column col0 + 8 j + e) into the running softmax. EDGE: the last vocab
// tile, whose columns past V are masked.
template <bool EDGE>
__device__ __forceinline__ void fwd_fold(FwdRows& st, const float (&s)[32], int col0, int V) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[16];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[2 * j + e] = !EDGE || col0 + 8 * j + e < V ? s[4 * j + 2 * h + e] : kNegInf;
        mx = fmaxf(mx, v[2 * j + e]);
      }
    const float m_new = fmaxf(st.m[h], mx);
    const int d = st.t[h] - col0;  // the target's place among the columns
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sum += expf(v[i] - m_new);
      st.tgt[h] = d == 8 * (i >> 1) + (i & 1) ? v[i] : st.tgt[h];
    }
    st.l[h] = st.l[h] * expf(st.m[h] - m_new) + sum;
    st.m[h] = m_new;
  }
}

// Tile `it`'s score product into s. PREV: the previous tile's scores,
// complete, are in ps; this tile's first kAhead chunks are issued, then
// the previous tile is folded while they run. Later chunks keep kAhead in
// flight; the tile is waited for and handed back before return, so no
// product is in flight across the walk's loop (ptxas serializes the
// products where one is, C7514).
template <bool PREV>
__device__ __forceinline__ void fwd_tile(FwdRing& r, FwdRows& st, float (&s)[32],
                                         float (&ps)[32], int col0, int V) {
  using namespace ::sm90;
#pragma unroll
  for (int kk = 0; kk < kAhead; ++kk) score_chunk(r, s, kk);
  if constexpr (PREV) {
    fence_regs(ps);
    fwd_fold<false>(st, ps, col0 - kTile, V);
  }
  for (int kk = kAhead; kk < r.nck; ++kk) {
    score_chunk(r, s, kk);
    wg_wait<kAhead>();  // chunk kk - kAhead is done
    release_one(r);
  }
  wg_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) release_one(r);
}

// The forward's consumer warpgroups: the walk over the vocab tiles, two
// score accumulators in turn, then the merge and the per-row outputs.
__device__ __forceinline__ void fwd_consumer(const Params& p, FwdRing& r, float* merge,
                                             uint64_t* res_full, int n_tiles, int r0, int tid) {
  using namespace ::sm90;
  const int warp = tid >> 5, lane = tid & 31;
  const int ra = 16 * (warp & 3) + (lane >> 2), q4 = lane & 3;  // rows ra, ra + 8
  const int col = 64 * r.wg + 2 * q4;  // this thread's first column of a tile
  FwdRows st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int t;
    float unused_lse, unused_coef;
    row_inputs(p, r0 + ra + 8 * h, t, unused_lse, unused_coef, false);
    st.t[h] = t >= 0 && t < p.V ? t : -1;
    st.m[h] = kNegInf;
    st.l[h] = 0.f;
    st.tgt[h] = 0.f;
  }
  float s0[32], s1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s0[i] = s1[i] = 0.f;
  mbar_wait(res_full, 0);

  fwd_tile<false>(r, st, s0, s1, col, p.V);
  int it = 1;
  for (; it + 1 < n_tiles; it += 2) {
    fwd_tile<true>(r, st, s1, s0, it * kTile + col, p.V);
    fwd_tile<true>(r, st, s0, s1, (it + 1) * kTile + col, p.V);
  }
  // the last tile (n_tiles - 1), the only one with columns past V
  if (it < n_tiles) {
    fwd_tile<true>(r, st, s1, s0, it * kTile + col, p.V);
    fwd_fold<true>(st, s1, it * kTile + col, p.V);
  } else {
    fwd_fold<true>(st, s0, (it - 1) * kTile + col, p.V);
  }

  // the 4 lanes of a row, then the two warpgroups in order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m = quad_max(st.m[h]);
    const float l = quad_sum(st.l[h] * expf(st.m[h] - m));
    const float tv = quad_sum(st.tgt[h]);
    if (q4 == 0) {
      float* dst = merge + (r.wg * kRows + ra + 8 * h) * 3;
      dst[0] = m;
      dst[1] = l;
      dst[2] = tv;
    }
  }
  bar_sync(1, kConsumers);
  if (tid < kRows && r0 + tid < p.n) {
    const float* a = merge + tid * 3;
    const float* b = merge + (kRows + tid) * 3;
    const float m = fmaxf(a[0], b[0]);
    const float l = a[1] * expf(a[0] - m) + b[1] * expf(b[0] - m);
    const float ls = m + logf(fmaxf(l, 1e-30f));
    p.lse_out[r0 + tid] = ls;
    p.nll[r0 + tid] = ls - (a[2] + b[2]);
  }
}

// ---- backward ------------------------------------------------------------

// dlogits of this thread's score elements s[4 j + 2 h + e] (rows ra + 8 h,
// tile columns 64 wg + 8 j + 2 q4 + e) of tile `it`, rounded to bf16 into
// the dlogits tile (sub-tile wg, swizzled). EDGE: dx's tile holds vocab
// rows past V (only the last one can), which are masked.
template <int MODE, bool EDGE>
__device__ __forceinline__ void dlogits(const Params& p, const float (&s)[32], bf16* dl, int it,
                                        int r0, int ra, int wg, int q4, const int (&tr)[2],
                                        const float (&lr)[2], const float (&cr)[2],
                                        const int* vt, const float* vl, const float* vc) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float d[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = it * kTile + 64 * wg + 8 * j + 2 * q4 + e;  // streamed row
      if constexpr (MODE == DX) {
        // col is a vocab row; the resident token rows carry t, lse, coef
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sv = !EDGE || col < p.V ? s[4 * j + 2 * h + e] : kNegInf;
          d[h][e] = (expf(sv - lr[h]) - (col == tr[h] ? 1.f : 0.f)) * cr[h];
        }
      } else {
        // col is a token (its t, lse, coef staged in shared memory); the
        // resident rows are vocab rows r0 + ra (+ 8)
        const int c = col - it * kTile;
        const int tt = vt[c];
        const float ls = vl[c], cf = vc[c];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          d[h][e] = (expf(s[4 * j + 2 * h + e] - ls) - (r0 + ra + 8 * h == tt ? 1.f : 0.f)) * cf;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(dl + ::sm90::swz<kRows>(ra + 8 * h, 8 * wg + j) + 2 * q4) =
          ::sm90::pack_bf16(d[h][0], d[h][1]);
  }
}

// acc[b] += dl (64 x 128) S (128 x 64) for this warpgroup's NU output
// boxes, box b the ring's b-th load from `sl` (waited for), read
// MN-major. Each
// box's stage goes back (one arrival of this warp on `empty`) as soon as
// its products are done, so the producer refills the ring during the
// second product; returns when all are done.
template <int NU>
__device__ __forceinline__ void second_product(float (&acc)[kMaxNu][32], const bf16* dl,
                                               const bf16* ring, uint64_t* full,
                                               uint64_t* empty, int stages, Slot sl, int lane) {
  using namespace ::sm90;
  int prev = 0;
#pragma unroll
  for (int b = 0; b < NU; ++b) {
    const int st = sl.st;
    mbar_wait(&full[st], sl.ph);
    fence_regs(acc[b]);
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < kTile / 16; ++kq)
      wgmma_ss<64, 0, 1>(acc[b], desc_kmajor<kRows>(dl, kq),
                         desc_mnmajor<kTile>(ring + st * kStageElems, kq), 1);
    wg_commit();
    if (b > 0) {
      wg_wait<1>();  // box b - 1 is done
      fence_regs(acc[b - 1]);
      mbar_arrive_if(&empty[prev], lane == 0);
    }
    prev = st;
    sl.next(stages);
  }
  wg_wait<0>();
  fence_regs(acc[NU - 1]);
  mbar_arrive_if(&empty[prev], lane == 0);
}

}  // namespace s90

template <int MODE>
__global__ void __launch_bounds__(s90::kThreads, 1)
    ce_kernel_sm90(const __grid_constant__ s90::Maps mp, const Params p, const int stages) {
  using namespace ::sm90;
  using namespace s90;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int C = p.C, nck = C / kBK;
  bf16* ring = reinterpret_cast<bf16*>(base);  // [stages][128 rows][64 columns]
  bf16* res = ring + stages * kStageElems;    // [C / 64][64 rows][64 columns]
  uint8_t* tail = reinterpret_cast<uint8_t*>(res + kRows * C);
  bf16* dl = reinterpret_cast<bf16*>(tail);   // backward: [2][64 rows][64 columns]
  uint64_t* full = reinterpret_cast<uint64_t*>(tail + (MODE == FWD ? 0 : kRows * kTile * 2));
  uint64_t* empty = full + kMaxStages;
  uint64_t* res_full = empty + kMaxStages;
  float* merge = reinterpret_cast<float*>(res_full + 1);  // forward: [2][64 rows][m, l, t]
  int* vt = reinterpret_cast<int*>(res_full + 1);  // dW: [128] the tile's tokens: t, lse, coef
  float* vl = reinterpret_cast<float*>(vt + kTile);
  float* vc = vl + kTile;

  const int rows = MODE == DW ? p.V : p.n;  // resident rows
  const int r0 = blockIdx.x * kRows;
  const int n_tiles = ((MODE == DW ? p.n : p.V) + kTile - 1) / kTile;
  // backward output columns: 128-column units [ua, ub) of C, chunks
  // [ofirst, ofirst + no), loaded again after each tile's walk over the
  // C / 64 chunks
  const int u = C / kUnit;
  const int ua = blockIdx.y * u / gridDim.y, ub = (blockIdx.y + 1) * u / gridDim.y;
  const int nu = MODE == FWD ? 0 : ub - ua, no = 2 * nu, ofirst = 2 * ua;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(res_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one lane issues
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(res_full, kRows * C * 2);
      for (int k = 0; k < nck; ++k)
        tma_load_2d(res + k * kRows * kBK, &mp.res, res_full, k * kBK, r0);
      Slot sl{0, 0};
      int g = 0;
      for (int it = 0; it < n_tiles; ++it)
        for (int kk = 0; kk < nck + no; ++kk, ++g) {
          // the score's walk over C, then (backward) the output chunks again
          const int k = kk < nck ? kk : ofirst + kk - nck;
          // the stage's previous load is handed back (none on the first lap)
          if (g >= stages) mbar_wait(&empty[sl.st], sl.ph ^ 1);
          mbar_expect_tx(&full[sl.st], kStageBytes);
          tma_load_2d(ring + sl.st * kStageElems, &mp.str, &full[sl.st], k * kBK, it * kTile);
          sl.next(stages);
        }
    }
  } else if constexpr (MODE == FWD) {
    setmaxnreg_inc<kConsumerRegs>();
    FwdRing r{res, ring, full, empty, stages, nck, warp >> 2, lane, Slot{0, 0}, Slot{0, 0}};
    fwd_consumer(p, r, merge, res_full, n_tiles, r0, tid);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp >> 2;
    const int ra = 16 * (warp & 3) + (lane >> 2), q4 = lane & 3;  // rows ra, ra + 8
    int tr[2] = {-2, -2};
    float lr[2] = {0.f, 0.f}, cr[2] = {0.f, 0.f};
    if constexpr (MODE == DX) {
#pragma unroll
      for (int h = 0; h < 2; ++h) row_inputs(p, r0 + ra + 8 * h, tr[h], lr[h], cr[h], true);
    }
    // one arrival of this warp on `stage`'s empty barrier where pred
    auto release = [&](int stage, int pred) {
      mbar_arrive_if(&empty[stage], (pred != 0) & (lane == 0));
    };
    float acc[kMaxNu][32];
#pragma unroll
    for (int b = 0; b < kMaxNu; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const int bfirst = wg * nu;  // this warpgroup's boxes among the CTA's
    mbar_wait(res_full, 0);

    Slot cur{0, 0};  // the next load's place in the ring
    for (int it = 0; it < n_tiles; ++it) {
      // dW: the first warpgroup fetches the tile's per-token inputs (-2, 0,
      // 0 past n) while the score product runs, and stages them below
      int tok_t = -2;
      float tok_l = 0.f, tok_c = 0.f;
      if constexpr (MODE == DW) {
        const int tok = it * kTile + tid;
        if (tid < kTile && tok < p.n) {
          tok_t = __ldg(p.t + tok);
          tok_l = __ldg(p.lse_in + tok);
          tok_c = __ldg(p.coef + tok);
        }
      }
      int prev = 0;
      for (int kk = 0; kk < nck; ++kk) {
        const int st = cur.st;
        mbar_wait(&full[st], cur.ph);
        fence_regs(s);
        wg_fence();
#pragma unroll
        for (int q = 0; q < kBK / 16; ++q)
          wgmma_ss<64, 0, 0>(s, desc_kmajor<kRows>(res + kk * kRows * kBK, q),
                             desc_kmajor<kRows>(ring + st * kStageElems + wg * 64 * kBK, q),
                             kk > 0 || q > 0);
        wg_commit();
        wg_wait<1>();  // chunk kk - 1's products are done: hand it back
        fence_regs(s);
        release(prev, kk > 0);
        prev = st;
        cur.next(stages);
      }
      wg_wait<0>();
      fence_regs(s);
      release(prev, 1);

      if constexpr (MODE == DW) {
        if (tid < kTile) {
          vt[tid] = tok_t;
          vl[tid] = tok_l;
          vc[tid] = tok_c;
        }
      }
      // both warpgroups' last second product (and dlogits) are done, and
      // the staged per-token inputs are written
      bar_sync(1, kConsumers);
      if (MODE == DX && (it + 1) * kTile > p.V)
        dlogits<MODE, true>(p, s, dl, it, r0, ra, wg, q4, tr, lr, cr, vt, vl, vc);
      else
        dlogits<MODE, false>(p, s, dl, it, r0, ra, wg, q4, tr, lr, cr, vt, vl, vc);
      fence_proxy_async();
      bar_sync(1, kConsumers);  // the whole dlogits tile is written

      // The output chunks are the next no loads: this warpgroup's own nu go
      // through the second product; the other warpgroup's are handed back
      // at once where the stage's previous load was (every earlier load
      // was, before the barrier above), else after this warpgroup has
      // handed back its own (an arrival counts toward the stage's oldest
      // open phase).
      const int other = nu - bfirst;  // the other's first, from cur
      Slot o = cur.after(other, stages);
      for (int b = 0; b < nu; ++b, o.next(stages)) release(o.st, other + b < stages);
      const Slot own = cur.after(bfirst, stages);
      if (nu == 3)
        second_product<3>(acc, dl, ring, full, empty, stages, own, lane);
      else if (nu == 2)
        second_product<2>(acc, dl, ring, full, empty, stages, own, lane);
      else
        second_product<1>(acc, dl, ring, full, empty, stages, own, lane);
      o = cur.after(other, stages);
      for (int b = 0; b < nu; ++b, o.next(stages)) release(o.st, other + b >= stages);
      cur = cur.after(no, stages);
    }

    // rows: dx tokens, dW vocab rows r0 + ra (+ 8)
    bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int b = 0; b < kMaxNu; ++b) {
      if (b >= nu) break;
      const int col0 = (ofirst + bfirst + b) * kBK + 2 * q4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + ra + 8 * h;
        if (r >= rows) continue;
        bf16* orow = out + (long long)r * C + col0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[b][4 * j + 2 * h], acc[b][4 * j + 2 * h + 1]);
      }
    }
  }
}

namespace s90 {

// bf16, 0 < C <= kMaxC (a multiple of 128), n > 0, V > 0: the kernel of
// `mode` takes it
inline bool takes(int mode, const Params& p) {
  return p.n > 0 && p.V > 0 && plan(mode, p.C).stages > 0;
}

template <int MODE>
int launch(const Params& p, void* stream) {
  const Plan pl = plan(MODE, p.C);
  if (pl.stages == 0 || p.n <= 0 || p.V <= 0) return (int)cudaErrorInvalidValue;
  const void* res = MODE == DW ? p.w : p.x;
  const void* str = MODE == DW ? p.x : p.w;
  const int rows = MODE == DW ? p.V : p.n, srows = MODE == DW ? p.n : p.V;
  Maps mp;
  if (!::sm90::mat_map(&mp.res, res, rows, p.C, kRows) ||
      !::sm90::mat_map(&mp.str, str, srows, p.C, kTile))
    return (int)cudaErrorInvalidValue;
  static size_t cap[64] = {};
  const int err = flash::set_smem(ce_kernel_sm90<MODE>, pl.smem, cap);
  if (err) return err;
  const dim3 grid((rows + kRows - 1) / kRows, pl.ny);
  ce_kernel_sm90<MODE><<<grid, kThreads, pl.smem, (cudaStream_t)stream>>>(mp, p, pl.stages);
  return (int)cudaGetLastError();
}

}  // namespace s90
}  // namespace fce
