// flash_attn_bwd_dq / flash_attn_bwd_dkv: the FlashAttention-2 backward of
// flash_attn_fwd.cu over BTNH tensors (sm_90a, fp32 and bf16, any head
// size d with d % 8 == 0 up to 256, run at a built width as the forward
// runs it: Q, K, V and dO zero past d, so S, dP, dS K, dS^T Q and P^T dO
// take nothing from the padded columns, and dq, dk, dv are stored up to d
// only). In bf16 both have widths 32 and 80 and the dq also 192; fp32 runs
// those head sizes at 64, 128 and 256 (ops/flash_attention.py's `WIDTHS`
// is the one table of the built widths). Both recompute p = exp(s - lse) from
// the forward's logsumexp instead of storing probabilities; delta =
// rowsum(dout * out) - dlse comes in precomputed (fp32, (B, nh, T)), which
// is how a gradient flowing into lse folds in. Built and bound by
// ops/cuda_build.py; wrapped by ops/flash_attention.py.
//
// Replaces: `_bwd_dq_kernel` (pallas_call :482) and `_bwd_dkv_kernel`
// (:516) -> `_bwd_impl` (rows face) and `_slab_bwd_dq_kernel` (:727) /
// `_slab_bwd_dkv_kernel` (:756) -> `_slab_bwd` (slab face) of
// distributed_pytorch_tpu/ops/flash_attention.py, the arithmetic of its
// `_dq_tile` and `_dkv_tile`.
//
// Bound on the H100: at the training shape (B 8, T 1024, 12 heads x 64,
// causal) dq does 3 and dkv 4 products of the forward's ~6.4 GFLOP each,
// so operations bound both in bf16 (~0.020 and ~0.026 ms at 989 TFLOP/s).
//
// No atomics: dq and dkv are two kernels, each writing its rows once, so
// the results are deterministic. The dropout mask is regenerated from the
// forward's coordinates (row b*nh_all + h0 + h, q0 + query position, k0 + key
// position), not from a kernel's loop order.
//
// * dq, fp32 (`dq_kernel`): the FMA design of flash_attn_common.cuh
//   (tensor cores take fp32 only as TF32). One CTA per (64-row query
//   tile, head, batch), walking key tiles up to the causal frontier:
//   S = Q K^T and dP = dO V^T, dS = p * (dP * mask - delta) rounded to the
//   key dtype, dQ += dS K; dq carries * scale at the write. At head size
//   256 K^T and V^T come in two halves of D's columns (S and dP summed
//   over both), and K's row-major copy for dQ += dS K then takes their
//   space: 226,304 bytes of shared memory where loading all at once would
//   need 362,496.
// * dq, bf16 at widths 64, 80 and 128 (`flash_sm90::dq_kernel_sm90`):
//   tensor cores. One CTA of one warpgroup
//   (128 threads) per (64-row query tile, head, batch), the causal
//   heaviest tiles first (the grid's slowest axis runs down the frontier,
//   as in the forward). TMA brings the Q and dO tiles once and streams the
//   kv head's 64-key K and V tiles through a 2-stage ring (mbarrier
//   completion), the tile after next requested as soon as a stage is
//   free; 48 KB of shared memory at head size 64, 60 KB at 80, 96 KB at
//   128. Each
//   thread reads the lse and delta of its own two rows from device memory
//   once. Per key tile up to the frontier: S = Q K^T and dP = dO V^T are
//   wgmmas with both operands in shared memory (K-major); p = exp(s *
//   scale - lse) (expf of the fp32 score, as the FMA dq kernel and the
//   plain version form it; the bf16 dkv takes exp2 of the same score
//   times log2 e, which differs in the last bits), the dropout mask on
//   dP, and dS = p (dP * mask - delta) are computed on the accumulators
//   in registers and rounded to bf16 straight into the register A operand
//   of dQ += dS K, which reads the same K stage MN-major (the transpose
//   bit). Only tiles on the diagonal or at the ragged ends are masked (TMA
//   zero-fills rows past T and S). Each query row is written once,
//   dq * scale.
//   At width 80 (head sizes 72 and 80, the flagship with MLA) the tiles
//   hold exactly 80 columns (`sm90::Map80`, flash_attn_sm90.cuh): S and
//   dP take 5 k-steps, dQ += dS K is m64n64k16 + m64n16k16 into dQ's 40
//   registers; 130 registers a thread and 60 KB, three CTAs an SM. The
//   128-wide instance it replaces for these head sizes (0.1837 ms at B 8,
//   T 1024, 12 x 80, causal, on an H100) ran 8 k-steps and N 128, 48
//   columns zero. The warp-specialized design below, built at 80 on
//   64-key stages (4 of them, 120 KB; one CTA an SM at 168 registers),
//   ran slower there: 0.1350 against this one's 0.1307 ms
//   (bench/flash_ab.py, 12 / 12 and 12 / 4 heads): its two consumers an
//   SM overlap less than three one-warpgroup CTAs do.
// * dq, bf16 at widths 192 and 256 (`flash_ws::dq_kernel_sm90`: head
//   sizes 136-256, MLA's q_c | q_r): warp-specialized, the forward's
//   skeleton at 256 with the dkv's producer handshake. The 64 x 256 fp32
//   dQ accumulator is 128 registers a thread, so one warpgroup of a first
//   design walked 32-key stages in strict series (S and dP, wait, dS on
//   the CUDA cores, dQ += dS K, wait, refill) at 0.3259 ms, 6.2x its bound
//   at the MLA shape. Now one CTA of 384 threads per (128-row query tile,
//   head, batch), the causal heaviest first; 224 KB of shared memory at
//   256 (Q and dO of 128 rows 128 KB, a 3-stage ring of 32-key K and V
//   tiles 96 KB; 64-key stages would need 256 KB), 192 KB at 192 (4
//   stages).
//   - A producer warpgroup (24 registers after setmaxnreg): one lane loads
//     each consumer's Q and dO rows once, then streams the kv head's K and
//     V tiles up to the later consumer's causal frontier; full barriers
//     count the bytes in, empty ones take one arrival per consumer warp.
//     V goes back once both consumers' dP on it is done, K once their dQ
//     += dS K is, a turn later.
//   - Two consumer warpgroups (240 registers: dQ 128, S 16, dP 16, the dS
//     fragments 8), each owning 64 query rows and its own frontier, take
//     turns on named barriers: a turn issues S and dP of key tile j
//     (m64n32k16 SS) and dQ += dS K of tile j - 1 (m64nDk16 RS, K
//     MN-major), forms tile j's dS (the arithmetic above, branch-free,
//     masked by selects) beside that product and packs it once the
//     product is done, while the other consumer's products run. A
//     consumer with no row below T does not run (T ending in the first
//     64 rows), and the earlier consumer takes empty turns past its
//     frontier.
//   Each row sums its k-steps in the first design's order, so dq is the
//   same bit for bit (the dropout product rounded on its own, as that
//   design's branch rounded it). Shared memory bounds it: per 32-key
//   stage the two consumers read about 224 KB of operands against about
//   1,536 cycles of tensor work. Slower on the H100 (in-process A/Bs): 2
//   stages (K of the tile after next waits for dQ's release, a turn
//   late), 2 stages of 64 keys at 192, and descriptors the compiler
//   hoisted out of the walk (32 registers: the consumers spilled). Free-
//   running consumers (no turns) and 5 stages at 192 were within 2%.
// * dkv, fp32 (`dkv_kernel`): the FMA design, unchanged (tensor cores take
//   fp32 only as TF32, which would break the fp32 limits of the kernel
//   checks and the training parity). One CTA per (64-key tile, kv head,
//   batch); Q and dO are loaded in both orientations; head sizes 128 and
//   256 use 32-row query tiles to fit shared memory, and at 256 the
//   row-major Q and dO take the space of their transposed copies once S^T
//   and dP^T are formed (230,656 bytes instead of 297,216).
// * dkv, bf16 at head size 64 and 128 (`flash_sm90::dkv_kernel_sm90`):
//   tensor cores. One CTA of one warpgroup (128 threads) per (64-key
//   tile, kv head, batch) keeps its K and V tiles resident and walks the query tiles of every head of its GQA
//   group from the causal frontier on: 64 rows at head size 64, 32 at 128,
//   so that the dK and dV accumulators (64 x D fp32 each) and the two
//   score accumulators fit the thread's registers without spills (~200 a
//   thread: two CTAs an SM). TMA brings each query tile's Q and dO rows
//   and its lse and delta values into a 2-stage ring (mbarrier
//   completion), the tile after next requested as soon as a stage is
//   free; lse and delta come as one 1-D box from the 16-byte boundary at
//   or before the tile's first value (a TMA box must start on one; the
//   rows of a (B, nh, T) array need not). Per tile: S^T = K Q^T and
//   dP^T = V dO^T are wgmmas with both operands in shared memory
//   (K-major); P^T = exp(s * scale - lse), as the FMA kernel writes it,
//   and dS^T = P^T (dP^T * mask - delta) are formed on the accumulators in
//   registers and rounded to bf16 into the register A operands of
//   dV += (P^T * mask) dO and dK += dS^T Q, which read the same one copy
//   of dO and Q MN-major (the transpose bit). The group sum stays in the
//   fp32 accumulators and each key row is written once, dk * scale. Only
//   tiles on the diagonal or at the ragged ends are masked. Key tiles
//   launch in order, the causal heaviest first.
// * dkv, bf16 at width 80 (`flash_sm90::dkv_kernel_sm90<80>`: head sizes
//   72 and 80): the same kernel on tiles of exactly 80 columns (the
//   forward's layout, `sm90::Map80`), walking 64-row query tiles as at
//   64: S^T and dP^T in 5 k-steps each, dV += P^T dO and dK += dS^T Q as
//   m64n64k16 + m64n16k16. dK and dV take 40 registers each, S^T and dP^T
//   32 each; 210 registers a thread, no spill, 64 KB of shared memory.
//   The 128-wide instance it replaces for these head sizes walked 32-row
//   tiles (twice the turns) with 8 k-steps and N 128, 48 columns zero. The
//   layout of five 16-column sub-tiles ran slower here too (PERF.md).
// * dq and dkv, bf16 at width 32 (`flash_pipe::dq_kernel_sm90<32>`,
//   `flash_pipe::dkv_kernel_sm90<32>`: head sizes 8-32, the default
//   config's heads of 32): one warpgroup a CTA, as above (a dq CTA 64
//   query rows on 64-key stages, a dkv CTA 64 keys on 64-row query tiles
//   of every head of its group), on tiles of exactly 32 columns (one box
//   at the 64-byte swizzle, flash_attn_sm90.cuh): S and dP (S^T and dP^T)
//   in 2 k-steps, the MN-major products m64n32k16. At 32 the products
//   halve while the exponentials and the CUDA-core work per score stay
//   those of 64, and one warpgroup taking them in series ran as slowly
//   as the 64-wide instance. So the turns are pipelined, as in the
//   warp-specialized dq's consumers: a turn issues tile j's S and dP and
//   tile j - 1's dQ += dS K (dV and dK), forms tile j's dS (P^T and dS^T)
//   beside that product, branch-free (masked by selects, the dropout
//   products rounded on their own), then hands stage j - 1 back to a
//   4-stage ring and packs the fragments. Each sum keeps its order, so
//   dq, dk and dv are the bytes of the 64-wide masked instances. The dq
//   holds 127 registers (four CTAs an SM), the dkv at most 168 (three).
//   On the H100 (B 8, T 1024, 8 / 4 heads, causal, bench/flash_ab.py):
//   dq 0.0688 -> 0.046, dkv 0.1058 -> 0.047 ms. Slower there: the
//   templates above compiled at 32 (dq 0.0627, dkv 0.0935; 128-row dkv
//   query tiles 0.1048 at 254 registers; 4- and 6-stage rings no faster),
//   the warp-specialized dq at 32 (0.0793 on 64-key stages, one CTA an
//   SM; 0.0510 on 32-key stages, two), a dkv of two consumer warpgroups on
//   two 64-key tiles over one Q / dO ring (0.1646), and this dkv at 172
//   registers (two CTAs an SM: 0.0520) (PERF.md).
// * dkv, bf16 at head size 256 (`flash_ws::dkv_kernel_sm90`):
//   warp-specialized, one CTA of 384 threads per (64-key tile, kv head,
//   batch), 210 KB of shared memory (K and V 64 KB, a 2-stage ring of
//   64-row Q and dO tiles with their lse and delta 128 KB, P^T and dS^T
//   16 KB). The 64 x 256 fp32 dK and dV would be 256 registers a thread
//   in one warpgroup; the first design had two CTAs share a key tile, each
//   forming S^T and dP^T over all of D for its 128 columns: 6 products a
//   tile where 4 do, Q and dO read twice (0.6409 ms at the MLA shape).
//   - A producer warpgroup (24 registers after setmaxnreg): one lane loads
//     K and V once, then each query tile (every head of the GQA group,
//     from the causal frontier on) into the ring; full barriers count the
//     bytes in, empty ones take one arrival per consumer warp.
//   - Two consumer warpgroups (240 registers: dK 64, dV 64, S^T 16, dP^T
//     16). Consumer w forms S^T = K Q^T and dP^T = V dO^T for all 64 keys
//     x its 32 queries of the tile (m64n32k16 SS over D, both K-major),
//     P^T * mask and dS^T in registers with the arithmetic above, and
//     stores them as bf16 into the shared P^T / dS^T tiles in the
//     swizzled layout wgmma reads as a K-major A operand; fence.proxy.async
//     and a named barrier later, it adds P^T dO and dS^T Q over the tile's
//     64 queries into its 128 columns of dV and dK (m64n128k16 SS, dO and Q
//     MN-major). A second barrier before the stores keeps one tile's
//     P^T / dS^T from overwriting the last one's while the other consumer
//     still reads it. 4 products a tile; Q and dO cross from L2 once.
//   Key tiles run on the grid's fastest axis, so the CTAs of one (kv
//   head, batch) run together and share its Q and dO in L2 (faster on the
//   H100 than kv heads first). Issuing the next tile's S^T and dP^T before
//   this tile's dV and dK, to form P^T and dS^T beside those products,
//   was slower: its consumers spilled.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace {

using flash::Params;

// The K^T / V^T columns the fp32 dq loads at once: all of D up to 128; at
// 256 two halves, so that Q^T, dO^T, K^T, V^T and K fit shared memory, and
// K's row-major copy then takes the space of the halves (kAlias).
template <int D>
__host__ __device__ constexpr int dq_dc() {
  return D > 128 ? D / 2 : D;
}

template <int D>
__host__ __device__ constexpr size_t dq_kv_floats() {
  constexpr int DC = dq_dc<D>(), LD = flash::kBQ + flash::kPad, LDV = D + flash::kPad;
  return DC < D ? (2 * DC * LD > flash::kBK * LDV ? 2 * DC * LD : flash::kBK * LDV)
                : 2 * DC * LD + flash::kBK * LDV;
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * D * (flash::kBQ + flash::kPad) + dq_kv_floats<D>() +
                          flash::kBK * (flash::kBQ + flash::kPad));
}

template <typename T, int D, bool kPartial>
__global__ void __launch_bounds__(flash::kThreads) dq_kernel(const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace flash;
  constexpr int LD = kBQ + kPad;
  constexpr int LDV = D + kPad;
  constexpr int RN = D / 16;
  constexpr int DC = dq_dc<D>();
  constexpr bool kAlias = DC < D;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                                  // [D][LD]
  float* dOt = Qt + D * LD;                        // [D][LD]
  float* Kt = dOt + D * LD;                        // [DC][LD]
  float* Vt = Kt + DC * LD;                        // [DC][LD]
  float* Ks = kAlias ? Kt : Vt + DC * LD;          // [kBK][LDV]
  float* dSt = Kt + dq_kv_floats<D>();             // [kBK][LD] dS transposed (key-major)

  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.nh / p.nkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * dh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + (long long)h * dh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + (long long)g * dh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + (long long)g * dh;
  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const uint32_t row = flash::drop_row(p, b, h);
  const long long stat = (long long)(b * p.nh + h) * p.T;

  const int nq = min(kBQ, p.T - i0);
  load_tile<T, D, kBQ, true>(Qt, LD, q + i0 * p.q_st, p.q_st, nq, dh);
  load_tile<T, D, kBQ, true>(dOt, LD, dout + i0 * p.do_st, p.do_st, nq, dh);
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = i0 + ty * 4 + i;
    lse_r[i] = qp < p.T ? p.lse_in[stat + qp] : 0.f;
    dl_r[i] = qp < p.T ? p.delta[stat + qp] : 0.f;
  }

  float dq[4][RN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) dq[i][j] = 0.f;
  const int n_keys = p.causal ? min(p.S, i0 + kBQ) : p.S;
  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    const int nk = min(kBK, p.S - k0);
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 1
    for (int c = 0; c < D; c += DC) {
      __syncthreads();
      load_tile<T, DC, kBK, true>(Kt, LD, k + k0 * p.k_st + c, p.k_st, nk, kPartial ? dh - c : DC);
      load_tile<T, DC, kBK, true>(Vt, LD, v + k0 * p.v_st + c, p.v_st, nk, kPartial ? dh - c : DC);
      if (!kAlias) load_tile<T, D, kBK, false>(Ks, LDV, k + k0 * p.k_st, p.k_st, nk, dh);
      __syncthreads();
      mma_tile<4, DC>(s, Qt + c * LD, LD, Kt, LD, ty, tx);
      mma_tile<4, DC>(dp, dOt + c * LD, LD, Vt, LD, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = i0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool ok = qp < p.T && kp < p.S && (!p.causal || kp <= qp);
        const float pv = ok ? expf(s[i][j] * p.scale - lse_r[i]) : 0.f;
        float d = dp[i][j];
        if (p.dropout) d *= keep(p, s0, s1, row, qp, kp);
        s[i][j] = round_to<T>(pv * (d - dl_r[i]));  // dS in the key dtype
      }
    }
    if (kAlias) {
      __syncthreads();  // K^T and V^T are read: K's row-major copy takes their place
      load_tile<T, D, kBK, false>(Ks, LDV, k + k0 * p.k_st, p.k_st, nk, dh);
    }
    store_t<4>(dSt, LD, s, ty, tx);
    __syncthreads();
    mma_tile<RN, kBK>(dq, dSt, LD, Ks, LDV, ty, tx);
  }

  T* out = static_cast<T*>(p.out0) + (long long)b * p.T * p.nh * dh + (long long)h * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = i0 + ty * 4 + i;
    if (qp >= p.T) continue;
    T* orow = out + (long long)qp * p.nh * dh + tx * RN;
#pragma unroll
    for (int j = 0; j < RN; ++j)
      if (!kPartial || tx * RN + j < dh) orow[j] = from_f<T>(dq[i][j] * p.scale);
  }
}

template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D == 64 ? 64 : 32;  // query rows per dkv tile
}

// At head size 256 the fp32 dkv's row-major Q and dO take the space of
// their transposed copies once S^T and dP^T are formed (kAlias), which
// brings shared memory from 297,216 to 230,656 bytes.
template <int D>
__host__ __device__ constexpr size_t dkv_q_floats() {
  constexpr int BQ = dkv_bq<D>(), LDQ = BQ + flash::kPad, LDV = D + flash::kPad;
  return D > 128 ? (2 * D * LDQ > 2 * BQ * LDV ? 2 * D * LDQ : 2 * BQ * LDV)
                 : 2 * D * LDQ + 2 * BQ * LDV;
}

template <int D>
constexpr size_t dkv_smem() {
  constexpr int BQ = dkv_bq<D>();
  return sizeof(float) * (2 * D * (flash::kBK + flash::kPad) + dkv_q_floats<D>() +
                          2 * BQ * (flash::kBK + flash::kPad) + 2 * BQ);
}

template <typename T, int D, bool kPartial>
__global__ void __launch_bounds__(flash::kThreads) dkv_kernel(const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace flash;
  constexpr int BQ = dkv_bq<D>();
  constexpr int RNQ = BQ / 16;    // query columns per thread in S^T, dP^T
  constexpr int LDK = kBK + kPad;
  constexpr int LDQ = BQ + kPad;
  constexpr int LDV = D + kPad;
  constexpr int RN = D / 16;
  constexpr bool kAlias = D > 128;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;                                 // [D][LDK]
  float* Vt = Kt + D * LDK;                       // [D][LDK]
  float* Qt = Vt + D * LDK;                       // [D][LDQ]
  float* dOt = Qt + D * LDQ;                      // [D][LDQ]
  float* Qs = kAlias ? Qt : dOt + D * LDQ;        // [BQ][LDV]
  float* dOs = Qs + BQ * LDV;                     // [BQ][LDV]
  float* Ps = Qt + dkv_q_floats<D>();             // [BQ][LDK] (p * mask), query-major
  float* dSs = Ps + BQ * LDK;                     // [BQ][LDK] dS, query-major
  float* lse_s = dSs + BQ * LDK;                  // [BQ]
  float* dl_s = lse_s + BQ;                       // [BQ]

  const int j0 = blockIdx.x * kBK, g = blockIdx.y, b = blockIdx.z;
  const int rep = p.nh / p.nkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + (long long)g * dh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + (long long)g * dh;
  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const int nk = min(kBK, p.S - j0);
  load_tile<T, D, kBK, true>(Kt, LDK, k + j0 * p.k_st, p.k_st, nk, dh);
  load_tile<T, D, kBK, true>(Vt, LDK, v + j0 * p.v_st, p.v_st, nk, dh);

  float dk[4][RN], dv[4][RN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }
  // the first query tile with a row that sees this key tile
  const int t_begin = p.causal ? (j0 / BQ) * BQ : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const uint32_t row = flash::drop_row(p, b, h);
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * dh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + (long long)h * dh;
    const long long stat = (long long)(b * p.nh + h) * p.T;
    for (int i0 = t_begin; i0 < p.T; i0 += BQ) {
      const int nq = min(BQ, p.T - i0);
      __syncthreads();
      load_tile<T, D, BQ, true>(Qt, LDQ, q + i0 * p.q_st, p.q_st, nq, dh);
      load_tile<T, D, BQ, true>(dOt, LDQ, dout + i0 * p.do_st, p.do_st, nq, dh);
      if (!kAlias) {
        load_tile<T, D, BQ, false>(Qs, LDV, q + i0 * p.q_st, p.q_st, nq, dh);
        load_tile<T, D, BQ, false>(dOs, LDV, dout + i0 * p.do_st, p.do_st, nq, dh);
      }
      if (threadIdx.x < BQ) {
        const int e = threadIdx.x;
        lse_s[e] = e < nq ? p.lse_in[stat + i0 + e] : 0.f;
        dl_s[e] = e < nq ? p.delta[stat + i0 + e] : 0.f;
      }
      __syncthreads();

      // rows: keys ty*4 + i; columns: queries tx*RNQ + j
      float st[4][RNQ] = {}, dpt[4][RNQ] = {};
      mma_tile<RNQ, D>(st, Kt, LDK, Qt, LDQ, ty, tx);
      mma_tile<RNQ, D>(dpt, Vt, LDK, dOt, LDQ, ty, tx);
      float pd[4][RNQ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = j0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < RNQ; ++j) {
          const int qi = tx * RNQ + j, qp = i0 + qi;
          const bool ok = qp < p.T && kp < p.S && (!p.causal || kp <= qp);
          const float pv = ok ? expf(st[i][j] * p.scale - lse_s[qi]) : 0.f;
          float d = dpt[i][j], pm = pv;
          if (p.dropout) {
            const float mk = keep(p, s0, s1, row, qp, kp);
            pm = pv * mk;
            d *= mk;
          }
          pd[i][j] = round_to<T>(pm);                     // in dout's dtype
          st[i][j] = round_to<T>(pv * (d - dl_s[qi]));    // dS in q's dtype
        }
      }
      if (kAlias) {
        __syncthreads();  // Q^T and dO^T are read: the row-major copies take their place
        load_tile<T, D, BQ, false>(Qs, LDV, q + i0 * p.q_st, p.q_st, nq, dh);
        load_tile<T, D, BQ, false>(dOs, LDV, dout + i0 * p.do_st, p.do_st, nq, dh);
      }
      store_t<RNQ>(Ps, LDK, pd, ty, tx);
      store_t<RNQ>(dSs, LDK, st, ty, tx);
      __syncthreads();
      mma_tile<RN, BQ>(dv, Ps, LDK, dOs, LDV, ty, tx);
      mma_tile<RN, BQ>(dk, dSs, LDK, Qs, LDV, ty, tx);
    }
  }

  const long long base = (long long)b * p.S * p.nkv * dh + (long long)g * dh;
  T* dk_out = static_cast<T*>(p.out0) + base;
  T* dv_out = static_cast<T*>(p.out1) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = j0 + ty * 4 + i;
    if (kp >= p.S) continue;
    const long long off = (long long)kp * p.nkv * dh + tx * RN;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      if (kPartial && tx * RN + j >= dh) continue;
      dk_out[off + j] = from_f<T>(dk[i][j] * p.scale);
      dv_out[off + j] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int D, bool kPartial>
int launch_dq(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = dq_smem<D>();
  const int err = flash::set_smem(dq_kernel<T, D, kPartial>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  const dim3 grid((p.T + flash::kBQ - 1) / flash::kBQ, p.nh, p.B);
  dq_kernel<T, D, kPartial><<<grid, flash::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kPartial>
int launch_dkv(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = dkv_smem<D>();
  const int err = flash::set_smem(dkv_kernel<T, D, kPartial>, smem, cap);
  if (err) return err;
  if (p.S == 0 || p.B == 0 || p.nkv == 0) return 0;
  const dim3 grid((p.S + flash::kBK - 1) / flash::kBK, p.nkv, p.B);
  dkv_kernel<T, D, kPartial><<<grid, flash::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}


// ---- bf16 dkv: wgmma on TMA-fed shared memory -----------------------------

namespace flash_sm90 {

using sm90::bf16;
constexpr int kBK = 64;  // key rows: of a dkv CTA (one warpgroup), of a dq stage
constexpr int kStages = 2;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// query rows per tile: 64, and 32 at width 128, where 64-row tiles would
// leave dK and dV (64 x 128 fp32 each) and S^T, dP^T no room to fit
template <int D>
__host__ __device__ constexpr int bq() {
  return D == 128 ? 32 : 64;
}

template <int D>
struct Smem {
  static constexpr int BQ = bq<D>();
  alignas(1024) bf16 k[kBK * D];
  alignas(1024) bf16 v[kBK * D];
  alignas(1024) bf16 q[kStages][BQ * D];
  alignas(1024) bf16 dout[kStages][BQ * D];
  // BQ + 4 values from a 16-byte aligned start, each stage 128-byte aligned
  static constexpr int LS = (BQ + 4 + 31) / 32 * 32;
  alignas(128) float lse[kStages][LS];
  alignas(128) float delta[kStages][LS];
  uint64_t kvbar, full[kStages];
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;
}

// the maps of the dkv: Q, K, V and dO at built width D (MapsOf<CUtensorMap>
// at the widths that are multiples of 64), lse and delta
template <typename M>
struct MapsOf {
  M q, k, v, dout;
  CUtensorMap lse, delta;
};
using Maps = MapsOf<CUtensorMap>;
template <int D>
using DkvMaps = MapsOf<sm90::RowMap<D>>;

// where the lse and delta rows of (h, i0, b) start in their stage
__device__ __forceinline__ int stat_skew(const Params& p, int h, int i0, int b) {
  return ((b * p.nh + h) * p.T + i0) & 3;
}

// query tile `it` (head r of the group, then time) into stage s (one thread)
template <int D>
__device__ __forceinline__ void load_q(Smem<D>& sm, const DkvMaps<D>& mp, const Params& p, int it,
                                       int s, int n_qt, int t_begin, int g, int b) {
  constexpr int BQ = bq<D>();
  const int h = g * (p.nh / p.nkv) + it / n_qt;
  const int i0 = t_begin + (it % n_qt) * BQ;
  sm90::mbar_expect_tx(&sm.full[s], 2 * BQ * D * 2 + 2 * (BQ + 4) * 4);
  sm90::tma_rows<D, BQ>(sm.q[s], &mp.q, &sm.full[s], h, i0, b);
  sm90::tma_rows<D, BQ>(sm.dout[s], &mp.dout, &sm.full[s], h, i0, b);
  // a TMA box starts on 16 bytes: the rows from (b * nh + h) * T + i0 sit
  // stat_skew values into the box
  const int stat = (b * p.nh + h) * p.T + i0;
  sm90::tma_load_1d(sm.lse[s], &mp.lse, &sm.full[s], stat & ~3);
  sm90::tma_load_1d(sm.delta[s], &mp.delta, &sm.full[s], stat & ~3);
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel_sm90(const __grid_constant__ DkvMaps<D> mp, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  constexpr int BQ = bq<D>();
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = smem_aligned<Smem<D>>(smem_raw);
  const int g = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * kBK;
  const int rep = p.nh / p.nkv;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // the first query row that sees this key tile (j0 is a multiple of BQ)
  const int t_begin = p.causal ? j0 : 0;
  const int n_qt = p.T > t_begin ? (p.T - t_begin + BQ - 1) / BQ : 0;
  const int n_it = rep * n_qt;

  if (tid == 0) {
    mbar_init(&sm.kvbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_it > 0) {
    mbar_expect_tx(&sm.kvbar, 2 * kBK * D * 2);
    tma_rows<D, kBK>(sm.k, &mp.k, &sm.kvbar, g, j0, b);
    tma_rows<D, kBK>(sm.v, &mp.v, &sm.kvbar, g, j0, b);
    for (int it = 0; it < kStages && it < n_it; ++it)
      load_q<D>(sm, mp, p, it, it, n_qt, t_begin, g, b);
  }

  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const int r0 = w * 16 + (lane >> 2);  // this thread's key rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);        // and query columns 8 j + c0 + {0, 1}

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  if (n_it > 0) mbar_wait(&sm.kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int h = g * rep + it / n_qt;
    const int i0 = t_begin + (it % n_qt) * BQ;
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      st[i] = 0.f;
      dpt[i] = 0.f;
    }
    mbar_wait(&sm.full[s], ph);
    fence_regs(st);
    fence_regs(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, 0, 0>(st, kdesc<D, kBK>(sm.k, kk), kdesc<D, BQ>(sm.q[s], kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, 0, 0>(dpt, kdesc<D, kBK>(sm.v, kk), kdesc<D, BQ>(sm.dout[s], kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // mask only tiles on the diagonal or at the ragged ends
    const bool edge = (p.causal && j0 + kBK - 1 > i0) || i0 + BQ > p.T || j0 + kBK > p.S;
    const uint32_t row = flash::drop_row(p, b, h);
    const float* lse_s = sm.lse[s] + stat_skew(p, h, i0, b);
    const float* dl_s = sm.delta[s] + stat_skew(p, h, i0, b);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int ih = (i >> 1) & 1;
      const int qi = 8 * (i >> 2) + c0 + (i & 1);
      const int kp = j0 + r0 + 8 * ih, qp = i0 + qi;
      const float lse = lse_s[qi], dl = dl_s[qi];
      bool ok = true;
      if (edge) ok = qp < p.T && kp < p.S && (!p.causal || kp <= qp);
      // the fp32 score q.k * scale, then exp(score - lse)
      const float pv = ok ? exp2_ftz((st[i] * p.scale - lse) * kLog2e) : 0.f;
      float d = dpt[i], pm = pv;
      if (p.dropout) {
        const float mk = flash::keep(p, s0, s1, row, qp, kp);
        pm = pv * mk;
        d *= mk;
      }
      st[i] = pm;                 // P^T * mask, rounded to bf16 below
      dpt[i] = pv * (d - dl);     // dS^T
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_frag(st, kk, pa[kk]);
      acc_to_frag(dpt, kk, da[kk]);
    }
    fence_regs(dv);
    fence_regs(dk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_mn<D, BQ>(dv, pa[kk], sm.dout[s], kk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs_mn<D, BQ>(dk, da[kk], sm.q[s], kk);
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // every product on stage s is done: refill it
    if (tid == 0 && it + kStages < n_it) load_q<D>(sm, mp, p, it + kStages, s, n_qt, t_begin, g, b);
  }

  const long long base = (long long)b * p.S * p.nkv * dh + (long long)g * dh;
  bf16* dk_out = static_cast<bf16*>(p.out0) + base;
  bf16* dv_out = static_cast<bf16*>(p.out1) + base;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int kp = j0 + r0 + 8 * ih;
    if (kp >= p.S) continue;
    const long long off = (long long)kp * p.nkv * dh + c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      if (kPartial && 8 * jj >= dh) continue;  // columns 8 jj + c0 + {0, 1} lie past d
      *reinterpret_cast<__nv_bfloat162*>(dk_out + off + 8 * jj) = __floats2bfloat162_rn(
          dk[4 * jj + 2 * ih] * p.scale, dk[4 * jj + 2 * ih + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + off + 8 * jj) =
          __floats2bfloat162_rn(dv[4 * jj + 2 * ih], dv[4 * jj + 2 * ih + 1]);
    }
  }
}

template <int D, bool kPartial>
int launch_dkv(const Params& p, void* stream) {
  constexpr int BQ = bq<D>();
  static size_t cap[64] = {};
  const size_t smem = smem_bytes<D>();
  const int err = flash::set_smem(dkv_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.S == 0 || p.B == 0 || p.nkv == 0) return 0;
  if (p.T == 0) {  // no query sees a key: zero gradients, as the FMA kernel writes
    const size_t n = (size_t)p.B * p.S * p.nkv * p.d * sizeof(bf16);
    cudaMemsetAsync(p.out0, 0, n, (cudaStream_t)stream);
    cudaMemsetAsync(p.out1, 0, n, (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  DkvMaps<D> mp;
  const long long n_stat = (long long)p.B * p.nh * p.T;
  if (!sm90::rows_map(&mp.q, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, BQ) ||
      !sm90::rows_map(&mp.dout, p.dout, p.d, p.nh, p.T, p.B, p.do_st, p.do_sb, BQ) ||
      !sm90::rows_map(&mp.k, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kBK) ||
      !sm90::rows_map(&mp.v, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kBK) ||
      !sm90::vec_map(&mp.lse, p.lse_in, n_stat, BQ + 4) ||
      !sm90::vec_map(&mp.delta, p.delta, n_stat, BQ + 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nkv, p.B, (p.S + kBK - 1) / kBK);
  dkv_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

// ---- bf16 dq at widths 64 and 128: wgmma on TMA-fed shared memory ----------

constexpr int kBQ = 64;  // query rows per dq CTA: one warpgroup

template <int D>
struct DqSmem {
  alignas(1024) bf16 q[kBQ * D];
  alignas(1024) bf16 dout[kBQ * D];
  alignas(1024) bf16 k[kStages][kBK * D];
  alignas(1024) bf16 v[kStages][kBK * D];
  uint64_t qbar, full[kStages];
};

// the maps of the dq: Q, K, V and dO at built width D
template <int D>
struct DqMaps {
  sm90::RowMap<D> q, k, v, dout;
};

// K and V tile j of kv head g into stage s (one thread)
template <int D>
__device__ __forceinline__ void load_kv(DqSmem<D>& sm, const DqMaps<D>& mp, int j, int s, int g,
                                        int b) {
  sm90::mbar_expect_tx(&sm.full[s], 2 * kBK * D * 2);
  sm90::tma_rows<D, kBK>(sm.k[s], &mp.k, &sm.full[s], g, j * kBK, b);
  sm90::tma_rows<D, kBK>(sm.v[s], &mp.v, &sm.full[s], g, j * kBK, b);
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    dq_kernel_sm90(const __grid_constant__ DqMaps<D> mp, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = smem_aligned<DqSmem<D>>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest tiles first
  const int g = h / (p.nh / p.nkv);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // the keys any row of this tile may see
  const int n_keys = p.causal ? min(p.S, i0 + kBQ) : p.S;
  const int n_kt = (n_keys + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.qbar, 2 * kBQ * D * 2);
    tma_rows<D, kBQ>(sm.q, &mp.q, &sm.qbar, h, i0, b);
    tma_rows<D, kBQ>(sm.dout, &mp.dout, &sm.qbar, h, i0, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv<D>(sm, mp, j, j, g, b);
  }

  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const uint32_t row = flash::drop_row(p, b, h);
  const int r0 = w * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane & 3);        // and columns 8 j + c0 + {0, 1}
  const long long stat = (long long)(b * p.nh + h) * p.T;
  float lse[2], dl[2];
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = i0 + r0 + 8 * ih;
    lse[ih] = qp < p.T ? p.lse_in[stat + qp] : 0.f;
    dl[ih] = qp < p.T ? p.delta[stat + qp] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(&sm.qbar, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const int k0 = j * kBK;
    float sc[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      sc[i] = 0.f;
      dp[i] = 0.f;
    }
    mbar_wait(&sm.full[s], ph);
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBK, 0, 0>(sc, kdesc<D, kBQ>(sm.q, kk), kdesc<D, kBK>(sm.k[s], kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBK, 0, 0>(dp, kdesc<D, kBQ>(sm.dout, kk), kdesc<D, kBK>(sm.v[s], kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // mask only tiles on the diagonal or at the ragged ends
    const bool edge = (p.causal && k0 + kBK - 1 > i0) || i0 + kBQ > p.T || k0 + kBK > p.S;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int ih = (i >> 1) & 1;
      const int qp = i0 + r0 + 8 * ih, kp = k0 + 8 * (i >> 2) + c0 + (i & 1);
      bool ok = true;
      if (edge) ok = qp < p.T && kp < p.S && (!p.causal || kp <= qp);
      // the fp32 score q.k * scale, then exp(score - lse), as the FMA dq
      // kernel forms it
      const float pv = ok ? expf(sc[i] * p.scale - lse[ih]) : 0.f;
      float d = dp[i];
      if (p.dropout) d *= flash::keep(p, s0, s1, row, qp, kp);
      sc[i] = pv * (d - dl[ih]);  // dS, rounded to bf16 below
    }
    uint32_t da[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) acc_to_frag(sc, kk, da[kk]);
    fence_regs(dq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs_mn<D, kBK>(dq, da[kk], sm.k[s], kk);
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);
    __syncthreads();  // every product on stage s is done: refill it
    if (tid == 0 && j + kStages < n_kt) load_kv<D>(sm, mp, j + kStages, s, g, b);
  }

  bf16* out = static_cast<bf16*>(p.out0) + (long long)b * p.T * p.nh * dh + (long long)h * dh;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = i0 + r0 + 8 * ih;
    if (qp >= p.T) continue;
    bf16* orow = out + (long long)qp * p.nh * dh + c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      if (!kPartial || 8 * jj < dh)  // columns 8 jj + c0 + {0, 1}: below d exactly when 8 jj is
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) = __floats2bfloat162_rn(
          dq[4 * jj + 2 * ih] * p.scale, dq[4 * jj + 2 * ih + 1] * p.scale);
  }
}

template <int D, bool kPartial>
int launch_dq(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(DqSmem<D>) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(dq_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  if (p.S == 0) {  // no key to attend to: zero gradients, as the FMA kernel writes
    cudaMemsetAsync(p.out0, 0, (size_t)p.B * p.T * p.nh * p.d * sizeof(bf16),
                    (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  DqMaps<D> mp;
  if (!sm90::rows_map(&mp.q, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, kBQ) ||
      !sm90::rows_map(&mp.dout, p.dout, p.d, p.nh, p.T, p.B, p.do_st, p.do_sb, kBQ) ||
      !sm90::rows_map(&mp.k, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kBK) ||
      !sm90::rows_map(&mp.v, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nh, p.B, (p.T + kBQ - 1) / kBQ);
  dq_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

}  // namespace flash_sm90

// ---- bf16 dkv at head size 256: warp-specialized wgmma --------------------

namespace flash_ws {

using flash_sm90::Maps;
using sm90::bf16;
constexpr int kBK = 64;              // key rows a CTA
constexpr int kBQ = 64;              // query rows a tile; each consumer forms 32 of them
constexpr int kHalf = kBQ / 2;
constexpr int kStages = 2;
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread after setmaxnreg, out of the 168 x 384 the launch
// gives the CTA: 2 x 128 x 240 + 128 x 24 = 64512
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  alignas(1024) bf16 k[kBK * D];
  alignas(1024) bf16 v[kBK * D];
  alignas(1024) bf16 q[kStages][kBQ * D];
  alignas(1024) bf16 dout[kStages][kBQ * D];
  // P^T * mask and dS^T of the tile, bf16, 64 keys x 64 queries, laid out
  // as a TMA tile (128-byte swizzle): the K-major A operand of dV and dK
  alignas(1024) bf16 pt[kBK * kBQ];
  alignas(1024) bf16 dst[kBK * kBQ];
  // kBQ + 4 values from a 16-byte aligned start, each stage 128-byte aligned
  static constexpr int LS = (kBQ + 4 + 31) / 32 * 32;
  alignas(128) float lse[kStages][LS];
  alignas(128) float delta[kStages][LS];
  uint64_t kvbar, full[kStages], empty[kStages];
};

// query tile `it` (head r of the group, then time) into stage s (one thread)
template <int D>
__device__ __forceinline__ void load_q(Smem<D>& sm, const Maps& mp, const Params& p, int it,
                                       int s, int n_qt, int t_begin, int g, int b) {
  const int h = g * (p.nh / p.nkv) + it / n_qt;
  const int i0 = t_begin + (it % n_qt) * kBQ;
  sm90::mbar_expect_tx(&sm.full[s], 2 * kBQ * D * 2 + 2 * (kBQ + 4) * 4);
  sm90::tma_rows<D, kBQ>(sm.q[s], &mp.q, &sm.full[s], h, i0, b);
  sm90::tma_rows<D, kBQ>(sm.dout[s], &mp.dout, &sm.full[s], h, i0, b);
  const int stat = (b * p.nh + h) * p.T + i0;
  sm90::tma_load_1d(sm.lse[s], &mp.lse, &sm.full[s], stat & ~3);
  sm90::tma_load_1d(sm.delta[s], &mp.delta, &sm.full[s], stat & ~3);
}

// A consumer's walk over the query tiles (every head of the GQA group,
// from the causal frontier on) of the key tile at j0: S^T and dP^T, then
// P^T and dS^T in registers, to shared memory as bf16, then the tile's dV
// and dK products. r0, c0: this thread's key rows r0, r0 + 8 and query
// columns 8 j + c0 + {0, 1} in the accumulator layout.
template <bool DROP, int D>
__device__ __forceinline__ void dkv_walk(Smem<D>& sm, const Params& p, int j0, int g, int b,
                                         int n_qt, int t_begin, int n_it, int w, int r0, int c0,
                                         uint32_t s0, uint32_t s1, float (&dk)[D / 4],
                                         float (&dv)[D / 4]) {
  using namespace sm90;
  constexpr int DN = D / 2;
  const int rep = p.nh / p.nkv, lane = threadIdx.x & 31;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int h = g * rep + it / n_qt;
    const int i0 = t_begin + (it % n_qt) * kBQ;
    // S^T = K Q^T and dP^T = V dO^T over this consumer's 32 queries:
    // m64n32k16, both operands K-major, the queries from row 32 w of the
    // stage's tiles (an 8-row group boundary of the swizzle)
    float st[kHalf / 2], dpt[kHalf / 2];
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    fence_regs(st);
    fence_regs(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kHalf, 0, 0>(st, desc_kmajor<kBK>(sm.k, kk),
                            desc_kmajor<kBQ>(sm.q[s] + kHalf * w * 64, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kHalf, 0, 0>(dpt, desc_kmajor<kBK>(sm.v, kk),
                            desc_kmajor<kBQ>(sm.dout[s] + kHalf * w * 64, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // mask only tiles on the diagonal or at the ragged ends
    const bool edge = (p.causal && j0 + kBK - 1 > i0) || i0 + kBQ > p.T || j0 + kBK > p.S;
    const uint32_t row = flash::drop_row(p, b, h);
    const float* lse_s = sm.lse[s] + flash_sm90::stat_skew(p, h, i0, b);
    const float* dl_s = sm.delta[s] + flash_sm90::stat_skew(p, h, i0, b);
#pragma unroll
    for (int i = 0; i < kHalf / 2; ++i) {
      const int ih = (i >> 1) & 1;
      const int qi = kHalf * w + 8 * (i >> 2) + c0 + (i & 1);
      const int kp = j0 + r0 + 8 * ih, qp = i0 + qi;
      bool ok = true;
      if (edge) ok = qp < p.T && kp < p.S && (!p.causal || kp <= qp);
      // the fp32 score q.k * scale, then exp(score - lse)
      const float pv = ok ? exp2_ftz((st[i] * p.scale - lse_s[qi]) * kLog2e) : 0.f;
      float d = dpt[i], pm = pv;
      if constexpr (DROP) {
        const float mk = flash::keep(p, s0, s1, row, qp, kp);
        pm = pv * mk;
        d *= mk;
      }
      st[i] = pm;                    // P^T * mask
      dpt[i] = pv * (d - dl_s[qi]);  // dS^T
    }
    bar_sync(1, kConsumers);  // the last tile's products have read P^T / dS^T
    // this thread's values, rounded to bf16, at key rows r0 (+ 8), query
    // columns 32 w + 8 j + c0 (16-byte chunk 4 w + j)
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
      for (int ih = 0; ih < 2; ++ih) {
        const int off = swz<kBK>(r0 + 8 * ih, (kHalf / 8) * w + j) + c0;
        *reinterpret_cast<__nv_bfloat162*>(sm.pt + off) =
            __floats2bfloat162_rn(st[4 * j + 2 * ih], st[4 * j + 2 * ih + 1]);
        *reinterpret_cast<__nv_bfloat162*>(sm.dst + off) =
            __floats2bfloat162_rn(dpt[4 * j + 2 * ih], dpt[4 * j + 2 * ih + 1]);
      }
    fence_proxy_async();
    bar_sync(1, kConsumers);  // both halves are written

    // dV[:, cols] += (P^T * mask) dO[:, cols] and dK[:, cols] += dS^T Q[:,
    // cols] over the tile's 64 queries: m64n128k16, A K-major from the
    // shared P^T / dS^T tiles, dO and Q read MN-major from 64-column
    // sub-tile 2 w on
    fence_regs(dv);
    fence_regs(dk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_ss<DN, 0, 1>(dv, desc_kmajor<kBK>(sm.pt, kk),
                         desc_mnmajor<kBQ>(sm.dout[s] + w * DN * kBQ, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_ss<DN, 0, 1>(dk, desc_kmajor<kBK>(sm.dst, kk),
                         desc_mnmajor<kBQ>(sm.q[s] + w * DN * kBQ, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive_if(&sm.empty[s], lane == 0);  // this warp is done with stage s
  }
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel_sm90(const __grid_constant__ Maps mp, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  constexpr int DN = D / 2;  // dK and dV columns a consumer owns
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = smem_aligned<Smem<D>>(smem_raw);
  // key tiles on the grid's fastest axis, the causal heaviest first: the
  // CTAs of one (kv head, batch) run together and share its Q and dO in L2
  const int j0 = blockIdx.x * kBK, g = blockIdx.y, b = blockIdx.z;
  const int rep = p.nh / p.nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the first query row that sees this key tile (j0 is a multiple of kBQ)
  const int t_begin = p.causal ? j0 : 0;
  const int n_qt = p.T > t_begin ? (p.T - t_begin + kBQ - 1) / kBQ : 0;
  const int n_it = rep * n_qt;

  if (tid == 0) {
    mbar_init(&sm.kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one lane issues
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0 && n_it > 0) {
      mbar_expect_tx(&sm.kvbar, 2 * kBK * D * 2);
      tma_rows<D, kBK>(sm.k, &mp.k, &sm.kvbar, g, j0, b);
      tma_rows<D, kBK>(sm.v, &mp.v, &sm.kvbar, g, j0, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        // the stage's previous tile is handed back (none on the first lap)
        if (it >= kStages) mbar_wait(&sm.empty[s], ((it / kStages) & 1) ^ 1);
        flash_ws::load_q<D>(sm, mp, p, it, s, n_qt, t_begin, g, b);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int w = warp >> 2;  // consumer: queries 32 w .. of each tile, columns DN w .. of dK, dV
  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const int r0 = (warp & 3) * 16 + (lane >> 2);  // this thread's key rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);                 // and query columns 8 j + c0 + {0, 1}

  float dk[DN / 2], dv[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  if (n_it > 0) mbar_wait(&sm.kvbar, 0);
  // the walk over the query tiles, with dropout picked once, outside it
  // (a test of p.dropout inside it ran slower on the H100)
  if (p.dropout)
    dkv_walk<true, D>(sm, p, j0, g, b, n_qt, t_begin, n_it, w, r0, c0, s0, s1, dk, dv);
  else
    dkv_walk<false, D>(sm, p, j0, g, b, n_qt, t_begin, n_it, w, r0, c0, s0, s1, dk, dv);

  const long long base = (long long)b * p.S * p.nkv * dh + (long long)g * dh + w * DN;
  bf16* dk_out = static_cast<bf16*>(p.out0) + base;
  bf16* dv_out = static_cast<bf16*>(p.out1) + base;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int kp = j0 + r0 + 8 * ih;
    if (kp >= p.S) continue;
    const long long off = (long long)kp * p.nkv * dh + c0;
#pragma unroll
    for (int jj = 0; jj < DN / 8; ++jj) {
      if (kPartial && w * DN + 8 * jj >= dh) continue;  // columns past d
      *reinterpret_cast<__nv_bfloat162*>(dk_out + off + 8 * jj) = __floats2bfloat162_rn(
          dk[4 * jj + 2 * ih] * p.scale, dk[4 * jj + 2 * ih + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + off + 8 * jj) =
          __floats2bfloat162_rn(dv[4 * jj + 2 * ih], dv[4 * jj + 2 * ih + 1]);
    }
  }
}

template <int D, bool kPartial>
int launch_dkv(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(dkv_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.S == 0 || p.B == 0 || p.nkv == 0) return 0;
  if (p.T == 0) {  // no query sees a key: zero gradients, as the FMA kernel writes
    const size_t n = (size_t)p.B * p.S * p.nkv * p.d * sizeof(bf16);
    cudaMemsetAsync(p.out0, 0, n, (cudaStream_t)stream);
    cudaMemsetAsync(p.out1, 0, n, (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  Maps mp;
  const long long n_stat = (long long)p.B * p.nh * p.T;
  if (!sm90::rows_map(&mp.q, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, kBQ) ||
      !sm90::rows_map(&mp.dout, p.dout, p.d, p.nh, p.T, p.B, p.do_st, p.do_sb, kBQ) ||
      !sm90::rows_map(&mp.k, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kBK) ||
      !sm90::rows_map(&mp.v, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kBK) ||
      !sm90::vec_map(&mp.lse, p.lse_in, n_stat, kBQ + 4) ||
      !sm90::vec_map(&mp.delta, p.delta, n_stat, kBQ + 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p.S + kBK - 1) / kBK, p.nkv, p.B);
  // qualified: Maps would also bring flash_sm90's kernel in by argument lookup
  flash_ws::dkv_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

// ---- bf16 dq at widths 192 and 256: warp-specialized wgmma ----------------

using flash_sm90::DqMaps;
constexpr int kDqRows = 64;             // query rows a consumer warpgroup
constexpr int kDqBQ = 2 * kDqRows;      // query rows a CTA

// keys a stage (at width 256, Q and dO of 128 rows take 128 KB, and
// 64-key stages would need 256 KB)
constexpr int kDqBK = 32;

// stages of the K / V ring: 3 at width 256 (224 KB in all), 4 at 192
// (192 KB). A stage's K is handed back only once both consumers' dQ +=
// dS K on it is done, a turn after its S; with 2 stages the producer could
// only then start the load of the tile after next, and the consumers
// waited for it (B 8, T 1024, causal, on an H100 in one process: 8 x 256
// 0.2212 ms at 2 stages, 0.1723 at 3; 12 x 192 0.2216 at 2 stages of 64
// keys, 0.2093 at 4 of 32)
template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D > 192 ? 3 : 4;
}

template <int D>
struct DqSmem {
  static constexpr int NS = dq_stages<D>();
  alignas(1024) bf16 q[2][kDqRows * D];     // each consumer's 64 rows
  alignas(1024) bf16 dout[2][kDqRows * D];
  alignas(1024) bf16 k[NS][kDqBK * D];
  alignas(1024) bf16 v[NS][kDqBK * D];
  // K and V go back separately: V once both consumers' dP on it is done,
  // K once their dQ += dS K is, a turn later
  uint64_t qbar, kfull[NS], vfull[NS], kempty[NS], vempty[NS];
};

// A descriptor made opaque to the compiler, so that the ones derived from
// it for each k-step are formed where they are used: hoisted out of the
// walk, the 32 k-step descriptors of Q and dO would hold 32 registers
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// k-step kk's descriptor from k-step 0's (an R-row tile read K-major, as
// desc_kmajor<R>): + kk % 4 * 32 bytes, + R * 128 bytes every 4 k-steps
template <int R>
__device__ __forceinline__ uint64_t kstep(uint64_t d0, int kk) {
  return d0 + ((((kk >> 2) * R * 128) + (kk & 3) * 32) >> 4);
}

// What a dq consumer needs besides its accumulators: its first query row
// q0, this thread's rows r0, r0 + 8 and columns 8 j + c0 + {0, 1} of the
// accumulator layout, the lse and delta of its two rows, the key each row
// stops before (0 for a row past T), and the dropout seed and row
struct DqRows {
  int q0, r0, c0;
  float lse[2], dl[2];
  int kend[2];
  uint32_t s0, s1, row;
};

// S = Q K^T and dP = dO V^T over key tile stage s, this consumer's 64 rows
// (m64n32k16, both operands K-major), summed from zero as the
// single-warpgroup design summed them
template <int D>
__device__ __forceinline__ void issue_sdp(DqSmem<D>& sm, float (&sc)[kDqBK / 2],
                                          float (&dp)[kDqBK / 2], int w, int s) {
  using namespace sm90;
  const uint64_t dq0 = opaque(desc_kmajor<kDqRows>(sm.q[w], 0));
  const uint64_t ddo0 = opaque(desc_kmajor<kDqRows>(sm.dout[w], 0));
  const uint64_t dk0 = desc_kmajor<kDqBK>(sm.k[s], 0), dv0 = desc_kmajor<kDqBK>(sm.v[s], 0);
#pragma unroll
  for (int i = 0; i < kDqBK / 2; ++i) {
    sc[i] = 0.f;
    dp[i] = 0.f;
  }
  fence_regs(sc);
  fence_regs(dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kDqBK, 0, 0>(sc, kstep<kDqRows>(dq0, kk), kstep<kDqBK>(dk0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kDqBK, 0, 0>(dp, kstep<kDqRows>(ddo0, kk), kstep<kDqBK>(dv0, kk), 1);
  wg_commit();
}

// dQ += dS K over the key tile in stage s, K read MN-major
template <int D>
__device__ __forceinline__ void issue_dq(DqSmem<D>& sm, float (&dq)[D / 2],
                                         const uint32_t (&da)[kDqBK / 16][4], int s) {
  using namespace sm90;
  fence_regs(dq);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kDqBK / 16; ++kk)
    wgmma_rs<D, 1>(dq, da[kk], desc_mnmajor<kDqBK>(sm.k[s], kk));
  wg_commit();
}

// Key tile j's S and dP -> dS = p (dP * mask - delta) in sc (fp32), p =
// exp(s * scale - lse) of the fp32 score, as the FMA dq kernel and the
// plain version form it. It runs while this consumer's dQ += dS K of the
// tile before is in flight, so it has no branch: every tile is masked by
// selects against each row's kend (a no-op off the diagonal and the
// ragged ends), the dropout mask picked at compile time.
template <bool DROP, int BK = kDqBK>
__device__ __forceinline__ void form_ds(const Params& p, const DqRows& rw, float (&sc)[BK / 2],
                                        const float (&dp)[BK / 2], int j) {
  const int k0 = j * BK;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int ih = (i >> 1) & 1;
    const int kp = k0 + 8 * (i >> 2) + rw.c0 + (i & 1);
    const float pv = kp < rw.kend[ih] ? expf(sc[i] * p.scale - rw.lse[ih]) : 0.f;
    float d = dp[i];
    // rounded before the subtraction (no FMA), as the single-warpgroup
    // design, whose mask was a run-time branch, rounded it
    if constexpr (DROP)
      d = __fmul_rn(d, flash::keep(p, rw.s0, rw.s1, rw.row, rw.q0 + rw.r0 + 8 * ih, kp));
    sc[i] = pv * (d - rw.dl[ih]);  // dS, rounded to bf16 when packed
  }
}

// A consumer's walk over its nw key tiles. Ping-pong, as in the forward:
// each consumer issues its products in turns (named barrier 1 + w is "w's
// turn", `two` where both consumers run), so that one's products run
// while the other forms dS. Both take the CTA's n_kt + 1 turns: consumer
// 1 sees all n_kt tiles, consumer 0 n_kt or, causal, up to 64 / 32 = 2
// fewer, and takes that many turns with no work (`extra`) at the end;
// consumer 1's last turn hands on nothing, so every arrival meets its
// wait. The producer waits only for the release of tiles up to n_kt - 1
// - NS, which consumer 0 sees (2 <= NS). A turn issues S and dP of tile
// j, then dQ += dS K of tile j - 1, and forms tile j's dS as soon as S
// and dP are done, beside that product; dS is packed into the A
// fragments once the product is done.
template <bool DROP, int D>
__device__ __forceinline__ void dq_walk(DqSmem<D>& sm, const Params& p, const DqRows& rw, int w,
                                        int nw, int extra, int two, float (&dq)[D / 2]) {
  using namespace sm90;
  constexpr int NS = dq_stages<D>();
  static_assert(kDqRows / kDqBK <= NS, "consumer 0 must release every tile the producer awaits");
  const int lane = threadIdx.x & 31;
  const int mine = 1 + w, other = 2 - w;
  float sc[kDqBK / 2], dp[kDqBK / 2];
  uint32_t da[kDqBK / 16][4];
  bar_arrive_if(1, kConsumers, two && w == 1);  // the first turn is consumer 0's
  // turn 0: S and dP of tile 0
  bar_sync_if(mine, kConsumers, two);
  mbar_wait(&sm.kfull[0], 0);
  mbar_wait(&sm.vfull[0], 0);
  issue_sdp<D>(sm, sc, dp, w, 0);
  bar_arrive_if(other, kConsumers, two);
  wg_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  mbar_arrive_if(&sm.vempty[0], lane == 0);
  form_ds<DROP>(p, rw, sc, dp, 0);
#pragma unroll
  for (int kk = 0; kk < kDqBK / 16; ++kk) acc_to_frag(sc, kk, da[kk]);
  // turns 1 .. nw - 1: S and dP of tile j, dQ += dS K of tile j - 1
  for (int j = 1; j < nw; ++j) {
    const int s = j % NS, sp = (j - 1) % NS;
    bar_sync_if(mine, kConsumers, two);
    mbar_wait(&sm.kfull[s], (j / NS) & 1);
    mbar_wait(&sm.vfull[s], (j / NS) & 1);
    issue_sdp<D>(sm, sc, dp, w, s);
    issue_dq<D>(sm, dq, da, sp);
    bar_arrive_if(other, kConsumers, two);
    wg_wait<1>();  // S and dP of tile j
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive_if(&sm.vempty[s], lane == 0);
    form_ds<DROP>(p, rw, sc, dp, j);
    wg_wait<0>();  // dQ += dS K of tile j - 1
    fence_regs(dq);
    mbar_arrive_if(&sm.kempty[sp], lane == 0);
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk) acc_to_frag(sc, kk, da[kk]);
  }
  // turn nw: dQ += dS K of the last tile
  const int sp = (nw - 1) % NS;
  bar_sync_if(mine, kConsumers, two);
  issue_dq<D>(sm, dq, da, sp);
  bar_arrive_if(other, kConsumers, two && w == 0);
  wg_wait<0>();
  fence_regs(dq);
  mbar_arrive_if(&sm.kempty[sp], lane == 0);
  for (int e = 0; e < extra; ++e) {
    bar_sync_if(mine, kConsumers, two);
    bar_arrive_if(other, kConsumers, two);
  }
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel_sm90(const __grid_constant__ DqMaps<D> mp, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  constexpr int NS = dq_stages<D>();
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = smem_aligned<DqSmem<D>>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kDqBQ;  // heaviest tiles first
  const int g = h / (p.nh / p.nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // consumers with a live row: the second has none where T ends in the
  // first's 64 rows
  const int n_live = i0 + kDqRows < p.T ? 2 : 1;
  // key tiles the rows before q_end may see (at least one: S > 0)
  auto tiles_to = [&](int q_end) {
    return (min(p.S, p.causal ? q_end : p.S) + kDqBK - 1) / kDqBK;
  };

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.kfull[s], 1);
      mbar_init(&sm.vfull[s], 1);
      mbar_init(&sm.kempty[s], 4 * n_live);  // one arrival per consumer warp
      mbar_init(&sm.vempty[s], 4 * n_live);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one lane issues
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      const int n_kt = tiles_to(i0 + kDqRows * n_live);  // the last live consumer's
      mbar_expect_tx(&sm.qbar, 2 * n_live * kDqRows * D * 2);
      for (int w = 0; w < n_live; ++w) {
        tma_rows<D, kDqRows>(sm.q[w], &mp.q, &sm.qbar, h, i0 + kDqRows * w, b);
        tma_rows<D, kDqRows>(sm.dout[w], &mp.dout, &sm.qbar, h, i0 + kDqRows * w, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % NS;
        const uint32_t ph = ((j / NS) & 1) ^ 1;
        // the stage's previous V, then K, is handed back (none on the first lap)
        if (j >= NS) mbar_wait(&sm.vempty[s], ph);
        mbar_expect_tx(&sm.vfull[s], kDqBK * D * 2);
        tma_rows<D, kDqBK>(sm.v[s], &mp.v, &sm.vfull[s], g, j * kDqBK, b);
        if (j >= NS) mbar_wait(&sm.kempty[s], ph);
        mbar_expect_tx(&sm.kfull[s], kDqBK * D * 2);
        tma_rows<D, kDqBK>(sm.k[s], &mp.k, &sm.kfull[s], g, j * kDqBK, b);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int w = warp >> 2;  // consumer warpgroup: query rows i0 + 64 w ..
  if (w >= n_live) return;
  DqRows rw;
  rw.q0 = i0 + kDqRows * w;
  rw.r0 = (warp & 3) * 16 + (lane >> 2);
  rw.c0 = 2 * (lane & 3);
  rw.s0 = rw.s1 = 0u;
  if (p.dropout) {
    rw.s0 = (uint32_t)p.seed[0];
    rw.s1 = (uint32_t)p.seed[1];
  }
  rw.row = flash::drop_row(p, b, h);
  const long long stat = (long long)(b * p.nh + h) * p.T;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = rw.q0 + rw.r0 + 8 * ih;
    rw.lse[ih] = qp < p.T ? p.lse_in[stat + qp] : 0.f;
    rw.dl[ih] = qp < p.T ? p.delta[stat + qp] : 0.f;
    rw.kend[ih] = qp < p.T ? min(p.S, p.causal ? qp + 1 : p.S) : 0;
  }
  const int nw = tiles_to(rw.q0 + kDqRows);  // its key tiles
  const int extra = tiles_to(i0 + kDqRows * n_live) - nw;
  const int two = n_live == 2;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(&sm.qbar, 0);
  // dropout picked once, outside the walk
  if (p.dropout)
    dq_walk<true, D>(sm, p, rw, w, nw, extra, two, dq);
  else
    dq_walk<false, D>(sm, p, rw, w, nw, extra, two, dq);

  bf16* out = static_cast<bf16*>(p.out0) + (long long)b * p.T * p.nh * dh + (long long)h * dh;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = rw.q0 + rw.r0 + 8 * ih;
    if (qp >= p.T) continue;
    bf16* orow = out + (long long)qp * p.nh * dh + rw.c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      if (!kPartial || 8 * jj < dh)  // columns 8 jj + c0 + {0, 1}: below d exactly when 8 jj is
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) = __floats2bfloat162_rn(
            dq[4 * jj + 2 * ih] * p.scale, dq[4 * jj + 2 * ih + 1] * p.scale);
  }
}

template <int D, bool kPartial>
int launch_dq(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(DqSmem<D>) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(dq_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  if (p.S == 0) {  // no key to attend to: zero gradients, as the FMA kernel writes
    cudaMemsetAsync(p.out0, 0, (size_t)p.B * p.T * p.nh * p.d * sizeof(bf16),
                    (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  DqMaps<D> mp;
  if (!sm90::rows_map(&mp.q, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, kDqRows) ||
      !sm90::rows_map(&mp.dout, p.dout, p.d, p.nh, p.T, p.B, p.do_st, p.do_sb, kDqRows) ||
      !sm90::rows_map(&mp.k, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kDqBK) ||
      !sm90::rows_map(&mp.v, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kDqBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nh, p.B, (p.T + kDqBQ - 1) / kDqBQ);
  // qualified: DqMaps would also bring flash_sm90's kernel in by argument lookup
  flash_ws::dq_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

}  // namespace flash_ws

// ---- bf16 dq and dkv at width 32: one warpgroup, products pipelined --------

namespace flash_pipe {

using flash_sm90::DkvMaps;
using flash_sm90::DqMaps;
using flash_sm90::kLog2e;
using flash_sm90::kThreads;  // one warpgroup
using sm90::bf16;
constexpr int kB = 64;  // dq: query rows a CTA, keys a stage; dkv: keys a CTA, query rows a tile
constexpr int kStages = 4;

template <int D>
struct DqSmem {
  alignas(1024) bf16 q[kB * D];
  alignas(1024) bf16 dout[kB * D];
  alignas(1024) bf16 k[kStages][kB * D];
  alignas(1024) bf16 v[kStages][kB * D];
  uint64_t qbar, full[kStages];
};

template <int D>
__device__ __forceinline__ void load_kv(DqSmem<D>& sm, const DqMaps<D>& mp, int j, int s, int g,
                                        int b) {
  sm90::mbar_expect_tx(&sm.full[s], 2 * kB * D * 2);
  sm90::tma_rows<D, kB>(sm.k[s], &mp.k, &sm.full[s], g, j * kB, b);
  sm90::tma_rows<D, kB>(sm.v[s], &mp.v, &sm.full[s], g, j * kB, b);
}

// S = Q K^T and dP = dO V^T over the key tile in stage s, from zero
template <int D>
__device__ __forceinline__ void issue_sdp(DqSmem<D>& sm, float (&sc)[kB / 2], float (&dp)[kB / 2],
                                          int s) {
  using namespace sm90;
#pragma unroll
  for (int i = 0; i < kB / 2; ++i) {
    sc[i] = 0.f;
    dp[i] = 0.f;
  }
  fence_regs(sc);
  fence_regs(dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kB, 0, 0>(sc, kdesc<D, kB>(sm.q, kk), kdesc<D, kB>(sm.k[s], kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kB, 0, 0>(dp, kdesc<D, kB>(sm.dout, kk), kdesc<D, kB>(sm.v[s], kk), 1);
  wg_commit();
}

// dQ += dS K over the key tile in stage s, K read MN-major
template <int D>
__device__ __forceinline__ void issue_dq(DqSmem<D>& sm, float (&dq)[D / 2],
                                         const uint32_t (&da)[kB / 16][4], int s) {
  using namespace sm90;
  fence_regs(dq);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) wgmma_rs_mn<D, kB>(dq, da[kk], sm.k[s], kk);
  wg_commit();
}

// The walk over the n_kt key tiles: a turn issues S and dP of tile j and
// dQ += dS K of tile j - 1, forms tile j's dS (flash_ws::form_ds,
// branch-free) beside that product, then hands stage j - 1 back to the
// ring and packs dS into the A fragments.
template <bool DROP, int D>
__device__ __forceinline__ void dq_walk(DqSmem<D>& sm, const DqMaps<D>& mp, const Params& p,
                                        const flash_ws::DqRows& rw, int n_kt, int g, int b,
                                        float (&dq)[D / 2]) {
  using namespace sm90;
  const int tid = threadIdx.x;
  float sc[kB / 2], dp[kB / 2];
  uint32_t da[kB / 16][4];
  mbar_wait(&sm.full[0], 0);
  issue_sdp<D>(sm, sc, dp, 0);
  wg_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  flash_ws::form_ds<DROP, kB>(p, rw, sc, dp, 0);
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) acc_to_frag(sc, kk, da[kk]);
  for (int j = 1; j < n_kt; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    issue_sdp<D>(sm, sc, dp, s);
    issue_dq<D>(sm, dq, da, sp);
    wg_wait<1>();  // S and dP of tile j
    fence_regs(sc);
    fence_regs(dp);
    flash_ws::form_ds<DROP, kB>(p, rw, sc, dp, j);
    wg_wait<0>();  // dQ += dS K of tile j - 1
    fence_regs(dq);
    __syncthreads();  // every warp is done with stage sp: refill it
    if (tid == 0 && j - 1 + kStages < n_kt) load_kv<D>(sm, mp, j - 1 + kStages, sp, g, b);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) acc_to_frag(sc, kk, da[kk]);
  }
  issue_dq<D>(sm, dq, da, (n_kt - 1) % kStages);
  wg_wait<0>();
  fence_regs(dq);
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    dq_kernel_sm90(const __grid_constant__ DqMaps<D> mp, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = smem_aligned<DqSmem<D>>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kB;  // heaviest tiles first
  const int g = h / (p.nh / p.nkv);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int n_keys = p.causal ? min(p.S, i0 + kB) : p.S;
  const int n_kt = (n_keys + kB - 1) / kB;

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.qbar, 2 * kB * D * 2);
    tma_rows<D, kB>(sm.q, &mp.q, &sm.qbar, h, i0, b);
    tma_rows<D, kB>(sm.dout, &mp.dout, &sm.qbar, h, i0, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv<D>(sm, mp, j, j, g, b);
  }

  flash_ws::DqRows rw;
  rw.q0 = i0;
  rw.r0 = w * 16 + (lane >> 2);
  rw.c0 = 2 * (lane & 3);
  rw.s0 = rw.s1 = 0u;
  if (p.dropout) {
    rw.s0 = (uint32_t)p.seed[0];
    rw.s1 = (uint32_t)p.seed[1];
  }
  rw.row = flash::drop_row(p, b, h);
  const long long stat = (long long)(b * p.nh + h) * p.T;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = i0 + rw.r0 + 8 * ih;
    rw.lse[ih] = qp < p.T ? p.lse_in[stat + qp] : 0.f;
    rw.dl[ih] = qp < p.T ? p.delta[stat + qp] : 0.f;
    rw.kend[ih] = qp < p.T ? min(p.S, p.causal ? qp + 1 : p.S) : 0;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(&sm.qbar, 0);
  if (p.dropout)
    dq_walk<true, D>(sm, mp, p, rw, n_kt, g, b, dq);
  else
    dq_walk<false, D>(sm, mp, p, rw, n_kt, g, b, dq);

  bf16* out = static_cast<bf16*>(p.out0) + (long long)b * p.T * p.nh * dh + (long long)h * dh;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = i0 + rw.r0 + 8 * ih;
    if (qp >= p.T) continue;
    bf16* orow = out + (long long)qp * p.nh * dh + rw.c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      if (!kPartial || 8 * jj < dh)  // columns 8 jj + c0 + {0, 1}: below d exactly when 8 jj is
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) = __floats2bfloat162_rn(
            dq[4 * jj + 2 * ih] * p.scale, dq[4 * jj + 2 * ih + 1] * p.scale);
  }
}

template <int D, bool kPartial>
int launch_dq(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(DqSmem<D>) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(dq_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  if (p.S == 0) {  // no key to attend to: zero gradients, as the FMA kernel writes
    cudaMemsetAsync(p.out0, 0, (size_t)p.B * p.T * p.nh * p.d * sizeof(bf16),
                    (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  DqMaps<D> mp;
  if (!sm90::width_map<D>(&mp.q, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, kB) ||
      !sm90::width_map<D>(&mp.dout, p.dout, p.d, p.nh, p.T, p.B, p.do_st, p.do_sb, kB) ||
      !sm90::width_map<D>(&mp.k, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kB) ||
      !sm90::width_map<D>(&mp.v, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kB))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nh, p.B, (p.T + kB - 1) / kB);
  // qualified: DqMaps would also bring flash_sm90's kernel in by argument lookup
  flash_pipe::dq_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

template <int D>
struct Smem {
  alignas(1024) bf16 k[kB * D];
  alignas(1024) bf16 v[kB * D];
  alignas(1024) bf16 q[kStages][kB * D];
  alignas(1024) bf16 dout[kStages][kB * D];
  // kB + 4 values from a 16-byte aligned start, each stage 128-byte aligned
  static constexpr int LS = (kB + 4 + 31) / 32 * 32;
  alignas(128) float lse[kStages][LS];
  alignas(128) float delta[kStages][LS];
  uint64_t kvbar, full[kStages];
};

// query tile `it` (head r of the group, then time) into stage s (one thread)
template <int D>
__device__ __forceinline__ void load_q(Smem<D>& sm, const DkvMaps<D>& mp, const Params& p, int it,
                                       int s, int n_qt, int t_begin, int g, int b) {
  const int h = g * (p.nh / p.nkv) + it / n_qt;
  const int i0 = t_begin + (it % n_qt) * kB;
  sm90::mbar_expect_tx(&sm.full[s], 2 * kB * D * 2 + 2 * (kB + 4) * 4);
  sm90::tma_rows<D, kB>(sm.q[s], &mp.q, &sm.full[s], h, i0, b);
  sm90::tma_rows<D, kB>(sm.dout[s], &mp.dout, &sm.full[s], h, i0, b);
  const int stat = (b * p.nh + h) * p.T + i0;
  sm90::tma_load_1d(sm.lse[s], &mp.lse, &sm.full[s], stat & ~3);
  sm90::tma_load_1d(sm.delta[s], &mp.delta, &sm.full[s], stat & ~3);
}

// S^T = K Q^T and dP^T = V dO^T over the query tile in stage s, from zero
template <int D>
__device__ __forceinline__ void issue_st(Smem<D>& sm, float (&st)[kB / 2], float (&dpt)[kB / 2],
                                         int s) {
  using namespace sm90;
#pragma unroll
  for (int i = 0; i < kB / 2; ++i) {
    st[i] = 0.f;
    dpt[i] = 0.f;
  }
  fence_regs(st);
  fence_regs(dpt);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kB, 0, 0>(st, kdesc<D, kB>(sm.k, kk), kdesc<D, kB>(sm.q[s], kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kB, 0, 0>(dpt, kdesc<D, kB>(sm.v, kk), kdesc<D, kB>(sm.dout[s], kk), 1);
  wg_commit();
}

// dV += (P^T * mask) dO and dK += dS^T Q over the query tile in stage s,
// dO and Q read MN-major
template <int D>
__device__ __forceinline__ void issue_dvdk(Smem<D>& sm, float (&dv)[D / 2], float (&dk)[D / 2],
                                           const uint32_t (&pa)[kB / 16][4],
                                           const uint32_t (&da)[kB / 16][4], int s) {
  using namespace sm90;
  fence_regs(dv);
  fence_regs(dk);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) wgmma_rs_mn<D, kB>(dv, pa[kk], sm.dout[s], kk);
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) wgmma_rs_mn<D, kB>(dk, da[kk], sm.q[s], kk);
  wg_commit();
}

// Query tile it's S^T and dP^T -> P^T * mask in st and dS^T in dpt (fp32),
// the arithmetic of flash_sm90::dkv_kernel_sm90 without a branch: every
// tile is masked by selects, the dropout products rounded on their own
// (no FMA), as that kernel's branch rounded them.
template <bool DROP, int D>
__device__ __forceinline__ void form_pds(Smem<D>& sm, const Params& p, float (&st)[kB / 2],
                                         float (&dpt)[kB / 2], int it, int s, int n_qt,
                                         int t_begin, int g, int j0, int b, int r0, int c0) {
  // the seed read each turn, not held in two registers across the walk
  const uint32_t s0 = DROP ? (uint32_t)p.seed[0] : 0u, s1 = DROP ? (uint32_t)p.seed[1] : 0u;
  const int h = g * (p.nh / p.nkv) + it / n_qt;
  const int i0 = t_begin + (it % n_qt) * kB;
  // the dropout row formed each turn from an opaque copy of b: its batch
  // part, hoisted out of the walk, held a register and spilled the masked
  // instance
  int bb = b;
  if constexpr (DROP) asm volatile("" : "+r"(bb));
  const uint32_t row = flash::drop_row(p, bb, h);
  const float* lse_s = sm.lse[s] + flash_sm90::stat_skew(p, h, i0, b);
  const float* dl_s = sm.delta[s] + flash_sm90::stat_skew(p, h, i0, b);
#pragma unroll
  for (int i = 0; i < kB / 2; ++i) {
    const int ih = (i >> 1) & 1;
    const int qi = 8 * (i >> 2) + c0 + (i & 1);
    const int kp = j0 + r0 + 8 * ih, qp = i0 + qi;
    const bool ok = (qp < p.T) & (kp < p.S) & (!p.causal | (kp <= qp));
    // the fp32 score q.k * scale, then exp(score - lse)
    const float pv = ok ? sm90::exp2_ftz((st[i] * p.scale - lse_s[qi]) * kLog2e) : 0.f;
    float d = dpt[i], pm = pv;
    if constexpr (DROP) {
      const float mk = flash::keep(p, s0, s1, row, qp, kp);
      pm = __fmul_rn(pv, mk);
      d = __fmul_rn(d, mk);
    }
    st[i] = pm;                     // P^T * mask, rounded to bf16 when packed
    dpt[i] = pv * (d - dl_s[qi]);   // dS^T
  }
}

// The walk over the n_it query tiles: a turn issues S^T and dP^T of tile
// it and dV, dK of tile it - 1, forms tile it's P^T and dS^T beside those
// products, then hands stage it - 1 back to the ring and packs.
template <bool DROP, int D>
__device__ __forceinline__ void dkv_walk(Smem<D>& sm, const DkvMaps<D>& mp, const Params& p,
                                         int n_it, int n_qt, int t_begin, int g, int j0, int b,
                                         int r0, int c0, float (&dk)[D / 2], float (&dv)[D / 2]) {
  using namespace sm90;
  const int tid = threadIdx.x;
  float st[kB / 2], dpt[kB / 2];
  uint32_t pa[kB / 16][4], da[kB / 16][4];
  mbar_wait(&sm.full[0], 0);
  issue_st<D>(sm, st, dpt, 0);
  wg_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  form_pds<DROP, D>(sm, p, st, dpt, 0, 0, n_qt, t_begin, g, j0, b, r0, c0);
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    acc_to_frag(st, kk, pa[kk]);
    acc_to_frag(dpt, kk, da[kk]);
  }
  for (int it = 1; it < n_it; ++it) {
    const int s = it % kStages, sp = (it - 1) % kStages;
    mbar_wait(&sm.full[s], (it / kStages) & 1);
    issue_st<D>(sm, st, dpt, s);
    issue_dvdk<D>(sm, dv, dk, pa, da, sp);
    wg_wait<1>();  // S^T and dP^T of tile it
    fence_regs(st);
    fence_regs(dpt);
    form_pds<DROP, D>(sm, p, st, dpt, it, s, n_qt, t_begin, g, j0, b, r0, c0);
    wg_wait<0>();  // dV and dK of tile it - 1
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // every warp is done with stage sp: refill it
    if (tid == 0 && it - 1 + kStages < n_it)
      load_q<D>(sm, mp, p, it - 1 + kStages, sp, n_qt, t_begin, g, b);
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      acc_to_frag(st, kk, pa[kk]);
      acc_to_frag(dpt, kk, da[kk]);
    }
  }
  issue_dvdk<D>(sm, dv, dk, pa, da, (n_it - 1) % kStages);
  wg_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
}

// three CTAs an SM (168 registers; at its own 172, two CTAs an SM ran it
// 10-25% slower on the H100)
template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads, 3)
    dkv_kernel_sm90(const __grid_constant__ DkvMaps<D> mp, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = smem_aligned<Smem<D>>(smem_raw);
  const int g = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * kB;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // the first query row that sees this key tile
  const int t_begin = p.causal ? j0 : 0;
  const int n_qt = p.T > t_begin ? (p.T - t_begin + kB - 1) / kB : 0;
  const int n_it = (p.nh / p.nkv) * n_qt;

  if (tid == 0) {
    mbar_init(&sm.kvbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_it > 0) {
    mbar_expect_tx(&sm.kvbar, 2 * kB * D * 2);
    tma_rows<D, kB>(sm.k, &mp.k, &sm.kvbar, g, j0, b);
    tma_rows<D, kB>(sm.v, &mp.v, &sm.kvbar, g, j0, b);
    for (int it = 0; it < kStages && it < n_it; ++it)
      load_q<D>(sm, mp, p, it, it, n_qt, t_begin, g, b);
  }

  const int r0 = w * 16 + (lane >> 2);  // this thread's key rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);        // and query columns 8 j + c0 + {0, 1}

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  if (n_it > 0) {
    mbar_wait(&sm.kvbar, 0);
    if (p.dropout)
      dkv_walk<true, D>(sm, mp, p, n_it, n_qt, t_begin, g, j0, b, r0, c0, dk, dv);
    else
      dkv_walk<false, D>(sm, mp, p, n_it, n_qt, t_begin, g, j0, b, r0, c0, dk, dv);
  }

  const long long base = (long long)b * p.S * p.nkv * dh + (long long)g * dh;
  bf16* dk_out = static_cast<bf16*>(p.out0) + base;
  bf16* dv_out = static_cast<bf16*>(p.out1) + base;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int kp = j0 + r0 + 8 * ih;
    if (kp >= p.S) continue;
    const long long off = (long long)kp * p.nkv * dh + c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      if (kPartial && 8 * jj >= dh) continue;  // columns 8 jj + c0 + {0, 1} lie past d
      *reinterpret_cast<__nv_bfloat162*>(dk_out + off + 8 * jj) = __floats2bfloat162_rn(
          dk[4 * jj + 2 * ih] * p.scale, dk[4 * jj + 2 * ih + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + off + 8 * jj) =
          __floats2bfloat162_rn(dv[4 * jj + 2 * ih], dv[4 * jj + 2 * ih + 1]);
    }
  }
}

template <int D, bool kPartial>
int launch_dkv(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(dkv_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.S == 0 || p.B == 0 || p.nkv == 0) return 0;
  if (p.T == 0) {  // no query sees a key: zero gradients, as the FMA kernel writes
    const size_t n = (size_t)p.B * p.S * p.nkv * p.d * sizeof(bf16);
    cudaMemsetAsync(p.out0, 0, n, (cudaStream_t)stream);
    cudaMemsetAsync(p.out1, 0, n, (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  DkvMaps<D> mp;
  const long long n_stat = (long long)p.B * p.nh * p.T;
  if (!sm90::width_map<D>(&mp.q, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, kB) ||
      !sm90::width_map<D>(&mp.dout, p.dout, p.d, p.nh, p.T, p.B, p.do_st, p.do_sb, kB) ||
      !sm90::width_map<D>(&mp.k, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kB) ||
      !sm90::width_map<D>(&mp.v, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kB) ||
      !sm90::vec_map(&mp.lse, p.lse_in, n_stat, kB + 4) ||
      !sm90::vec_map(&mp.delta, p.delta, n_stat, kB + 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nkv, p.B, (p.S + kB - 1) / kB);
  // qualified: DkvMaps would also bring flash_sm90's kernel in by argument lookup
  flash_pipe::dkv_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(mp, p);
  return (int)cudaGetLastError();
}

}  // namespace flash_pipe

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the wgmma kernel);
// D: the built width it runs at (fp32 64, 128 or 256; bf16 also 32, 80
// and 192); d: the head size, d % 8 == 0, 8 <= d <= D (flash_attn_common.cuh).
// lse and delta (B, nh, T) fp32; dq (B, T, nh, d) contiguous. Returns the
// launch's cudaError_t.
extern "C" int flash_attn_bwd_dq(int dtype, int D, int d, const void* q, const void* k,
                                 const void* v, const void* dout, const float* lse,
                                 const float* delta, void* dq, const int* seed, const int* dims,
                                 const long long* strides, float scale, unsigned thresh,
                                 float keep_scale, void* stream) {
  if (!flash::runs_head_size(D, d)) return (int)cudaErrorInvalidValue;
  const Params p = flash::make_params(d, q, k, v, dout, lse, delta, dq, nullptr, nullptr, seed,
                                      dims, strides, scale, thresh, keep_scale);
  // The widths built for each dtype are `WIDTHS` of ops/flash_attention.py,
  // whose wrapper picks D; each runs on its own instances only: d == D the
  // one built for its head size, d < D the masked one. Any other D is
  // refused.
  const bool full = d == D;
  if (dtype == 0 && D == 64) return full ? launch_dq<float, 64, false>(p, stream)
                                         : launch_dq<float, 64, true>(p, stream);
  if (dtype == 0 && D == 128) return full ? launch_dq<float, 128, false>(p, stream)
                                          : launch_dq<float, 128, true>(p, stream);
  if (dtype == 0 && D == 256) return full ? launch_dq<float, 256, false>(p, stream)
                                          : launch_dq<float, 256, true>(p, stream);
  if (dtype == 1 && D == 32) return full ? flash_pipe::launch_dq<32, false>(p, stream)
                                         : flash_pipe::launch_dq<32, true>(p, stream);
  if (dtype == 1 && D == 64) return full ? flash_sm90::launch_dq<64, false>(p, stream)
                                         : flash_sm90::launch_dq<64, true>(p, stream);
  if (dtype == 1 && D == 80) return full ? flash_sm90::launch_dq<80, false>(p, stream)
                                         : flash_sm90::launch_dq<80, true>(p, stream);
  if (dtype == 1 && D == 128) return full ? flash_sm90::launch_dq<128, false>(p, stream)
                                          : flash_sm90::launch_dq<128, true>(p, stream);
  if (dtype == 1 && D == 192) return full ? flash_ws::launch_dq<192, false>(p, stream)
                                          : flash_ws::launch_dq<192, true>(p, stream);
  if (dtype == 1 && D == 256) return full ? flash_ws::launch_dq<256, false>(p, stream)
                                          : flash_ws::launch_dq<256, true>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// As flash_attn_bwd_dq (widths: fp32 64, 128 or 256, bf16 also 32 and 80); dk
// and dv (B, S, nkv, d) contiguous.
extern "C" int flash_attn_bwd_dkv(int dtype, int D, int d, const void* q, const void* k,
                                  const void* v, const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv, const int* seed,
                                  const int* dims, const long long* strides, float scale,
                                  unsigned thresh, float keep_scale, void* stream) {
  if (!flash::runs_head_size(D, d)) return (int)cudaErrorInvalidValue;
  const Params p = flash::make_params(d, q, k, v, dout, lse, delta, dk, dv, nullptr, seed, dims,
                                      strides, scale, thresh, keep_scale);
  const bool full = d == D;  // as in flash_attn_bwd_dq
  if (dtype == 0 && D == 64) return full ? launch_dkv<float, 64, false>(p, stream)
                                         : launch_dkv<float, 64, true>(p, stream);
  if (dtype == 0 && D == 128) return full ? launch_dkv<float, 128, false>(p, stream)
                                          : launch_dkv<float, 128, true>(p, stream);
  if (dtype == 0 && D == 256) return full ? launch_dkv<float, 256, false>(p, stream)
                                          : launch_dkv<float, 256, true>(p, stream);
  if (dtype == 1 && D == 32) return full ? flash_pipe::launch_dkv<32, false>(p, stream)
                                         : flash_pipe::launch_dkv<32, true>(p, stream);
  if (dtype == 1 && D == 64) return full ? flash_sm90::launch_dkv<64, false>(p, stream)
                                         : flash_sm90::launch_dkv<64, true>(p, stream);
  if (dtype == 1 && D == 80) return full ? flash_sm90::launch_dkv<80, false>(p, stream)
                                         : flash_sm90::launch_dkv<80, true>(p, stream);
  if (dtype == 1 && D == 128) return full ? flash_sm90::launch_dkv<128, false>(p, stream)
                                          : flash_sm90::launch_dkv<128, true>(p, stream);
  if (dtype == 1 && D == 256) return full ? flash_ws::launch_dkv<256, false>(p, stream)
                                          : flash_ws::launch_dkv<256, true>(p, stream);
  return (int)cudaErrorInvalidValue;
}
