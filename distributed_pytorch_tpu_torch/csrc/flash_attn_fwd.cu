// flash_attn_fwd: online-softmax attention over BTNH tensors (sm_90a, fp32
// and bf16, any head size d with d % 8 == 0 up to 256), returning out and
// the fp32 logsumexp of the scaled scores. Causal or full; GQA reads kv
// head h / (nh / nkv); attention-weight dropout from a counter hash. Built
// and bound by ops/cuda_build.py; wrapped by ops/flash_attention.py.
//
// Head sizes: the C entry takes the width D the wrapper picks
// (`padded_width`: the least of the forward's built widths in the dtype
// that holds d, ops/flash_attention.py's `WIDTHS`: 64, 128 and 256, and
// 32 and 80 in bf16) and runs d on the instance built for D, or on its
// masked instance (kPartial), whose stores stop at d.
// The TMA maps' row is d wide (their head stride d * 2 bytes, a multiple
// of 16 exactly when d % 8 == 0), so each box past d arrives as zeros and
// still counts its whole bytes on the barrier; the FMA loads zero-fill
// past d. The zero columns add exactly 0 to Q K^T, and the output columns
// past d, P V over zero columns of V, are never stored: the stores stop at
// d and step rows by nh * d. No padded copy is made on the host.
//
// Replaces: `_fwd_kernel` -> `_fwd` (rows face, pallas_call :378) and
// `_slab_fwd_kernel` -> `_slab_fwd` (slab face, :678) of
// distributed_pytorch_tpu/ops/flash_attention.py. Both compute one
// function; this kernel reads the model's (B, T, N, H) layout through
// (batch, time) strides, so it needs neither the rows face's transposes
// nor the slab face's in-VMEM relayout. The arithmetic is the reference's
// `_fwd_tile`: scores q.k * scale in fp32, masked scores -1e30, the
// normalizer sums the undropped p, the dropout mask multiplies p after
// the normalizer update, p is rounded to the value dtype before P V, and
// lse = m + log(max(l, 1e-30)).
//
// Bound on the H100: at the training shape (B 8, T 1024, 12 heads x 64,
// causal) a call does ~12.9 GFLOP (Q K^T and P V over the causal pairs)
// and moves ~50 MB, so bf16 is bound by bytes (~0.015 ms at 3.35 TB/s;
// ~0.013 ms of tensor-core time at 989 TFLOP/s) and fp32, which has no
// tensor-core path here, by FMA issue.
//
// The dtype picks the kernel; it is not a fallback:
// * bf16 at head size 64 and 128 (`flash_sm90::fwd_kernel_sm90`): tensor
//   cores. One CTA of one warpgroup (128 threads) per (64-row query tile,
//   head, batch); 42 KB of shared memory at head size 64 (five CTAs an
//   SM), 82 KB at 128 (two). TMA brings the query tile, then 64-key K and
//   V tiles into a 2-stage ring (128-byte swizzle, mbarrier completion); the tile after
//   next is requested as soon as a stage is free, so one tile is always in
//   flight while the warpgroup computes. S = Q K^T is a wgmma with both
//   operands in shared memory (K-major); the online softmax runs on the fp32
//   accumulator in registers (a row lives in the 4 threads of a quad,
//   exp2 on the special-function unit); P is rounded to bf16 and becomes
//   the register A operand of O += P V, with V read MN-major through the
//   transpose bit. There is no separate producer warp: the loads are one
//   thread's few instructions per tile, and the other CTAs on the SM
//   overlap one CTA's softmax with their products. (Measured on the
//   H100: a third stage, and starting the next tile's S beside P V inside
//   the warpgroup, were both slower, as the extra stage's shared memory
//   costs CTAs per SM.) Only the diagonal tile and the ragged last tile
//   are masked (TMA zero-fills rows past T and S). Query tiles launch
//   heaviest first (the grid's slowest axis runs down the causal
//   frontier), so long tiles do not form the grid's tail.
// * bf16 at width 80 (`flash_sm90::fwd_kernel_sm90<80>`: head sizes 72
//   and 80, the flagship with MLA, 64 + 16): the same kernel on tiles of
//   exactly 80 columns (`sm90::Map80`, flash_attn_sm90.cuh): columns
//   0-63 a 128-byte-swizzled sub-tile, 64-79 a 16-column one at the
//   32-byte swizzle, so S = Q K^T takes 5 k-steps and P V is m64n64k16 +
//   m64n16k16 into O's 40 registers. 52 KB of shared memory and 104
//   registers a thread: four CTAs an SM. Run on the 128-wide instance
//   instead (masked, as head size 80 ran before), S took 8 k-steps and P V
//   N 128, 48 of each 128 columns zero, at 82 KB and two CTAs an SM. A
//   third stage (72 KB) would leave three CTAs an SM, so none is built.
//   The other layout, five 16-column sub-tiles at the 32-byte swizzle (P V
//   one m64n80k16), issues five TMA boxes a tile for this one's two and
//   ran slower on the H100 (bench/flash_ab.py; PERF.md).
// * bf16 at width 32 (`flash_pipe::fwd_kernel_sm90<32>`: head sizes 8-32,
//   the default config's heads of 32): one warpgroup a CTA of 64 query
//   rows, on tiles of exactly 32 columns (one box at the 64-byte swizzle,
//   flash_attn_sm90.cuh), so S = Q K^T takes 2 k-steps and P V is one
//   m64n32k16 into O's 16 registers. On the 64-wide masked instance these
//   head sizes ran on before, half of every k-step, P V column and TMA
//   box was zeros, and the products halve at 32 while the exponentials
//   and the CUDA-core work per score stay those of 64 (their floor at B 8,
//   T 1024, 8 heads, causal: 33.6 M ex2 on 132 SMs x 16 a clock, about
//   0.009 ms). So the softmax must overlap the products: the turns are
//   pipelined as in the width-32 dq and dkv (flash_attn_bwd.cu), a turn
//   issuing S of tile j and P V of tile j - 1 and forming tile j's
//   softmax beside that product, branch-free (`flash_ws::softmax_p`: the
//   mask by selects; `rescale_pack`: the dropout after the normalizer
//   update, once P V is done). K and V come through a 4-stage TMA ring of
//   64-key stages (8 KB each), the stage a turn released refilled at once.
//   96 registers a thread and 38 KB of shared memory: five CTAs an SM. At
//   width 64 the next tile's S beside P V was slower (see above); at 32 O
//   is 16 registers a thread, not 32. On the H100 at B 8, T 1024, 8 / 4
//   heads, causal: 0.0270 ms of device time against the 64-wide masked
//   instance's 0.0426 and SDPA's 0.0329 (bench/flash_ab.py, PERF.md). The
//   tiles and the arithmetic are that instance's, but out and lse are not
//   its bytes (they differ within the bf16 limits; not traced to one
//   instruction).
// * bf16 at head size 256 (`flash_ws::fwd_kernel_sm90`; MLA's
//   concatenated content and rotary features): warp-specialized. The O
//   accumulator alone is 128 registers a thread and 64 x 256 K and V
//   tiles take 64 KB a stage, so one CTA fills an SM; a lone warpgroup
//   (the first design, 0.1990 ms at the MLA shape) left the tensor cores
//   idle through every softmax and load. One CTA of 384 threads per
//   (128-row query tile, head, batch), heaviest first, 194 KB of shared
//   memory (Q 64 KB, a 2-stage K/V ring 128 KB):
//   - a producer warpgroup (24 registers after setmaxnreg) whose one lane
//     loads Q, then streams 64-key K and V tiles up to the last live row's
//     frontier. Full barriers count the bytes in; a stage's K goes back
//     once both consumers' S on it has retired and its V once their P V
//     has, a turn later (empty barriers, one arrival per consumer warp),
//     so the next K load starts a turn before the V one;
//   - two consumer warpgroups (240 registers: O 128, S 32, P 16), each
//     owning 64 query rows and stopping at its own causal frontier. A
//     turn issues S of tile j (SS, m64n64k16), then P V of tile j - 1
//     (RS, m64n256k16); as soon as S is done, the softmax of tile j (the
//     arithmetic above, with no branch: the mask by selects on every
//     tile) runs beside that P V; once it is done, O is rescaled and the
//     new P dropped and packed. The two consumers take turns (named
//     barriers 1 and 2), so that one's products run while the other
//     forms its softmax. Both take the same number of turns (a consumer
//     past its frontier takes a turn with no work), so every bar.arrive
//     meets its bar.sync; a CTA whose second consumer has no row below T
//     runs the first alone.
//   Measured on the H100 at the MLA shape, each faster than what it
//   replaced: the softmax beside P V (the turns alone left it in series
//   with the products), K and V handed back apart, query tiles heaviest
//   first across the grid (not head by head, for L2), 64-key stages (80
//   spilled and ran slower).
//   What bounds it: shared memory feeds the products at about the tensor
//   rate (S reads Q and K, P V reads V, and TMA writes K and V: 256 KB a
//   128 x 64 tile, 2048 cycles at 128 bytes a cycle, as long as the
//   products' 2048).
// * fp32 (`fwd_kernel`): the FMA design of flash_attn_common.cuh,
//   unchanged (223,232 bytes of shared memory at head size 256, under the
//   227 KB a block may opt into). Tensor cores take fp32 only as TF32,
//   which would break the fp32 limits of the kernel-vs-plain checks and of
//   the training parity.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace {

using flash::Params;

// ---- fp32: FMA loops on CUDA cores (flash_attn_common.cuh) -----------------

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * (flash::kBQ + flash::kPad) +
                          flash::kBK * (D + flash::kPad) +
                          flash::kBK * (flash::kBQ + flash::kPad));
}

template <typename T, int D, bool kPartial>
__global__ void __launch_bounds__(flash::kThreads) fwd_kernel(const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace flash;
  constexpr int LD = kBQ + kPad;  // Qt, Kt, Pt rows (64 wide)
  constexpr int LDV = D + kPad;   // Vs rows
  constexpr int RN = D / 16;      // output columns per thread
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                 // [D][LD]   Q transposed
  float* Kt = Qt + D * LD;        // [D][LD]   K tile transposed
  float* Vs = Kt + D * LD;        // [kBK][LDV]
  float* Pt = Vs + kBK * LDV;     // [kBK][LD] P transposed (key-major)

  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.nh / p.nkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * dh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + (long long)g * dh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + (long long)g * dh;
  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const uint32_t row = flash::drop_row(p, b, h);

  load_tile<T, D, kBQ, true>(Qt, LD, q + i0 * p.q_st, p.q_st, min(kBQ, p.T - i0), dh);

  float o[4][RN], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RN; ++j) o[i][j] = 0.f;
  }
  // the last key any row of this tile may see
  const int n_keys = p.causal ? min(p.S, i0 + kBQ) : p.S;
  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    const int nk = min(kBK, p.S - k0);
    __syncthreads();  // the previous tile's products are done
    load_tile<T, D, kBK, true>(Kt, LD, k + k0 * p.k_st, p.k_st, nk, dh);
    load_tile<T, D, kBK, false>(Vs, LDV, v + k0 * p.v_st, p.v_st, nk, dh);
    __syncthreads();

    float s[4][4] = {};
    mma_tile<4, D>(s, Qt, LD, Kt, LD, ty, tx);
    float pr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = i0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool ok = kp < p.S && (!p.causal || kp <= qp);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pr[i][j] = expf(s[i][j] - m_new);
        sum += pr[i][j];
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * alpha + sum;  // the undropped p
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RN; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = pr[i][j];
        if (p.dropout) pv *= keep(p, s0, s1, row, qp, k0 + tx * 4 + j);
        pr[i][j] = round_to<T>(pv);
      }
    }
    store_t<4>(Pt, LD, pr, ty, tx);
    __syncthreads();
    mma_tile<RN, kBK>(o, Pt, LD, Vs, LDV, ty, tx);
  }

  float* lse = p.lse_out + (long long)(b * p.nh + h) * p.T;
  T* out = static_cast<T*>(p.out0) + (long long)b * p.T * p.nh * dh + (long long)h * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = i0 + ty * 4 + i;
    if (qp >= p.T) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = out + (long long)qp * p.nh * dh + tx * RN;
#pragma unroll
    for (int j = 0; j < RN; ++j)
      if (!kPartial || tx * RN + j < dh) orow[j] = from_f<T>(o[i][j] / ls);
    if (tx == 0) lse[qp] = m[i] + logf(ls);
  }
}

template <typename T, int D, bool kPartial>
int launch(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = fwd_smem<D>();
  const int err = flash::set_smem(fwd_kernel<T, D, kPartial>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  const dim3 grid((p.T + flash::kBQ - 1) / flash::kBQ, p.nh, p.B);
  fwd_kernel<T, D, kPartial><<<grid, flash::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}


// ---- bf16: wgmma on TMA-fed shared memory ---------------------------------

namespace flash_sm90 {

using sm90::bf16;
constexpr int kBQ = 64;      // query rows per CTA: one warpgroup
constexpr int kBK = 64;      // keys per stage
constexpr int kStages = 2;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  alignas(1024) bf16 q[kBQ * D];
  alignas(1024) bf16 k[kStages][kBK * D];
  alignas(1024) bf16 v[kStages][kBK * D];
  uint64_t qbar, kbar[kStages], vbar[kStages];
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;  // + room to align the base to 1024
}

// K and V tile j into stage s (one thread)
template <int D>
__device__ __forceinline__ void load_kv(Smem<D>& sm, const sm90::RowMap<D>* tk,
                                        const sm90::RowMap<D>* tv, int j, int s, int g, int b) {
  sm90::mbar_expect_tx(&sm.kbar[s], kBK * D * 2);
  sm90::tma_rows<D, kBK>(sm.k[s], tk, &sm.kbar[s], g, j * kBK, b);
  sm90::mbar_expect_tx(&sm.vbar[s], kBK * D * 2);
  sm90::tma_rows<D, kBK>(sm.v[s], tv, &sm.vbar[s], g, j * kBK, b);
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel_sm90(const __grid_constant__ sm90::RowMap<D> tq,
                    const __grid_constant__ sm90::RowMap<D> tk,
                    const __grid_constant__ sm90::RowMap<D> tv, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = smem_aligned<Smem<D>>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest tiles first
  const int g = h / (p.nh / p.nkv);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // the keys any row of this tile may see
  const int n_keys = p.causal ? min(p.S, i0 + kBQ) : p.S;
  const int n_kt = (n_keys + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.kbar[s], 1);
      mbar_init(&sm.vbar[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.qbar, kBQ * D * 2);
    tma_rows<D, kBQ>(sm.q, &tq, &sm.qbar, h, i0, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv<D>(sm, &tk, &tv, j, j, g, b);
  }

  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const uint32_t row = flash::drop_row(p, b, h);
  const int r0 = w * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane & 3);        // and columns 8 j + c0 + {0, 1}

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {flash::kNegInf, flash::kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part

  mbar_wait(&sm.qbar, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const int k0 = j * kBK;
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    mbar_wait(&sm.kbar[s], ph);
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBK, 0, 0>(sc, kdesc<D, kBQ>(sm.q, kk), kdesc<D, kBK>(sm.k[s], kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // mask only the diagonal tile and the ragged last one
    const bool edge = (p.causal && k0 + kBK - 1 > i0) || k0 + kBK > p.S;
    float mx[2] = {flash::kNegInf, flash::kNegInf};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int ih = (i >> 1) & 1;
      float x = sc[i] * p.scale;
      if (edge) {
        const int qp = i0 + r0 + 8 * ih, kp = k0 + 8 * (i >> 2) + c0 + (i & 1);
        if (!(kp < p.S && (!p.causal || kp <= qp))) x = flash::kNegInf;
      }
      sc[i] = x;
      mx[ih] = fmaxf(mx[ih], x);
    }
    float ml[2];
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      const float m_new = fmaxf(m[ih], quad_max(mx[ih]));
      const float alpha = exp2_ftz((m[ih] - m_new) * kLog2e);
      m[ih] = m_new;
      ml[ih] = m_new * kLog2e;
      l[ih] *= alpha;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        o[4 * jj + 2 * ih] *= alpha;
        o[4 * jj + 2 * ih + 1] *= alpha;
      }
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int ih = (i >> 1) & 1;
      float pr = exp2_ftz(fmaf(sc[i], kLog2e, -ml[ih]));
      l[ih] += pr;  // the undropped p
      if (p.dropout) {
        const int qp = i0 + r0 + 8 * ih, kp = k0 + 8 * (i >> 2) + c0 + (i & 1);
        pr *= flash::keep(p, s0, s1, row, qp, kp);
      }
      sc[i] = pr;
    }
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) acc_to_frag(sc, kk, pa[kk]);

    mbar_wait(&sm.vbar[s], ph);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs_mn<D, kBK>(o, pa[kk], sm.v[s], kk);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    __syncthreads();  // every product on stage s is done: refill it
    if (tid == 0 && j + kStages < n_kt) load_kv<D>(sm, &tk, &tv, j + kStages, s, g, b);
  }

  float* lse = p.lse_out + (long long)(b * p.nh + h) * p.T;
  bf16* out = static_cast<bf16*>(p.out0) + (long long)b * p.T * p.nh * dh + (long long)h * dh;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = i0 + r0 + 8 * ih;
    const float ls = fmaxf(quad_sum(l[ih]), 1e-30f);
    if (qp >= p.T) continue;
    bf16* orow = out + (long long)qp * p.nh * dh + c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      if (!kPartial || 8 * jj < dh)  // columns 8 jj + c0 + {0, 1}: below d exactly when 8 jj is
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
            __floats2bfloat162_rn(o[4 * jj + 2 * ih] / ls, o[4 * jj + 2 * ih + 1] / ls);
    if ((lane & 3) == 0) lse[qp] = m[ih] + logf(ls);
  }
}

template <int D, bool kPartial>
int launch(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = smem_bytes<D>();
  const int err = flash::set_smem(fwd_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  sm90::RowMap<D> tq, tk, tv;
  if (!sm90::rows_map(&tq, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, kBQ) ||
      !sm90::rows_map(&tk, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kBK) ||
      !sm90::rows_map(&tv, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nh, p.B, (p.T + kBQ - 1) / kBQ);
  fwd_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace flash_sm90

// ---- bf16 at head size 256: warp-specialized wgmma ------------------------

namespace flash_ws {

using sm90::bf16;
constexpr int kRows = 64;            // query rows a consumer warpgroup
constexpr int kBQ = 2 * kRows;       // query rows a CTA
constexpr int kBK = 64;              // keys a stage
constexpr int kStages = 2;
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread after setmaxnreg, out of the 168 x 384 the launch
// gives the CTA: 2 x 128 x 240 + 128 x 24 = 64512 (at 232 the consumers
// spilled a few descriptor words)
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  alignas(1024) bf16 q[2][kRows * D];  // each consumer's 64 rows
  alignas(1024) bf16 k[kStages][kBK * D];
  alignas(1024) bf16 v[kStages][kBK * D];
  // K and V go back separately: K once both consumers' S on it is done,
  // V once their P V is, a turn later
  uint64_t qbar, kfull[kStages], vfull[kStages], kempty[kStages], vempty[kStages];
};

// What a consumer needs besides its accumulators: its first query row q0
// and this thread's rows r0, r0 + 8 and columns 8 j + c0 + {0, 1} of the
// accumulator layout; the dropout seed and row
struct Rows {
  int q0, r0, c0;
  uint32_t s0, s1, row;
};

// Key tile j's scores in sc (64 x 64, accumulator layout) -> p in sc
// (fp32, not yet dropped), this thread's rows' running max m and sum l
// (of the undropped p), and the factor alpha by which O is to be
// rescaled: the arithmetic of flash_sm90::fwd_kernel_sm90. It runs while
// this consumer's P V of the tile before is in flight, so it has no
// branch: every tile is masked by selects against each row's last key (a
// no-op off the diagonal and the ragged end).
__device__ __forceinline__ void softmax_p(const Params& p, const Rows& rw, float (&sc)[kBK / 2],
                                          float (&m)[2], float (&l)[2], float (&alpha)[2],
                                          int j) {
  using namespace sm90;
  const int k0 = j * kBK;
  int kend[2];  // keys k0 + c < kend[ih] are seen by row r0 + 8 ih
  float mx[2] = {flash::kNegInf, flash::kNegInf};
#pragma unroll
  for (int ih = 0; ih < 2; ++ih)
    kend[ih] = min(p.S, p.causal ? rw.q0 + rw.r0 + 8 * ih + 1 : p.S) - k0;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int ih = (i >> 1) & 1;
    const int c = 8 * (i >> 2) + rw.c0 + (i & 1);
    const float x = c < kend[ih] ? sc[i] * p.scale : flash::kNegInf;
    sc[i] = x;
    mx[ih] = fmaxf(mx[ih], x);
  }
  float ml[2];
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const float m_new = fmaxf(m[ih], quad_max(mx[ih]));
    alpha[ih] = exp2_ftz((m[ih] - m_new) * kLog2e);
    m[ih] = m_new;
    ml[ih] = m_new * kLog2e;
    l[ih] *= alpha[ih];
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int ih = (i >> 1) & 1;
    const float pr = exp2_ftz(fmaf(sc[i], kLog2e, -ml[ih]));
    l[ih] += pr;  // the undropped p
    sc[i] = pr;
  }
}

// Once P V of the tile before is done: O *= alpha, and p of key tile j,
// dropped after the normalizer took it, rounded to bf16 into the A
// fragments of O += P V
template <int D>
__device__ __forceinline__ void rescale_pack(const Params& p, const Rows& rw,
                                             float (&sc)[kBK / 2], float (&o)[D / 2],
                                             const float (&alpha)[2],
                                             uint32_t (&pa)[kBK / 16][4], int j) {
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      o[4 * jj + 2 * ih] *= alpha[ih];
      o[4 * jj + 2 * ih + 1] *= alpha[ih];
    }
  if (p.dropout) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int ih = (i >> 1) & 1;
      const int qp = rw.q0 + rw.r0 + 8 * ih, kp = j * kBK + 8 * (i >> 2) + rw.c0 + (i & 1);
      sc[i] *= flash::keep(p, rw.s0, rw.s1, rw.row, qp, kp);
    }
  }
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) sm90::acc_to_frag(sc, kk, pa[kk]);
}

// S = Q K^T over key tile j (stage s), both operands K-major
template <int D>
__device__ __forceinline__ void issue_s(Smem<D>& sm, float (&sc)[kBK / 2], int w, int s) {
  using namespace sm90;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kBK, 0, 0>(sc, desc_kmajor<kRows>(sm.q[w], kk), desc_kmajor<kBK>(sm.k[s], kk), kk > 0);
}

// O += P V over the key tile in stage s, V read MN-major
template <int D>
__device__ __forceinline__ void issue_pv(Smem<D>& sm, float (&o)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4], int s) {
  using namespace sm90;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<D, 1>(o, pa[kk], desc_mnmajor<kBK>(sm.v[s], kk));
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = smem_aligned<Smem<D>>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest tiles first
  const int g = h / (p.nh / p.nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // consumers with a live row: the second has none where T ends in the
  // first's 64 rows
  const int n_live = i0 + kRows < p.T ? 2 : 1;
  // key tiles the rows before q_end may see (each side computes its own,
  // so that little stays live across setmaxnreg)
  auto tiles_to = [&](int q_end) { return (min(p.S, p.causal ? q_end : p.S) + kBK - 1) / kBK; };

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < kStages; ++s) {
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
      const int n_kt = tiles_to(i0 + kRows * n_live);  // the last live consumer's
      mbar_expect_tx(&sm.qbar, n_live * kRows * D * 2);
      for (int w = 0; w < n_live; ++w) tma_rows<D, kRows>(sm.q[w], &tq, &sm.qbar, h, i0 + kRows * w, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        const uint32_t ph = ((j / kStages) & 1) ^ 1;
        // the stage's previous K, then V, is handed back (none on the first lap)
        if (j >= kStages) mbar_wait(&sm.kempty[s], ph);
        mbar_expect_tx(&sm.kfull[s], kBK * D * 2);
        tma_rows<D, kBK>(sm.k[s], &tk, &sm.kfull[s], g, j * kBK, b);
        if (j >= kStages) mbar_wait(&sm.vempty[s], ph);
        mbar_expect_tx(&sm.vfull[s], kBK * D * 2);
        tma_rows<D, kBK>(sm.v[s], &tv, &sm.vfull[s], g, j * kBK, b);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int w = warp >> 2;  // consumer warpgroup: query rows i0 + 64 w ..
  if (w >= n_live) return;
  Rows rw{i0 + kRows * w, (warp & 3) * 16 + (lane >> 2), 2 * (lane & 3), 0u, 0u,
          flash::drop_row(p, b, h)};
  const int nw = tiles_to(rw.q0 + kRows);  // its key tiles
  const int two = n_live == 2;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {flash::kNegInf, flash::kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part
  if (p.dropout) {
    rw.s0 = (uint32_t)p.seed[0];
    rw.s1 = (uint32_t)p.seed[1];
  }
  mbar_wait(&sm.qbar, 0);
  // The walk over the nw key tiles. Ping-pong: each consumer issues its
  // products in turns (named barrier 1 + w is "w's turn", `two` where both
  // consumers run), so that one's products run while the other forms its
  // softmax. Both take the CTA's n_kt + 1 turns: consumer 1 sees all n_kt
  // tiles, consumer 0 n_kt or, causal, n_kt - 1, and then takes one turn
  // with no work (`extra`); consumer 1's last turn hands on nothing, so
  // every arrival meets its wait. A turn issues S of tile j, then P V of
  // tile j - 1, and forms tile j's softmax as soon as S is done, beside
  // that P V; O is rescaled and the new P packed once P V is done.
  if (nw > 0) {
    const int extra = tiles_to(i0 + kRows * n_live) - nw;
    const int mine = 1 + w, other = 2 - w;
    bar_arrive_if(1, kConsumers, two && w == 1);  // the first turn is consumer 0's
    float sc[kBK / 2], alpha[2];
    uint32_t pa[kBK / 16][4];
    // turn 0: S of tile 0
    bar_sync_if(mine, kConsumers, two);
    mbar_wait(&sm.kfull[0], 0);
    fence_regs(sc);
    wg_fence();
    issue_s<D>(sm, sc, w, 0);
    wg_commit();
    bar_arrive_if(other, kConsumers, two);
    wg_wait<0>();
    fence_regs(sc);
    mbar_arrive_if(&sm.kempty[0], lane == 0);
    softmax_p(p, rw, sc, m, l, alpha, 0);
    rescale_pack<D>(p, rw, sc, o, alpha, pa, 0);
    // turns 1 .. nw - 1: S of tile j, P V of tile j - 1
    for (int j = 1; j < nw; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      bar_sync_if(mine, kConsumers, two);
      mbar_wait(&sm.kfull[s], (j / kStages) & 1);
      mbar_wait(&sm.vfull[sp], ((j - 1) / kStages) & 1);
      fence_regs(sc);
      fence_regs(o);
      wg_fence();
      issue_s<D>(sm, sc, w, s);
      wg_commit();
      issue_pv<D>(sm, o, pa, sp);
      wg_commit();
      bar_arrive_if(other, kConsumers, two);
      wg_wait<1>();  // S of tile j
      fence_regs(sc);
      mbar_arrive_if(&sm.kempty[s], lane == 0);
      softmax_p(p, rw, sc, m, l, alpha, j);
      wg_wait<0>();  // P V of tile j - 1
      fence_regs(o);
      mbar_arrive_if(&sm.vempty[sp], lane == 0);
      rescale_pack<D>(p, rw, sc, o, alpha, pa, j);
    }
    // turn nw: P V of the last tile
    const int sp = (nw - 1) % kStages;
    bar_sync_if(mine, kConsumers, two);
    mbar_wait(&sm.vfull[sp], ((nw - 1) / kStages) & 1);
    fence_regs(o);
    wg_fence();
    issue_pv<D>(sm, o, pa, sp);
    wg_commit();
    bar_arrive_if(other, kConsumers, two && w == 0);
    wg_wait<0>();
    fence_regs(o);
    mbar_arrive_if(&sm.vempty[sp], lane == 0);
    bar_sync_if(mine, kConsumers, two && extra);
    bar_arrive_if(other, kConsumers, two && extra);
  }

  float* lse = p.lse_out + (long long)(b * p.nh + h) * p.T;
  bf16* out = static_cast<bf16*>(p.out0) + (long long)b * p.T * p.nh * dh + (long long)h * dh;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = rw.q0 + rw.r0 + 8 * ih;
    const float ls = fmaxf(quad_sum(l[ih]), 1e-30f);
    if (qp >= p.T) continue;
    bf16* orow = out + (long long)qp * p.nh * dh + rw.c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      if (!kPartial || 8 * jj < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
            __floats2bfloat162_rn(o[4 * jj + 2 * ih] / ls, o[4 * jj + 2 * ih + 1] / ls);
    if ((lane & 3) == 0) lse[qp] = m[ih] + logf(ls);
  }
}

template <int D, bool kPartial>
int launch(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(fwd_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (!sm90::rows_map(&tq, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, kRows) ||
      !sm90::rows_map(&tk, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kBK) ||
      !sm90::rows_map(&tv, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nh, p.B, (p.T + kBQ - 1) / kBQ);
  fwd_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace flash_ws

// ---- bf16 at width 32: one warpgroup, products pipelined ------------------

namespace flash_pipe {

using flash_ws::Rows;
using sm90::bf16;
constexpr int kB = 64;  // query rows a CTA, keys a stage
constexpr int kStages = 4;
constexpr int kThreads = 128;  // one warpgroup
static_assert(kB == flash_ws::kBK, "flash_ws's softmax forms 64-key tiles");

template <int D>
struct Smem {
  alignas(1024) bf16 q[kB * D];
  alignas(1024) bf16 k[kStages][kB * D];
  alignas(1024) bf16 v[kStages][kB * D];
  uint64_t qbar, full[kStages];
};

// K and V tile j into stage s, one barrier for both (one thread)
template <int D>
__device__ __forceinline__ void load_kv(Smem<D>& sm, const sm90::RowMap<D>& tk,
                                        const sm90::RowMap<D>& tv, int j, int s, int g, int b) {
  sm90::mbar_expect_tx(&sm.full[s], 2 * kB * D * 2);
  sm90::tma_rows<D, kB>(sm.k[s], &tk, &sm.full[s], g, j * kB, b);
  sm90::tma_rows<D, kB>(sm.v[s], &tv, &sm.full[s], g, j * kB, b);
}

// S = Q K^T over the key tile in stage s, both operands K-major, summed
// onto zeros as the 64-wide instance sums it
template <int D>
__device__ __forceinline__ void issue_s(Smem<D>& sm, float (&sc)[kB / 2], int s) {
  using namespace sm90;
#pragma unroll
  for (int i = 0; i < kB / 2; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kB, 0, 0>(sc, kdesc<D, kB>(sm.q, kk), kdesc<D, kB>(sm.k[s], kk), 1);
  wg_commit();
}

// O += P V over the key tile in stage s, V read MN-major
template <int D>
__device__ __forceinline__ void issue_pv(Smem<D>& sm, float (&o)[D / 2],
                                         const uint32_t (&pa)[kB / 16][4], int s) {
  using namespace sm90;
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) wgmma_rs_mn<D, kB>(o, pa[kk], sm.v[s], kk);
  wg_commit();
}

// The walk over the n_kt key tiles: a turn issues S of tile j and P V of
// tile j - 1, forms tile j's softmax (flash_ws::softmax_p, branch-free)
// beside that product, then hands stage j - 1 back to the ring, rescales
// O and packs tile j's p into the A fragments (flash_ws::rescale_pack).
template <int D>
__device__ __forceinline__ void fwd_walk(Smem<D>& sm, const sm90::RowMap<D>& tk,
                                         const sm90::RowMap<D>& tv, const Params& p,
                                         const Rows& rw, int n_kt, int g, int b,
                                         float (&o)[D / 2], float (&m)[2], float (&l)[2]) {
  using namespace sm90;
  const int tid = threadIdx.x;
  float sc[kB / 2], alpha[2];
  uint32_t pa[kB / 16][4];
  mbar_wait(&sm.full[0], 0);
  issue_s<D>(sm, sc, 0);
  wg_wait<0>();
  fence_regs(sc);
  flash_ws::softmax_p(p, rw, sc, m, l, alpha, 0);
  flash_ws::rescale_pack<D>(p, rw, sc, o, alpha, pa, 0);
  for (int j = 1; j < n_kt; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    issue_s<D>(sm, sc, s);
    issue_pv<D>(sm, o, pa, sp);
    wg_wait<1>();  // S of tile j
    fence_regs(sc);
    flash_ws::softmax_p(p, rw, sc, m, l, alpha, j);
    wg_wait<0>();  // P V of tile j - 1
    fence_regs(o);
    __syncthreads();  // every warp is done with stage sp: refill it
    if (tid == 0 && j - 1 + kStages < n_kt) load_kv<D>(sm, tk, tv, j - 1 + kStages, sp, g, b);
    flash_ws::rescale_pack<D>(p, rw, sc, o, alpha, pa, j);
  }
  issue_pv<D>(sm, o, pa, (n_kt - 1) % kStages);
  wg_wait<0>();
  fence_regs(o);
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel_sm90(const __grid_constant__ sm90::RowMap<D> tq,
                    const __grid_constant__ sm90::RowMap<D> tk,
                    const __grid_constant__ sm90::RowMap<D> tv, const Params p) {
  const int dh = kPartial ? p.d : D;  // the head size
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = smem_aligned<Smem<D>>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kB;  // heaviest tiles first
  const int g = h / (p.nh / p.nkv);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // the keys any row of this tile may see
  const int n_keys = p.causal ? min(p.S, i0 + kB) : p.S;
  const int n_kt = (n_keys + kB - 1) / kB;

  if (tid == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.qbar, kB * D * 2);
    tma_rows<D, kB>(sm.q, &tq, &sm.qbar, h, i0, b);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv<D>(sm, tk, tv, j, j, g, b);
  }

  Rows rw{i0, w * 16 + (lane >> 2), 2 * (lane & 3), 0u, 0u, flash::drop_row(p, b, h)};
  if (p.dropout) {
    rw.s0 = (uint32_t)p.seed[0];
    rw.s1 = (uint32_t)p.seed[1];
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {flash::kNegInf, flash::kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's part
  mbar_wait(&sm.qbar, 0);
  if (n_kt > 0) fwd_walk<D>(sm, tk, tv, p, rw, n_kt, g, b, o, m, l);

  float* lse = p.lse_out + (long long)(b * p.nh + h) * p.T;
  bf16* out = static_cast<bf16*>(p.out0) + (long long)b * p.T * p.nh * dh + (long long)h * dh;
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qp = i0 + rw.r0 + 8 * ih;
    const float ls = fmaxf(quad_sum(l[ih]), 1e-30f);
    if (qp >= p.T) continue;
    bf16* orow = out + (long long)qp * p.nh * dh + rw.c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      if (!kPartial || 8 * jj < dh)  // columns 8 jj + c0 + {0, 1}: below d exactly when 8 jj is
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
            __floats2bfloat162_rn(o[4 * jj + 2 * ih] / ls, o[4 * jj + 2 * ih + 1] / ls);
    if ((lane & 3) == 0) lse[qp] = m[ih] + logf(ls);
  }
}

template <int D, bool kPartial>
int launch(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the base to 1024
  const int err = flash::set_smem(fwd_kernel_sm90<D, kPartial>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  sm90::RowMap<D> tq, tk, tv;
  if (!sm90::width_map<D>(&tq, p.q, p.d, p.nh, p.T, p.B, p.q_st, p.q_sb, kB) ||
      !sm90::width_map<D>(&tk, p.k, p.d, p.nkv, p.S, p.B, p.k_st, p.k_sb, kB) ||
      !sm90::width_map<D>(&tv, p.v, p.d, p.nkv, p.S, p.B, p.v_st, p.v_sb, kB))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.nh, p.B, (p.T + kB - 1) / kB);
  flash_pipe::fwd_kernel_sm90<D, kPartial><<<grid, kThreads, smem, (cudaStream_t)stream>>>(tq, tk,
                                                                                        tv, p);
  return (int)cudaGetLastError();
}

}  // namespace flash_pipe

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel); D: the
// built width it runs at (fp32 64, 128 or 256; bf16 also 32 and 80); d: the head
// size, d % 8 == 0, 8 <= d <= D (flash_attn_common.cuh). out (B, T, nh, d) and lse
// (B, nh, T) fp32, both contiguous. dims and strides as in
// flash::make_params.
// Returns the launch's cudaError_t (0 = success).
extern "C" int flash_attn_fwd(int dtype, int D, int d, const void* q, const void* k,
                              const void* v, void* out, float* lse, const int* seed,
                              const int* dims, const long long* strides, float scale,
                              unsigned thresh, float keep_scale, void* stream) {
  if (!flash::runs_head_size(D, d)) return (int)cudaErrorInvalidValue;
  const Params p = flash::make_params(d, q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse,
                                      seed, dims, strides, scale, thresh, keep_scale);
  // The widths built for each dtype are `WIDTHS` of ops/flash_attention.py,
  // whose wrapper picks D; each runs on its own instances only: d == D the
  // one built for its head size, d < D the masked one. Any other D is
  // refused.
  const bool full = d == D;
  if (dtype == 0 && D == 64) return full ? launch<float, 64, false>(p, stream)
                                         : launch<float, 64, true>(p, stream);
  if (dtype == 0 && D == 128) return full ? launch<float, 128, false>(p, stream)
                                          : launch<float, 128, true>(p, stream);
  if (dtype == 0 && D == 256) return full ? launch<float, 256, false>(p, stream)
                                          : launch<float, 256, true>(p, stream);
  if (dtype == 1 && D == 32) return full ? flash_pipe::launch<32, false>(p, stream)
                                         : flash_pipe::launch<32, true>(p, stream);
  if (dtype == 1 && D == 64) return full ? flash_sm90::launch<64, false>(p, stream)
                                         : flash_sm90::launch<64, true>(p, stream);
  if (dtype == 1 && D == 80) return full ? flash_sm90::launch<80, false>(p, stream)
                                         : flash_sm90::launch<80, true>(p, stream);
  if (dtype == 1 && D == 128) return full ? flash_sm90::launch<128, false>(p, stream)
                                          : flash_sm90::launch<128, true>(p, stream);
  if (dtype == 1 && D == 256) return full ? flash_ws::launch<256, false>(p, stream)
                                          : flash_ws::launch<256, true>(p, stream);
  return (int)cudaErrorInvalidValue;
}
