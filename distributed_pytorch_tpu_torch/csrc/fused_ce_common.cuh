// Shared body of the fused cross-entropy kernels (fused_ce_fwd.cu,
// fused_ce_bwd.cu): the weight-tied lm-head product and the softmax /
// cross-entropy reduction in one pass, so the (n, V) logits never exist in
// device memory. Built for sm_90a by ops/cuda_build.py; wrapped by
// ops/fused_ce.py. `ce_kernel` runs all three (forward, dx, dW) in fp32
// and, past C 1024, in bf16; bf16 up to C 1024 runs `ce_kernel_sm90`
// (fused_ce_sm90.cuh: wgmma on a TMA ring).
//
// Replaces the tile math of the reference package's Pallas kernels
// (distributed_pytorch_tpu/ops/fused_ce.py): `_score_tile` :71 and
// `_dlogits` :146, shared by `_fwd_kernel` :84, `_bwd_dx_kernel` :153 and
// `_bwd_dw_kernel` :171.
//
// Bound on the H100: operations. At the training shape (n 8192 tokens,
// C 768, V 50304, bf16) the forward does 2 n V C = 633 GFLOP over ~90 MB of
// x and W (~7,000 FLOP per byte, against the card's ~295), 0.64 ms at the
// bf16 tensor-core peak; each backward kernel recomputes the scores and
// does 1.27 TFLOP (1.28 ms).
//
// Design of `ce_kernel` (the first design; the bf16 Hopper redesign of
// all three is in fused_ce_sm90.cuh):
// * One CTA of 8 warps per tile of the RESIDENT operand, walking tiles of
//   the STREAMED operand in an inner loop — the TPU's sequential
//   ("arbitrary") grid axis becomes that loop, so nothing crosses CTAs: no
//   atomics, and dx and dW are deterministic.
//     forward, dx: resident x rows (tokens), streamed W rows (vocab);
//     dW:          resident W rows (vocab), streamed x rows (tokens).
//   Every CTA walks the streamed tiles in the same order from tile 0, so
//   CTAs running together read the same W tiles and W (77 MB in bf16, more
//   than the 50 MB L2) is mostly read from L2, not device memory.
// * C is streamed in chunks of at most 768 columns, of near-equal widths
//   that are multiples of 128: one chunk up to C 768, two at 1024 and
//   1280. Both tiles hold one chunk of their rows in shared memory, loaded
//   with cp.async (rows past the end zero-filled); rows are padded by 16
//   bytes, so the fragment loads of 8 rows hit 32 distinct banks. The
//   score product sums over the chunks. With one chunk the resident tile
//   is loaded once for the CTA's whole walk; with more it is reloaded with
//   each chunk of each streamed tile.
// * A backward CTA owns one chunk of its output rows' columns (grid.y)
//   and walks the chunks so that it ends on its own: the streamed tile's
//   columns that its second product reads are then in shared memory. Past
//   one chunk each backward CTA recomputes the whole score product, so
//   the backward does nc times the score work of one chunk.
// * The score tile S = X W^T (fp32) is split over the 8 warps, each warp
//   owning 16 token rows and a strip of vocab columns. bf16 operands run
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate: the reference's
//   preferred_element_type=float32) on fragments loaded with ldmatrix.
//   fp32 operands run the same fragment layout as fp32 FMA loops (full
//   fp32, no TF32), for the fp32 parity.
// * Measured limit (H100, bf16): every kernel does ~64 FLOP per byte of
//   the streamed tile it reads (2 x the resident rows, whole rows of C),
//   and all three ran at ~125 TFLOP/s, ~2 TB/s of tile reads with the
//   loads not overlapped with the products (one CTA per SM); the bf16
//   redesign takes 64 resident rows, a TMA ring and wgmma.
// * Forward: online max / normaliser per token row across vocab tiles
//   (quad shuffles, then across warps through shared memory); the target
//   logit is picked where the column equals the target.
// * Backward: dlogits = (exp(s - lse) - onehot(t)) * coef, rounded to the
//   operand dtype (the reference's `.astype` before each product) into a
//   32 x K shared tile (dW stores it transposed), then the second product
//   acc(32 x Cc) += D(32 x K) B(K x Cc) over the CTA's output chunk of Cc
//   columns, with B the streamed tile (dx: W rows, dW: x rows), held in
//   fp32 registers (96 a thread at Cc 768) for the CTA's whole walk and
//   written once at the end.
// * Columns past V are masked to -1e30 before the max (the reference pads
//   W to a tile multiple on the host instead); rows past n or V are zero
//   and never written. An ignored row has target -2 and coef 0, so its
//   dlogits, and its dx row, are exactly 0.

#pragma once

#include <type_traits>

#include "flash_attn_common.cuh"

namespace fce {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 8 warps
constexpr int kUnit = 128;     // C is a multiple of 128
constexpr int kMaxC = 768;     // the widest C chunk a tile holds
enum Mode { FWD = 0, DX = 1, DW = 2 };

struct Params {
  const void* x;        // (n, C)
  const void* w;        // (V, C)
  const int* t;         // (n,) targets; outside [0, V) never matches
  const float* lse_in;  // (n,) backward
  const float* coef;    // (n,) backward: d loss / d nll
  float* nll;           // (n,) forward
  float* lse_out;       // (n,) forward
  void* out;            // dx (n, C) or dW (V, C)
  int n, V, C;
  int nc, cw;           // C chunks, and the widest chunk's width
};

// Columns [start, start + width) of C chunk k: chunk k takes units of 128
// columns [k u / nc, (k + 1) u / nc), u = C / 128.
__host__ __device__ __forceinline__ void chunk(const Params& p, int k, int& start, int& width) {
  const int u = p.C / kUnit;
  const int a = k * u / p.nc, b = (k + 1) * u / p.nc;
  start = a * kUnit;
  width = (b - a) * kUnit;
}

// Tile shapes. BN token rows x BV vocab columns of the score tile; the
// second product's contraction K2 (dx: BV vocab, dW: BN tokens) and rows
// (32 tokens for dx, 32 vocab for dW).
template <typename T, int MODE>
struct Cfg {
  static constexpr bool kBf = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BN = kBf ? (MODE == DX ? 32 : 64) : 32;
  static constexpr int BV = kBf ? (MODE == DW ? 32 : 64) : 32;
  static constexpr int WM = BN / 16;         // warps along tokens
  static constexpr int WN = 8 / WM;          // warps along vocab
  static constexpr int NT = BV / WN / 8;     // 8-column n-tiles per warp
  static constexpr int PAD = 16 / sizeof(T); // elements of row padding
  static constexpr int K2 = MODE == DX ? BV : BN;
  static constexpr int LDD = K2 + PAD;       // dlogits tile row stride
};

template <typename T, int MODE>
inline size_t smem_bytes(int cw) {
  using Cf = Cfg<T, MODE>;
  return sizeof(T) * ((size_t)(Cf::BN + Cf::BV) * (cw + Cf::PAD) + 32 * Cf::LDD) +
         sizeof(float) * 3 * Cf::WN * Cf::BN;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Copy `rows` rows of `width` elements (row stride C) into shared memory
// (row stride ld), zero-filling rows >= n_valid. Asynchronous: cp_wait()
// waits.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int rows, int n_valid,
                                          int width, int C) {
  const int vpr = width * (int)sizeof(T) / 16;
  for (int e = threadIdx.x; e < rows * vpr; e += kThreads) {
    const int r = e / vpr, v = e - r * vpr;
    const bool ok = r < n_valid;
    const char* s = reinterpret_cast<const char*>(ok ? src + (long long)r * C : src) + v * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(reinterpret_cast<char*>(dst + r * ld) + v * 16)),
                 "l"(s), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// ldmatrix.x4: four 8 x 8 bf16 matrices, lanes 8i..8i+7 giving the row
// addresses of matrix i; each thread receives one 32-bit pair of each
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s[j][e] = sum_k X[r0 + g (+8)][k] * W[c0 + 8j + 2q (+1)][k]: this warp's
// 16 x 8*NT block of the score tile in the mma.sync C-fragment layout
// (e = 0,1: row g, columns 2q, 2q+1; e = 2,3: row g+8). X and W are shared
// tiles of stride ld; X points at row r0, W at row c0.
template <int NT>
__device__ __forceinline__ void score(float (&s)[NT][4], const __nv_bfloat16* X,
                                      const __nv_bfloat16* W, int ld, int C, int lane) {
  static_assert(NT % 2 == 0, "n-tiles load in pairs");
  // A fragments: lanes address rows (lane & 7) + 8 * bit 3 at column
  // 8 * bit 4; B fragments of n-tiles (j, j+1): rows (lane & 7) + 8 * bit 4
  // at column 8 * bit 3
  const __nv_bfloat16* xa = X + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const __nv_bfloat16* wb = W + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll 4
  for (int k = 0; k < C; k += 16) {
    unsigned a[4];
    ldsm_x4(a, xa + k);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      unsigned b[4];
      ldsm_x4(b, wb + j * 8 * ld + k);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void score(float (&s)[NT][4], const float* X, const float* W, int ld,
                                      int C, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float* x0 = X + g * ld;
  const float* x1 = x0 + 8 * ld;
  for (int k = 0; k < C; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(x0 + k);
    const float4 a1 = *reinterpret_cast<const float4*>(x1 + k);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* wj = W + (j * 8 + 2 * q) * ld + k;
      const float4 b0 = *reinterpret_cast<const float4*>(wj);
      const float4 b1 = *reinterpret_cast<const float4*>(wj + ld);
      s[j][0] = fmaf(a0.x, b0.x, s[j][0]);
      s[j][1] = fmaf(a0.x, b1.x, s[j][1]);
      s[j][2] = fmaf(a1.x, b0.x, s[j][2]);
      s[j][3] = fmaf(a1.x, b1.x, s[j][3]);
      s[j][0] = fmaf(a0.y, b0.y, s[j][0]);
      s[j][1] = fmaf(a0.y, b1.y, s[j][1]);
      s[j][2] = fmaf(a1.y, b0.y, s[j][2]);
      s[j][3] = fmaf(a1.y, b1.y, s[j][3]);
      s[j][0] = fmaf(a0.z, b0.z, s[j][0]);
      s[j][1] = fmaf(a0.z, b1.z, s[j][1]);
      s[j][2] = fmaf(a1.z, b0.z, s[j][2]);
      s[j][3] = fmaf(a1.z, b1.z, s[j][3]);
      s[j][0] = fmaf(a0.w, b0.w, s[j][0]);
      s[j][1] = fmaf(a0.w, b1.w, s[j][1]);
      s[j][2] = fmaf(a1.w, b0.w, s[j][2]);
      s[j][3] = fmaf(a1.w, b1.w, s[j][3]);
    }
  }
}

// acc[mi][j][e] += sum_k D[mi*16 + g (+8)][k] * B[k][n0 + 8j + 2q (+1)]
// for j < ntc: the warp's 32 x 8*ntc strip of the second product, D the
// 32 x K2 dlogits tile (stride LDD), B the K2-row tile (stride ld) at
// column n0.
template <int K2, int LDD>
__device__ __forceinline__ void accumulate(float (&acc)[2][kMaxC / 64][4],
                                           const __nv_bfloat16* D, const __nv_bfloat16* B,
                                           int ld, int n0, int ntc, int lane) {
  const __nv_bfloat16* da = D + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDD + (lane >> 4) * 8;
  // ldmatrix.x4.trans: lanes 0-7 / 8-15 address rows k..k+7 / k+8..k+15 of
  // n-tile 2jj, lanes 16-31 the same rows of n-tile 2jj+1
  const __nv_bfloat16* bl = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < K2; k += 16) {
    unsigned a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) ldsm_x4(a[mi], da + mi * 16 * LDD + k);
#pragma unroll
    for (int jj = 0; jj < kMaxC / 128; ++jj) {
      if (2 * jj >= ntc) break;
      unsigned b0, b1, b2, b3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
          : "r"(smem_addr(bl + k * ld + jj * 16)));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * jj], a[mi], b0, b1);
        mma_bf16(acc[mi][2 * jj + 1], a[mi], b2, b3);
      }
    }
  }
}

template <int K2, int LDD>
__device__ __forceinline__ void accumulate(float (&acc)[2][kMaxC / 64][4], const float* D,
                                           const float* B, int ld, int n0, int ntc, int lane) {
  const int g = lane >> 2, q = lane & 3;
  for (int k = 0; k < K2; ++k) {
    float a[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      a[mi][0] = D[(mi * 16 + g) * LDD + k];
      a[mi][1] = D[(mi * 16 + g + 8) * LDD + k];
    }
    const float* bk = B + k * ld + n0 + 2 * q;
#pragma unroll
    for (int j = 0; j < kMaxC / 64; ++j) {
      if (j >= ntc) break;
      const float2 b = *reinterpret_cast<const float2*>(bk + j * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][j][0] = fmaf(a[mi][0], b.x, acc[mi][j][0]);
        acc[mi][j][1] = fmaf(a[mi][0], b.y, acc[mi][j][1]);
        acc[mi][j][2] = fmaf(a[mi][1], b.x, acc[mi][j][2]);
        acc[mi][j][3] = fmaf(a[mi][1], b.y, acc[mi][j][3]);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The per-token inputs of score-tile rows r (this thread's two rows): the
// target (-2 past n) and, in the backward, lse and coef (0 past n).
__device__ __forceinline__ void row_inputs(const Params& p, int i, int& t, float& lse,
                                           float& coef, bool bwd) {
  const bool ok = i < p.n;
  t = ok ? p.t[i] : -2;
  lse = (ok && bwd) ? p.lse_in[i] : 0.f;
  coef = (ok && bwd) ? p.coef[i] : 0.f;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) ce_kernel(const Params p) {
  using Cf = Cfg<T, MODE>;
  constexpr int BN = Cf::BN, BV = Cf::BV, NT = Cf::NT, LDD = Cf::LDD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C, ld = p.cw + Cf::PAD;
  T* Xs = reinterpret_cast<T*>(smem_raw);  // [BN][ld] token rows, one C chunk
  T* Ws = Xs + BN * ld;                     // [BV][ld] vocab rows, one C chunk
  T* Ds = Ws + BV * ld;                     // [32][LDD] dlogits (dW: transposed)
  float* red = reinterpret_cast<float*>(Ds + 32 * LDD);  // [3][WN][BN]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / Cf::WN, wn = warp % Cf::WN;
  const int r0 = wm * 16, c0 = wn * NT * 8;  // the warp's block of the score tile
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);

  // the resident tile and the number of streamed tiles
  int i0 = 0, j0 = 0, n_tiles;
  if constexpr (MODE == DW) {
    j0 = blockIdx.x * BV;
    n_tiles = (p.n + BN - 1) / BN;
  } else {
    i0 = blockIdx.x * BN;
    n_tiles = (p.V + BV - 1) / BV;
  }
  // columns [start, start + width) of the resident rows into shared memory
  auto load_resident = [&](int start, int width) {
    if constexpr (MODE == DW) {
      load_rows<T>(Ws, ld, w + (long long)j0 * C + start, BV, p.V - j0, width, C);
    } else {
      load_rows<T>(Xs, ld, x + (long long)i0 * C + start, BN, p.n - i0, width, C);
    }
  };
  if (p.nc == 1) load_resident(0, C);  // once, for the whole walk
  // the backward's output chunk: its columns of the second product
  const int cy = MODE == FWD ? 0 : blockIdx.y;
  int o_start, o_width;
  chunk(p, cy, o_start, o_width);

  int tr[2];
  float lse[2], coef[2];
  if constexpr (MODE != DW) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_inputs(p, i0 + r0 + g + 8 * h, tr[h], lse[h], coef[h], MODE == DX);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, tgt[2] = {0.f, 0.f};
  float acc[2][kMaxC / 64][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < kMaxC / 64; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const int ntc = o_width / 64;       // second-product n-tiles per warp
  const int n0 = warp * o_width / 8;  // this warp's columns of the output chunk

  for (int it = 0; it < n_tiles; ++it) {
    if constexpr (MODE == DW) {
      i0 = it * BN;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        row_inputs(p, i0 + r0 + g + 8 * h, tr[h], lse[h], coef[h], true);
    } else {
      j0 = it * BV;
    }

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < p.nc; ++kk) {
      // the backward ends on its output chunk cy, whose streamed columns
      // its second product reads
      const int k = MODE == FWD ? kk : (cy + 1 + kk) % p.nc;
      int start, width;
      chunk(p, k, start, width);
      __syncthreads();  // the previous reads of the tiles are done
      if (p.nc > 1) load_resident(start, width);
      if constexpr (MODE == DW) {
        load_rows<T>(Xs, ld, x + (long long)i0 * C + start, BN, p.n - i0, width, C);
      } else {
        load_rows<T>(Ws, ld, w + (long long)j0 * C + start, BV, p.V - j0, width, C);
      }
      cp_wait();
      __syncthreads();
      score<NT>(s, Xs + r0 * ld, Ws + c0 * ld, ld, width, lane);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + c0 + j * 8 + 2 * q + (e & 1) >= p.V) s[j][e] = kNegInf;

    if constexpr (MODE == FWD) {
      float* red_m = red;
      float* red_l = red + Cf::WN * BN;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        if (q == 0) red_m[wn * BN + r0 + g + 8 * h] = mx[h];
      }
      __syncthreads();
      float m_new[2], sum[2] = {0.f, 0.f};
      for (int h = 0; h < 2; ++h) {
        float tm = kNegInf;
        for (int v = 0; v < Cf::WN; ++v) tm = fmaxf(tm, red_m[v * BN + r0 + g + 8 * h]);
        m_new[h] = fmaxf(m[h], tm);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          sum[h] += expf(s[j][e] - m_new[h]);
          if (j0 + c0 + j * 8 + 2 * q + (e & 1) == tr[h]) tgt[h] += s[j][e];
        }
      for (int h = 0; h < 2; ++h) {
        sum[h] = quad_sum(sum[h]);
        if (q == 0) red_l[wn * BN + r0 + g + 8 * h] = sum[h];
      }
      __syncthreads();
      for (int h = 0; h < 2; ++h) {
        float ts = 0.f;
        for (int v = 0; v < Cf::WN; ++v) ts += red_l[v * BN + r0 + g + 8 * h];
        l[h] = l[h] * expf(m[h] - m_new[h]) + ts;
        m[h] = m_new[h];
      }
    } else {
      // dlogits rounded to the operand dtype; dx keeps [token][vocab],
      // dW stores the transpose [vocab][token]
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int col = c0 + j * 8 + 2 * q + (e & 1), row = r0 + g + 8 * h;
          const float pr = expf(s[j][e] - lse[h]);
          const float d = (pr - (j0 + col == tr[h] ? 1.f : 0.f)) * coef[h];
          if constexpr (MODE == DX) {
            Ds[row * LDD + col] = flash::from_f<T>(d);
          } else {
            Ds[col * LDD + row] = flash::from_f<T>(d);
          }
        }
      __syncthreads();
      accumulate<Cf::K2, LDD>(acc, Ds, MODE == DX ? Ws : Xs, ld, n0, ntc, lane);
    }
  }

  if constexpr (MODE == FWD) {
    float* red_t = red + 2 * Cf::WN * BN;
    for (int h = 0; h < 2; ++h) {
      const float tv = quad_sum(tgt[h]);
      if (q == 0) red_t[wn * BN + r0 + g + 8 * h] = tv;
    }
    __syncthreads();
    if (wn == 0 && q == 0)
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + r0 + g + 8 * h;
        if (i >= p.n) continue;
        float tv = 0.f;
        for (int v = 0; v < Cf::WN; ++v) tv += red_t[v * BN + r0 + g + 8 * h];
        const float ls = m[h] + logf(fmaxf(l[h], 1e-30f));
        p.lse_out[i] = ls;
        p.nll[i] = ls - tv;
      }
  } else {
    // rows: dx tokens i0 + ..., dW vocab j0 + ...
    const int base = MODE == DX ? i0 : j0;
    const int lim = MODE == DX ? p.n : p.V;
    T* out = static_cast<T*>(p.out);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = base + mi * 16 + g + 8 * h;
        if (r >= lim) continue;
        T* orow = out + (long long)r * C + o_start + n0 + 2 * q;
#pragma unroll
        for (int j = 0; j < kMaxC / 64; ++j) {
          if (j >= ntc) break;
          orow[j * 8] = flash::from_f<T>(acc[mi][j][2 * h]);
          orow[j * 8 + 1] = flash::from_f<T>(acc[mi][j][2 * h + 1]);
        }
      }
  }
}

// Check the shape, raise the shared-memory cap once per device and
// instantiation, launch on `stream`. Returns a cudaError_t.
template <typename T, int MODE>
int launch(Params p, void* stream) {
  using Cf = Cfg<T, MODE>;
  if (p.C <= 0 || p.C % kUnit != 0 || p.n < 0 || p.V <= 0) return (int)cudaErrorInvalidValue;
  const int u = p.C / kUnit, per = kMaxC / kUnit;
  p.nc = (u + per - 1) / per;
  p.cw = kUnit * ((u + p.nc - 1) / p.nc);
  static size_t cap[64] = {};
  const size_t smem = smem_bytes<T, MODE>(p.cw);
  const int err = flash::set_smem(ce_kernel<T, MODE>, smem, cap);
  if (err) return err;
  const int rows = MODE == DW ? p.V : p.n;
  const int tile = MODE == DW ? Cf::BV : Cf::BN;
  if (rows == 0) return 0;
  const dim3 grid((rows + tile - 1) / tile, MODE == FWD ? 1 : p.nc);
  ce_kernel<T, MODE><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(int dtype, Params p, void* stream) {
  if (dtype == 0) return launch<float, MODE>(p, stream);
  if (dtype == 1) return launch<__nv_bfloat16, MODE>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace fce
