// Shared body of the grouped-matmul kernels (grouped_mm_fwd.cu,
// grouped_mm_bwd.cu): one 128 x 128 output tile of a product whose operands
// come from an expert-sorted, tile-aligned row buffer and a stack of expert
// weights. Built for sm_90a by ops/cuda_build.py; wrapped by
// ops/grouped_matmul.py.
//
// Replaces the tile math of the reference package's Pallas kernels
// (distributed_pytorch_tpu/ops/grouped_matmul.py): `_dot` / `_dot_nt` /
// `_dot_tn` :83-97 as run by `_fwd_kernel(_scaled)` :105-113,
// `_dx_kernel(_scaled)` :116-124 and `_dw_kernel` :127.
//
// Bound on the H100: operations. At the training shape (P 25600 packed
// rows, K 768 / N 2048 for the fc product, K 1024 / N 768 for proj, bf16)
// each product does 2 P K N FLOP (80.5 / 40.3 GFLOP: 0.081 / 0.041 ms at
// the bf16 tensor-core peak) over ~0.1 GB of operands, ~800 FLOP per byte
// against the card's ~295. dx and dW do the same FLOP each.
//
// `gmm_kernel` is the fp32 design of all three modes (forward, dx, dW):
// FMA loops on CUDA cores, full fp32 (tensor cores take fp32 only as TF32,
// which would break the fp32 limits). Every bf16 product runs on tensor
// cores instead, wgmma on TMA-fed shared memory: `fwd_kernel_sm90`
// (grouped_mm_fwd.cu), `dx_kernel_sm90` and `dw_kernel_sm90`
// (grouped_mm_bwd.cu); the dtype picks the kernel before launch. What
// bounds this body on the H100 is FMA issue out of shared memory, at
// about twice its fp32 operation bound (PERF.md §6):
// * One CTA of 8 warps owns a 128 x 128 tile of the output, each warp a
//   32 x 64 block (4 warps along M, 2 along N). The contraction streams in
//   chunks of 32 through two shared-memory stages filled with 16-byte
//   cp.async copies (out-of-range vectors zero-filled), so the next
//   chunk's loads fly while this chunk's products run.
// * Every operand is copied as it lies in device memory, rows of 16-byte
//   vectors padded by 16 bytes; its orientation is handled at the read
//   instead, by the stored axis (`A_KM`, `B_KM`). Each thread accumulates
//   the mma.sync C-fragment layout of its warp's block with fmaf:
//     forward: A = x rows [m][k], B = W_e [k][n]
//     dx:      A = dy rows [m][n], B = W_e [k][n] read as W_e^T
//     dW:      A = x rows [r][k] read as x^T, B = dy rows [r][n]
// * The expert of a forward or dx CTA is tile_group[row0 / bm], read from
//   device memory as the TPU's scalar prefetch read it (bm a multiple of
//   128, so a CTA's rows lie in one tile). A dW CTA owns one (expert,
//   K tile, N tile) and walks that expert's own rows, [start, start +
//   ceil(count / bm) bm), in the contraction loop: the TPU's sequential
//   token-tile grid axis with its tile_first resets becomes that loop, so
//   nothing crosses CTAs — no atomics, a deterministic sum, and an expert
//   with no rows writes zeros. Experts are the grid's slowest axis, so the
//   shared experts' CTAs (every token) start first. An expert's rows run
//   to 24576 at the training shape: each 128-row tile is summed into a
//   fresh partial and then added to the accumulator, as the plain version
//   sums per tile.
// * Gates: the forward scales each fp32 row at the output write, then
//   rounds once; dx and dW round dy * gate to the operand dtype in shared
//   memory before the product, as the reference's `.astype` does.

#pragma once

#include <type_traits>

#include "fused_ce_common.cuh"

namespace gmm {

constexpr int kThreads = 256;  // 8 warps
constexpr int BM = 128;        // output rows of a CTA (and the least bm)
constexpr int BN = 128;        // output columns of a CTA
constexpr int BK = 32;         // contraction chunk
constexpr int kAlign = 8;      // widths in elements: whole 16-byte vectors
constexpr int kPromote = 4;    // dW: chunks (128 rows) summed in a partial
enum Mode { FWD = 0, DX = 1, DW = 2 };

struct Params {
  const void* a;          // fwd, dW: x_pad (P, K); dx: dy (P, N)
  const void* b;          // fwd, dx: w (E, K, N); dW: dy (P, N)
  const float* scale;     // (P,) row gates, or null (unscaled)
  const int* tile_group;  // (P / bm,) expert of each row tile: fwd, dx
  const int* counts;      // (E,) rows of each expert: dW
  const int* gstart;      // (E,) first (padded) row of each expert: dW
  void* out;              // fwd (P, N), dx (P, K) in the operand dtype;
                          // dW (E, K, N) fp32
  int P, K, N, E, bm;
};

// Tile geometry of one mode: A is stored [m][kk] unless A_KM ([kk][m]),
// B [n][kk] unless B_KM ([kk][n]); each row padded by 16 bytes.
template <typename T, int MODE>
struct Cfg {
  static constexpr bool A_KM = MODE == DW;
  static constexpr bool B_KM = MODE != DX;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDA = A_KM ? BM + PAD : BK + PAD;
  static constexpr int LDB = B_KM ? BN + PAD : BK + PAD;
  static constexpr int A_SZ = (A_KM ? BK : BM) * LDA;  // elements a stage
  static constexpr int B_SZ = (B_KM ? BK : BN) * LDB;
  static constexpr size_t kSmem = sizeof(T) * 2 * (A_SZ + B_SZ) + sizeof(float) * BM;
};

// Copy the ROWS x COLS tile at (r0, c0) of a row-major matrix (row stride
// ld) into shared memory (row stride ldd); elements at or past (r_end,
// c_end) are zero-filled. c_end is a multiple of 16 bytes' worth of T.
// Asynchronous: one commit group.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* base, long long ld, int r0,
                                          int c0, int r_end, int c_end) {
  constexpr int EPV = 16 / sizeof(T);  // elements a vector
  constexpr int VPR = COLS / EPV;
  for (int e = threadIdx.x; e < ROWS * VPR; e += kThreads) {
    const int r = e / VPR, c = (e - r * VPR) * EPV;
    const bool ok = r0 + r < r_end && c0 + c < c_end;
    const T* s = ok ? base + (long long)(r0 + r) * ld + c0 + c : base;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     fce::smem_addr(dst + r * ldd + c)),
                 "l"(s), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc[mi][j][e] += sum over one BK chunk of A(m, kk) B(kk, n) for this
// warp's rows m = wm0 + 16 mi + g (+8 for e >= 2) and columns n = wn0 +
// 8 j + 2 q (+1 for odd e): the mma.sync C-fragment layout.
template <bool A_KM, bool B_KM>
__device__ __forceinline__ void mma_chunk(float (&acc)[2][8][4], const float* As, int lda,
                                          const float* Bs, int ldb, int wm0, int wn0, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float a[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm0 + mi * 16 + g + 8 * h;
        a[mi][h] = A_KM ? As[k * lda + m] : As[m * lda + k];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = wn0 + j * 8 + 2 * q;
      float b0, b1;
      if constexpr (B_KM) {
        const float2 v = *reinterpret_cast<const float2*>(Bs + k * ldb + n);
        b0 = v.x;
        b1 = v.y;
      } else {
        b0 = Bs[n * ldb + k];
        b1 = Bs[(n + 1) * ldb + k];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][j][0] = fmaf(a[mi][0], b0, acc[mi][j][0]);
        acc[mi][j][1] = fmaf(a[mi][0], b1, acc[mi][j][1]);
        acc[mi][j][2] = fmaf(a[mi][1], b0, acc[mi][j][2]);
        acc[mi][j][3] = fmaf(a[mi][1], b1, acc[mi][j][3]);
      }
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) gmm_kernel(const Params p) {
  static_assert(std::is_same<T, float>::value, "bf16 runs the *_kernel_sm90 kernels");
  using Cf = Cfg<T, MODE>;
  constexpr bool A_KM = Cf::A_KM, B_KM = Cf::B_KM;
  constexpr int LDA = Cf::LDA, LDB = Cf::LDB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [2][A_SZ]
  T* Bs = As + 2 * Cf::A_SZ;               // [2][B_SZ]
  float* gs = reinterpret_cast<float*>(Bs + 2 * Cf::B_SZ);  // [BM] dx row gates
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 64;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  const bool scaled = p.scale != nullptr;

  // The output tile (m0, n0) and its bounds, the contraction range
  // [c0, c1), and each operand's row stride and row/column ends in its
  // stored orientation.
  int m0, n0, m_end, n_end, c0, c1, e;
  long long lda, ldb;
  if constexpr (MODE == DW) {
    e = blockIdx.z;
    m0 = blockIdx.x * BM;  // over K
    n0 = blockIdx.y * BN;  // over N
    m_end = p.K;
    n_end = p.N;
    const int cnt = p.counts[e];
    c0 = p.gstart[e];
    c1 = min(c0 + (cnt + p.bm - 1) / p.bm * p.bm, p.P);
    lda = p.K;  // x rows [r][k]
    ldb = p.N;  // dy rows [r][n]
  } else {
    m0 = blockIdx.x * BM;  // over P
    n0 = blockIdx.y * BN;  // over N (fwd) or K (dx)
    e = p.tile_group[m0 / p.bm];
    m_end = p.P;
    n_end = MODE == FWD ? p.N : p.K;
    c0 = 0;
    c1 = MODE == FWD ? p.K : p.N;
    lda = MODE == FWD ? p.K : p.N;  // x or dy rows
    ldb = p.N;                      // W_e rows [k][n]
    B += (long long)e * p.K * p.N;
    if (MODE == DX && scaled)
      for (int r = threadIdx.x; r < BM; r += kThreads)
        gs[r] = m0 + r < p.P ? p.scale[m0 + r] : 0.f;
  }
  const int nk = c1 > c0 ? (c1 - c0 + BK - 1) / BK : 0;

  auto load = [&](int c, int s) {
    const int kc = c0 + c * BK;
    T* as = As + s * Cf::A_SZ;
    T* bs = Bs + s * Cf::B_SZ;
    if constexpr (A_KM) {
      load_tile<T, BK, BM>(as, LDA, A, lda, kc, m0, c1, m_end);
    } else {
      load_tile<T, BM, BK>(as, LDA, A, lda, m0, kc, m_end, c1);
    }
    if constexpr (B_KM) {
      load_tile<T, BK, BN>(bs, LDB, B, ldb, kc, n0, c1, n_end);
    } else {
      load_tile<T, BN, BK>(bs, LDB, B, ldb, n0, kc, n_end, c1);
    }
  };

  float acc[2][8][4], part[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][j][v] = part[mi][j][v] = 0.f;

  if (nk > 0) load(0, 0);
  for (int c = 0; c < nk; ++c) {
    const int s = c & 1;
    if (c + 1 < nk) {
      load(c + 1, s ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    T* as = As + s * Cf::A_SZ;
    T* bs = Bs + s * Cf::B_SZ;
    if (scaled && MODE != FWD) {
      // dy * gate rounded to the operand dtype before the product: dx's
      // A tile (rows m), dW's B tile (rows kc + r)
      const int kc = c0 + c * BK;
      constexpr int W = MODE == DX ? BK : BN;
      constexpr int LD = MODE == DX ? LDA : LDB;
      T* t = MODE == DX ? as : bs;
      for (int i = threadIdx.x; i < (MODE == DX ? BM : BK) * W; i += kThreads) {
        const int r = i / W, col = i - r * W;
        const float gate = MODE == DX ? gs[r] : (kc + r < c1 ? p.scale[kc + r] : 0.f);
        t[r * LD + col] = flash::from_f<T>(flash::to_f<T>(t[r * LD + col]) * gate);
      }
      __syncthreads();
    }
    if constexpr (MODE == DW) {
      mma_chunk<A_KM, B_KM>(part, as, LDA, bs, LDB, wm0, wn0, lane);
      if ((c + 1) % kPromote == 0 || c + 1 == nk) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              acc[mi][j][v] += part[mi][j][v];
              part[mi][j][v] = 0.f;
            }
      }
    } else {
      mma_chunk<A_KM, B_KM>(acc, as, LDA, bs, LDB, wm0, wn0, lane);
    }
    __syncthreads();  // this stage is refilled two chunks on
  }

  // epilogue in fp32, the forward's rows times their gates
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + mi * 16 + g + 8 * h;
      if (m >= m_end) continue;
      const float gate = (MODE == FWD && scaled) ? p.scale[m] : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wn0 + j * 8 + 2 * q;
        if (n >= n_end) continue;
        const float x = acc[mi][j][2 * h] * gate, y = acc[mi][j][2 * h + 1] * gate;
        float* o = static_cast<float*>(p.out) +
                   (MODE == DW ? ((long long)e * p.K + m) * p.N : (long long)m * n_end) + n;
        *reinterpret_cast<float2*>(o) = make_float2(x, y);
      }
    }
}

// The shapes every grouped kernel takes: widths whole 16-byte vectors of
// bf16, bm a multiple of the 128-row tile dividing P.
inline bool shape_ok(const Params& p) {
  return p.P >= 0 && p.K > 0 && p.N > 0 && p.E > 0 && p.K % kAlign == 0 && p.N % kAlign == 0 &&
         p.bm > 0 && p.bm % BM == 0 && p.P % p.bm == 0;
}

// Check the shape, raise the shared-memory cap once per device and
// instantiation, launch on `stream`. Returns a cudaError_t.
template <typename T, int MODE>
int launch(const Params& p, void* stream) {
  if (!shape_ok(p)) return (int)cudaErrorInvalidValue;
  static size_t cap[64] = {};
  const size_t smem = Cfg<T, MODE>::kSmem;
  const int err = flash::set_smem(gmm_kernel<T, MODE>, smem, cap);
  if (err) return err;
  dim3 grid;
  if (MODE == DW) {
    grid = dim3((p.K + BM - 1) / BM, (p.N + BN - 1) / BN, p.E);
  } else {
    if (p.P == 0) return 0;
    grid = dim3(p.P / BM, ((MODE == FWD ? p.N : p.K) + BN - 1) / BN);
  }
  gmm_kernel<T, MODE><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace gmm
