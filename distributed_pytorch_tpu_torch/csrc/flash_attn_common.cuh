// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the launch parameters, the dropout hash, tile loads
// from BTNH tensors into shared memory, and the register-tiled product of
// two shared-memory tiles. Built for sm_90a by ops/cuda_build.py.
//
// What they replace: the tile math shared by the reference package's Pallas
// kernels `_fwd_tile` / `_dq_tile` / `_dkv_tile`
// (distributed_pytorch_tpu/ops/flash_attention.py:267-332), which both of
// its kernel faces (rows and slab) run. Here the kernels read the model's
// own (B, T, N, H) layout through row strides, so one kernel serves both
// faces.
//
// Who uses the FMA design below: the fp32 forward, dq and dkv kernels.
// The bf16 kernels run on tensor cores instead (wgmma on TMA-fed shared
// memory, flash_attn_sm90.cuh and sm90_common.cuh); they share only
// `Params`, `keep` and `set_smem` with this file. fp32 stays here because
// tensor cores take fp32 only as TF32, which would break the fp32 limits
// of the kernel checks and of the training parity.
//
// What bounds it on the H100: the products are FMA loops on CUDA cores out
// of shared memory, so FMA and shared-memory issue bound them.
// * A CTA of 256 threads is a 16 x 16 grid; thread (ty, tx) owns a 4 x RN
//   block of every 64-row output tile: rows ty*4 .. ty*4+3, columns
//   tx*RN .. tx*RN+RN-1. Row reductions (softmax max and sum) stay inside
//   the 16 lanes of one half-warp.
// * Tiles live in shared memory as fp32, stored "contraction-major": the
//   operand of C = A @ B that is read along the contracted axis sits with
//   that axis outermost, so each step of the product reads one 16-byte
//   vector of A (broadcast in the half-warp) and RN/4 vectors of B. Rows are
//   padded by kPad floats, which keeps every vector 16-byte aligned.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // large-negative: masked rows stay NaN-free
constexpr int kThreads = 256;      // 16 x 16 thread grid
constexpr int kBK = 64;            // key rows per tile
constexpr int kBQ = 64;            // query rows per forward / dq tile
constexpr int kPad = 4;            // floats of padding per shared-memory row

// Head sizes: a kernel is built at a width D of 64, 128 or 256 and runs
// any head size d with d % 8 == 0 and D / 2 < d <= D (8 .. 64 at D 64).
// Columns d .. D - 1 of every q, k, v and dout row load as zeros, which add
// exactly 0 to each product, and no output column past d is written.
//
// Everything a kernel reads, passed by value. Element strides: q/k/v/dout
// rows of head h of batch b at time t sit at base + b*sb + t*st + h*d.
// lse and delta are (B, nh, T) fp32; out/dq are (B, T, nh, d) and dk/dv
// (B, S, nkv, d), contiguous.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;          // fwd: out; dq: dq; dkv: dk
  void* out1;          // dkv: dv
  float* lse_out;      // fwd: lse
  const int* seed;     // (2,) int32 on the device
  int B, T, S, nh, nkv;
  int nh_all, h0;      // the heads of the whole call, this call's first
  uint32_t q_mix, k_mix;  // the position offsets' terms of the dropout hash
  int d;               // the head size (the kernel's width D or less)
  int causal, dropout;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st;
  float scale;
  uint32_t thresh;     // drop iff bits < thresh
  float keep_scale;    // 1 / (1 - rate), in fp32
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: a product operand in the input dtype, as the
// TPU kernel's `.astype(v.dtype)` before each product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// A 16-byte vector of T as floats: 4 fp32 values, or 8 bf16 values (a bf16
// is the upper half of the fp32 with the same value; the lower element of
// each 32-bit word comes first).
template <typename T> __device__ __forceinline__ void unpack(const uint4& x, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& x, float* f) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& x, float* f) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// `_mix_bits` (flash_attention.py:118-136) in uint32 arithmetic: the hash of
// (attention row b*nh_all + h0 + h, query position, key position) and the seed.
// Keyed on absolute coordinates, so every kernel regenerates the same mask
// whatever its tile order. A call over a block of a longer sequence (a ring
// attention hop) has its first query and key at global positions q0 and k0;
// (q0 + qp) * c == qp * c + q0 * c mod 2^32, so the offsets enter as the
// addends q_mix = q0 * 0x85EBCA6B and k_mix = k0 * 0xC2B2AE35, folded on the
// host (0 at offsets 0).
__device__ __forceinline__ uint32_t mix_bits(uint32_t s0, uint32_t s1, uint32_t row,
                                             uint32_t qp, uint32_t kp, uint32_t q_mix,
                                             uint32_t k_mix) {
  uint32_t x = row * 0x9E3779B1u;
  x ^= qp * 0x85EBCA6Bu + q_mix;
  x ^= kp * 0xC2B2AE35u + k_mix;
  x ^= s0;
  x += s1 * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The dropout row of local head h of batch b: the row the whole call's mask
// gives that head (b * nh_all + h0 + h), so a call over a slice of the heads
// (a tensor-parallel rank's) draws the slice of the whole mask. At h0 0 and
// nh_all nh it is b * nh + h.
__device__ __forceinline__ uint32_t drop_row(const Params& p, int b, int h) {
  return (uint32_t)(b * p.nh_all + p.h0 + h);
}

// The scaled keep-mask value of one element: 1/(1-rate) or 0.
__device__ __forceinline__ float keep(const Params& p, uint32_t s0, uint32_t s1,
                                      uint32_t row, int qp, int kp) {
  return mix_bits(s0, s1, row, (uint32_t)qp, (uint32_t)kp, p.q_mix, p.k_mix) >= p.thresh
             ? p.keep_scale
             : 0.f;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load R rows of D elements (rows >= n_valid and columns >= n_cols read as
// zeros; n_cols is a multiple of the vector, and n_cols >= D, a constant
// in a kernel built for its head size, compiles the column test away)
// from `src` (row stride
// `stride` elements, 16-byte aligned rows) into shared memory as fp32:
// row-major dst[r*ld + c], or transposed dst[c*ld + r]. Every thread
// issues all its 16-byte loads before it stores any.
template <typename T, int D, int R, bool kTrans>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const T* __restrict__ src, long long stride,
                                          int n_valid, int n_cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = D / kVec;                 // vectors per row
  constexpr int kIters = R * kVpr / kThreads;    // R * kVpr is a multiple of 256
  static_assert(R * kVpr % kThreads == 0, "tile must split evenly");
  uint4 u[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = it * kThreads + threadIdx.x;
    const int r = e / kVpr, c = (e - r * kVpr) * kVec;
    u[it] = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid && (n_cols >= D || c < n_cols)) u[it] = *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = it * kThreads + threadIdx.x;
    const int r = e / kVpr, c = (e - r * kVpr) * kVec;
    float f[kVec];
    unpack<T>(u[it], f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (kTrans)
        dst[(c + i) * ld + r] = f[i];
      else
        dst[r * ld + c + i] = f[i];
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x;
      v[i + 1] = x.y;
      v[i + 2] = x.z;
      v[i + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "row vectors are 2, 4 or 8 floats");
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
}

// c[i][j] += sum_{kk < K} At[kk*lda + ty*4 + i] * Bt[kk*ldb + tx*RN + j]:
// this thread's 4 x RN block of C = A @ B with both operands stored
// contraction-major in shared memory.
template <int RN, int K>
__device__ __forceinline__ void mma_tile(float (&c)[4][RN], const float* __restrict__ At,
                                         int lda, const float* __restrict__ Bt, int ldb,
                                         int ty, int tx) {
  const float* a_p = At + ty * 4;
  const float* b_p = Bt + tx * RN;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[4], b[RN];
    load_vec<4>(a_p + kk * lda, a);
    load_vec<RN>(b_p + kk * ldb, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
}

// Store this thread's 4 x RN block of a tile transposed, as 4-float
// vectors along the 4 rows: dst[(tx*RN + j)*ld + ty*4 + i] = v[i][j].
template <int RN>
__device__ __forceinline__ void store_t(float* __restrict__ dst, int ld, const float (&v)[4][RN],
                                        int ty, int tx) {
#pragma unroll
  for (int j = 0; j < RN; ++j)
    *reinterpret_cast<float4*>(dst + (tx * RN + j) * ld + ty * 4) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Raise a kernel's dynamic shared-memory cap once per device and
// instantiation, not per launch. Returns a cudaError_t.
template <typename Kernel>
inline int set_smem(Kernel kernel, size_t smem, size_t (&cap)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > cap[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) cap[dev] = smem;
  }
  return 0;
}

// Whether a kernel built at width D runs head size d
inline bool runs_head_size(int D, int d) { return d % 8 == 0 && d >= 8 && d <= D; }

// Fill Params from the C entry's arguments. dims = (B, T, S, nh, nkv, causal,
// dropout, nh_all, h0, q0, k0); strides = (q_sb, q_st, k_sb, k_st, v_sb, v_st, do_sb, do_st).
inline Params make_params(int d, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse_in, const float* delta, void* out0, void* out1,
                          float* lse_out, const int* seed, const int* dims,
                          const long long* strides, float scale, unsigned thresh,
                          float keep_scale) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = lse_in;
  p.delta = delta;
  p.out0 = out0;
  p.out1 = out1;
  p.lse_out = lse_out;
  p.seed = seed;
  p.B = dims[0];
  p.T = dims[1];
  p.S = dims[2];
  p.nh = dims[3];
  p.nkv = dims[4];
  p.d = d;
  p.causal = dims[5];
  p.dropout = dims[6];
  p.nh_all = dims[7];
  p.h0 = dims[8];
  p.q_mix = (uint32_t)dims[9] * 0x85EBCA6Bu;
  p.k_mix = (uint32_t)dims[10] * 0xC2B2AE35u;
  p.q_sb = strides[0];
  p.q_st = strides[1];
  p.k_sb = strides[2];
  p.k_st = strides[3];
  p.v_sb = strides[4];
  p.v_st = strides[5];
  p.do_sb = strides[6];
  p.do_st = strides[7];
  p.scale = scale;
  p.thresh = thresh;
  p.keep_scale = keep_scale;
  return p;
}

}  // namespace flash
