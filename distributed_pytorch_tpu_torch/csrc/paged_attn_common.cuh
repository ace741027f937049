// Shared tile loop of the paged attention kernels (paged_decode_attn.cu,
// paged_prefill_attn.cu): a block of query rows of ONE kv head attends the
// keys of one sequence's paged cache, read through its block table, with
// an fp32 online softmax. Built for sm_90a by ops/cuda_build.py.
//
// What it replaces: the body shared by the reference package's Pallas
// kernels `_kernel` / `_paged_body` / `_prefill_kernel` and their int8
// variants `_kernel_q8` / `_paged_body_q8` / `_prefill_kernel_q8`
// (distributed_pytorch_tpu/ops/flash_decode.py). The cache element type C
// is the activations' type T, or int8 codes with one fp32 scale per
// (key row, kv head) in (n_blocks, bs, nkv, 1) scale pools: one loop for
// both, so the table walk, the causal mask and the online softmax are one
// piece of code. There the grid walked the
// kv blocks in order on one core and carried (m, l, acc) in VMEM scratch
// from one grid step to the next; here one CTA owns a set of query rows and
// walks the keys in an inner loop, so nothing has to carry across CTAs.
//
// Design (FMA loops on CUDA cores), run by the decode at rows wider than
// a warp's 32 vectors (fp32/bf16 K/V rows over 512 bytes, int8 rows over
// 256 codes), the fp32 prefill (either cache), and the bf16 prefill
// (either cache) at head sizes other than 64 and 128. The bf16 prefill at
// head size 64 and 128 runs `prefill_kernel_sm90` over a bf16 cache and
// `prefill_kernel_sm90_q8` over an int8 one (wgmma on cp.async-gathered
// tiles, paged_prefill_attn.cu), and the fp32, bf16 and int8-cache decode
// the split-KV kernels of paged_decode_attn.cu, each picked by dtype (and
// head size) before launch. What bounds this body on the H100 is the latency of its
// four passes a key tile (gather, scores, softmax, P V, each behind a
// __syncthreads, nothing overlapped) and FMA issue, not bytes (PERF.md
// §6: tens of times its byte bound):
// * The CTA loads its query rows once into shared memory (fp32), then for
//   each tile of kTile logical key rows gathers K and V rows from the pool
//   through the table (one table read per row: blocks may be any size, and
//   a contiguous cache is a pool of B blocks of S rows), converts them to
//   fp32 in shared memory, and runs score -> row softmax update -> PV as
//   three FMA passes separated by __syncthreads. K/V rows move as 16-byte
//   vectors, several per thread in flight before any is stored (the first
//   version loaded one element at a time and paid the memory latency once
//   per element: ~10x slower on the H100, PERF.md).
// * The loop stops at the last key any of the CTA's rows may see
//   (position + 1, capped at the table's capacity). Blocks past a
//   sequence's length are never touched: this is what the TPU kernel got
//   from clamping its index map so the DMA saw an unchanged block.
// * Masked scores are -1e30 (NaN-free), as in the TPU kernel. p is rounded
//   to the value dtype before the PV product (the TPU kernel's
//   `p.astype(v.dtype)`); the normalizer sums the unrounded fp32 p.
// * K rows are stored in shared memory with one float of padding, so the
//   score pass (consecutive threads on consecutive keys, same query row)
//   reads 32 distinct banks.
// * int8 cache: codes convert to fp32 exactly in shared memory (8-byte
//   vectors of 8 codes, so every head size that is a multiple of 8 tiles);
//   the tile's K and V scales are staged in shared memory beside them. The
//   score is the fp32 dot of q with the codes times (k_scale * scale); the
//   normalizer sums the fp32 p; the PV operand is (p * v_scale) rounded to
//   T against the codes — the reference's `_q8` arithmetic. Halving the
//   cache bytes is the point of the int8 cache; the FMA loops are
//   unchanged (packed int8 dot products are later work).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace paged_attn {

constexpr float kNegInf = -1e30f;  // large-negative: masked rows stay NaN-free
constexpr int kTile = 64;          // logical key rows per tile

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

// x rounded to T and back: p in the value dtype, as the PV product sees it
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// How a cache row moves: fp32 and bf16 rows as 16-byte vectors of
// 16 / sizeof(C) elements, int8 codes as 8-byte vectors of 8 codes.
template <typename C> struct RowVec {
  using type = uint4;
  static constexpr int n = 16 / sizeof(C);
};
template <> struct RowVec<int8_t> {
  using type = uint2;
  static constexpr int n = 8;
};

// One vector of C as floats: 4 fp32 values, 8 bf16 values (a bf16 is the
// upper half of the fp32 with the same value), or 8 int8 codes (exact);
// the lower element of each 32-bit word comes first.
template <typename C>
__device__ __forceinline__ void unpack(const typename RowVec<C>::type& x, float* f);
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
template <> __device__ __forceinline__ void unpack<int8_t>(const uint2& x, float* f) {
  const unsigned w[2] = {x.x, x.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b)  // byte b, sign-extended by the shift
      f[4 * i + b] = (float)(static_cast<int>(w[i] << (24 - 8 * b)) >> 24);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bytes of dynamic shared memory `attend_rows` needs for n_rows query rows
// (ops/flash_decode.py `_smem_bytes` computes the same).
inline size_t smem_bytes(int n_rows, int hs, bool q8) {
  const size_t floats = (size_t)n_rows * hs * 2   // q_s, acc_s
                      + (size_t)kTile * (hs + 1)  // k_s, padded rows
                      + (size_t)kTile * hs        // v_s
                      + (size_t)n_rows * kTile    // p_s
                      + (size_t)n_rows * 3        // m_s, l_s, a_s
                      + (q8 ? 2 * kTile : 0);     // ks_s, vs_s
  return floats * sizeof(float);
}

// The CTA's query rows. Packed row gi = row0 + i (i < n_rows) is query head
// (g*rep + gi % rep) at chunk position t = gi / rep; its q and out rows sit
// at base + t * stride_t + (gi % rep) * hs, and its global position is
// pos0 + t. Decode: one position (t = 0), rep rows. Prefill: T*rep rows.
struct Rows {
  int row0;
  int n_rows;
  int rep;
  long long stride_t;
  int pos0;
};

// T: the activations' type; C: the cache's (T, or int8 codes with the
// fp32 scale pools k_scale/v_scale, null otherwise).
template <typename T, typename C, int NT>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            const Rows r, const C* __restrict__ k,
                            const C* __restrict__ v,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ table, int n_max, int bs,
                            int nkv, int g, int hs, float scale) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  extern __shared__ float smem[];
  const int n_rows = r.n_rows;
  const int ks = hs + 1;
  float* q_s = smem;
  float* acc_s = q_s + (size_t)n_rows * hs;
  float* k_s = acc_s + (size_t)n_rows * hs;
  float* v_s = k_s + (size_t)kTile * ks;
  float* p_s = v_s + (size_t)kTile * hs;
  float* m_s = p_s + (size_t)n_rows * kTile;
  float* l_s = m_s + n_rows;
  float* a_s = l_s + n_rows;
  float* ks_s = a_s + n_rows;  // int8 cache: the tile's K and V scales
  float* vs_s = ks_s + kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int e = tid; e < n_rows * hs; e += NT) {
    const int i = e / hs, d = e - i * hs, gi = r.row0 + i;
    q_s[e] = to_f<T>(q[(gi / r.rep) * r.stride_t + (long long)(gi % r.rep) * hs + d]);
    acc_s[e] = 0.f;
  }
  for (int i = tid; i < n_rows; i += NT) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  // the last key any row of this CTA may see, within the table's capacity
  const int last_pos = r.pos0 + (r.row0 + n_rows - 1) / r.rep;
  const int n_keys = min(last_pos + 1, n_max * bs);
  __syncthreads();

  // K/V rows move as vectors of kVec elements (the wrapper checks hs % 8
  // == 0 and 16-byte aligned pools), kUnroll of them per thread in flight
  // before any is stored, so a tile's loads overlap instead of paying the
  // memory latency once per element
  using Vec = typename RowVec<C>::type;
  constexpr int kVec = RowVec<C>::n;
  constexpr int kUnroll = 4;
  const int vpr = hs / kVec;              // vectors per row
  const int nvec = kTile * vpr;           // vectors per tile (K or V)
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    const int nk = min(kTile, n_keys - k0);
    // gather the tile's K/V rows through the block table
    for (int base = 0; base < nvec; base += NT * kUnroll) {
      Vec kr[kUnroll], vr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = base + u * NT + tid;
        const int j = e / vpr;
        kr[u] = Vec{};
        vr[u] = Vec{};
        if (e < nvec && j < nk) {
          const int kp = k0 + j;
          const long long blk = table[kp / bs];
          const long long off = ((blk * bs + kp % bs) * nkv + g) * (long long)hs +
                                (long long)(e - j * vpr) * kVec;
          kr[u] = *reinterpret_cast<const Vec*>(k + off);
          vr[u] = *reinterpret_cast<const Vec*>(v + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = base + u * NT + tid;
        if (e < nvec) {
          const int j = e / vpr, d0 = (e - j * vpr) * kVec;
          float kf[kVec], vf[kVec];
          unpack<C>(kr[u], kf);
          unpack<C>(vr[u], vf);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            k_s[j * ks + d0 + i] = kf[i];
            v_s[j * hs + d0 + i] = vf[i];
          }
        }
      }
    }
    if constexpr (kQ8) {
      // one scale per (key row, kv head); 0 past the tile's last key
      for (int j = tid; j < kTile; j += NT) {
        float a = 0.f, b = 0.f;
        if (j < nk) {
          const int kp = k0 + j;
          const long long row = ((long long)table[kp / bs] * bs + kp % bs) * nkv + g;
          a = k_scale[row];
          b = v_scale[row];
        }
        ks_s[j] = a;
        vs_s[j] = b;
      }
    }
    __syncthreads();
    // scores, causal on each row's global position
    for (int e = tid; e < n_rows * kTile; e += NT) {
      const int i = e / kTile, j = e - i * kTile;
      const int qpos = r.pos0 + (r.row0 + i) / r.rep;
      float s = kNegInf;
      if (j < nk && k0 + j <= qpos) {
        const float* qr = q_s + (size_t)i * hs;
        const float* kr = k_s + (size_t)j * ks;
        float dot = 0.f;
        for (int d = 0; d < hs; ++d) dot = fmaf(qr[d], kr[d], dot);
        if constexpr (kQ8)
          s = dot * (ks_s[j] * scale);  // dequantize k, then softmax scale
        else
          s = dot * scale;
      }
      p_s[e] = s;
    }
    __syncthreads();
    // online softmax update, one warp per row
    for (int i = warp; i < n_rows; i += NT / 32) {
      float* pr = p_s + (size_t)i * kTile;
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = expf(pr[j] - m_new);
        sum += p;
        if constexpr (kQ8)
          pr[j] = round_to<T>(p * vs_s[j]);  // dequantize v into p
        else
          pr[j] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ V
    for (int e = tid; e < n_rows * hs; e += NT) {
      const int i = e / hs, d = e - i * hs;
      const float* pr = p_s + (size_t)i * kTile;
      float pv = 0.f;
      for (int j = 0; j < nk; ++j) pv = fmaf(pr[j], v_s[j * hs + d], pv);
      acc_s[e] = acc_s[e] * a_s[i] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < n_rows * hs; e += NT) {
    const int i = e / hs, d = e - i * hs, gi = r.row0 + i;
    out[(gi / r.rep) * r.stride_t + (long long)(gi % r.rep) * hs + d] =
        from_f<T>(acc_s[e] / fmaxf(l_s[i], 1e-30f));
  }
}

}  // namespace paged_attn
