// flash_attn_bwd_dq / flash_attn_bwd_dkv: the FlashAttention-2 backward of
// flash_attn_fwd.cu over BTNH tensors (sm_90a, fp32 and bf16, head size 64
// or 128). Both recompute p = exp(s - lse) from the forward's logsumexp
// instead of storing probabilities; delta = rowsum(dout * out) - dlse comes
// in precomputed (fp32, (B, nh, T)), which is how a gradient flowing into
// lse folds in. Built and bound by ops/cuda_build.py; wrapped by
// ops/flash_attention.py.
//
// Replaces: `_bwd_dq_kernel` and `_bwd_dkv_kernel` -> `_bwd_impl` (rows
// face) and `_slab_bwd_dq_kernel` / `_slab_bwd_dkv_kernel` -> `_slab_bwd`
// (slab face) of distributed_pytorch_tpu/ops/flash_attention.py.
//
// Bound on the H100: at the training shape (B 8, T 1024, 12 heads x 64,
// causal) dq does 3 and dkv 4 products of the forward's ~6.4 GFLOP each,
// so operations bound both (~0.020 and ~0.026 ms at the bf16 peak). These
// kernels run FMA loops out of shared memory, as the forward does.
//
// Design, two kernels and no atomics (deterministic):
// * dq: one CTA per (64-row query tile, head, batch), walking key tiles up
//   to the causal frontier: S = Q K^T and dP = dO V^T (4 x 4 per thread),
//   dS = p * (dP * mask - delta) rounded to the key dtype, dQ += dS K.
//   dq carries * scale at the write.
// * dkv: one CTA per (64-key tile, kv head, batch), looping over the rep
//   query heads of its GQA group and over the query tiles from the causal
//   frontier on: S^T = K Q^T and dP^T = V dO^T, then dV += (p * mask)^T dO
//   and dK += dS^T Q, so the group sum happens in the CTA's fp32
//   registers and each key row is written once. The dropout mask is
//   regenerated from the forward's coordinates (row b*nh + h, query
//   position, key position), not from this kernel's loop order. Head size
//   128 uses 32-row query tiles to fit shared memory.

#include "flash_attn_common.cuh"

namespace {

using flash::Params;

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * (flash::kBQ + flash::kPad) +
                          flash::kBK * (D + flash::kPad) +
                          flash::kBK * (flash::kBQ + flash::kPad));
}

template <typename T, int D>
__global__ void __launch_bounds__(flash::kThreads) dq_kernel(const Params p) {
  using namespace flash;
  constexpr int LD = kBQ + kPad;
  constexpr int LDV = D + kPad;
  constexpr int RN = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;                  // [D][LD]
  float* dOt = Qt + D * LD;        // [D][LD]
  float* Kt = dOt + D * LD;        // [D][LD]
  float* Vt = Kt + D * LD;         // [D][LD]
  float* Ks = Vt + D * LD;         // [kBK][LDV]
  float* dSt = Ks + kBK * LDV;     // [kBK][LD] dS transposed (key-major)

  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.nh / p.nkv);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * D;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + (long long)h * D;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + (long long)g * D;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + (long long)g * D;
  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const uint32_t row = (uint32_t)(b * p.nh + h);
  const long long stat = (long long)(b * p.nh + h) * p.T;

  const int nq = min(kBQ, p.T - i0);
  load_tile<T, D, kBQ, true>(Qt, LD, q + i0 * p.q_st, p.q_st, nq);
  load_tile<T, D, kBQ, true>(dOt, LD, dout + i0 * p.do_st, p.do_st, nq);
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
    __syncthreads();
    load_tile<T, D, kBK, true>(Kt, LD, k + k0 * p.k_st, p.k_st, nk);
    load_tile<T, D, kBK, true>(Vt, LD, v + k0 * p.v_st, p.v_st, nk);
    load_tile<T, D, kBK, false>(Ks, LDV, k + k0 * p.k_st, p.k_st, nk);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mma_tile<4, D>(s, Qt, LD, Kt, LD, ty, tx);
    mma_tile<4, D>(dp, dOt, LD, Vt, LD, ty, tx);
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
    store_t<4>(dSt, LD, s, ty, tx);
    __syncthreads();
    mma_tile<RN, kBK>(dq, dSt, LD, Ks, LDV, ty, tx);
  }

  T* out = static_cast<T*>(p.out0) + (long long)b * p.T * p.nh * D + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = i0 + ty * 4 + i;
    if (qp >= p.T) continue;
    T* orow = out + (long long)qp * p.nh * D + tx * RN;
#pragma unroll
    for (int j = 0; j < RN; ++j) orow[j] = from_f<T>(dq[i][j] * p.scale);
  }
}

template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D == 64 ? 64 : 32;  // query rows per dkv tile
}

template <int D>
constexpr size_t dkv_smem() {
  constexpr int BQ = dkv_bq<D>();
  return sizeof(float) * (2 * D * (flash::kBK + flash::kPad) + 2 * D * (BQ + flash::kPad) +
                          2 * BQ * (D + flash::kPad) + 2 * BQ * (flash::kBK + flash::kPad) +
                          2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(flash::kThreads) dkv_kernel(const Params p) {
  using namespace flash;
  constexpr int BQ = dkv_bq<D>();
  constexpr int RNQ = BQ / 16;    // query columns per thread in S^T, dP^T
  constexpr int LDK = kBK + kPad;
  constexpr int LDQ = BQ + kPad;
  constexpr int LDV = D + kPad;
  constexpr int RN = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;                  // [D][LDK]
  float* Vt = Kt + D * LDK;        // [D][LDK]
  float* Qt = Vt + D * LDK;        // [D][LDQ]
  float* dOt = Qt + D * LDQ;       // [D][LDQ]
  float* Qs = dOt + D * LDQ;       // [BQ][LDV]
  float* dOs = Qs + BQ * LDV;      // [BQ][LDV]
  float* Ps = dOs + BQ * LDV;      // [BQ][LDK] (p * mask), query-major
  float* dSs = Ps + BQ * LDK;      // [BQ][LDK] dS, query-major
  float* lse_s = dSs + BQ * LDK;   // [BQ]
  float* dl_s = lse_s + BQ;        // [BQ]

  const int j0 = blockIdx.x * kBK, g = blockIdx.y, b = blockIdx.z;
  const int rep = p.nh / p.nkv;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + (long long)g * D;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + (long long)g * D;
  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const int nk = min(kBK, p.S - j0);
  load_tile<T, D, kBK, true>(Kt, LDK, k + j0 * p.k_st, p.k_st, nk);
  load_tile<T, D, kBK, true>(Vt, LDK, v + j0 * p.v_st, p.v_st, nk);

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
    const uint32_t row = (uint32_t)(b * p.nh + h);
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * D;
    const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + (long long)h * D;
    const long long stat = (long long)(b * p.nh + h) * p.T;
    for (int i0 = t_begin; i0 < p.T; i0 += BQ) {
      const int nq = min(BQ, p.T - i0);
      __syncthreads();
      load_tile<T, D, BQ, true>(Qt, LDQ, q + i0 * p.q_st, p.q_st, nq);
      load_tile<T, D, BQ, false>(Qs, LDV, q + i0 * p.q_st, p.q_st, nq);
      load_tile<T, D, BQ, true>(dOt, LDQ, dout + i0 * p.do_st, p.do_st, nq);
      load_tile<T, D, BQ, false>(dOs, LDV, dout + i0 * p.do_st, p.do_st, nq);
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
      store_t<RNQ>(Ps, LDK, pd, ty, tx);
      store_t<RNQ>(dSs, LDK, st, ty, tx);
      __syncthreads();
      mma_tile<RN, BQ>(dv, Ps, LDK, dOs, LDV, ty, tx);
      mma_tile<RN, BQ>(dk, dSs, LDK, Qs, LDV, ty, tx);
    }
  }

  const long long base = (long long)b * p.S * p.nkv * D + (long long)g * D;
  T* dk_out = static_cast<T*>(p.out0) + base;
  T* dv_out = static_cast<T*>(p.out1) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = j0 + ty * 4 + i;
    if (kp >= p.S) continue;
    const long long off = (long long)kp * p.nkv * D + tx * RN;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      dk_out[off + j] = from_f<T>(dk[i][j] * p.scale);
      dv_out[off + j] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
int launch_dq(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = dq_smem<D>();
  const int err = flash::set_smem(dq_kernel<T, D>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  const dim3 grid((p.T + flash::kBQ - 1) / flash::kBQ, p.nh, p.B);
  dq_kernel<T, D><<<grid, flash::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = dkv_smem<D>();
  const int err = flash::set_smem(dkv_kernel<T, D>, smem, cap);
  if (err) return err;
  if (p.S == 0 || p.B == 0 || p.nkv == 0) return 0;
  const dim3 grid((p.S + flash::kBK - 1) / flash::kBK, p.nkv, p.B);
  dkv_kernel<T, D><<<grid, flash::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128. lse and delta (B, nh, T)
// fp32; dq (B, T, nh, D) contiguous. Returns the launch's cudaError_t.
extern "C" int flash_attn_bwd_dq(int dtype, int D, const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dq, const int* seed, const int* dims,
                                 const long long* strides, float scale, unsigned thresh,
                                 float keep_scale, void* stream) {
  const Params p = flash::make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, seed,
                                      dims, strides, scale, thresh, keep_scale);
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(p, stream);
  if (dtype == 0 && D == 128) return launch_dq<float, 128>(p, stream);
  if (dtype == 1 && D == 64) return launch_dq<__nv_bfloat16, 64>(p, stream);
  if (dtype == 1 && D == 128) return launch_dq<__nv_bfloat16, 128>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// As flash_attn_bwd_dq; dk and dv (B, S, nkv, D) contiguous.
extern "C" int flash_attn_bwd_dkv(int dtype, int D, const void* q, const void* k,
                                  const void* v, const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv, const int* seed,
                                  const int* dims, const long long* strides, float scale,
                                  unsigned thresh, float keep_scale, void* stream) {
  const Params p = flash::make_params(q, k, v, dout, lse, delta, dk, dv, nullptr, seed, dims,
                                      strides, scale, thresh, keep_scale);
  if (dtype == 0 && D == 64) return launch_dkv<float, 64>(p, stream);
  if (dtype == 0 && D == 128) return launch_dkv<float, 128>(p, stream);
  if (dtype == 1 && D == 64) return launch_dkv<__nv_bfloat16, 64>(p, stream);
  if (dtype == 1 && D == 128) return launch_dkv<__nv_bfloat16, 128>(p, stream);
  return (int)cudaErrorInvalidValue;
}
