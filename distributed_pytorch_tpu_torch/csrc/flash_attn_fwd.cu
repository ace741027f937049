// flash_attn_fwd: online-softmax attention over BTNH tensors (sm_90a, fp32
// and bf16, head size 64 or 128), returning out and the fp32 logsumexp of
// the scaled scores. Causal or full; GQA reads kv head h / (nh / nkv);
// attention-weight dropout from a counter hash. Built and bound by
// ops/cuda_build.py; wrapped by ops/flash_attention.py.
//
// Replaces: `_fwd_kernel` -> `_fwd` (rows face) and `_slab_fwd_kernel` ->
// `_slab_fwd` (slab face) of distributed_pytorch_tpu/ops/flash_attention.py.
// Both compute the same function; this kernel reads the model's (B, T, N, H)
// layout through row strides, so it needs neither the rows face's
// transposes nor the slab face's in-VMEM relayout.
//
// Bound on the H100: at the training shape (B 8, T 1024, 12 heads x 64,
// causal) the call does ~12.9 GFLOP on ~50 MB, so operations bound it
// (~0.013 ms at the bf16 tensor-core peak). This kernel runs its products
// as FMA loops on CUDA cores out of shared memory, so it is bound by FMA
// and shared-memory issue, far above that; mma.sync/wgmma is the later step.
//
// Design: one CTA per (64-row query tile, head, batch). The tile's queries
// stay in shared memory; the CTA walks 64-key tiles up to the causal
// frontier of its last row (keys past it are never read), computing
// S = Q K^T with each thread holding a 4 x 4 block, the running max and
// normalizer per row (half-warp shuffles), then P V into a 4 x D/16 block
// of fp32 accumulators. Arithmetic as the TPU kernel (flash_attention.py
// `_fwd_tile`): scores q.k * scale in fp32, masked scores -1e30, the
// normalizer sums the undropped p, the dropout mask multiplies p after the
// normalizer update, p is rounded to the value dtype before P V, and
// lse = m + log(max(l, 1e-30)).

#include "flash_attn_common.cuh"

namespace {

using flash::Params;

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * (flash::kBQ + flash::kPad) +
                          flash::kBK * (D + flash::kPad) +
                          flash::kBK * (flash::kBQ + flash::kPad));
}

template <typename T, int D>
__global__ void __launch_bounds__(flash::kThreads) fwd_kernel(const Params p) {
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
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * D;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + (long long)g * D;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + (long long)g * D;
  uint32_t s0 = 0, s1 = 0;
  if (p.dropout) {
    s0 = (uint32_t)p.seed[0];
    s1 = (uint32_t)p.seed[1];
  }
  const uint32_t row = (uint32_t)(b * p.nh + h);

  load_tile<T, D, kBQ, true>(Qt, LD, q + i0 * p.q_st, p.q_st, min(kBQ, p.T - i0));

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
    load_tile<T, D, kBK, true>(Kt, LD, k + k0 * p.k_st, p.k_st, nk);
    load_tile<T, D, kBK, false>(Vs, LDV, v + k0 * p.v_st, p.v_st, nk);
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
  T* out = static_cast<T*>(p.out0) + (long long)b * p.T * p.nh * D + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = i0 + ty * 4 + i;
    if (qp >= p.T) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = out + (long long)qp * p.nh * D + tx * RN;
#pragma unroll
    for (int j = 0; j < RN; ++j) orow[j] = from_f<T>(o[i][j] / ls);
    if (tx == 0) lse[qp] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const Params& p, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = fwd_smem<D>();
  const int err = flash::set_smem(fwd_kernel<T, D>, smem, cap);
  if (err) return err;
  if (p.T == 0 || p.B == 0 || p.nh == 0) return 0;
  const dim3 grid((p.T + flash::kBQ - 1) / flash::kBQ, p.nh, p.B);
  fwd_kernel<T, D><<<grid, flash::kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128. out (B, T, nh, D) and
// lse (B, nh, T) fp32, both contiguous. dims and strides as in
// flash::make_params. Returns the launch's cudaError_t (0 = success).
extern "C" int flash_attn_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                              void* out, float* lse, const int* seed, const int* dims,
                              const long long* strides, float scale, unsigned thresh,
                              float keep_scale, void* stream) {
  const Params p = flash::make_params(q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse,
                                      seed, dims, strides, scale, thresh, keep_scale);
  if (dtype == 0 && D == 64) return launch<float, 64>(p, stream);
  if (dtype == 0 && D == 128) return launch<float, 128>(p, stream);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(p, stream);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(p, stream);
  return (int)cudaErrorInvalidValue;
}
