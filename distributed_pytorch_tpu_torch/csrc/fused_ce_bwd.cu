// fused_ce_bwd_dx / fused_ce_bwd_dw: the gradients of the per-token
// cross-entropy of fused_ce_fwd.cu with respect to x and W, recomputing
// the scores from the saved lse instead of reading stored logits:
//   dlogits = (exp(s - lse) - onehot(t)) * coef, rounded to the operand dtype,
//   dx = dlogits W, dW = dlogits^T x, both accumulated in fp32.
// Built and bound by ops/cuda_build.py; wrapped by ops/fused_ce.py.
//
// Replaces: `_bwd_dx_kernel` :153 and `_bwd_dw_kernel` :171 -> `_bwd`
// :190 (pallas_calls :193 and :210) of distributed_pytorch_tpu/ops/fused_ce.py.
// As on the TPU, dx runs token-major (one CTA per 32 token rows walking
// every vocab tile) and dW vocab-major (one CTA per 32 vocab rows walking
// every token tile, the reference's transposed grid), so each CTA owns its
// output rows: no atomics, deterministic sums.
//
// Bound on the H100: operations — each kernel recomputes the 2 n V C score
// FLOP and does as many again for its product: 1.27 TFLOP (1.28 ms in bf16
// at n 8192, C 768, V 50304). The fp32 accumulator, 32 rows by one chunk
// of at most 768 columns (one CTA per chunk, grid.y), lives in registers
// for the CTA's whole walk (the TPU kept it in VMEM scratch); design and
// limits in fused_ce_common.cuh.

#include "fused_ce_common.cuh"

namespace {

fce::Params bwd_params(const void* x, const void* w, const int* t, const float* lse,
                       const float* coef, void* out, int n, int V, int C) {
  fce::Params p{};
  p.x = x;
  p.w = w;
  p.t = t;
  p.lse_in = lse;
  p.coef = coef;
  p.out = out;
  p.n = n;
  p.V = V;
  p.C = C;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x (n, C), w (V, C) and the output,
// all contiguous; t (n,) int32; lse and coef (n,) fp32. dx is (n, C), dw
// (V, C). C a multiple of 128. Return the launch's
// cudaError_t (0 = success).
extern "C" int fused_ce_bwd_dx(int dtype, const void* x, const void* w, const int* t,
                               const float* lse, const float* coef, void* dx, int n, int V, int C,
                               void* stream) {
  return fce::dispatch<fce::DX>(dtype, bwd_params(x, w, t, lse, coef, dx, n, V, C), stream);
}

extern "C" int fused_ce_bwd_dw(int dtype, const void* x, const void* w, const int* t,
                               const float* lse, const float* coef, void* dw, int n, int V, int C,
                               void* stream) {
  return fce::dispatch<fce::DW>(dtype, bwd_params(x, w, t, lse, coef, dw, n, V, C), stream);
}
