// fused_ce_bwd_dx / fused_ce_bwd_dw: the gradients of the per-token
// cross-entropy of fused_ce_fwd.cu with respect to x and W, recomputing
// the scores from the saved lse instead of reading stored logits:
//   dlogits = (exp(s - lse) - onehot(t)) * coef, rounded to the operand dtype,
//   dx = dlogits W, dW = dlogits^T x, both accumulated in fp32.
// Built and bound by ops/cuda_build.py; wrapped by ops/fused_ce.py.
//
// Replaces: `_bwd_dx_kernel` :153 and `_bwd_dw_kernel` :171 -> `_bwd`
// :190 (pallas_calls :193 and :210) of distributed_pytorch_tpu/ops/fused_ce.py.
// As on the TPU, dx runs token-major (each CTA owns token rows and walks
// every vocab tile) and dW vocab-major (each CTA owns vocab rows and walks
// every token tile, the reference's transposed grid), so each CTA owns its
// output rows: no atomics, deterministic sums.
//
// Bound on the H100: operations — each kernel recomputes the 2 n V C score
// FLOP and does as many again for its product: 1.27 TFLOP (1.28 ms in bf16
// at n 8192, C 768, V 50304).
//
// The dtype and C pick the kernel before launch (never as a fallback; a
// launch that fails returns its error and the wrapper raises):
// * bf16 with C <= 1024 (`ce_kernel_sm90<MODE>`, fused_ce_sm90.cuh):
//   wgmma on a TMA ring fed by a producer warp, 64 resident rows and two
//   consumer warpgroups a CTA, dlogits through one bf16 shared tile, never
//   device memory.
// * bf16 with C > 1024, where the resident tile and the ring do not fit in
//   shared memory together, and fp32 (tensor cores take fp32 only as TF32):
//   `ce_kernel<T, MODE>` (fused_ce_common.cuh), 32 resident rows a CTA,
//   mma.sync (bf16) or FMA loops (fp32), C streamed in chunks of at most
//   768 columns.
// `fused_ce_bwd_plan` names the kernel each shape takes.

#include "fused_ce_sm90.cuh"

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

bool takes_sm90(int dtype, const fce::Params& p) {
  return dtype == 1 && fce::s90::takes(fce::DX, p);
}

template <int MODE>
int bwd(int dtype, const fce::Params& p, void* stream) {
  if (takes_sm90(dtype, p)) return fce::s90::launch<MODE>(p, stream);
  return fce::dispatch<MODE>(dtype, p, stream);
}

}  // namespace

// The kernel fused_ce_bwd_dx and fused_ce_bwd_dw launch for n tokens of
// width C over V vocab rows: 2 = ce_kernel_sm90, with its ring stages
// and output-column blocks (grid.y) in *stages and *ny; 1 = ce_kernel on
// mma.sync (bf16); 0 = ce_kernel on FMA loops (fp32). *stages and *ny
// are 0 but for 2.
extern "C" int fused_ce_bwd_plan(int dtype, int n, int V, int C, int* stages, int* ny) {
  const fce::Params p = bwd_params(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n, V, C);
  const fce::s90::Plan pl = takes_sm90(dtype, p) ? fce::s90::plan(fce::DX, C) : fce::s90::Plan{0, 0, 0};
  *stages = pl.stages;
  *ny = pl.ny;
  return pl.stages > 0 ? 2 : dtype == 1 ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16, for x (n, C), w (V, C) and the output,
// all contiguous and 16-byte aligned; t (n,) int32; lse and coef (n,) fp32.
// dx is (n, C), dw (V, C). C a multiple of 128. Return the launch's
// cudaError_t (0 = success).
extern "C" int fused_ce_bwd_dx(int dtype, const void* x, const void* w, const int* t,
                               const float* lse, const float* coef, void* dx, int n, int V, int C,
                               void* stream) {
  return bwd<fce::DX>(dtype, bwd_params(x, w, t, lse, coef, dx, n, V, C), stream);
}

extern "C" int fused_ce_bwd_dw(int dtype, const void* x, const void* w, const int* t,
                               const float* lse, const float* coef, void* dw, int n, int V, int C,
                               void* stream) {
  return bwd<fce::DW>(dtype, bwd_params(x, w, t, lse, coef, dw, n, V, C), stream);
}
