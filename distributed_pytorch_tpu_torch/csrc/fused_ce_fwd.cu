// fused_ce_fwd: per-token cross-entropy of the weight-tied lm head without
// logits in device memory — nll = lse - s[target] and lse = logsumexp(s)
// over s = x W^T (fp32 from fp32 or bf16 operands). Built and bound by
// ops/cuda_build.py; wrapped by ops/fused_ce.py.
//
// Replaces: `_fwd_kernel` :84 -> `_fwd` :112 (pallas_call :115) of
// distributed_pytorch_tpu/ops/fused_ce.py. The TPU kernel carries the
// running max m, normaliser l and target logit across its sequential
// vocab grid axis in VMEM scratch; here one CTA owns 64 token rows (32 in
// fp32) and walks every vocab tile in an inner loop, keeping m, l and the
// target logit in registers.
//
// Bound on the H100: operations — 2 n V C FLOP (633 GFLOP, 0.64 ms in bf16
// at n 8192, C 768, V 50304) against ~90 MB of x and W.
//
// The dtype and C pick the kernel before launch (never as a fallback; a
// launch that fails returns its error and the wrapper raises):
// * bf16 with C <= 1024 (`ce_kernel_sm90<FWD>`, fused_ce_sm90.cuh): 64
//   resident token rows loaded once by TMA, a producer warp streaming
//   128-row W tiles through a TMA ring (8 stages at C 768), two consumer
//   warpgroups forming the score tile with wgmma, each folding one tile
//   into its running softmax while the next tile's products run.
// * bf16 with C > 1024, where the resident tile and the ring do not fit in
//   shared memory together, and fp32 (tensor cores take fp32 only as TF32):
//   `ce_kernel<T, FWD>` (fused_ce_common.cuh), mma.sync (bf16) or FMA
//   loops (fp32) on cp.async-loaded tiles, C in chunks of at most 768.
// `fused_ce_fwd_plan` names the kernel each shape takes.
//
// Arithmetic as the reference: columns >= V masked to -1e30 before the
// max, l = l * exp(m_old - m_new) + sum exp(s - m_new) per vocab tile,
// lse = m + log(max(l, 1e-30)), nll = lse - s[t] (a target outside
// [0, V), as the -2 of an ignored row, contributes 0).

#include "fused_ce_sm90.cuh"

namespace {

fce::Params fwd_params(const void* x, const void* w, const int* t, float* nll, float* lse, int n,
                       int V, int C) {
  fce::Params p{};
  p.x = x;
  p.w = w;
  p.t = t;
  p.nll = nll;
  p.lse_out = lse;
  p.n = n;
  p.V = V;
  p.C = C;
  return p;
}

bool takes_sm90(int dtype, const fce::Params& p) {
  return dtype == 1 && fce::s90::takes(fce::FWD, p);
}

}  // namespace

// The kernel fused_ce_fwd launches for n tokens of width C over V vocab
// rows: 2 = ce_kernel_sm90<FWD>, with its ring stages in *stages; 1 =
// ce_kernel on mma.sync (bf16); 0 = ce_kernel on FMA loops (fp32).
// *stages is 0 but for 2.
extern "C" int fused_ce_fwd_plan(int dtype, int n, int V, int C, int* stages) {
  const fce::Params p = fwd_params(nullptr, nullptr, nullptr, nullptr, nullptr, n, V, C);
  *stages = takes_sm90(dtype, p) ? fce::s90::plan(fce::FWD, C).stages : 0;
  return *stages > 0 ? 2 : dtype == 1 ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16, for both x (n, C) and w (V, C), both
// contiguous and 16-byte aligned; t (n,) int32; nll and lse (n,) fp32. C a
// multiple of 128. Returns the launch's cudaError_t (0 = success).
extern "C" int fused_ce_fwd(int dtype, const void* x, const void* w, const int* t, float* nll,
                            float* lse, int n, int V, int C, void* stream) {
  const fce::Params p = fwd_params(x, w, t, nll, lse, n, V, C);
  if (takes_sm90(dtype, p)) return fce::s90::launch<fce::FWD>(p, stream);
  return fce::dispatch<fce::FWD>(dtype, p, stream);
}
