// fused_ce_fwd: per-token cross-entropy of the weight-tied lm head without
// logits in device memory — nll = lse - s[target] and lse = logsumexp(s)
// over s = x W^T (fp32 from fp32 or bf16 operands). Built and bound by
// ops/cuda_build.py; wrapped by ops/fused_ce.py.
//
// Replaces: `_fwd_kernel` :84 -> `_fwd` :112 (pallas_call :115) of
// distributed_pytorch_tpu/ops/fused_ce.py. The TPU kernel carries the
// running max m, normaliser l and target logit across its sequential
// vocab grid axis in VMEM scratch; here one CTA owns 64 token rows (32 in
// fp32) and walks every 64-row vocab tile (32 in fp32) in an inner loop,
// keeping m, l and the target logit in registers.
//
// Bound on the H100: operations — 2 n V C FLOP (633 GFLOP, 0.64 ms in bf16
// at n 8192, C 768, V 50304) against ~90 MB of x and W. The design's
// answer and its limits are in fused_ce_common.cuh: mma.sync tensor-core
// products out of shared memory, W shared between concurrent CTAs through
// L2, no overlap yet between a W tile's load and the products.
//
// Arithmetic as the reference: columns >= V masked to -1e30 before the
// max, l = l * exp(m_old - m_new) + sum exp(s - m_new) per vocab tile,
// lse = m + log(max(l, 1e-30)), nll = lse - s[t] (a target outside
// [0, V), as the -2 of an ignored row, contributes 0).

#include "fused_ce_common.cuh"

// dtype: 0 = float32, 1 = bfloat16, for both x (n, C) and w (V, C), both
// contiguous; t (n,) int32; nll and lse (n,) fp32. C a multiple of 128. Returns the launch's cudaError_t (0 = success).
extern "C" int fused_ce_fwd(int dtype, const void* x, const void* w, const int* t, float* nll,
                            float* lse, int n, int V, int C, void* stream) {
  fce::Params p{};
  p.x = x;
  p.w = w;
  p.t = t;
  p.nll = nll;
  p.lse_out = lse;
  p.n = n;
  p.V = V;
  p.C = C;
  return fce::dispatch<fce::FWD>(dtype, p, stream);
}
