// grouped_mm_bwd_dx / grouped_mm_bwd_dw: the gradients of grouped_mm_fwd
// with respect to the packed rows and the expert weights,
//   dx[r] = (dy[r] * gate[r]) @ W[tile_group[r / bm]]^T   (P, K), dy's dtype
//   dW[e] = sum over e's rows r of x_pad[r]^T (dy[r] * gate[r])  (E, K, N), fp32
// where dy * gate is rounded to the operand dtype before the product, as
// the reference rounds it (gate = 1 in the unscaled form). Built and bound
// by ops/cuda_build.py; wrapped by ops/grouped_matmul.py.
//
// Replaces: `_dx_kernel` :122 / `_dx_kernel_scaled` :116 -> `_dx_call` :178
// (pallas_call :199), and `_dw_kernel` :127 -> `_dw_call_impl` :208
// (pallas_call :231) of distributed_pytorch_tpu/ops/grouped_matmul.py.
// dx runs token-major as on the TPU: one CTA per (128-row tile, 128
// columns of K). The TPU's dW sums over a sequential token-tile grid axis,
// resetting its VMEM block at each expert's first tile; here one CTA per
// (expert, 128 x 128 block of dW) loops over that expert's own rows and
// writes its fp32 sum once — no atomics, deterministic, and zeros for an
// expert with no rows (the reference masks those after the call).
// Trailing tiles past the last expert's rows are never visited: they hold
// gate-0 rows (proj) or zero dy rows (fc), which add nothing.
//
// Bound on the H100: operations — 2 P K N FLOP each (80.5 / 40.3 GFLOP,
// 0.081 / 0.041 ms in bf16 for the flagship's fc / proj); design and limits
// in grouped_mm_common.cuh.

#include "grouped_mm_common.cuh"

// dtype: 0 = float32, 1 = bfloat16, for dy (P, N), w (E, K, N) and dx
// (P, K), all contiguous; scale (P,) fp32 or null; tile_group (P / bm,)
// int32. Returns the launch's cudaError_t (0 = success).
extern "C" int grouped_mm_bwd_dx(int dtype, const void* dy, const void* w, const float* scale,
                                 const int* tile_group, void* dx, int P, int K, int N, int E,
                                 int bm, void* stream) {
  gmm::Params p{};
  p.a = dy;
  p.b = w;
  p.scale = scale;
  p.tile_group = tile_group;
  p.out = dx;
  p.P = P;
  p.K = K;
  p.N = N;
  p.E = E;
  p.bm = bm;
  return gmm::dispatch<gmm::DX>(dtype, p, stream);
}

// dtype as above for x (P, K) and dy (P, N); scale (P,) fp32 or null;
// counts and gstart (E,) int32: each expert's rows and its first padded
// row (a multiple of bm); dw (E, K, N) fp32. Returns the launch's
// cudaError_t (0 = success).
extern "C" int grouped_mm_bwd_dw(int dtype, const void* x, const void* dy, const float* scale,
                                 const int* counts, const int* gstart, float* dw, int P, int K,
                                 int N, int E, int bm, void* stream) {
  gmm::Params p{};
  p.a = x;
  p.b = dy;
  p.scale = scale;
  p.counts = counts;
  p.gstart = gstart;
  p.out = dw;
  p.P = P;
  p.K = K;
  p.N = N;
  p.E = E;
  p.bm = bm;
  return gmm::dispatch<gmm::DW>(dtype, p, stream);
}
