// grouped_mm_fwd: the ragged grouped matmul of a dropless MoE dispatch,
// y[r] = x_pad[r] @ W[tile_group[r / bm]] (times the row's fp32 gate in the
// scaled form, applied at the output write, then rounded once), with fp32
// accumulation over operands in their own dtype. Built and bound by
// ops/cuda_build.py; wrapped by ops/grouped_matmul.py.
//
// Replaces: `_fwd_kernel` :111 and `_fwd_kernel_scaled` :105 -> `_fwd_call`
// :148 (pallas_call :169) of distributed_pytorch_tpu/ops/grouped_matmul.py.
// The TPU's grid (token tiles, N tiles) with the tile's expert taken from a
// scalar-prefetched tile_group becomes one CTA per (128-row tile, 128
// output columns) that reads tile_group from device memory itself.
//
// Bound on the H100: operations — 2 P K N FLOP (80.5 GFLOP, 0.081 ms in
// bf16 for the flagship's fc product at P 25600, K 768, N 2048; 40.3 GFLOP
// for proj). The design's answer and its limits are in
// grouped_mm_common.cuh: mma.sync tensor-core products out of shared
// memory fed by double-buffered cp.async chunks.

#include "grouped_mm_common.cuh"

// dtype: 0 = float32, 1 = bfloat16, for x (P, K), w (E, K, N) and y (P, N),
// all contiguous; scale (P,) fp32 or null; tile_group (P / bm,) int32.
// K and N multiples of 8, bm a multiple of 128 dividing P. Returns the
// launch's cudaError_t (0 = success).
extern "C" int grouped_mm_fwd(int dtype, const void* x, const void* w, const float* scale,
                              const int* tile_group, void* y, int P, int K, int N, int E, int bm,
                              void* stream) {
  gmm::Params p{};
  p.a = x;
  p.b = w;
  p.scale = scale;
  p.tile_group = tile_group;
  p.out = y;
  p.P = P;
  p.K = K;
  p.N = N;
  p.E = E;
  p.bm = bm;
  return gmm::dispatch<gmm::FWD>(dtype, p, stream);
}
