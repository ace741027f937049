// The flash-attention kernels' own Hopper (sm_90a) pieces, beside the
// shared ones of sm90_common.cuh (mbarriers, TMA loads, descriptors, the
// wgmma products, `acc_to_frag`, the tensor-map encoding): the TMA load
// and map of the rows of one head of a BTNH tensor, exp2 on the
// special-function unit, and the row reductions of the softmax across the
// four threads that hold one accumulator row (these two serve the
// forward's online softmax). Used by the bf16 forward, dq and dkv kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu); the bf16 paged prefill
// (paged_prefill_attn.cu) uses the quad reductions.

#pragma once

#include "sm90_common.cuh"

namespace sm90 {

// Rows t0 .. t0 + R - 1 of head `head` of batch `b` (a 4-D map over
// (D, heads, time, batch) with a 64 x 1 x R x 1 box) into the R x C tile
// at `dst`, one box per 64-column sub-tile. Rows past the tensor's end
// arrive as zeros. Counted on `bar` (R * C * 2 bytes).
template <int C, int R>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int t0, int b) {
#pragma unroll
  for (int s = 0; s < C / 64; ++s) tma_load_4d(dst + s * R * 64, map, bar, s * 64, head, t0, b);
}

// 2^x on the special-function unit (one MUFU.EX2); results below 2^-126
// flush to zero, where exp2f would return subnormals
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The map of a bf16 (B, time, heads, C) tensor read through element
// strides st (time) and sb (batch), heads packed: dims (C, heads, time,
// batch), a 64 x 1 x R x 1 box, 128-byte swizzle, zeros past the ends.
// Returns false when the driver refuses it.
inline bool rows_map(CUtensorMap* map, const void* base, int C, int heads, int time, int batch,
                     long long st, long long sb, int R) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)heads, (cuuint64_t)time,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)R, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
