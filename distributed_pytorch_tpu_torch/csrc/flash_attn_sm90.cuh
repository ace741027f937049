// The flash-attention kernels' own Hopper (sm_90a) pieces, beside the
// shared ones of sm90_common.cuh (mbarriers, TMA loads, descriptors, the
// wgmma products, `acc_to_frag`, the tensor-map encoding): the TMA load
// and map of the rows of one head of a BTNH tensor, exp2 on the
// special-function unit, and the row reductions of the softmax across the
// four threads that hold one accumulator row (these two serve the
// forward's online softmax). Used by the bf16 forward, dq and dkv kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu); the bf16 paged prefill
// (paged_prefill_attn.cu) uses the quad reductions and the width pieces
// below. Also the layouts of tiles of widths 32 and 80 (below) and the
// pieces that read a tile of any built width: its maps (`RowMap`,
// `width_map`), loads (`tma_rows`), K-major k-steps (`kdesc`), MN-major
// products (`wgmma_rs_mn`), and where a tile gathered with cp.async puts
// each 16-byte chunk (`chunk_at`).

#pragma once

#include <type_traits>

#include "sm90_common.cuh"

namespace sm90 {

// ---- width 32 --------------------------------------------------------------
//
// Head sizes 8-32 (the default config's 256 / 8 heads) run the bf16
// forward, dq and dkv at width 32: a row of 32 bf16 is 64 bytes, so a
// tile is one R x 32 box at the 64-byte swizzle (one `CUtensorMap` with a
// 32-column box): 16-byte chunk c of row r sits at position c ^ ((r / 2)
// % 4) of the row (`chunk_at`). K-major reads take k-steps 0 and 1 of it,
// 32 bytes apart; an MN-major product (N the head size) is one m64n32k16
// into 16 accumulator registers a thread, in the layout of
// sm90_common.cuh. The bf16 forward, dq and dkv at width 32 (`flash_pipe`,
// flash_attn_fwd.cu and flash_attn_bwd.cu) and the bf16 paged prefill at
// head size 32 (its tiles gathered with cp.async, paged_prefill_attn.cu)
// read their tiles so; the 64-wide instances these head sizes ran on
// before read 4 k-steps (2 of zeros) and took products at N 64 (32
// columns of zeros).

// ---- width 80 --------------------------------------------------------------
//
// Head size 80 (the flagship's 64 + MLA's rotary 16) is built at width 80:
// its tiles hold exactly 80 columns. The 128-byte swizzle spans 64 bf16
// columns, so a row of 80 is not one box at it. Columns 0-63 form one
// 128-byte-swizzled R x 64 sub-tile (as at the widths that are multiples
// of 64), columns 64-79 an R x 16 sub-tile at the 32-byte swizzle right
// after it (R * 64 elements in). K-major reads take k-steps 0-3 from the
// first and k-step 4 from the second; an MN-major product (N the head
// size) is m64n64k16 + m64n16k16 into the first 32 and the last 8
// accumulator registers a thread. The accumulator of a 64 x 80 result is
// thus 40 registers a thread in the layout of sm90_common.cuh (registers
// 4 j .. 4 j + 3: columns 8 j .. 8 j + 7), so the code around the products
// is the same as at 64 or 128.
// The other layout tried, five R x 16 sub-tiles at the 32-byte swizzle with
// each MN-major product one m64n80k16, was slower on the H100 (forward
// 0.0941 against 0.0818 ms, dkv 0.1946 against 0.1876 at B 8, T 1024, 12
// heads; bench/flash_ab.py, PERF.md): it issues five TMA boxes of 32-byte
// rows a tile for two, and reads every k-step at the 32-byte swizzle.

// The TMA maps of one operand at width 80: 64-column boxes at the 128-byte
// swizzle (columns 0-63) and 16-column boxes at the 32-byte swizzle
// (columns 64-79)
struct Map80 {
  CUtensorMap box64, box16;
};

// the maps of one operand at built width D
template <int D>
using RowMap = std::conditional_t<D == 80, Map80, CUtensorMap>;

// Rows t0 .. t0 + R - 1 of head `head` of batch `b` (a 4-D map over
// (D, heads, time, batch) with a 64 x 1 x R x 1 box, 32 x 1 x R x 1 at
// width 32) into the R x C tile at `dst`, one box per 64-column sub-tile
// (at width 32 the one 32-column box). Rows past the tensor's end arrive
// as zeros. Counted on `bar` (R * C * 2 bytes).
template <int C, int R>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int t0, int b) {
  static_assert(C == 32 || C % 64 == 0, "tiles are 32 or a multiple of 64 columns wide");
  if constexpr (C == 32) {
    tma_load_4d(dst, map, bar, 0, head, t0, b);
  } else {
#pragma unroll
    for (int s = 0; s < C / 64; ++s) tma_load_4d(dst + s * R * 64, map, bar, s * 64, head, t0, b);
  }
}

// The same at width 80 (R * 160 bytes on `bar`)
template <int C, int R>
__device__ __forceinline__ void tma_rows(bf16* dst, const Map80* map, uint64_t* bar, int head,
                                         int t0, int b) {
  static_assert(C == 80, "Map80 holds the maps of width 80");
  tma_load_4d(dst, &map->box64, bar, 0, head, t0, b);
  tma_load_4d(dst + R * 64, &map->box16, bar, 64, head, t0, b);
}

// k-step kk of an R-row tile of width D read K-major (kk a constant once
// the k-step loop is unrolled, so the choice of sub-tile folds away)
template <int D, int R>
__device__ __forceinline__ uint64_t kdesc(const bf16* tile, int kk) {
  if constexpr (D == 32)
    return desc_kmajor_sw<64>(tile, kk);
  else if constexpr (D == 80)
    return kk < 4 ? desc_kmajor_sw<128>(tile, kk) : desc_kmajor_sw<32>(tile + R * 64, 0);
  else
    return desc_kmajor<R>(tile, kk);
}

// d (64 x D) += A B over k-step kk, A from registers, B an R-row tile of
// width D read MN-major (its rows the contraction, its columns N)
template <int D, int R>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[D / 2], const uint32_t (&a)[4],
                                            const bf16* tile, int kk) {
  if constexpr (D == 32) {
    wgmma_rs<32, 1>(d, a, desc_mnmajor_sw<R, 64>(tile, kk));
  } else if constexpr (D != 80) {
    wgmma_rs<D, 1>(d, a, desc_mnmajor<R>(tile, kk));
  } else {
    wgmma_rs_n64<1>(*reinterpret_cast<float(*)[32]>(&d[0]), a, desc_mnmajor_sw<R, 128>(tile, kk),
                    1);
    wgmma_rs_n16<1>(*reinterpret_cast<float(*)[8]>(&d[32]), a,
                    desc_mnmajor_sw<R, 32>(tile + R * 64, kk), 1);
  }
}

// Element offset of 16-byte chunk c of row r in an R-row tile of built
// width D as TMA writes it, for a tile gathered row by row with cp.async:
// at width 32 one R x 32 tile at the 64-byte swizzle (chunk position c ^
// ((r / 2) % 4), the bits 7-8 of the row's offset), at the multiples of 64
// the 128-byte-swizzled R x 64 sub-tiles (`swz`)
template <int D, int R>
__device__ __forceinline__ int chunk_at(int r, int c) {
  static_assert(D == 32 || D % 64 == 0, "gathered tiles are 32 or a multiple of 64 columns wide");
  if constexpr (D == 32)
    return r * 32 + ((c ^ ((r >> 1) & 3)) << 3);
  else
    return swz<R>(r, c);
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
// batch), a box x 1 x R x 1 box (box 64, 32 or 16 columns) at the swizzle
// of its row's span, zeros past the ends. Returns false when
// cuTensorMapEncodeTiled refuses it.
inline bool rows_map(CUtensorMap* map, const void* base, int C, int heads, int time, int batch,
                     long long st, long long sb, int R, int box = 64) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)heads, (cuuint64_t)time,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, 1, (cuuint32_t)R, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            boxes, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(box * 2),
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of the same tensor read at width 80
inline bool rows_map(Map80* map, const void* base, int C, int heads, int time, int batch,
                     long long st, long long sb, int R) {
  return rows_map(&map->box64, base, C, heads, time, batch, st, sb, R, 64) &&
         rows_map(&map->box16, base, C, heads, time, batch, st, sb, R, 16);
}

// The map(s) of the same tensor read at built width D: one 32-column box
// at 32, the two boxes of Map80 at 80, 64-column boxes at the multiples
// of 64
template <int D>
inline bool width_map(RowMap<D>* map, const void* base, int C, int heads, int time, int batch,
                      long long st, long long sb, int R) {
  if constexpr (D == 80)
    return rows_map(map, base, C, heads, time, batch, st, sb, R);
  else
    return rows_map(map, base, C, heads, time, batch, st, sb, R, D == 32 ? 32 : 64);
}

}  // namespace sm90
