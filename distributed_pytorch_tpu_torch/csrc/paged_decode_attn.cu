// paged_decode_attn: one query token per sequence against its paged KV
// cache (sm_90a, fp32 and bf16). Built and bound by ops/cuda_build.py;
// wrapped by ops/flash_decode.py (`paged_flash_decode`, and `flash_decode`
// for a contiguous cache, which is a pool of B blocks of S rows with the
// table arange(B)[:, None]).
//
// Replaces: `_paged_body` -> `paged_flash_decode` and `_kernel` ->
// `flash_decode` of distributed_pytorch_tpu/ops/flash_decode.py.
//
// Bound on the H100: bytes. Each sequence's live K/V rows are read once
// (2 * cache_len * nkv * hs elements) for ~4 * cache_len * nh * hs FLOPs,
// about one FLOP per byte in bf16, far under the card's ~295 FLOP/byte
// ridge. The design streams exactly the live rows (the loop ends at
// cache_len; dead blocks cost nothing) and reads K/V once per kv head for
// all `rep` query heads of the group.
//
// Grid: one CTA of 128 threads per (sequence, kv head). What holds it back:
// at B=8 and 12 kv heads that is 96 CTAs on 132 SMs, with no split of the
// KV length across CTAs, and the tile loop is FMA-on-shared-memory.

#include "paged_attn_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ tables,
                    const int* __restrict__ cache_len, T* __restrict__ out,
                    int nh, int nkv, int hs, int bs, int n_max, float scale) {
  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = nh / nkv;
  paged_attn::Rows r;
  r.row0 = 0;
  r.n_rows = rep;
  r.rep = rep;
  r.stride_t = 0;
  r.pos0 = cache_len[b] - 1;  // keys [0, cache_len) are live
  const long long base = ((long long)b * nh + (long long)g * rep) * hs;
  paged_attn::attend_rows<T, kThreads>(q + base, out + base, r, k, v,
                                       tables + (long long)b * n_max, n_max,
                                       bs, nkv, g, hs, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* cache_len, void* out, int B, int nh, int nkv, int hs,
           int bs, int n_max, float scale, void* stream) {
  const size_t smem = paged_attn::smem_bytes(nh / nkv, hs);
  // raise the kernel's shared-memory cap once per device, not per launch
  static size_t smem_cap[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > smem_cap[dev]) {
    err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_cap[dev] = smem;
  }
  const dim3 grid(B, nkv);
  paged_decode_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)tables,
      (const int*)cache_len, (T*)out, nh, nkv, hs, bs, n_max, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out (B, nh, hs); k/v pools
// (n_blocks, bs, nkv, hs); tables (B, n_max) int32; cache_len (B,) int32.
// Returns the launch's cudaError_t (0 = success).
extern "C" int paged_decode_attn(int dtype, const void* q, const void* k,
                                 const void* v, const void* tables,
                                 const void* cache_len, void* out, int B,
                                 int nh, int nkv, int hs, int bs, int n_max,
                                 float scale, void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, tables, cache_len, out, B, nh, nkv, hs, bs,
                         n_max, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, tables, cache_len, out, B, nh, nkv,
                                 hs, bs, n_max, scale, stream);
  return (int)cudaErrorInvalidValue;
}
