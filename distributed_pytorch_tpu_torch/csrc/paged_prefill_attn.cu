// paged_prefill_attn: a T-token prefill chunk of ONE sequence, written at a
// block-aligned offset `off`, attends causally (key position <= off + t)
// over the sequence's own paged blocks (sm_90a, fp32 and bf16). Built and
// bound by ops/cuda_build.py; wrapped by ops/flash_decode.py
// (`paged_flash_prefill`).
//
// Replaces: `_prefill_kernel` -> `paged_flash_prefill` of
// distributed_pytorch_tpu/ops/flash_decode.py.
//
// Bound on the H100: a T-row chunk does ~4 * T * (off + T/2) * nh * hs
// FLOPs on 2 * T * nh * hs query/output elements and 2 * (off + T) * nkv
// * hs K/V elements. At the serving path's chunks (T = 512, hs = 64, MHA)
// that is ~130 FLOP per bf16 byte, under the card's ~295 FLOP/byte
// ridge, so bytes bound it; longer chunks cross over to operations. The
// design packs the chunk's (t, rep) rows of each kv head into tiles of 64
// rows, one CTA per (row tile, kv head), keeps each K/V tile in shared
// memory for all 64 rows, and ends each CTA's key loop at its own last
// row's position, so keys past a tile's causal edge are never read. The
// products are FMA loops on CUDA cores, far from either bound: wgmma with
// TMA-fed tiles is the later step.

#include "paged_attn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // packed (t, rep) query rows per CTA

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ table,
                     T* __restrict__ out, int n_tok, int nh, int nkv, int hs,
                     int bs, int n_max, int off, float scale) {
  const int g = blockIdx.y;
  const int rep = nh / nkv;
  paged_attn::Rows r;
  r.row0 = blockIdx.x * kRows;
  r.n_rows = min(kRows, n_tok * rep - r.row0);
  r.rep = rep;
  r.stride_t = (long long)nh * hs;  // q/out are (1, T, nh, hs)
  r.pos0 = off;
  const long long base = (long long)g * rep * hs;
  paged_attn::attend_rows<T, kThreads>(q + base, out + base, r, k, v, table,
                                       n_max, bs, nkv, g, hs, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           void* out, int n_tok, int nh, int nkv, int hs, int bs, int n_max,
           int off, float scale, void* stream) {
  const size_t smem = paged_attn::smem_bytes(kRows, hs);
  // raise the kernel's shared-memory cap once per device, not per launch
  static size_t smem_cap[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > smem_cap[dev]) {
    err = cudaFuncSetAttribute(
        paged_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_cap[dev] = smem;
  }
  const int rows = n_tok * (nh / nkv);
  const dim3 grid((rows + kRows - 1) / kRows, nkv);
  paged_prefill_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)table, (T*)out,
      n_tok, nh, nkv, hs, bs, n_max, off, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out (1, n_tok, nh, hs); k/v pools
// (n_blocks, bs, nkv, hs); table (n_max,) int32 of the one sequence.
// Returns the launch's cudaError_t (0 = success).
extern "C" int paged_prefill_attn(int dtype, const void* q, const void* k,
                                  const void* v, const void* table, void* out,
                                  int n_tok, int nh, int nkv, int hs, int bs,
                                  int n_max, int off, float scale,
                                  void* stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, table, out, n_tok, nh, nkv, hs, bs, n_max,
                         off, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, table, out, n_tok, nh, nkv, hs, bs,
                                 n_max, off, scale, stream);
  return (int)cudaErrorInvalidValue;
}
