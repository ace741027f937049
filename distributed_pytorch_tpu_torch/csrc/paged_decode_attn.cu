// paged_decode_attn and paged_decode_attn_q8: one query token per sequence
// against its paged KV cache (sm_90a, fp32 and bf16 activations; the _q8
// entry reads int8 codes with fp32 per-(row, kv head) scale pools). Built
// and bound by ops/cuda_build.py; wrapped by ops/flash_decode.py
// (`paged_flash_decode`, and `flash_decode` for a contiguous cache, which
// is a pool of B blocks of S rows with the table arange(B)[:, None]).
//
// Replaces: `_paged_body` -> `paged_flash_decode` and `_kernel` ->
// `flash_decode` of distributed_pytorch_tpu/ops/flash_decode.py; the _q8
// entry their int8 bodies `_paged_body_q8` and `_kernel_q8`.
//
// Bound on the H100: bytes. Each sequence's live K/V rows are read once
// (2 * cache_len * nkv * hs elements, int8 codes plus two fp32 scales a
// row for the _q8 entry) for ~4 * cache_len * nh * hs FLOPs, about one
// FLOP per byte in bf16, far under the card's ~295 FLOP/byte ridge. What a
// call takes is the latency of each CTA's chain of dependent loads (table
// entry, then K/V rows), so the design is about how many rows are in
// flight at once and how long the longest chain is.
//
// Split-KV (flash-decoding), on CUDA cores, for every cache type — one
// query row per head makes no matrix product, so there is no wgmma here.
// * `decode_split_kernel<T, C, R>` (T the activations' type, C the
//   cache's: T, or int8 codes): a grid of (sequence, kv head x row chunk,
//   split); split s owns keys [128 s, 128 s + 128) of the table's
//   capacity (n_max * bs), and a CTA whose span starts at or past
//   min(cache_len, capacity) exits at once, so blocks past a sequence's
//   length are never read. cache_len is read on the device only; the
//   split count comes from the capacity. Each of the CTA's 4 warps owns 32
//   of the span's keys. A key row moves from the pool, through the block
//   table, straight into registers as vectors (16 bytes: 8 bf16 or 4 fp32;
//   8 bytes: 8 int8 codes): a group of G lanes (G the row's vectors,
//   rounded up to a power of two) holds one key, so a warp reads 32 / G
//   keys a pass and keeps up to 8 passes of K and V in flight before it
//   computes. Scores are the lanes'
//   fp32 dot products summed by shuffles within the group; each warp
//   keeps its own running (m, l) and fp32 P V accumulator in registers
//   (the groups' partial sums meet by shuffles once, at the end), and the
//   4 warps merge once through shared memory, in warp order. The R query
//   rows of a kv head's group (GQA/MQA, R = rep rounded up to a power of
//   two, at most 8; rep 12 takes two row chunks) share every K/V read.
//   The CTA writes its (unnormalized fp32 acc, m, l) per row to the
//   workspace.
// * `decode_combine_kernel<T>`: one CTA per (head, sequence) merges the
//   live splits in split order — out = sum_s e^(m_s - M) acc_s / sum_s
//   e^(m_s - M) l_s — so two launches are bit-equal; a row with cache_len
//   0 has no live split and writes zeros.
// * The arithmetic is the FMA kernel's: fp32 scores times `scale`, -1e30
//   masks, `expf`, l summing the unrounded p, p rounded to T before P V
//   (the reference's `p.astype(v.dtype)`); the running max moves once a
//   chunk of up to 8 passes (32 keys for bf16 at head size 64).
// * int8 cache: the codes become fp32 in registers (exactly); each lane
//   of a key's group reads the key's K and V scales (one address, so one
//   read a group). The score is the fp32 dot of q with the codes times
//   (k_scale * scale); l sums the fp32 p; the P V operand is (p * v_scale)
//   rounded to T against the codes — the reference's `(p * vs).astype`.
//   A key past cache_len loads no code and no scale (they stay 0, its
//   score -1e30), so NaN in a dead row never meets a product.
// Rows wider than a warp's 32 vectors (more than 512 bytes of fp32/bf16:
// head size > 128 in fp32, > 256 in bf16; int8 head size > 256):
// `paged_decode_kernel<T, C>` — one CTA of 128 threads per (sequence, kv
// head) running the FMA tile loop `attend_rows` (paged_attn_common.cuh)
// with K/V tiles in shared memory; no split of the KV length, four
// synchronized passes a 64-key tile. The C entries pick it by row width
// before launch, as the reference's kernel takes every head size whose
// tiles fit (ops/flash_decode.py gates both).

#include "paged_attn_common.cuh"

namespace {

using paged_attn::kNegInf;

// ---- split-KV ----------------------------------------------------------

constexpr int kWarps = 4;                  // warps of a split CTA
constexpr int kWarpKeys = 32;              // keys a warp owns
constexpr int kSpan = kWarps * kWarpKeys;  // keys a split owns (ops/flash_decode.py _SPAN)
constexpr int kMaxRows = 8;                // query rows a CTA holds
constexpr int kMaxVecs = 32;               // row vectors a warp holds: one a lane
constexpr int kCombineThreads = 128;

// kVec elements of a T row into fp32, as 16-byte vectors (one, or two for
// the 8 fp32 values that meet an int8 vector)
template <typename T, int kVec>
__device__ __forceinline__ void load_q(const T* src, float* f) {
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < kVec / per; ++i)
    paged_attn::unpack<T>(*reinterpret_cast<const uint4*>(src + i * per), f + i * per);
}

template <typename T, typename C, int R>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ cache_len, float* __restrict__ ws,
                    int nh, int nkv, int hs, int bs, int n_max, int n_split,
                    float scale) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  using Vec = typename paged_attn::RowVec<C>::type;
  constexpr int kVec = paged_attn::RowVec<C>::n;
  constexpr int NP = R <= 2 ? 8 : 16 / R;  // key passes in flight: 8, 8, 4, 2
  const int b = blockIdx.x, split = blockIdx.z;
  const int rep = nh / nkv, n_rc = (rep + R - 1) / R;
  const int g = blockIdx.y / n_rc, row0 = (blockIdx.y % n_rc) * R;
  const int n_rows = min(R, rep - row0);
  const int n_live = min(cache_len[b], n_max * bs);
  const int span0 = split * kSpan;
  if (span0 >= n_live) return;  // nothing of this sequence lies here

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vpr = hs / kVec;  // vectors a row (<= 32)
  int G = 1;                  // lanes a key
  while (G < vpr) G <<= 1;
  const int KP = 32 / G;  // keys a pass
  const int grp = lane / G, lig = lane & (G - 1);
  const bool has = lig < vpr;

  float qf[R][kVec], acc[R][kVec], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) qf[r][e] = acc[r][e] = 0.f;
    if (has && r < n_rows)
      load_q<T, kVec>(q + ((long long)b * nh + g * rep + row0 + r) * hs + lig * kVec, qf[r]);
  }

  const int* table = tables + (long long)b * n_max;
  const int w_end = min(span0 + (warp + 1) * kWarpKeys, n_live);
  for (int c0 = span0 + warp * kWarpKeys; c0 < w_end; c0 += NP * KP) {
    // up to NP passes of K and V rows in flight: key c0 + i KP + grp; an
    // int8 key's scales too (0, like its codes, past the live keys)
    Vec kr[NP], vr[NP];
    float ksc[NP], vsc[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int kp = c0 + i * KP + grp;
      kr[i] = Vec{};
      vr[i] = Vec{};
      ksc[i] = vsc[i] = 0.f;
      if (kp < w_end) {
        const long long row = ((long long)table[kp / bs] * bs + kp % bs) * nkv + g;
        if (has) {
          const long long off = row * hs + lig * kVec;
          kr[i] = __ldg(reinterpret_cast<const Vec*>(k + off));
          vr[i] = __ldg(reinterpret_cast<const Vec*>(v + off));
        }
        if constexpr (kQ8) {  // every lane of the group: one address
          ksc[i] = __ldg(k_scale + row);
          vsc[i] = __ldg(v_scale + row);
        }
      }
    }
    // scores: each lane's share of the dot, summed within its group
    float s[NP][R];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float kf[kVec];
      paged_attn::unpack<C>(kr[i], kf);
      const bool live = c0 + i * KP + grp < w_end;
      const float sc = kQ8 ? ksc[i] * scale : scale;  // dequantize k, then scale
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qf[r][e], kf[e], dot);
        for (int o = G >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[i][r] = live ? dot * sc : kNegInf;
      }
    }
    // the warp's running softmax; s becomes the P V operand rounded to T
    // (p, times the key's v_scale for an int8 cache)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = s[0][r];
#pragma unroll
      for (int i = 1; i < NP; ++i) mx = fmaxf(mx, s[i][r]);
      for (int o = G; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float p = expf(s[i][r] - m_new);
        sum += p;
        s[i][r] = paged_attn::round_to<T>(kQ8 ? p * vsc[i] : p);
      }
      for (int o = G; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] *= alpha;
    }
    // P V over the group's own keys
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float vf[kVec];
      paged_attn::unpack<C>(vr[i], vf);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(s[i][r], vf[e], acc[r][e]);
    }
  }
  // the groups' partial P V sums (one running max for the whole warp)
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      for (int o = G; o < 32; o <<= 1) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);

  // merge the warps once, in warp order, into this split's workspace rows
  extern __shared__ float sm[];  // [kWarps][R][hs + 2]: acc, m, l
  const int ld = hs + 2;
  float* mine = sm + warp * R * ld;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (grp == 0 && has)
#pragma unroll
      for (int e = 0; e < kVec; ++e) mine[r * ld + lig * kVec + e] = acc[r][e];
    if (lane == 0) {
      mine[r * ld + hs] = m[r];
      mine[r * ld + hs + 1] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * ld; i += kWarps * 32) {
    const int r = i / ld, d = i - r * ld;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[(w * R + r) * ld + hs]);
    float val = mx;
    if (d != hs) {
      val = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float* row = sm + (w * R + r) * ld;
        val += expf(row[hs] - mx) * row[d];
      }
    }
    ws[(((long long)b * nh + g * rep + row0 + r) * n_split + split) * ld + d] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ ws, const int* __restrict__ cache_len,
                      T* __restrict__ out, int nh, int hs, int n_keys, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_live = min(cache_len[b], n_keys);
  const int ns = n_live > 0 ? (n_live + kSpan - 1) / kSpan : 0;  // live splits
  const int ld = hs + 2;
  const float* w = ws + ((long long)b * nh + h) * n_split * ld;
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, w[s * ld + hs]);
  float l = 0.f;
  for (int s = 0; s < ns; ++s) l += expf(w[s * ld + hs] - mx) * w[s * ld + hs + 1];
  for (int d = threadIdx.x; d < hs; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < ns; ++s) a += expf(w[s * ld + hs] - mx) * w[s * ld + d];
    out[((long long)b * nh + h) * hs + d] = paged_attn::from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, typename C, int R>
int launch_split(const void* q, const void* k, const void* k_scale, const void* v,
                 const void* v_scale, const void* tables, const void* cache_len, float* ws,
                 int B, int nh, int nkv, int hs, int bs, int n_max, int n_split, float scale,
                 cudaStream_t st) {
  const int n_rc = (nh / nkv + R - 1) / R;
  const dim3 grid(B, nkv * n_rc, n_split);
  const size_t smem = sizeof(float) * kWarps * R * (hs + 2);
  decode_split_kernel<T, C, R><<<grid, kWarps * 32, smem, st>>>(
      (const T*)q, (const C*)k, (const C*)v, (const float*)k_scale, (const float*)v_scale,
      (const int*)tables, (const int*)cache_len, ws, nh, nkv, hs, bs, n_max, n_split, scale);
  return (int)cudaGetLastError();
}

// ---- rows past a warp's 32 vectors: the FMA tile loop ---------------------

constexpr int kThreads = 128;

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const C* __restrict__ k,
                    const C* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ tables,
                    const int* __restrict__ cache_len, T* __restrict__ out, int nh, int nkv,
                    int hs, int bs, int n_max, float scale) {
  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = nh / nkv;
  paged_attn::Rows r;
  r.row0 = 0;
  r.n_rows = rep;
  r.rep = rep;
  r.stride_t = 0;
  r.pos0 = cache_len[b] - 1;  // keys [0, cache_len) are live
  const long long base = ((long long)b * nh + (long long)g * rep) * hs;
  paged_attn::attend_rows<T, C, kThreads>(q + base, out + base, r, k, v, k_scale, v_scale,
                                               tables + (long long)b * n_max, n_max, bs, nkv, g,
                                               hs, scale);
}

template <typename T, typename C>
int launch_tile(const void* q, const void* k, const void* k_scale, const void* v,
              const void* v_scale, const void* tables, const void* cache_len, void* out, int B,
              int nh, int nkv, int hs, int bs, int n_max, float scale, void* stream) {
  const size_t smem = paged_attn::smem_bytes(nh / nkv, hs, std::is_same<C, int8_t>::value);
  // raise the kernel's shared-memory cap once per device, not per launch
  static size_t smem_cap[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > smem_cap[dev]) {
    err = cudaFuncSetAttribute(paged_decode_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_cap[dev] = smem;
  }
  const dim3 grid(B, nkv);
  paged_decode_kernel<T, C><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const C*)k, (const C*)v, (const float*)k_scale,
      (const float*)v_scale, (const int*)tables, (const int*)cache_len, (T*)out, nh, nkv, hs, bs,
      n_max, scale);
  return (int)cudaGetLastError();
}

// T activations over a cache of C (T, or int8 codes with k_scale/v_scale):
// the split pair for rows of at most 32 vectors, else the tile kernel
template <typename T, typename C>
int launch_decode(const void* q, const void* k, const void* k_scale, const void* v,
                  const void* v_scale, const void* tables, const void* cache_len, void* out,
                  void* ws, int B, int nh, int nkv, int hs, int bs, int n_max, int n_split,
                  float scale, void* stream) {
  constexpr int kVec = paged_attn::RowVec<C>::n;
  const long long n_keys = (long long)n_max * bs;
  // a row wider than a warp's vectors takes the tile kernel, which reads
  // no workspace and no split count
  const bool split = hs / kVec <= kMaxVecs;
  if (B < 0 || nkv <= 0 || nh % nkv != 0 || hs <= 0 || hs % kVec != 0 || bs <= 0 ||
      n_max <= 0 || n_keys > (1 << 30) ||
      (split && n_split != (n_keys + kSpan - 1) / kSpan))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (!split)
    return launch_tile<T, C>(q, k, k_scale, v, v_scale, tables, cache_len, out, B, nh, nkv, hs,
                             bs, n_max, scale, stream);
  const cudaStream_t st = (cudaStream_t)stream;
  float* w = static_cast<float*>(ws);
  const int rep = nh / nkv;
  const int err =
      rep == 1   ? launch_split<T, C, 1>(q, k, k_scale, v, v_scale, tables, cache_len, w, B, nh,
                                         nkv, hs, bs, n_max, n_split, scale, st)
      : rep == 2 ? launch_split<T, C, 2>(q, k, k_scale, v, v_scale, tables, cache_len, w, B, nh,
                                         nkv, hs, bs, n_max, n_split, scale, st)
      : rep <= 4 ? launch_split<T, C, 4>(q, k, k_scale, v, v_scale, tables, cache_len, w, B, nh,
                                         nkv, hs, bs, n_max, n_split, scale, st)
                 : launch_split<T, C, kMaxRows>(q, k, k_scale, v, v_scale, tables, cache_len, w,
                                                B, nh, nkv, hs, bs, n_max, n_split, scale, st);
  if (err) return err;
  decode_combine_kernel<T><<<dim3(nh, B), kCombineThreads, 0, st>>>(
      w, (const int*)cache_len, (T*)out, nh, hs, (int)n_keys, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out (B, nh, hs), q 16-byte aligned;
// k/v pools (n_blocks, bs, nkv, hs) of the same dtype, 16-byte aligned,
// hs a multiple of 16 bytes' worth of elements (rows past 512 bytes take
// the tile kernel, whose tiles must fit in shared memory); tables (B,
// n_max) int32; cache_len (B,) int32; ws the (B, nh, n_split, hs + 2) fp32
// workspace, n_split = ceil(n_max * bs / 128) (both unread, and may be
// null and 0, for rows past 512 bytes). Returns the launches' cudaError_t
// (0 = success).
extern "C" int paged_decode_attn(int dtype, const void* q, const void* k, const void* v,
                                 const void* tables, const void* cache_len, void* out, void* ws,
                                 int B, int nh, int nkv, int hs, int bs, int n_max, int n_split,
                                 float scale, void* stream) {
  if (dtype == 0)
    return launch_decode<float, float>(q, k, nullptr, v, nullptr, tables, cache_len, out, ws, B,
                                       nh, nkv, hs, bs, n_max, n_split, scale, stream);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16, __nv_bfloat16>(q, k, nullptr, v, nullptr, tables,
                                                       cache_len, out, ws, B, nh, nkv, hs, bs,
                                                       n_max, n_split, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 cache: k/v pools of int8 codes (hs a multiple of 8; rows past
// 256 codes take the tile kernel, which reads no workspace), k_scale/v_scale
// (n_blocks, bs, nkv, 1) float32; q/out, tables, cache_len, ws and n_split
// as paged_decode_attn.
extern "C" int paged_decode_attn_q8(int dtype, const void* q, const void* k, const void* k_scale,
                                    const void* v, const void* v_scale, const void* tables,
                                    const void* cache_len, void* out, void* ws, int B, int nh,
                                    int nkv, int hs, int bs, int n_max, int n_split, float scale,
                                    void* stream) {
  if (dtype == 0)
    return launch_decode<float, int8_t>(q, k, k_scale, v, v_scale, tables, cache_len, out, ws, B,
                                        nh, nkv, hs, bs, n_max, n_split, scale, stream);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16, int8_t>(q, k, k_scale, v, v_scale, tables, cache_len,
                                                out, ws, B, nh, nkv, hs, bs, n_max, n_split,
                                                scale, stream);
  return (int)cudaErrorInvalidValue;
}
