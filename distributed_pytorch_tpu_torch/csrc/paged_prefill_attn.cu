// paged_prefill_attn and paged_prefill_attn_q8: a T-token prefill chunk of
// ONE sequence, written at a block-aligned offset `off`, attends causally
// (key position <= off + t) over the sequence's own paged blocks (sm_90a,
// fp32 and bf16 activations; the _q8 entry reads int8 codes with fp32
// per-(row, kv head) scale pools). Built and bound by ops/cuda_build.py;
// wrapped by ops/flash_decode.py (`paged_flash_prefill`).
//
// Replaces: `_prefill_kernel` -> `paged_flash_prefill` of
// distributed_pytorch_tpu/ops/flash_decode.py; the _q8 entry its int8
// body `_prefill_kernel_q8`.
//
// Bound on the H100: a T-row chunk does ~4 * T * (off + T/2) * nh * hs
// FLOPs on 2 * T * nh * hs query/output elements and 2 * (off + T) * nkv
// * hs K/V elements. At the serving path's chunks (T = 512, hs = 64, MHA)
// that is ~130 FLOP per bf16 byte, under the card's ~295 FLOP/byte
// ridge, so bytes bound it (~1 us); longer chunks cross over to
// operations. Neither bound is what the kernels meet at that shape: a
// chunk is 8 row tiles x 12 kv heads = 96 CTAs on 132 SMs, each walking
// up to 12 key tiles in a chain of dependent steps, so its time is that
// chain's latency. At the default config's head size 32 (GQA 8 / 4) a
// 512-row chunk packs 1024 rows a kv head: 16 row tiles x 4 kv heads = 64
// CTAs, chains of up to 8 key tiles at offset 0 and 12 at offset 256,
// each step half the products of head size 64's (bound ~0.2 us, bytes).
//
// Every design packs the chunk's (t, rep) rows of each kv head into tiles
// of 64 rows, one CTA per (row tile, kv head), keeps each K/V tile in
// shared memory for all 64 rows, and ends each CTA's key loop at its own
// last row's position, so keys past a tile's causal edge are never read.
// The dtype and the head size pick the kernel before launch; it is not a
// fallback (a launch that fails returns its error, and the wrapper
// raises):
// * bf16 at head size 32, 64 or 128 (`prefill_kernel_sm90`): tensor cores. One
//   warpgroup (128 threads) per (64-row tile, kv head); 28 KB of shared memory
//   at head size 32, 56 KB at 64, 112 KB at 128. Hopper's TMA cannot gather
//   rows through a block table (and a box per page would tie the kernel to
//   block sizes that divide 64), so all 128 threads gather each 64-key K and V
//   tile with 16-byte cp.async copies, one table read per row, straight into
//   the swizzled layout that wgmma reads (the 128-byte swizzle at 64 and 128;
//   at 32, a row of 64 bytes, the 64-byte swizzle that TMA writes for a
//   32-column box: `chunk_at`, flash_attn_sm90.cuh), for any block size, nkv
//   and offset the wrapper accepts. At 32, S = Q K^T takes 2 k-steps and P V
//   is one m64n32k16 (`kdesc`, `wgmma_rs_mn`); before, this head size ran the
//   FMA kernel below. The tiles come through a 3-stage ring: tile j + 3 is
//   requested as soon as tile j's products are done, so two tiles' copies are
//   in flight while the warpgroup computes (a third stage ran 4-5% faster than
//   two at hs 32, 2% at 64, on the H100; PERF.md); each copier fences the
//   async proxy before the barrier that hands a landed tile to wgmma. The
//   query tile is gathered once the same way. S = Q K^T is a wgmma with both
//   operands in shared memory (K-major); the online softmax runs on the fp32
//   accumulator in registers (a row lives in the 4 threads of a quad); P,
//   rounded to bf16, becomes the register A operand of O += P V, with V read
//   MN-major. The arithmetic is the FMA kernel's: s = fp32(q.k) * scale,
//   masked scores -1e30, p = expf(s - m) (not exp2 with the scale folded in:
//   that moves served logits by an ulp), l sums the unrounded fp32 p, P V
//   takes p rounded to bf16, out = acc / max(l, 1e-30). Row tiles launch
//   longest first (the grid's slowest axis runs down the causal frontier), so
//   the tiles with the most keys do not form the grid's tail.
//   At hs 32 a chunk makes few CTAs (a 512-row chunk at 8 / 4 heads: 64 on
//   132 SMs), each a chain of dependent key tiles. Where two CTAs a (row
//   tile, kv head) still fit on the SMs at once, the wrapper asks for a
//   split (`prefill_splits`, ops/flash_decode.py): each CTA of the pair
//   walks half of the key tiles and writes its unnormalized o with its m
//   and l to a workspace, and `prefill_combine` merges the halves (the
//   decode's split-KV scheme). On the H100 that took the 512-row chunk
//   from 0.0134 to 0.0119 ms at offset 0 and from 0.0191 to 0.0145 at
//   offset 256 (SDPA: 0.0166, 0.0208), while a probe that split hs 64 (96
//   CTAs, 192 split) ran 0.0210 -> 0.0234 (bench/flash_ab.py, PERF.md), so
//   hs 64 and 128 never split.
// * The int8 cache with bf16 activations at head size 64 or 128
//   (`prefill_kernel_sm90_q8`, the same body templated on the cache type):
//   the K/V codes come through the table by 16-byte cp.async into a
//   2-stage ring of int8 tiles (half the bf16 tiles' bytes), the tile's 64
//   K and 64 V scales by 4-byte cp.async (a key past the chunk loads
//   neither). After its own wait each thread converts the codes it copied
//   into one swizzled bf16 K and V tile, exactly (|code| <= 127 fits
//   bf16), then the async-proxy fence and the barrier hand the tile to
//   wgmma, and the stage is refilled at once, so two tiles' codes fly
//   while one computes. The codes are converted, not dequantized: the K
//   scale multiplies the fp32 score (acc * (k_scale * scale), as the
//   reference and the FMA kernel form it), `l` sums the unscaled p, and
//   the P V operand is p * v_scale rounded to bf16, against the V codes.
//   Rounding code * scale to bf16 first would add a rounding that neither
//   the reference nor the plain version has. 41 KB of shared memory at
//   head size 64, 82 KB at 128.
// * fp32, bf16 at other head sizes, and the int8 cache at head size 32:
//   FMA loops on CUDA cores (`paged_prefill_kernel` over `attend_rows`,
//   paged_attn_common.cuh; tensor cores take fp32 only as TF32, which
//   would break the fp32 limits), far from either bound.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"
#include "paged_attn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // packed (t, rep) query rows per CTA

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const C* __restrict__ k,
                     const C* __restrict__ v,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ table, T* __restrict__ out,
                     int n_tok, int nh, int nkv, int hs, int bs, int n_max,
                     int off, float scale) {
  const int g = blockIdx.y;
  const int rep = nh / nkv;
  paged_attn::Rows r;
  r.row0 = blockIdx.x * kRows;
  r.n_rows = min(kRows, n_tok * rep - r.row0);
  r.rep = rep;
  r.stride_t = (long long)nh * hs;  // q/out are (1, T, nh, hs)
  r.pos0 = off;
  const long long base = (long long)g * rep * hs;
  paged_attn::attend_rows<T, C, kThreads>(q + base, out + base, r, k, v,
                                          k_scale, v_scale, table, n_max, bs,
                                          nkv, g, hs, scale);
}

template <typename T, typename C>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* table, void* out, int n_tok,
           int nh, int nkv, int hs, int bs, int n_max, int off, float scale,
           void* stream) {
  const size_t smem = paged_attn::smem_bytes(kRows, hs,
                                             std::is_same<C, int8_t>::value);
  static size_t cap[64] = {};
  const int err = flash::set_smem(paged_prefill_kernel<T, C>, smem, cap);
  if (err) return err;
  const int rows = n_tok * (nh / nkv);
  const dim3 grid((rows + kRows - 1) / kRows, nkv);
  paged_prefill_kernel<T, C><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const C*)k, (const C*)v, (const float*)k_scale,
      (const float*)v_scale, (const int*)table, (T*)out, n_tok, nh, nkv, hs,
      bs, n_max, off, scale);
  return (int)cudaGetLastError();
}

// ---- bf16 at head size 32 / 64 / 128: wgmma on cp.async-gathered tiles ----

namespace prefill_sm90 {

using sm90::bf16;
constexpr int kRows = 64;     // packed query rows per CTA: one warpgroup
constexpr int kBK = 64;       // keys per stage
// ring stages: bf16 K/V tiles (3: on the H100 a third stage ran the
// chunk 2-5% faster than 2 at hs 32 and 64, PERF.md), or int8 code tiles
template <typename C>
constexpr int kStages = std::is_same<C, int8_t>::value ? 2 : 3;
constexpr int kThreads = 128;
static_assert(kThreads == 2 * kBK, "one scale copy a thread: K's, then V's");

// bf16 cache: the query tile and a ring of K/V tiles that cp.async fills
// straight into the swizzled layout wgmma reads.
template <int HS, typename C>
struct Smem {
  alignas(1024) bf16 q[kRows * HS];
  alignas(1024) bf16 k[kStages<C>][kBK * HS];
  alignas(1024) bf16 v[kStages<C>][kBK * HS];
  __device__ __forceinline__ bf16* k_tile(int s) { return k[s]; }
  __device__ __forceinline__ bf16* v_tile(int s) { return v[s]; }
};

// int8 cache: a ring of code tiles (HS codes a key row, as the pools hold
// them) with their fp32 scales (a tile's 64 K scales, then its 64 V
// scales), and one bf16 K and V tile that each thread fills by converting
// the codes it copied; the current tile's scales move out of the ring with
// them (`sc_t`), so the stage can be refilled while the softmax still
// reads them.
template <int HS>
struct Smem<HS, int8_t> {
  alignas(1024) bf16 q[kRows * HS];
  alignas(1024) bf16 k[kBK * HS];
  alignas(1024) bf16 v[kBK * HS];
  alignas(16) int8_t kc[kStages<int8_t>][kBK * HS];
  alignas(16) int8_t vc[kStages<int8_t>][kBK * HS];
  float sc[kStages<int8_t>][2 * kBK];
  float sc_t[2 * kBK];
  __device__ __forceinline__ bf16* k_tile(int) { return k; }
  __device__ __forceinline__ bf16* v_tile(int) { return v; }
};

// The pool row of key position kp of kv head g, read through the table
__device__ __forceinline__ long long pool_row(const int* __restrict__ table, int kp, int bs,
                                              int nkv, int g) {
  return ((long long)table[kp / bs] * bs + kp % bs) * nkv + g;
}

// Key tile j (keys k0 = 64 j ..) of kv head g into stage s, read through
// the table: one commit group's worth of cp.async copies by each thread;
// keys at or past n_keys arrive as zeros and are not read. bf16: 16-byte
// chunks straight into the swizzled tiles. int8: 16-code chunks into the
// code ring, and one scale a thread (K's for threads 0-63, V's for
// 64-127). Every tile puts the same chunks and scale on the same thread,
// so a thread that refills a stage overwrites only what it converted.
template <int HS>
__device__ __forceinline__ void gather_kv(Smem<HS, bf16>& sm, int s, const bf16* __restrict__ k,
                                          const float* __restrict__,
                                          const bf16* __restrict__ v,
                                          const float* __restrict__,
                                          const int* __restrict__ table, int k0, int n_keys,
                                          int bs, int nkv, int g) {
  constexpr int kChunks = HS / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = e / kChunks, c = e % kChunks;
    const int kp = k0 + row;
    const int ok = kp < n_keys;
    const long long src = ok ? pool_row(table, kp, bs, nkv, g) * HS + c * 8 : 0;
    const int dst = sm90::chunk_at<HS, kBK>(row, c);
    sm90::cp_async16(sm.k[s] + dst, k + src, ok);
    sm90::cp_async16(sm.v[s] + dst, v + src, ok);
  }
}

template <int HS>
__device__ __forceinline__ void gather_kv(Smem<HS, int8_t>& sm, int s,
                                          const int8_t* __restrict__ k,
                                          const float* __restrict__ k_scale,
                                          const int8_t* __restrict__ v,
                                          const float* __restrict__ v_scale,
                                          const int* __restrict__ table, int k0, int n_keys,
                                          int bs, int nkv, int g) {
  constexpr int kChunks = HS / 16;  // 16-code chunks a row
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = e / kChunks, c = e % kChunks;
    const int kp = k0 + row;
    const int ok = kp < n_keys;
    const long long src = ok ? pool_row(table, kp, bs, nkv, g) * HS + c * 16 : 0;
    sm90::cp_async16(sm.kc[s] + row * HS + c * 16, k + src, ok);
    sm90::cp_async16(sm.vc[s] + row * HS + c * 16, v + src, ok);
  }
  const int kp = k0 + threadIdx.x % kBK;
  const int ok = kp < n_keys;
  const long long src = ok ? pool_row(table, kp, bs, nkv, g) : 0;
  sm90::cp_async4(&sm.sc[s][threadIdx.x], (threadIdx.x < kBK ? k_scale : v_scale) + src, ok);
}

// Codes b0 and b0 + 1 of the 4 in word u (the codes biased by 128: w ^
// 0x80808080), as a packed bf16 pair, exactly (|code| <= 127 fits bf16's
// 8-bit significand; the reference casts the codes to the activations'
// dtype the same way). Integer and FP32 pipes only: each code goes under
// the exponent of 2^23 by one byte permute, one FADD removes 2^23 + 128,
// and one permute packs the two upper halves (the fp32 values' low 16
// bits are zero). It ran the kernel 3-5% faster than I2F and a packing
// F2FP, which issue on the slower conversion unit (PERF.md §6).
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t u, int b0) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b0)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441 + b0)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 16 codes as the two 16-byte bf16 chunks at dst0 and dst1
__device__ __forceinline__ void codes_to_bf16(const int8_t* src, bf16* dst0, bf16* dst1) {
  uint4 w = *reinterpret_cast<const uint4*>(src);
  w.x ^= 0x80808080u;
  w.y ^= 0x80808080u;
  w.z ^= 0x80808080u;
  w.w ^= 0x80808080u;
  *reinterpret_cast<uint4*>(dst0) = make_uint4(codes_to_bf16x2(w.x, 0), codes_to_bf16x2(w.x, 2),
                                               codes_to_bf16x2(w.y, 0), codes_to_bf16x2(w.y, 2));
  *reinterpret_cast<uint4*>(dst1) = make_uint4(codes_to_bf16x2(w.z, 0), codes_to_bf16x2(w.z, 2),
                                               codes_to_bf16x2(w.w, 0), codes_to_bf16x2(w.w, 2));
}

// int8: once its own copies of stage s have landed, each thread converts
// the code chunks it copied into the swizzled bf16 K and V tiles (16
// codes -> bf16 chunks 2c and 2c + 1 of the row) and moves the scale it
// copied out of the ring. bf16: nothing to do.
template <int HS>
__device__ __forceinline__ void convert_kv(Smem<HS, bf16>&, int) {}

template <int HS>
__device__ __forceinline__ void convert_kv(Smem<HS, int8_t>& sm, int s) {
  constexpr int kChunks = HS / 16;
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = e / kChunks, c = e % kChunks;
    const int d0 = sm90::swz<kBK>(row, 2 * c), d1 = sm90::swz<kBK>(row, 2 * c + 1);
    codes_to_bf16(sm.kc[s] + row * HS + c * 16, sm.k + d0, sm.k + d1);
    codes_to_bf16(sm.vc[s] + row * HS + c * 16, sm.v + d0, sm.v + d1);
  }
  sm.sc_t[threadIdx.x] = sm.sc[s][threadIdx.x];
}

// One CTA: 64 packed (t, rep) query rows of kv head g against the keys up
// to its last row's position. C is the cache's element type: bf16, or
// int8 codes with fp32 row scales (k_scale / v_scale; null for bf16).
template <int HS, typename C>
__device__ __forceinline__ void prefill_body(const bf16* __restrict__ q, const C* __restrict__ k,
                                             const float* __restrict__ k_scale,
                                             const C* __restrict__ v,
                                             const float* __restrict__ v_scale,
                                             const int* __restrict__ table,
                                             bf16* __restrict__ out, int n_tok, int nh, int nkv,
                                             int bs, int n_max, int off, float scale,
                                             float* __restrict__ ws) {
  using namespace sm90;
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr int kS = kStages<C>;
  extern __shared__ uint8_t smem_raw[];
  Smem<HS, C>& sm = smem_aligned<Smem<HS, C>>(smem_raw);
  const int g = blockIdx.x;
  const int rep = nh / nkv;
  const int n_packed = n_tok * rep;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest tiles first
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  // the last key any row of this tile may see, within the table's capacity
  const int last_pos = off + (min(row0 + kRows, n_packed) - 1) / rep;
  const int n_keys = min(last_pos + 1, n_max * bs);
  // split (ws set): CTA z of the pair walks the first (z 0) or the last
  // (z 1) half of the key tiles and writes its partial to ws
  const int n_all = (n_keys + kBK - 1) / kBK;
  const int t_lo = ws != nullptr && blockIdx.z == 1 ? (n_all + 1) / 2 : 0;
  const int n_kt = (ws != nullptr && blockIdx.z == 0 ? (n_all + 1) / 2 : n_all) - t_lo;

  // the query tile: packed row gi is head g * rep + gi % rep at position
  // gi / rep of the chunk; rows past the chunk arrive as zeros
  constexpr int kChunks = HS / 8;
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int row = e / kChunks, c = e % kChunks, gi = row0 + row;
    const int ok = gi < n_packed;
    const long long src = ok ? ((long long)(gi / rep) * nh + g * rep + gi % rep) * HS + c * 8 : 0;
    cp_async16(sm.q + chunk_at<HS, kRows>(row, c), q + src, ok);
  }
  // key tiles 0 .. kS - 1, a commit group each (tile 0's also holds
  // the query tile; a tile past the keys is an empty group)
#pragma unroll
  for (int t = 0; t < kS; ++t) {
    if (t < n_kt)
      gather_kv<HS>(sm, t, k, k_scale, v, v_scale, table, (t_lo + t) * kBK, n_keys, bs, nkv, g);
    cp_async_commit();
  }

  const int r0 = w * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane & 3);        // and columns 8 j + c0 + {0, 1}
  int qpos[2];
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) qpos[ih] = off + (row0 + r0 + 8 * ih) / rep;

  float o[HS / 2];
#pragma unroll
  for (int i = 0; i < HS / 2; ++i) o[i] = 0.f;
  // m: the running max; l: this thread's part of the normalizer
  float m[2] = {paged_attn::kNegInf, paged_attn::kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kS;
    const int k0 = (t_lo + j) * kBK;
    cp_async_wait<kS - 1>();  // tile j has landed (tiles j + 1 .. may fly)
    convert_kv<HS>(sm, s);         // int8: this thread's codes -> bf16
    fence_proxy_async();  // this thread's writes, before wgmma reads them
    __syncthreads();
    if constexpr (kQ8) {
      // stage s is converted: refill it with tile j + kS now, so two
      // tiles' codes fly while this one computes
      if (j + kS < n_kt)
        gather_kv<HS>(sm, s, k, k_scale, v, v_scale, table, k0 + kS * kBK, n_keys, bs, nkv,
                      g);
      cp_async_commit();
    }

    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
      wgmma_ss<kBK, 0, 0>(sc, kdesc<HS, kRows>(sm.q, kk), kdesc<HS, kBK>(sm.k_tile(s), kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // scale, mask (causal on each row's global position, and the keys the
    // tile holds), and the online softmax, as the FMA kernel forms them;
    // int8: the key row's scale joins the softmax scale on the fp32 score
    // (columns 8 (i / 4) + c0 + i % 2 of this thread's registers i)
    float mx[2] = {paged_attn::kNegInf, paged_attn::kNegInf};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int ih = (i >> 1) & 1;
      const int col = 8 * (i >> 2) + c0 + (i & 1);
      const int kp = k0 + col;
      float x;
      if constexpr (kQ8)
        x = sc[i] * (sm.sc_t[col] * scale);
      else
        x = sc[i] * scale;
      if (!(kp < n_keys && kp <= qpos[ih])) x = paged_attn::kNegInf;
      sc[i] = x;
      mx[ih] = fmaxf(mx[ih], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      const float m_new = fmaxf(m[ih], quad_max(mx[ih]));
      alpha[ih] = expf(m[ih] - m_new);
      m[ih] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int ih = (i >> 1) & 1;
      sc[i] = expf(sc[i] - m[ih]);
      sum[ih] += sc[i];
      // int8: l sums p; the P V operand is p times the value row's scale
      if constexpr (kQ8) sc[i] *= sm.sc_t[kBK + 8 * (i >> 2) + c0 + (i & 1)];
    }
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      l[ih] = l[ih] * alpha[ih] + sum[ih];
#pragma unroll
      for (int jj = 0; jj < HS / 8; ++jj) {
        o[4 * jj + 2 * ih] *= alpha[ih];
        o[4 * jj + 2 * ih + 1] *= alpha[ih];
      }
    }
    uint32_t pa[kBK / 16][4];  // the P V operand rounded to bf16: A fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) acc_to_frag(sc, kk, pa[kk]);

    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs_mn<HS, kBK>(o, pa[kk], sm.v_tile(s), kk);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    __syncthreads();  // every product on the tile is done: refill or rewrite it
    if constexpr (!kQ8) {
      if (j + kS < n_kt)
        gather_kv<HS>(sm, s, k, k_scale, v, v_scale, table, k0 + kS * kBK, n_keys, bs, nkv,
                      g);
      cp_async_commit();
    }
  }

  if (ws != nullptr) {  // this half's partial: o, m and l of each row
    cp_async_wait<0>();  // a half with no key tile leaves its groups open
    float* part = ws + ((size_t)(g * gridDim.y + row0 / kRows) * 2 + blockIdx.z) * kRows * (HS + 2);
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      const float lsum = quad_sum(l[ih]);
      float* prow = part + (r0 + 8 * ih) * (HS + 2);
#pragma unroll
      for (int jj = 0; jj < HS / 8; ++jj)
        *reinterpret_cast<float2*>(prow + 8 * jj + c0) =
            make_float2(o[4 * jj + 2 * ih], o[4 * jj + 2 * ih + 1]);
      if ((lane & 3) == 0) *reinterpret_cast<float2*>(prow + HS) = make_float2(m[ih], lsum);
    }
    return;
  }
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int gi = row0 + r0 + 8 * ih;
    const float ls = fmaxf(quad_sum(l[ih]), 1e-30f);
    if (gi >= n_packed) continue;
    bf16* orow = out + ((long long)(gi / rep) * nh + g * rep + gi % rep) * HS + c0;
#pragma unroll
    for (int jj = 0; jj < HS / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
          __floats2bfloat162_rn(o[4 * jj + 2 * ih] / ls, o[4 * jj + 2 * ih + 1] / ls);
  }
}

template <int HS>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ table,
                        bf16* __restrict__ out, int n_tok, int nh, int nkv, int bs, int n_max,
                        int off, float scale, float* __restrict__ ws) {
  prefill_body<HS, bf16>(q, k, nullptr, v, nullptr, table, out, n_tok, nh, nkv, bs, n_max, off,
                         scale, ws);
}

// The two halves' partials of a (row tile, kv head) merged, in half order:
// out = (o0 a0 + o1 a1) / (l0 a0 + l1 a1), a_z = exp(m_z - max(m0, m1)).
// A half that saw no live key of a row (every score masked) has the
// -1e30 max, so its a_z is 0.
template <int HS>
__global__ void __launch_bounds__(kThreads)
    prefill_combine(const float* __restrict__ ws, bf16* __restrict__ out, int n_tok, int nh,
                    int nkv) {
  const int g = blockIdx.x, tile = blockIdx.y;
  const int rep = nh / nkv, n_packed = n_tok * rep;
  const float* p0 = ws + (size_t)(g * gridDim.y + tile) * 2 * kRows * (HS + 2);
  const float* p1 = p0 + kRows * (HS + 2);
  for (int e = threadIdx.x; e < kRows * HS / 2; e += kThreads) {
    const int r = e / (HS / 2), c = 2 * (e % (HS / 2));
    const int gi = tile * kRows + r;
    if (gi >= n_packed) continue;
    const float* a = p0 + r * (HS + 2);
    const float* b = p1 + r * (HS + 2);
    const float mx = fmaxf(a[HS], b[HS]);
    const float ea = expf(a[HS] - mx), eb = expf(b[HS] - mx);
    const float ls = fmaxf(a[HS + 1] * ea + b[HS + 1] * eb, 1e-30f);
    bf16* orow = out + ((long long)(gi / rep) * nh + g * rep + gi % rep) * HS + c;
    *reinterpret_cast<__nv_bfloat162*>(orow) = __floats2bfloat162_rn(
        (a[c] * ea + b[c] * eb) / ls, (a[c + 1] * ea + b[c + 1] * eb) / ls);
  }
}

template <int HS>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel_sm90_q8(const bf16* __restrict__ q, const int8_t* __restrict__ k,
                           const float* __restrict__ k_scale, const int8_t* __restrict__ v,
                           const float* __restrict__ v_scale, const int* __restrict__ table,
                           bf16* __restrict__ out, int n_tok, int nh, int nkv, int bs, int n_max,
                           int off, float scale) {
  prefill_body<HS, int8_t>(q, k, k_scale, v, v_scale, table, out, n_tok, nh, nkv, bs, n_max, off,
                           scale, nullptr);
}

// C: the cache's element type (bf16, or int8 codes with k_scale/v_scale);
// ws: null, or (bf16) the workspace of a split launch: (nkv, row tiles, 2,
// 64, HS + 2) fp32
template <int HS, typename C>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* table, void* out, int n_tok, int nh, int nkv, int bs,
           int n_max, int off, float scale, float* ws, void* stream) {
  static size_t cap[64] = {};
  const size_t smem = sizeof(Smem<HS, C>) + 1024;  // + room to align the base to 1024
  const int rows = n_tok * (nh / nkv);
  const dim3 grid(nkv, (rows + kRows - 1) / kRows);
  if constexpr (std::is_same<C, int8_t>::value) {
    const int err = flash::set_smem(prefill_kernel_sm90_q8<HS>, smem, cap);
    if (err) return err;
    prefill_kernel_sm90_q8<HS><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const bf16*)q, (const int8_t*)k, (const float*)k_scale, (const int8_t*)v,
        (const float*)v_scale, (const int*)table, (bf16*)out, n_tok, nh, nkv, bs, n_max, off,
        scale);
  } else {
    const int err = flash::set_smem(prefill_kernel_sm90<HS>, smem, cap);
    if (err) return err;
    const dim3 halves(grid.x, grid.y, ws != nullptr ? 2 : 1);
    prefill_kernel_sm90<HS><<<halves, kThreads, smem, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)table, (bf16*)out, n_tok, nh,
        nkv, bs, n_max, off, scale, ws);
    if constexpr (HS == 32) {  // the C entry hands the other widths no ws
      if (ws != nullptr)
        prefill_combine<HS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(ws, (bf16*)out, n_tok,
                                                                        nh, nkv);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace prefill_sm90

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (the wgmma kernel at hs
// 32, 64 and 128, the FMA kernel otherwise), picked before launch. q/out
// (1, n_tok, nh, hs), 16-byte
// aligned; k/v pools (n_blocks, bs, nkv, hs) of the same dtype; table
// (n_max,) int32 of the one sequence. n_split 2 (the wrapper's
// `prefill_splits`, ops/flash_decode.py) splits the key tiles of each of the
// bf16 hs-32 kernel's (row tile, kv head) over two CTAs that write their
// partials to ws ((nkv, row tiles, 2, 64, 34) fp32), merged by
// `prefill_combine`; every other call takes n_split 1 (ws unused).
// Returns the launch's cudaError_t (0 = success).
extern "C" int paged_prefill_attn(int dtype, const void* q, const void* k,
                                  const void* v, const void* table, void* out,
                                  int n_tok, int nh, int nkv, int hs, int bs,
                                  int n_max, int off, float scale, float* ws,
                                  int n_split, void* stream) {
  if (n_split != 1 && !(n_split == 2 && ws != nullptr && dtype == 1 && hs == 32))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, float>(q, k, nullptr, v, nullptr, table, out, n_tok,
                                nh, nkv, hs, bs, n_max, off, scale, stream);
  if (dtype == 1 && hs == 32)
    return prefill_sm90::launch<32, __nv_bfloat16>(q, k, nullptr, v, nullptr,
                                                   table, out, n_tok, nh, nkv,
                                                   bs, n_max, off, scale,
                                                   n_split == 2 ? ws : nullptr,
                                                   stream);
  if (dtype == 1 && hs == 64)
    return prefill_sm90::launch<64, __nv_bfloat16>(q, k, nullptr, v, nullptr,
                                                   table, out, n_tok, nh, nkv,
                                                   bs, n_max, off, scale,
                                                   nullptr, stream);
  if (dtype == 1 && hs == 128)
    return prefill_sm90::launch<128, __nv_bfloat16>(q, k, nullptr, v, nullptr,
                                                    table, out, n_tok, nh,
                                                    nkv, bs, n_max, off,
                                                    scale, nullptr, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, nullptr, v, nullptr, table, out, n_tok, nh, nkv, hs, bs, n_max,
        off, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The int8 cache: k/v pools of int8 codes, k_scale/v_scale (n_blocks, bs,
// nkv, 1) float32; everything else as paged_prefill_attn. bf16 at hs 64
// and 128 runs the wgmma kernel (`prefill_kernel_sm90_q8`), fp32 and other
// bf16 head sizes (32 included: no served path reaches an int8 cache at
// head size 32) the FMA kernel.
extern "C" int paged_prefill_attn_q8(int dtype, const void* q, const void* k,
                                     const void* k_scale, const void* v,
                                     const void* v_scale, const void* table,
                                     void* out, int n_tok, int nh, int nkv,
                                     int hs, int bs, int n_max, int off,
                                     float scale, void* stream) {
  if (dtype == 0)
    return launch<float, int8_t>(q, k, k_scale, v, v_scale, table, out, n_tok,
                                 nh, nkv, hs, bs, n_max, off, scale, stream);
  if (dtype == 1 && hs == 64)
    return prefill_sm90::launch<64, int8_t>(q, k, k_scale, v, v_scale, table,
                                            out, n_tok, nh, nkv, bs, n_max,
                                            off, scale, nullptr, stream);
  if (dtype == 1 && hs == 128)
    return prefill_sm90::launch<128, int8_t>(q, k, k_scale, v, v_scale, table,
                                             out, n_tok, nh, nkv, bs, n_max,
                                             off, scale, nullptr, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, k, k_scale, v, v_scale, table,
                                         out, n_tok, nh, nkv, hs, bs, n_max,
                                         off, scale, stream);
  return (int)cudaErrorInvalidValue;
}
