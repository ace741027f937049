"""Paged flash-decode and paged chunk-prefill attention: wrappers of the
hand-written CUDA kernels (csrc/) and their plain PyTorch versions.

Counterpart of the reference package's `ops/flash_decode.py`, whose six
Pallas bodies on the serving path map to four CUDA kernels here:

* `paged_flash_decode` (reference `_paged_body`) and `flash_decode`
  (reference `_kernel`, contiguous cache) -> `paged_decode_attn`
  (csrc/paged_decode_attn.cu). One query row per sequence against its
  live cache rows [0, cache_len); a contiguous (B, S, nkv, hs) cache is a
  pool of B blocks of S rows with the table arange(B)[:, None]. Split-KV
  on CUDA cores: a split kernel over (sequence, kv head, 128-key split
  of the table's capacity) writes each split's unnormalized fp32
  (acc, m, l) to a (B, nh, n_split, hs + 2) workspace that the wrapper
  allocates (`decode_workspace`), and a combine kernel of the same C
  entry merges the live splits in split order. A K/V row wider than the
  split kernel holds in one warp's registers (32 vectors: 512 bytes of
  fp32 or bf16, head size > 256 in bf16, > 128 in fp32; 256 int8 codes;
  `takes_split`) takes the FMA tile kernel (`attend_rows`) instead,
  picked by the C entry before launch; it needs no workspace.
* `paged_flash_prefill` (reference `_prefill_kernel`) ->
  `paged_prefill_attn` (csrc/paged_prefill_attn.cu). A T-row chunk of ONE
  sequence at a block-aligned offset, causal on global position off + t.
  The dtype and head size pick the kernel inside the C entry, before
  launch and never as a fallback: bf16 at head size 32, 64 or 128 runs
  `prefill_kernel_sm90` (tensor cores: K/V tiles gathered through the
  block table by cp.async into a 3-stage ring, S and P V as wgmma; its
  time is the latency of each CTA's chain of key tiles, not bytes; at 32,
  where a chunk makes few CTAs, the key tiles of each row tile split over
  two CTAs, `prefill_splits`, into a workspace the wrapper allocates,
  merged by `prefill_combine`); fp32 and bf16 at other head sizes run FMA
  loops (`attend_rows`, csrc/paged_attn_common.cuh).
* The int8-cache variants (reference `_paged_body_q8`, `_kernel_q8`,
  `_prefill_kernel_q8`) -> `paged_decode_attn_q8` and
  `paged_prefill_attn_q8`, in the same two sources. Given `k_scale` /
  `v_scale` (the cache's fp32 (..., nkv, 1) scale rows, ops/quant.py),
  k/v hold int8 codes: the score is the fp32 dot of q with the codes
  times (k_scale * scale), the normalizer sums the fp32 p, and the PV
  operand is (p * v_scale) rounded to the query dtype against the codes.
  The int8 decode runs the same split-KV pair (codes as 8-byte vectors,
  dequantized in registers; the same workspace), rows past 256 codes the
  tile kernel. The int8 prefill: bf16 at head size 64 or 128 runs
  `prefill_kernel_sm90_q8` (the codes gathered by cp.async and converted
  exactly to bf16 in shared memory, the scales applied to the fp32 score
  and to p), fp32 and other head sizes (32 included) `attend_rows`.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it runs the plain version, which
repeats the kernel's arithmetic (fp32 scores, -1e30 masking, the PV
operand rounded to the activations' dtype, fp32 normalizer) in one pass.
Both kinds of call are counted: `LAUNCHES[name]` where a kernel is
launched, `PLAIN_CALLS[name]` where its plain version runs — so a run can
show its main path went through the kernels.

The `*_usable` gates say whether the kernels take a call's shapes and
dtypes (fp32/bf16 activations over a same-dtype cache, or an int8 cache
with fp32 scale rows; head size a multiple of 8, whole kv-head groups,
16-byte aligned pools, tiles within the card's 227 KB of shared memory:
the split-KV decode's merge rows for a row of at most 32 vectors, the
FMA tile kernel's K/V tiles for a wider one).
A wrapper given CUDA tensors its gate declines raises:
`ops/attention_core.py` routes by shape alone, so no cached call on the
card falls quietly to a plain path.
"""

from __future__ import annotations

import torch

from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather

_NEG_INF = -1e30  # large-negative instead of -inf: masked rows stay NaN-free

_KERNELS = ("paged_decode_attn", "paged_prefill_attn",
            "paged_decode_attn_q8", "paged_prefill_attn_q8")
#: kernel launches per kernel, counted by the wrappers
LAUNCHES = dict.fromkeys(_KERNELS, 0)
#: plain-version calls per kernel (CPU tensors)
PLAIN_CALLS = dict.fromkeys(_KERNELS, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024         # dynamic shared memory a block may use
_TILE = 64                       # key rows per tile (csrc kTile)
_PREFILL_ROWS = 64               # packed query rows per prefill CTA
_SPAN = 128                      # keys a decode split owns (csrc kSpan)
_SPLIT_WARPS = 4                 # warps of a decode split CTA (csrc kWarps)
_SPLIT_ROWS = 8                  # query rows a split CTA holds (kMaxRows)
_ROW_VECS = 32                   # widest K/V row of the split kernel, in
                                 # vectors (16 bytes, 8 for int8 codes);
                                 # wider rows take the tile kernel


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _smem_bytes(n_rows: int, hs: int, q8: bool = False) -> int:
    """csrc/paged_attn_common.cuh `smem_bytes`: fp32 q and accumulator
    rows, a K tile (rows padded by one float), a V tile, the scores, three
    row statistics, and for an int8 cache the tile's K and V scales."""
    return 4 * (2 * n_rows * hs + _TILE * (hs + 1) + _TILE * hs
                + n_rows * _TILE + 3 * n_rows + (2 * _TILE if q8 else 0))


def prefill_splits(n_tok: int, nh: int, nkv: int, hs: int, dtype,
                   n_sm: int) -> int:
    """CTAs a (64-row tile, kv head) of the prefill shares its key tiles
    between: 2 for the bf16 wgmma kernel at head size 32 where the pairs
    of such a T-row chunk's CTAs all fit on the card's `n_sm` SMs at once
    (each walks half the keys, `prefill_combine` merges them), else 1."""
    ctas = nkv * -(-n_tok * (nh // nkv) // _PREFILL_ROWS)
    return 2 if dtype == torch.bfloat16 and hs == 32 and 2 * ctas <= n_sm \
        else 1


def prefill_workspace(n_tok: int, nh: int, nkv: int, hs: int, device):
    """The split prefill's fp32 workspace: per (kv head, row tile, half)
    each packed row's unnormalized accumulator, then its running max and
    sum."""
    tiles = -(-n_tok * (nh // nkv) // _PREFILL_ROWS)
    return torch.empty(nkv, tiles, 2, _PREFILL_ROWS, hs + 2,
                       dtype=torch.float32, device=device)


def decode_splits(n_keys: int) -> int:
    """Splits of the decode kernel over a table of `n_keys` = n_max * bs
    rows (its capacity, known on the host; cache_len stays on the card)."""
    return -(-n_keys // _SPAN)


def decode_workspace(B: int, nh: int, hs: int, n_keys: int, device):
    """The decode kernel's fp32 workspace: per (sequence, head, split) the
    split's unnormalized accumulator row, then its running max and sum."""
    return torch.empty(B, nh, decode_splits(n_keys), hs + 2,
                       dtype=torch.float32, device=device)


def takes_split(hs: int, dtype) -> bool:
    """Whether K/V rows of head size `hs` in the cache dtype `dtype` take
    the split-KV decode (at most one vector a lane of a warp: 512 bytes of
    fp32 or bf16 in 16-byte vectors, 256 int8 codes in 8-byte ones) rather
    than the tile kernel."""
    vec = 8 if dtype == torch.int8 else 16
    return hs * dtype.itemsize <= _ROW_VECS * vec


def workspace_for(q, k, n_keys: int):
    """The workspace a decode launch of q (B, nh, hs) over the pool `k`
    (its dtype the cache's) hands its C entry: `decode_workspace` where the
    rows take the split kernel, None (no split count) where they take the
    tile kernel."""
    B, nh, hs = q.shape
    if not takes_split(hs, k.dtype):
        return None
    return decode_workspace(B, nh, hs, n_keys, q.device)


def _split_smem_bytes(rep: int, hs: int) -> int:
    """Shared memory of a decode split CTA: each warp's merged rows
    (acc, m, l) for the query rows it holds (rep rounded up to a power of
    two, at most _SPLIT_ROWS; more rows take further CTAs)."""
    rows = min(_SPLIT_ROWS, 1 << (rep - 1).bit_length())
    return 4 * _SPLIT_WARPS * rows * (hs + 2)


def _kernel_operands_ok(q, k, v, k_scale=None, v_scale=None) -> bool:
    """fp32/bf16 activations over a same-dtype cache, or over int8 codes
    with fp32 (..., nkv, 1) scale rows; head size a multiple of 8 (the
    kernels move rows as 16-byte vectors of fp32/bf16, 8-byte vectors of
    int8) and 16-byte aligned pools."""
    if q.dtype not in _DTYPE_CODE or k.dim() != 4 or k.shape != v.shape \
            or k.shape[-1] != q.shape[-1] or q.shape[-1] % 8 != 0 \
            or k.data_ptr() % 16 != 0 or v.data_ptr() % 16 != 0:
        return False
    if k_scale is None and v_scale is None:
        return k.dtype == q.dtype and v.dtype == q.dtype
    sshape = k.shape[:-1] + (1,)
    return (k_scale is not None and v_scale is not None
            and k.dtype == torch.int8 and v.dtype == torch.int8
            and k_scale.dtype == torch.float32
            and v_scale.dtype == torch.float32
            and k_scale.shape == sshape and v_scale.shape == sshape)


def paged_flash_decode_usable(q, k, v, k_scale=None, v_scale=None) -> bool:
    """Decode-shaped (B, 1, nh, hs) query over (n_blocks, bs, nkv, hs)
    pools, or a contiguous (B, S, nkv, hs) cache, the decode kernels
    take (int8 codes with `k_scale`/`v_scale`)."""
    if q.dim() != 4 or q.shape[1] != 1 \
            or not _kernel_operands_ok(q, k, v, k_scale, v_scale):
        return False
    nh, hs = q.shape[2], q.shape[3]
    nkv = k.shape[2]
    if nh % nkv:
        return False
    if takes_split(hs, k.dtype):
        return _split_smem_bytes(nh // nkv, hs) <= _SMEM_LIMIT
    return _smem_bytes(nh // nkv, hs, k_scale is not None) <= _SMEM_LIMIT


def paged_flash_prefill_usable(q, k, v, k_scale=None,
                               v_scale=None) -> bool:
    """One sequence's (1, T>1, nh, hs) chunk the prefill kernels take."""
    if q.dim() != 4 or q.shape[0] != 1 or q.shape[1] <= 1 \
            or not _kernel_operands_ok(q, k, v, k_scale, v_scale):
        return False
    nh, hs = q.shape[2], q.shape[3]
    return nh % k.shape[2] == 0 and \
        _smem_bytes(_PREFILL_ROWS, hs, k_scale is not None) <= _SMEM_LIMIT


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _softmax_p(s, valid, dtype, v_scale=None):
    """Masked one-pass softmax with the kernels' arithmetic: -1e30
    masking, fp32 normalizer `l` of the unrounded p, and the PV operand —
    p, times the value rows' scales for an int8 cache — rounded to the
    activations' dtype. `s` (..., S) fp32 scores; `valid` and `v_scale`
    broadcast against it. Returns (PV operand, l), unnormalized."""
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale
    return p.to(dtype).float(), l


def _decode_plain(q, kl, vl, cache_len, scale, ksl=None, vsl=None):
    """q (B, nh, hs) against logical views kl/vl (B, S, nkv, hs) with live
    rows [0, cache_len); for an int8 cache, codes with scale views ksl/vsl
    (B, S, nkv, 1)."""
    B, nh, hs = q.shape
    S, nkv = kl.shape[1], kl.shape[2]
    rep = nh // nkv
    live = torch.arange(S, device=q.device)[None, :] < \
        cache_len.reshape(B, 1).to(q.device)                  # (B, S)
    # rows past cache_len are never read by the kernel: zero them so
    # garbage there cannot turn 0 * x into NaN
    zero = torch.zeros((), device=q.device)
    vf = torch.where(live[:, :, None, None], vl.float(), zero)
    qf = q.float().reshape(B, nkv, rep, hs)
    s = torch.einsum("bgrh,bsgh->bgrs", qf, kl.float())
    vs = None
    if ksl is None:
        s = s * scale
    else:
        # one scale per (key row, kv head): (B, S, nkv, 1) -> (B, nkv, 1, S)
        s = s * (ksl[..., 0].permute(0, 2, 1)[:, :, None, :] * scale)
        vs = torch.where(live[:, :, None], vsl[..., 0], zero) \
            .permute(0, 2, 1)[:, :, None, :]
    p, l = _softmax_p(s, live[:, None, None, :], q.dtype, vs)
    out = torch.einsum("bgrs,bsgh->bgrh", p, vf) / l.clamp_min(1e-30)
    return out.reshape(B, nh, hs).to(q.dtype)


def _kname(base: str, k_scale) -> str:
    """The kernel a call runs: `base`, or its int8 variant `base_q8`."""
    return base if k_scale is None else base + "_q8"


def paged_flash_decode_plain(q, k, v, block_tables, cache_len, *, scale,
                             k_scale=None, v_scale=None):
    """Plain version of `paged_decode_attn` (`_q8` with scales) over a
    paged pool."""
    PLAIN_CALLS[_kname("paged_decode_attn", k_scale)] += 1
    ks = vs = None
    if k_scale is not None:
        ks = paged_gather(k_scale, block_tables)
        vs = paged_gather(v_scale, block_tables)
    return _decode_plain(q, paged_gather(k, block_tables),
                         paged_gather(v, block_tables), cache_len, scale,
                         ks, vs)


def flash_decode_plain(q, k, v, cache_len, *, scale, k_scale=None,
                       v_scale=None):
    """Plain version of `paged_decode_attn` (`_q8` with scales) over a
    contiguous cache."""
    PLAIN_CALLS[_kname("paged_decode_attn", k_scale)] += 1
    return _decode_plain(q, k, v, cache_len, scale, k_scale, v_scale)


def paged_flash_prefill_plain(q, k, v, block_tables, q_offset: int, *,
                              scale, k_scale=None, v_scale=None):
    """Plain version of `paged_prefill_attn` (`_q8` with scales)."""
    PLAIN_CALLS[_kname("paged_prefill_attn", k_scale)] += 1
    _, T, nh, hs = q.shape
    table = block_tables.reshape(1, -1)
    kl = paged_gather(k, table)[0]                            # (S, nkv, hs)
    vl = paged_gather(v, table)[0]
    S, nkv = kl.shape[0], kl.shape[1]
    rep = nh // nkv
    qpos = q_offset + torch.arange(T, device=q.device)
    valid = torch.arange(S, device=q.device)[None, :] <= qpos[:, None]
    seen = torch.arange(S, device=q.device) < q_offset + T
    zero = torch.zeros((), device=q.device)
    vf = torch.where(seen[:, None, None], vl.float(), zero)
    qf = q[0].float().reshape(T, nkv, rep, hs)
    s = torch.einsum("tgrh,sgh->gtrs", qf, kl.float())
    vs = None
    if k_scale is None:
        s = s * scale
    else:
        # (S, nkv, 1) scale rows -> (nkv, 1, 1, S)
        ksl = paged_gather(k_scale, table)[0, :, :, 0]
        vsl = torch.where(seen[:, None],
                          paged_gather(v_scale, table)[0, :, :, 0], zero)
        s = s * (ksl.t()[:, None, None, :] * scale)
        vs = vsl.t()[:, None, None, :]
    p, l = _softmax_p(s, valid[None, :, None, :], q.dtype, vs)
    out = torch.einsum("gtrs,sgh->tgrh", p, vf) \
        / l.permute(1, 0, 2, 3).clamp_min(1e-30)
    return out.reshape(1, T, nh, hs).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, *tensors) -> None:
    if not q.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{q.device}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("kernel operands must share one device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _describe(q, k, k_scale) -> str:
    return (f"q {tuple(q.shape)} {q.dtype} with a {tuple(k.shape)} "
            f"{k.dtype} cache" + ("" if k_scale is None else
                                  f" and {tuple(k_scale.shape)} "
                                  f"{k_scale.dtype} scales"))


def _launch_decode(q, k, v, tables, cache_len, scale, k_scale,
                   v_scale) -> torch.Tensor:
    """paged_decode_attn (`_q8` with scales) over pools k/v (n_blocks, bs,
    nkv, hs)."""
    from distributed_pytorch_tpu_torch.ops import cuda_build
    name = _kname("paged_decode_attn", k_scale)
    if not paged_flash_decode_usable(q[:, None], k, v, k_scale, v_scale):
        raise ValueError(f"{name} does not take {_describe(q, k, k_scale)}")
    q = q.contiguous()
    if q.data_ptr() % 16:               # the kernels' 16-byte loads
        q = q.clone()
    tables = tables.to(torch.int32).contiguous()
    cache_len = cache_len.to(device=q.device, dtype=torch.int32) \
        .reshape(-1).contiguous()
    scales = () if k_scale is None else (k_scale, v_scale)
    _check(q, k, v, tables, cache_len, *scales)
    B, nh, hs = q.shape
    if tables.dim() != 2 or tables.shape[0] != B or cache_len.numel() != B:
        raise ValueError(f"need a (B, max_blocks) table and (B,) lengths "
                         f"for B={B}, got {tuple(tables.shape)} and "
                         f"{tuple(cache_len.shape)}")
    bs, nkv = k.shape[1], k.shape[2]
    n_max = tables.shape[1]
    out = torch.empty_like(q)
    lib = cuda_build.load(name)
    ws = workspace_for(q, k, n_max * bs)
    kv = (k.data_ptr(), v.data_ptr()) if k_scale is None else \
        (k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr())
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            _DTYPE_CODE[q.dtype], q.data_ptr(), *kv, tables.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, nh, nkv, hs, bs, n_max,
            0 if ws is None else ws.shape[2], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def paged_flash_decode(q, k, v, block_tables, cache_len, *, scale,
                       k_scale=None, v_scale=None):
    """Single-token attention over a PAGED cache: q (B, nh, hs) against
    (n_blocks, bs, nkv, hs) pools through `block_tables` (B, max_blocks)
    int32, live rows [0, cache_len) per sequence. With `k_scale`/`v_scale`
    (n_blocks, bs, nkv, 1) fp32 the pools hold int8 codes. Returns
    (B, nh, hs)."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k, v, block_tables, cache_len,
                                        scale=scale, k_scale=k_scale,
                                        v_scale=v_scale)
    return _launch_decode(q, k, v, block_tables, cache_len, scale, k_scale,
                          v_scale)


def flash_decode(q, k, v, cache_len, *, scale, k_scale=None, v_scale=None):
    """Single-token attention over a contiguous (B, S, nkv, hs) cache with
    live rows [0, cache_len) per sequence (int8 codes with (B, S, nkv, 1)
    `k_scale`/`v_scale`). Returns (B, nh, hs)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, cache_len, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale)
    table = torch.arange(q.shape[0], dtype=torch.int32,
                         device=q.device)[:, None]
    return _launch_decode(q, k, v, table, cache_len, scale, k_scale,
                          v_scale)


def paged_flash_prefill(q, k, v, block_tables, q_offset: int, *, scale,
                        k_scale=None, v_scale=None):
    """Chunk attention over a PAGED cache: q (1, T, nh, hs), rows at
    global positions [q_offset, q_offset + T) already written to the pool,
    attending causally over the sequence's blocks (`block_tables`
    (1, max_blocks) int32). With `k_scale`/`v_scale` the pools hold int8
    codes. Returns (1, T, nh, hs)."""
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, k, v, block_tables, q_offset,
                                         scale=scale, k_scale=k_scale,
                                         v_scale=v_scale)
    from distributed_pytorch_tpu_torch.ops import cuda_build
    name = _kname("paged_prefill_attn", k_scale)
    if not paged_flash_prefill_usable(q, k, v, k_scale, v_scale):
        raise ValueError(f"{name} does not take {_describe(q, k, k_scale)}")
    q = q.contiguous()
    if q.data_ptr() % 16:               # the 16-byte copies of the kernels
        q = q.clone()
    table = block_tables.to(torch.int32).reshape(-1).contiguous()
    scales = () if k_scale is None else (k_scale, v_scale)
    _check(q, k, v, table, *scales)
    _, T, nh, hs = q.shape
    bs, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = cuda_build.load(name)
    if k_scale is None:
        kv = (k.data_ptr(), v.data_ptr())
        n_split = prefill_splits(T, nh, nkv, hs, q.dtype, torch.cuda
                                 .get_device_properties(q.device)
                                 .multi_processor_count)
        ws = prefill_workspace(T, nh, nkv, hs, q.device) if n_split == 2 \
            else None
        split = (None if ws is None else ws.data_ptr(), n_split)
    else:
        kv = (k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
              v_scale.data_ptr())
        split = ()
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            _DTYPE_CODE[q.dtype], q.data_ptr(), *kv, table.data_ptr(),
            out.data_ptr(), T, nh, nkv, hs, bs, table.shape[0],
            int(q_offset), float(scale), *split,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out
