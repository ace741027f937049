"""Paged flash-decode and paged chunk-prefill attention: wrappers of the
hand-written CUDA kernels (csrc/) and their plain PyTorch versions.

Counterpart of the reference package's `ops/flash_decode.py`, whose three
Pallas kernels on the serving path map to two CUDA kernels here:

* `paged_flash_decode` (reference `_paged_body`) and `flash_decode`
  (reference `_kernel`, contiguous cache) -> `paged_decode_attn`
  (csrc/paged_decode_attn.cu). One query row per sequence against its
  live cache rows [0, cache_len); a contiguous (B, S, nkv, hs) cache is a
  pool of B blocks of S rows with the table arange(B)[:, None].
* `paged_flash_prefill` (reference `_prefill_kernel`) ->
  `paged_prefill_attn` (csrc/paged_prefill_attn.cu). A T-row chunk of ONE
  sequence at a block-aligned offset, causal on global position off + t.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take; for CPU tensors it runs the plain version, which
repeats the kernel's arithmetic (fp32 scores, -1e30 masking, p rounded to
the value dtype before the PV product, fp32 normalizer) in one pass. Both
kinds of call are counted: `LAUNCHES[name]` where a kernel is launched,
`PLAIN_CALLS[name]` where its plain version runs — so a run can show its
main path went through the kernels.

The `*_usable` gates say whether the kernels take a call's shapes and
dtypes (fp32/bf16 activations, a same-dtype 16-byte aligned cache, head
size a multiple of 8, whole kv-head groups, tiles within the card's 227
KB of shared memory). A wrapper given CUDA tensors its gate declines
raises: `ops/attention_core.py` routes by shape alone, so no cached call
on the card falls quietly to a plain path.
"""

from __future__ import annotations

import torch

from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather

_NEG_INF = -1e30  # large-negative instead of -inf: masked rows stay NaN-free

#: kernel launches per kernel, counted by the wrappers
LAUNCHES = {"paged_decode_attn": 0, "paged_prefill_attn": 0}
#: plain-version calls per kernel (CPU tensors)
PLAIN_CALLS = {"paged_decode_attn": 0, "paged_prefill_attn": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024         # dynamic shared memory a block may use
_TILE = 64                       # key rows per tile (csrc kTile)
_PREFILL_ROWS = 64               # packed query rows per prefill CTA


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _smem_bytes(n_rows: int, hs: int) -> int:
    """csrc/paged_attn_common.cuh `smem_bytes`."""
    return 4 * (2 * n_rows * hs + _TILE * (hs + 1) + _TILE * hs
                + n_rows * _TILE + 3 * n_rows)


def _kernel_operands_ok(q, k, v) -> bool:
    """fp32/bf16 activations over a same-dtype cache whose rows the
    kernels can move as 16-byte vectors (head size a multiple of 8,
    16-byte aligned pools)."""
    return (q.dtype in _DTYPE_CODE and k.dtype == q.dtype
            and v.dtype == q.dtype and k.dim() == 4 and k.shape == v.shape
            and k.shape[-1] == q.shape[-1] and q.shape[-1] % 8 == 0
            and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)


def paged_flash_decode_usable(q, k, v) -> bool:
    """Decode-shaped (B, 1, nh, hs) query over (n_blocks, bs, nkv, hs)
    pools, or a contiguous (B, S, nkv, hs) cache, the decode kernel
    takes."""
    if q.dim() != 4 or q.shape[1] != 1 or not _kernel_operands_ok(q, k, v):
        return False
    nh, hs = q.shape[2], q.shape[3]
    nkv = k.shape[2]
    return nh % nkv == 0 and _smem_bytes(nh // nkv, hs) <= _SMEM_LIMIT


def paged_flash_prefill_usable(q, k, v) -> bool:
    """One sequence's (1, T>1, nh, hs) chunk the prefill kernel takes."""
    if q.dim() != 4 or q.shape[0] != 1 or q.shape[1] <= 1 \
            or not _kernel_operands_ok(q, k, v):
        return False
    nh, hs = q.shape[2], q.shape[3]
    return nh % k.shape[2] == 0 and \
        _smem_bytes(_PREFILL_ROWS, hs) <= _SMEM_LIMIT


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _softmax_p(s, valid, v_dtype):
    """Masked one-pass softmax with the kernels' arithmetic: -1e30
    masking, fp32 normalizer `l`, and p rounded to the value dtype as the
    PV product sees it. `s` (..., S) fp32 scores; `valid` broadcasts
    against it. Returns (p, l), p unnormalized."""
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p.to(v_dtype).float()
    return p, l


def _decode_plain(q, kl, vl, cache_len, scale):
    """q (B, nh, hs) against logical views kl/vl (B, S, nkv, hs) with live
    rows [0, cache_len)."""
    B, nh, hs = q.shape
    S, nkv = kl.shape[1], kl.shape[2]
    rep = nh // nkv
    live = torch.arange(S, device=q.device)[None, :] < \
        cache_len.reshape(B, 1).to(q.device)                  # (B, S)
    # rows past cache_len are never read by the kernel: zero them so
    # garbage there cannot turn 0 * x into NaN
    vf = torch.where(live[:, :, None, None], vl.float(),
                     torch.zeros((), device=q.device))
    qf = q.float().reshape(B, nkv, rep, hs)
    s = torch.einsum("bgrh,bsgh->bgrs", qf, kl.float()) * scale
    p, l = _softmax_p(s, live[:, None, None, :], vl.dtype)
    out = torch.einsum("bgrs,bsgh->bgrh", p, vf) / l.clamp_min(1e-30)
    return out.reshape(B, nh, hs).to(q.dtype)


def paged_flash_decode_plain(q, k, v, block_tables, cache_len, *, scale):
    """Plain version of `paged_decode_attn` over a paged pool."""
    PLAIN_CALLS["paged_decode_attn"] += 1
    return _decode_plain(q, paged_gather(k, block_tables),
                         paged_gather(v, block_tables), cache_len, scale)


def flash_decode_plain(q, k, v, cache_len, *, scale):
    """Plain version of `paged_decode_attn` over a contiguous cache."""
    PLAIN_CALLS["paged_decode_attn"] += 1
    return _decode_plain(q, k, v, cache_len, scale)


def paged_flash_prefill_plain(q, k, v, block_tables, q_offset: int, *,
                              scale):
    """Plain version of `paged_prefill_attn`."""
    PLAIN_CALLS["paged_prefill_attn"] += 1
    _, T, nh, hs = q.shape
    kl = paged_gather(k, block_tables.reshape(1, -1))[0]      # (S, nkv, hs)
    vl = paged_gather(v, block_tables.reshape(1, -1))[0]
    S, nkv = kl.shape[0], kl.shape[1]
    rep = nh // nkv
    qpos = q_offset + torch.arange(T, device=q.device)
    valid = torch.arange(S, device=q.device)[None, :] <= qpos[:, None]
    seen = torch.arange(S, device=q.device) < q_offset + T
    vf = torch.where(seen[:, None, None], vl.float(),
                     torch.zeros((), device=q.device))
    qf = q[0].float().reshape(T, nkv, rep, hs)
    s = torch.einsum("tgrh,sgh->gtrs", qf, kl.float()) * scale
    p, l = _softmax_p(s, valid[None, :, None, :], vl.dtype)
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


def _launch_decode(q, k, v, tables, cache_len, scale) -> torch.Tensor:
    """paged_decode_attn over pools k/v (n_blocks, bs, nkv, hs)."""
    from distributed_pytorch_tpu_torch.ops import cuda_build
    if not paged_flash_decode_usable(q[:, None], k, v):
        raise ValueError(
            f"paged_decode_attn does not take q {tuple(q.shape)} "
            f"{q.dtype} with a {tuple(k.shape)} {k.dtype} cache")
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    cache_len = cache_len.to(device=q.device, dtype=torch.int32) \
        .reshape(-1).contiguous()
    _check(q, k, v, tables, cache_len)
    B, nh, hs = q.shape
    if tables.dim() != 2 or tables.shape[0] != B or cache_len.numel() != B:
        raise ValueError(f"need a (B, max_blocks) table and (B,) lengths "
                         f"for B={B}, got {tuple(tables.shape)} and "
                         f"{tuple(cache_len.shape)}")
    bs, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = cuda_build.load("paged_decode_attn")
    with torch.cuda.device(q.device):
        err = lib.paged_decode_attn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            tables.data_ptr(), cache_len.data_ptr(), out.data_ptr(), B, nh,
            nkv, hs, bs, tables.shape[1], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attn launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["paged_decode_attn"] += 1
    return out


def paged_flash_decode(q, k, v, block_tables, cache_len, *, scale):
    """Single-token attention over a PAGED cache: q (B, nh, hs) against
    (n_blocks, bs, nkv, hs) pools through `block_tables` (B, max_blocks)
    int32, live rows [0, cache_len) per sequence. Returns (B, nh, hs)."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k, v, block_tables, cache_len,
                                        scale=scale)
    return _launch_decode(q, k, v, block_tables, cache_len, scale)


def flash_decode(q, k, v, cache_len, *, scale):
    """Single-token attention over a contiguous (B, S, nkv, hs) cache with
    live rows [0, cache_len) per sequence. Returns (B, nh, hs)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, cache_len, scale=scale)
    table = torch.arange(q.shape[0], dtype=torch.int32,
                         device=q.device)[:, None]
    return _launch_decode(q, k, v, table, cache_len, scale)


def paged_flash_prefill(q, k, v, block_tables, q_offset: int, *, scale):
    """Chunk attention over a PAGED cache: q (1, T, nh, hs), rows at
    global positions [q_offset, q_offset + T) already written to the pool,
    attending causally over the sequence's blocks (`block_tables`
    (1, max_blocks) int32). Returns (1, T, nh, hs)."""
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, k, v, block_tables, q_offset,
                                         scale=scale)
    from distributed_pytorch_tpu_torch.ops import cuda_build
    if not paged_flash_prefill_usable(q, k, v):
        raise ValueError(
            f"paged_prefill_attn does not take q {tuple(q.shape)} "
            f"{q.dtype} with a {tuple(k.shape)} {k.dtype} cache")
    q = q.contiguous()
    table = block_tables.to(torch.int32).reshape(-1).contiguous()
    _check(q, k, v, table)
    _, T, nh, hs = q.shape
    bs, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = cuda_build.load("paged_prefill_attn")
    with torch.cuda.device(q.device):
        err = lib.paged_prefill_attn(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            table.data_ptr(), out.data_ptr(), T, nh, nkv, hs, bs,
            table.shape[0], int(q_offset), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attn launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["paged_prefill_attn"] += 1
    return out
