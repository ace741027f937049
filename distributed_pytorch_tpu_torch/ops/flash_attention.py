"""Flash attention: wrappers of the hand-written CUDA kernels
(csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu), their plain PyTorch
versions, and the autograd glue.

Counterpart of the reference package's `ops/flash_attention.py`, whose six
Pallas kernel bodies map to three CUDA kernels here. The rows face (`_fwd`,
`_bwd_impl`) and the slab face (`_slab_fwd`, `_slab_bwd`) compute one
function over two layouts; the kernels read the model's own (B, T, N, H)
layout through (batch, time) strides, so they serve both:

* `flash_attn_fwd` (reference `_fwd_kernel`, `_slab_fwd_kernel`): out and
  the fp32 logsumexp `lse` of the scaled scores.
* `flash_attn_bwd_dq` (reference `_bwd_dq_kernel`, `_slab_bwd_dq_kernel`).
* `flash_attn_bwd_dkv` (reference `_bwd_dkv_kernel`,
  `_slab_bwd_dkv_kernel`), the GQA group summed in the kernel.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take (dtypes other than fp32/bf16, head sizes that are not
a multiple of 8 from 8 to 256). A head size d runs at `padded_width(d,
kernel, dtype)`, the least of the kernel's built widths in that dtype
(`WIDTHS`, the one table of them) that holds it: columns d .. width - 1
load as zeros, which add exactly 0 to every product, and no output column
past d is written, so the wrappers hand the kernels the caller's own
tensors (no padded copy) and get outputs of head size d. The C entries
run each width on the instance built for it (d equal to the width) or on
its masked one (d under it), and refuse any width not in the table. In
bf16 every kernel has widths 32 (the default config's heads of 32) and
80 (the flagship with MLA, 64 + 16), and the dq 192; fp32 runs those head
sizes at 64, 128 and 256.
The dtype picks the design inside the C entry, by dtype and never as a fallback: bf16 runs on tensor cores (wgmma on TMA-fed shared
memory, csrc/flash_attn_sm90.cuh and csrc/sm90_common.cuh), fp32 on the
FMA design (csrc/flash_attn_common.cuh), since tensor cores take fp32
only as TF32. For CPU tensors a wrapper runs the plain version, which repeats the
kernel's arithmetic in one pass: fp32 scores, masked scores -1e30, the
normalizer over the undropped p, p (and dS) rounded to the operand dtype
before each product, lse = m + log(max(l, 1e-30)). Both kinds of call are
counted: `LAUNCHES[name]` where a kernel is launched, `PLAIN_CALLS[name]`
where its plain version runs.

Dropout: `seed` is an explicit (2,) int32 tensor drawn by the caller, and
the keep-mask of element (row b*nh + h, query position, key position) is
`dropout_bits(...) >= dropout_threshold(rate)` — the reference's
`_mix_bits` bit for bit, so both packages draw the same mask from the same
seed, and the backward regenerates it without storing it. A call over a
slice of the heads (a tensor-parallel rank's nh / tp heads) passes
`head_offset` (its first head) and `total_heads` (the whole call's nh):
its row is then b * total_heads + head_offset + h, so it draws the slice
of the whole call's mask and the mask does not change with the tensor-
parallel size. A call over a block of a longer sequence (a ring
attention hop, ops/ring_attention.py) passes `q_pos0` and `k_pos0`, the
global positions of its first query and first key: element (i, j) is then
keyed on (q_pos0 + i, k_pos0 + j), so the hops together draw the whole
sequence's mask (the reference's `_hop_dropout_mask`). The mask is
keyed on absolute coordinates, so tile sizes do not change it; the
reference's TPU tile knobs (FLASH_BLOCK_Q/K/H, FLASH_LAYOUT, the VMEM
budget) have no counterpart.

Layouts: q (B, T, nh, D); k, v (B, S, nkv, D), nh a multiple of nkv. The
kernels return lse as (B, nh, T); `flash_attention_lse` returns it as
(B, T, nh), as the reference does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_NEG_INF = -1e30  # large-negative instead of -inf: masked rows stay NaN-free
_M32 = 0xFFFFFFFF

#: kernel launches per kernel, counted by the wrappers
LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
            "flash_attn_bwd_dkv": 0}
#: plain-version calls per kernel (CPU tensors)
PLAIN_CALLS = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
               "flash_attn_bwd_dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the widths each kernel is built at, by dtype; its C entry dispatches
#: these and refuses any other
WIDTHS = {
    "flash_attn_fwd": {torch.float32: (64, 128, 256),
                       torch.bfloat16: (32, 64, 80, 128, 256)},
    "flash_attn_bwd_dq": {torch.float32: (64, 128, 256),
                          torch.bfloat16: (32, 64, 80, 128, 192, 256)},
    "flash_attn_bwd_dkv": {torch.float32: (64, 128, 256),
                           torch.bfloat16: (32, 64, 80, 128, 256)}}
#: the largest head size every kernel takes in every dtype
MAX_HEAD_SIZE = min(ws[-1] for by_dtype in WIDTHS.values()
                    for ws in by_dtype.values())


def head_size_ok(d: int) -> bool:
    """Whether the kernels run head size `d`: a multiple of 8 (16-byte
    rows in bf16, as the TMA maps' head stride needs; the reference's gate
    asks the same) from 8 to MAX_HEAD_SIZE."""
    return d % 8 == 0 and 8 <= d <= MAX_HEAD_SIZE


def padded_width(d: int, kernel: str, dtype: torch.dtype) -> int:
    """The built width `kernel` runs head size `d` at in `dtype`: the
    least of its WIDTHS that holds it."""
    if not head_size_ok(d):
        raise ValueError(f"the flash kernels take head sizes that are "
                         f"multiples of 8 from 8 to {MAX_HEAD_SIZE}, not {d}")
    return next(w for w in WIDTHS[kernel][dtype] if d <= w)


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# dropout mask
# ---------------------------------------------------------------------------

def dropout_bits(seed0, seed1, row, qpos, kpos) -> torch.Tensor:
    """The reference's `_mix_bits` (flash_attention.py:118-136) bit for
    bit: a uint32 hash of (attention row, query position, key position)
    and the seed, computed in int64 with `& 0xFFFFFFFF` after every product
    and sum. Arguments are ints or int tensors that broadcast."""
    dev = next((a.device for a in (seed0, seed1, row, qpos, kpos)
                if isinstance(a, torch.Tensor)), None)

    def u(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev) & _M32

    x = (u(row) * 0x9E3779B1) & _M32
    x = x ^ ((u(qpos) * 0x85EBCA6B) & _M32)
    x = x ^ ((u(kpos) * 0xC2B2AE35) & _M32)
    x = x ^ u(seed0)
    x = (x + u(seed1) * 0x27D4EB2F) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """uint32 threshold with P(bits < t) = rate
    (flash_attention.py:139-141)."""
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def _keep_scale(rate: float) -> float:
    """1 / (1 - rate) as the reference's fp32 division computes it."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def keep_mask(seed, rate: float, B: int, nh: int, T: int, S: int,
              device=None, head_offset: int = 0, total_heads=None,
              q_pos0: int = 0, k_pos0: int = 0) -> torch.Tensor:
    """The scaled keep-mask (B, nh, T, S) fp32: 1/(1 - rate) where
    `dropout_bits` of (b*total_heads + head_offset + h, q_pos0 + t,
    k_pos0 + s) reaches the threshold, else 0 (`total_heads` defaults to
    nh)."""
    seed = torch.as_tensor(seed, device=device).long()
    row = (torch.arange(B, device=device).reshape(B, 1, 1, 1)
           * (nh if total_heads is None else total_heads) + head_offset
           + torch.arange(nh, device=device).reshape(1, nh, 1, 1))
    bits = dropout_bits(seed[0], seed[1], row,
                        q_pos0 + torch.arange(T, device=device)[:, None],
                        k_pos0 + torch.arange(S, device=device))
    return (bits >= dropout_threshold(rate)).float() * _keep_scale(rate)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, scale, causal):
    """Masked fp32 scores (B, nkv, rep, T, S) of q (B, T, nh, D) against
    k (B, S, nkv, D); GQA groups query heads h = g*rep + r on kv head g."""
    B, T, nh, D = q.shape
    S, nkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, T, nkv, nh // nkv, D)
    s = torch.einsum("btgrd,bsgd->bgrts", qg, k.float()) * scale
    if causal:
        valid = torch.arange(S, device=q.device)[None, :] <= \
            torch.arange(T, device=q.device)[:, None]
        s = torch.where(valid, s, torch.full((), _NEG_INF, device=q.device))
    return s


def _group(x, nkv):
    """(B, nh, T) -> (B, nkv, rep, T, 1)."""
    B, nh, T = x.shape
    return x.reshape(B, nkv, nh // nkv, T, 1)


def _mask_g(seed, rate, q, nkv, S, coords):
    """The keep-mask grouped as the scores; `coords` = (head_offset,
    total_heads, q_pos0, k_pos0)."""
    B, T, nh, _ = q.shape
    return keep_mask(seed, rate, B, nh, T, S, q.device, *coords) \
        .reshape(B, nkv, nh // nkv, T, S)


def flash_attn_fwd_plain(q, k, v, seed=None, *, scale, causal=True,
                         dropout_rate=0.0, head_offset=0, total_heads=None,
                         q_pos0=0, k_pos0=0):
    """Plain version of `flash_attn_fwd`: (out (B, T, nh, D), lse
    (B, nh, T) fp32)."""
    PLAIN_CALLS["flash_attn_fwd"] += 1
    B, T, nh, D = q.shape
    nkv = k.shape[2]
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_rate > 0.0:
        p = p * _mask_g(seed, dropout_rate, q, nkv, k.shape[1],
                        (head_offset, total_heads, q_pos0, k_pos0))
    pv = torch.einsum("bgrts,bsgd->bgrtd", p.to(v.dtype).float(), v.float())
    out = (pv / l).permute(0, 3, 1, 2, 4).reshape(B, T, nh, D)
    lse = (m + torch.log(l)).reshape(B, nh, T)
    return out.to(q.dtype), lse


def _bwd_plain(q, k, v, dout, lse, delta, seed, scale, causal, rate,
               coords):
    """(p * mask, dS) (B, nkv, rep, T, S) fp32, as both backward kernels
    form them."""
    nkv = k.shape[2]
    p = torch.exp(_scores(q, k, scale, causal) - _group(lse, nkv))
    B, T, nh, D = q.shape
    dog = dout.float().reshape(B, T, nkv, nh // nkv, D)
    dp = torch.einsum("btgrd,bsgd->bgrts", dog, v.float())
    pm = p
    if rate > 0.0:
        mask = _mask_g(seed, rate, q, nkv, k.shape[1], coords)
        pm = p * mask
        dp = dp * mask
    return pm, p * (dp - _group(delta, nkv))


def flash_attn_bwd_dq_plain(q, k, v, dout, lse, delta, seed=None, *, scale,
                            causal=True, dropout_rate=0.0, head_offset=0,
                            total_heads=None, q_pos0=0, k_pos0=0):
    """Plain version of `flash_attn_bwd_dq`: dq (B, T, nh, D)."""
    PLAIN_CALLS["flash_attn_bwd_dq"] += 1
    _, ds = _bwd_plain(q, k, v, dout, lse, delta, seed, scale, causal,
                       dropout_rate, (head_offset, total_heads, q_pos0,
                                      k_pos0))
    dq = torch.einsum("bgrts,bsgd->btgrd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.reshape(q.shape).to(q.dtype)


def flash_attn_bwd_dkv_plain(q, k, v, dout, lse, delta, seed=None, *, scale,
                             causal=True, dropout_rate=0.0, head_offset=0,
                             total_heads=None, q_pos0=0, k_pos0=0):
    """Plain version of `flash_attn_bwd_dkv`: (dk, dv) (B, S, nkv, D), the
    GQA group summed in fp32."""
    PLAIN_CALLS["flash_attn_bwd_dkv"] += 1
    pm, ds = _bwd_plain(q, k, v, dout, lse, delta, seed, scale, causal,
                        dropout_rate, (head_offset, total_heads, q_pos0,
                                       k_pos0))
    B, T, nh, D = q.shape
    nkv = k.shape[2]
    qg = q.float().reshape(B, T, nkv, nh // nkv, D)
    dog = dout.float().reshape(B, T, nkv, nh // nkv, D)
    dk = torch.einsum("bgrts,btgrd->bsgd", ds.to(q.dtype).float(), qg) * scale
    dv = torch.einsum("bgrts,btgrd->bsgd", pm.to(dout.dtype).float(), dog)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def flash_attention_usable(q, k, v) -> bool:
    """Whether the kernels take these operands: fp32/bf16 q, k, v of one
    dtype, a head size `head_size_ok` takes, whole kv-head groups."""
    return (q.dim() == 4 and k.dim() == 4 and k.shape == v.shape
            and q.dtype in _DTYPE_CODE and k.dtype == q.dtype
            and v.dtype == q.dtype and head_size_ok(q.shape[-1])
            and k.shape[-1] == q.shape[-1] and k.shape[0] == q.shape[0]
            and q.shape[2] % k.shape[2] == 0)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """`x` contiguous from a 16-byte aligned address, copied only where
    needed (a contiguous view may start off a 16-byte boundary)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _strided(x: torch.Tensor) -> torch.Tensor:
    """`x` itself when the kernels can read it through (batch, time)
    strides — heads and head dims packed, base and row strides 16-byte
    aligned, as the FMA kernels' vector loads and the bf16 kernels' TMA
    maps need — else an aligned contiguous copy."""
    el = x.element_size()
    if (x.stride(3) == 1 and x.stride(2) == x.shape[3]
            and x.data_ptr() % 16 == 0 and (x.stride(0) * el) % 16 == 0
            and (x.stride(1) * el) % 16 == 0):
        return x
    return _aligned(x)


def _prepare(name, q, k, v, seed, rate, coords, *more):
    """Check the operands of kernel `name`; returns the strided views, the
    device seed and the dims array. `coords` = (head_offset, total_heads,
    q_pos0, k_pos0): q's heads are heads head_offset .. of a call over
    total_heads (None: q's own nh), its first query and key the global
    positions q_pos0 and k_pos0 of the dropout mask."""
    if not q.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{q.device}")
    if not flash_attention_usable(q, k, v):
        raise ValueError(
            f"{name} does not take q {tuple(q.shape)} {q.dtype} with k/v "
            f"{tuple(k.shape)} {k.dtype} (fp32/bf16, head size a multiple "
            f"of 8 from 8 to {MAX_HEAD_SIZE}, nh a multiple of nkv)")
    for t in (k, v, *more):
        if t.device != q.device:
            raise ValueError("kernel operands must share one device")
    if rate > 0.0:
        if seed is None:
            raise ValueError("dropout needs a (2,) int32 seed")
        seed = seed.to(device=q.device, dtype=torch.int32).contiguous()
        if seed.numel() != 2:
            raise ValueError(f"seed must hold 2 values, got {seed.numel()}")
    else:
        seed = None
    B, T, nh, _ = q.shape
    h0, n_all = coords[0], nh if coords[1] is None else coords[1]
    if not 0 <= h0 <= n_all - nh:
        raise ValueError(f"{name}: heads {h0} .. {h0 + nh - 1} are not "
                         f"heads of a call over {n_all}")
    if coords[2] < 0 or coords[3] < 0:
        raise ValueError(f"{name}: position offsets {coords[2:]} must not "
                         "be negative")
    dims = (ctypes.c_int * 11)(B, T, k.shape[1], nh, k.shape[2], 0, int(
        rate > 0.0), n_all, h0, coords[2], coords[3])
    return _strided(q), _strided(k), _strided(v), seed, dims


def _launch(name, fn_args, q, dims, strides, seed, scale, causal, rate):
    from distributed_pytorch_tpu_torch.ops import cuda_build
    dims[5] = int(causal)
    lib = cuda_build.load(name)
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            _DTYPE_CODE[q.dtype], padded_width(q.shape[3], name, q.dtype),
            q.shape[3],
            *fn_args,
            None if seed is None else seed.data_ptr(), dims,
            (ctypes.c_longlong * 8)(*strides), float(scale),
            dropout_threshold(rate) if rate > 0.0 else 0,
            _keep_scale(rate) if rate > 0.0 else 1.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def flash_attn_fwd(q, k, v, seed=None, *, scale, causal=True,
                   dropout_rate=0.0, head_offset=0, total_heads=None,
                   q_pos0=0, k_pos0=0):
    """Attention forward: (out (B, T, nh, D) in q's dtype, lse (B, nh, T)
    fp32). `seed` (2,) int32 feeds the dropout mask (ignored at rate 0);
    `head_offset` / `total_heads` place q's heads in a call over more,
    `q_pos0` / `k_pos0` its queries and keys in a longer sequence
    (module docstring)."""
    if q.device.type == "cpu":
        return flash_attn_fwd_plain(q, k, v, seed, scale=scale,
                                    causal=causal, dropout_rate=dropout_rate,
                                    head_offset=head_offset,
                                    total_heads=total_heads, q_pos0=q_pos0,
                                    k_pos0=k_pos0)
    q, k, v, seed, dims = _prepare("flash_attn_fwd", q, k, v, seed,
                                   dropout_rate, (head_offset, total_heads,
                                                  q_pos0, k_pos0))
    B, T, nh, D = q.shape
    out = torch.empty(B, T, nh, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, nh, T, dtype=torch.float32, device=q.device)
    _launch("flash_attn_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()),
            q, dims, (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                      v.stride(0), v.stride(1), 0, 0),
            seed, scale, causal, dropout_rate)
    return out, lse


def _bwd_operands(name, q, k, v, dout, lse, delta, seed, rate, coords):
    q, k, v, seed, dims = _prepare(name, q, k, v, seed, rate, coords, dout,
                                   lse, delta)
    B, T, nh, _ = q.shape
    if dout.shape != q.shape or lse.shape != (B, nh, T) \
            or delta.shape != (B, nh, T):
        raise ValueError(f"{name}: dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    dout = _strided(dout.to(q.dtype))
    lse = _aligned(lse.float())
    delta = _aligned(delta.float())
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
               v.stride(0), v.stride(1), dout.stride(0), dout.stride(1))
    return q, k, v, dout, lse, delta, seed, dims, strides


def flash_attn_bwd_dq(q, k, v, dout, lse, delta, seed=None, *, scale,
                      causal=True, dropout_rate=0.0, head_offset=0,
                      total_heads=None, q_pos0=0, k_pos0=0):
    """dq (B, T, nh, D) from the forward's lse and delta = rowsum(dout *
    out) - dlse, both (B, nh, T) fp32."""
    if q.device.type == "cpu":
        return flash_attn_bwd_dq_plain(q, k, v, dout, lse, delta, seed,
                                       scale=scale, causal=causal,
                                       dropout_rate=dropout_rate,
                                       head_offset=head_offset,
                                       total_heads=total_heads, q_pos0=q_pos0,
                                       k_pos0=k_pos0)
    q, k, v, dout, lse, delta, seed, dims, strides = _bwd_operands(
        "flash_attn_bwd_dq", q, k, v, dout, lse, delta, seed, dropout_rate,
        (head_offset, total_heads, q_pos0, k_pos0))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_attn_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, dims, strides, seed, scale, causal, dropout_rate)
    return dq


def flash_attn_bwd_dkv(q, k, v, dout, lse, delta, seed=None, *, scale,
                       causal=True, dropout_rate=0.0, head_offset=0,
                       total_heads=None, q_pos0=0, k_pos0=0):
    """(dk, dv) (B, S, nkv, D), each kv head's query group summed."""
    if q.device.type == "cpu":
        return flash_attn_bwd_dkv_plain(q, k, v, dout, lse, delta, seed,
                                        scale=scale, causal=causal,
                                        dropout_rate=dropout_rate,
                                        head_offset=head_offset,
                                        total_heads=total_heads, q_pos0=q_pos0,
                                        k_pos0=k_pos0)
    q, k, v, dout, lse, delta, seed, dims, strides = _bwd_operands(
        "flash_attn_bwd_dkv", q, k, v, dout, lse, delta, seed, dropout_rate,
        (head_offset, total_heads, q_pos0, k_pos0))
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch("flash_attn_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, dims, strides, seed, scale, causal, dropout_rate)
    return dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def coords_kw(coords) -> dict:
    """The wrappers' keywords of `coords` = (head_offset, total_heads,
    q_pos0, k_pos0)."""
    return dict(zip(("head_offset", "total_heads", "q_pos0", "k_pos0"),
                    coords))


class _FlashAttention(torch.autograd.Function):
    """(out, lse) with lse differentiable: its gradient folds into delta
    (flash_attention.py:460-476), so a caller that merges partial
    attentions through lse (ring attention) gets the exact gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, causal, rate, coords):
        kw = coords_kw(coords)
        out, lse = flash_attn_fwd(q, k, v, seed, scale=scale, causal=causal,
                                  dropout_rate=rate, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seed, ctx.scale, ctx.causal, ctx.rate = seed, scale, causal, rate
        ctx.kw = kw
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse.float()
        kw = dict(scale=ctx.scale, causal=ctx.causal, dropout_rate=ctx.rate,
                  **ctx.kw)
        dq = flash_attn_bwd_dq(q, k, v, dout, lse, delta, ctx.seed, **kw)
        dk, dv = flash_attn_bwd_dkv(q, k, v, dout, lse, delta, ctx.seed, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_lse(q, k, v, *, scale: float, causal: bool = True,
                        dropout_rate: float = 0.0, seed=None,
                        head_offset: int = 0, total_heads=None,
                        q_pos0: int = 0, k_pos0: int = 0):
    """Flash attention returning (out (B, T, nh, D), lse (B, T, nh) fp32);
    both outputs are differentiable. `causal=False` is full attention.
    `dropout_rate` > 0 drops attention weights inside the kernels with the
    mask of `seed` (a (2,) int32 tensor), q's heads being heads
    `head_offset` .. of a call over `total_heads` (default: q's own); lse
    is the true logsumexp of the undropped scores. `q_pos0` / `k_pos0`
    place the queries and keys in a longer sequence for the mask."""
    rate = float(dropout_rate)
    if rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 needs a (2,) int32 seed")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    out, lse = _FlashAttention.apply(q, k, v, seed, float(scale),
                                     bool(causal), rate,
                                     (int(head_offset), total_heads,
                                      int(q_pos0), int(k_pos0)))
    return out, lse.transpose(1, 2)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    q_offset=0, dropout_rate: float = 0.0, seed=None,
                    head_offset: int = 0, total_heads=None):
    """Flash attention over BTNH tensors; `q_offset` must be a static 0
    (cached offsets take the decode kernels or the naive path)."""
    if not (isinstance(q_offset, int) and q_offset == 0):
        raise ValueError("the flash kernels take a static q_offset == 0")
    out, _ = flash_attention_lse(q, k, v, scale=scale, causal=causal,
                                 dropout_rate=dropout_rate, seed=seed,
                                 head_offset=head_offset,
                                 total_heads=total_heads)
    return out
