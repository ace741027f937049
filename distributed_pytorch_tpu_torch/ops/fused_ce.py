"""Fused cross-entropy: the weight-tied lm-head product and the softmax /
cross-entropy reduction in one streaming kernel, so the (n, V) logits never
exist in device memory. Wrappers of the hand-written CUDA kernels
(csrc/fused_ce_fwd.cu, csrc/fused_ce_bwd.cu), their plain PyTorch
versions, and the autograd glue.

Counterpart of the reference package's `ops/fused_ce.py`:

* `fused_ce_fwd` (reference `_fwd_kernel` :84 -> `_fwd` :112): per-token
  nll = lse - s[target] and lse = logsumexp(s), s = x W^T in fp32.
* `fused_ce_bwd_dx` (reference `_bwd_dx_kernel` :153) and
  `fused_ce_bwd_dw` (`_bwd_dw_kernel` :171): dx = dl W and dW = dl^T x with
  dl = (exp(s - lse) - onehot(t)) * coef, s recomputed from x and W.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take (dtypes other than fp32/bf16, mixed dtypes, C not a
multiple of 128, non-contiguous or misaligned operands); for
CPU tensors it runs the plain version, which repeats the kernel's
arithmetic over the whole logits matrix: fp32 scores from the operands'
values, lse = m + log(max(l, 1e-30)), dl rounded to the operand dtype
before each product, fp32 accumulation. `LAUNCHES[name]` counts kernel
launches, `PLAIN_CALLS[name]` plain-version calls; `DEGRADED` counts losses
that asked for `loss_impl='pallas'` and took the chunked path because the
reference's gate refused their shape or dtype, the vocab-parallel loss
under a 'model' axis or the sequence-parallel loss under a 'seq' axis,
which the same gate sends off the kernels (models/gpt.py). The kernels
take every width that gate accepts. Each C entry picks a kernel by dtype
and width before launch (the libraries' `fused_ce_fwd_plan` and
`fused_ce_bwd_plan` name it): bf16 at C <= 1024 runs the Hopper kernel
`ce_kernel_sm90` (wgmma on a TMA ring, csrc/fused_ce_sm90.cuh); wider bf16
and fp32 run `ce_kernel`, which streams C in chunks of at most 768
columns (csrc/fused_ce_common.cuh).

The kernels take the vocabulary as it is: columns past V are masked, so W
is never padded on the host (the reference's `_pad_vocab` :261). Under a
data-parallel recipe each rank runs the kernels over its own rows, as the
reference's `shard_map` over the 'data' mesh axis does (:322-332), and the
mean's denominator is the global valid count (ops/losses.py
`mean_denominator`).
"""

from __future__ import annotations

import torch

from distributed_pytorch_tpu_torch import config
from distributed_pytorch_tpu_torch.ops.losses import mean_denominator

DEFAULT_BLOCK_N = config.knob("CE_BLOCK_N")     # tokens, for the gate

#: kernel launches per kernel, counted by the wrappers
LAUNCHES = {"fused_ce_fwd": 0, "fused_ce_bwd_dx": 0, "fused_ce_bwd_dw": 0}
#: plain-version calls per kernel (CPU tensors)
PLAIN_CALLS = {"fused_ce_fwd": 0, "fused_ce_bwd_dx": 0, "fused_ce_bwd_dw": 0}
#: losses degraded from loss_impl='pallas': to the chunked path by the
#: shape and dtype gate, to the vocab-parallel loss under tensor
#: parallelism (the reference's gate, models/gpt.py)
DEGRADED = {"chunked": 0, "vocab_parallel": 0, "sequence_parallel": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, DEGRADED):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# the reference's gate
# ---------------------------------------------------------------------------

def _pick(n: int, preferred: int) -> int:
    """Largest divisor of n that is <= preferred and a multiple of 8;
    0 when no such divisor exists (incl. n == 0, e.g. an eval batch
    smaller than the data-axis size leaving zero local tokens)."""
    if n < 8:
        return 0
    b = min(preferred, n)
    while b > 8 and n % b != 0:
        b -= 8
    return b if (n % b == 0 and b % 8 == 0) else 0


def pallas_ce_usable(n_tokens: int, n_embd: int, dtype) -> bool:
    """Static gate: shapes/dtypes the kernel handles."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if n_embd % 128 != 0:          # lane-dim multiple (C is the minor dim)
        return False
    return bool(_pick(n_tokens, DEFAULT_BLOCK_N))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(x, w):
    """fp32 scores x W^T (n, V) from the operands' values."""
    return x.float() @ w.float().t()


def _onehot(t, V):
    """(n, V) fp32 with 1 where the column equals the target (a target
    outside [0, V) matches nothing)."""
    col = torch.arange(V, device=t.device)
    return (col[None, :] == t.long()[:, None]).float()


def fused_ce_fwd_plain(x, w, t):
    """Plain version of `fused_ce_fwd`: (nll, lse) (n,) fp32."""
    PLAIN_CALLS["fused_ce_fwd"] += 1
    s = _scores(x, w)
    m = s.amax(dim=-1)
    l = torch.exp(s - m[:, None]).sum(dim=-1)
    lse = m + torch.log(l.clamp_min(1e-30))
    tgt = (s * _onehot(t, w.shape[0])).sum(dim=-1)
    return lse - tgt, lse


def _dlogits(x, w, t, lse, coef):
    """(n, V) dlogits (exp(s - lse) - onehot(t)) * coef, fp32."""
    p = torch.exp(_scores(x, w) - lse.float()[:, None])
    return (p - _onehot(t, w.shape[0])) * coef.float()[:, None]


def fused_ce_bwd_dx_plain(x, w, t, lse, coef):
    """Plain version of `fused_ce_bwd_dx`: dx (n, C) in x's dtype."""
    PLAIN_CALLS["fused_ce_bwd_dx"] += 1
    dl = _dlogits(x, w, t, lse, coef).to(w.dtype).float()
    return (dl @ w.float()).to(x.dtype)


def fused_ce_bwd_dw_plain(x, w, t, lse, coef):
    """Plain version of `fused_ce_bwd_dw`: dW (V, C) in w's dtype."""
    PLAIN_CALLS["fused_ce_bwd_dw"] += 1
    dl = _dlogits(x, w, t, lse, coef).to(x.dtype).float()
    return (dl.t() @ x.float()).to(w.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, x, w, t, *rows):
    """Raise unless the kernel takes these operands: x (n, C) and w (V, C)
    contiguous, 16-byte aligned, both fp32 or both bf16, C a multiple of
    128; t (n,) int32 and the per-token `rows` (n,)
    fp32, contiguous; all CUDA tensors on one device."""
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name} takes fp32 or bf16 x and w of one dtype, "
                         f"got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (n, C) and (V, C)")
    if x.shape[1] % 128 or x.shape[1] == 0:
        raise ValueError(f"{name}: C = {x.shape[1]} is not a multiple of 128")
    n = x.shape[0]
    if t.shape != (n,) or t.dtype != torch.int32:
        raise ValueError(f"{name}: targets must be (n,) int32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    for r in rows:
        if r.shape != (n,) or r.dtype != torch.float32:
            raise ValueError(f"{name}: lse/coef must be (n,) fp32, got "
                             f"{tuple(r.shape)} {r.dtype}")
    for a in (x, w, t, *rows):
        if a.device != x.device:
            raise ValueError("kernel operands must share one device")
        if not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous operands")
    if not x.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x.device}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be 16-byte aligned")


def _launch(name, *args, x, V):
    from distributed_pytorch_tpu_torch.ops import cuda_build
    lib = cuda_build.load(name)
    n, C = x.shape
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            _DTYPE_CODE[x.dtype], *(a.data_ptr() for a in args), n, V, C,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def fused_ce_fwd(x, w, t):
    """Per-token (nll, lse), both (n,) fp32, of x (n, C) against the tied
    embedding w (V, C) and targets t (n,) int32 (outside [0, V): nll = lse)."""
    if x.device.type == "cpu":
        return fused_ce_fwd_plain(x, w, t)
    _check("fused_ce_fwd", x, w, t)
    nll = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    _launch("fused_ce_fwd", x, w, t, nll, lse, x=x, V=w.shape[0])
    return nll, lse


def fused_ce_bwd_dx(x, w, t, lse, coef):
    """dx (n, C) in x's dtype from the forward's lse and coef = d loss /
    d nll, both (n,) fp32."""
    if x.device.type == "cpu":
        return fused_ce_bwd_dx_plain(x, w, t, lse, coef)
    _check("fused_ce_bwd_dx", x, w, t, lse, coef)
    dx = torch.empty_like(x)
    _launch("fused_ce_bwd_dx", x, w, t, lse, coef, dx, x=x, V=w.shape[0])
    return dx


def fused_ce_bwd_dw(x, w, t, lse, coef):
    """dW (V, C) in w's dtype from the forward's lse and coef."""
    if x.device.type == "cpu":
        return fused_ce_bwd_dw_plain(x, w, t, lse, coef)
    _check("fused_ce_bwd_dw", x, w, t, lse, coef)
    dw = torch.empty_like(w)
    _launch("fused_ce_bwd_dw", x, w, t, lse, coef, dw, x=x, V=w.shape[0])
    return dw


# ---------------------------------------------------------------------------
# autograd over per-token nll
# ---------------------------------------------------------------------------

class _CENll(torch.autograd.Function):
    """Per-token nll (n,) fp32 of x (n, C), w (V, C), t (n,) int32 — the
    reference's `_ce_nll` and its VJP (:233-258). Rows whose target lies
    outside [0, V) get nll = lse; callers mask ignored rows outside, which
    also zeroes their cotangent, so the backward ignores them."""

    @staticmethod
    def forward(ctx, x, w, t):
        nll, lse = fused_ce_fwd(x, w, t)
        ctx.save_for_backward(x, w, t, lse)
        return nll

    @staticmethod
    def backward(ctx, d_nll):
        x, w, t, lse = ctx.saved_tensors
        coef = d_nll.float().contiguous()
        dx = fused_ce_bwd_dx(x, w, t, lse, coef) \
            if ctx.needs_input_grad[0] else None
        dw = fused_ce_bwd_dw(x, w, t, lse, coef) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def pallas_cross_entropy(x: torch.Tensor, embedding: torch.Tensor,
                         targets: torch.Tensor, *,
                         ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over valid targets; drop-in for fused_cross_entropy
    (ops/losses.py) with the same (B, T, C)/(V, C)/(B, T) signature. Gate
    with `pallas_ce_usable`."""
    B, T, C = x.shape
    mask = targets != ignore_index
    safe_t = torch.where(mask, targets, torch.full_like(targets, -2))
    n = B * T
    nll = _CENll.apply(x.reshape(n, C).contiguous(), embedding.contiguous(),
                       safe_t.reshape(n).to(torch.int32).contiguous())
    nll = nll.reshape(B, T)
    denom = mean_denominator(mask.sum())
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / denom
