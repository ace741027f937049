"""Cross-entropy losses for the weight-tied LM head.

Counterpart of the reference package's `ops/losses.py`
(`unchunked_cross_entropy`, `_chunk_for`, `_nll_sum_chunked`,
`fused_cross_entropy`; losses.py:47-191). `fused_cross_entropy` never
holds the whole (B, T, V) logits: the sequence axis is split into chunks
and each chunk's `logsumexp(logits) - logit[target]` runs under
`torch.utils.checkpoint`, so forward and backward each hold at most one
(B, chunk, V) block — the reference's `jax.checkpoint` + `lax.scan`, as a
Python loop.

Logits are fp32 whatever the compute dtype, as the reference's
`preferred_element_type=float32` gives them: a bf16 lm-head product
accumulates and returns in fp32 (`torch.mm(..., out_dtype=float32)` on the
card), and its backward takes the fp32 gradient back to bf16 products.
ignore_index is -1 throughout. The streaming-kernel loss
(`loss_impl='pallas'`) is ops/fused_ce.py.

Under a data-parallel recipe each rank computes its own tokens' loss, as
the reference's shard_map over 'data' does (fused_ce.py:322-332), and the
mean's denominator is the global batch's valid count over W, the number
of ranks holding different tokens (data x seq, `mean_denominator`): the
ranks' losses then average, and their gradients mean, to the global mean
over valid targets even where the ranks hold different numbers of ignored
targets (the reference's `mask.sum()` over the global batch,
fused_ce.py:336). Under sequence parallelism `sp_fused_cross_entropy` is
the reference's (losses.py:122-166): each rank chunk-scans its (B, T/sp)
tokens, the chunk re-derived for the local length.

Under tensor parallelism the tied embedding is vocab-parallel (parallel/
tensor.py) and `vocab_parallel_cross_entropy` computes the loss from the
local vocabulary rows with three all-reduces over 'model' per chunk (the
max, the sum of exponentials, the target's logit); its backward sums dx
over 'model' and keeps dW local.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from distributed_pytorch_tpu_torch.parallel import context


def mean_denominator(count: torch.Tensor) -> torch.Tensor:
    """The denominator of a mean over valid targets from this rank's valid
    `count`: max(count, 1) on one process; under a data-parallel recipe
    max(global count, 1) / W, W the data x seq ranks (one all-reduce of a
    scalar)."""
    if not context.distributed():
        return count.clamp_min(1)
    return context.batch_all_reduce_sum(count.clone()).clamp_min(1) \
        / context.batch_size()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation and an fp32 result."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _LmHead(torch.autograd.Function):
    """fp32 logits x @ emb^T from compute-dtype operands."""

    @staticmethod
    def forward(ctx, x, emb):
        ctx.save_for_backward(x, emb)
        return _mm_f32(x.reshape(-1, x.shape[-1]), emb.t()) \
            .reshape(*x.shape[:-1], emb.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, emb = ctx.saved_tensors
        g = g.reshape(-1, emb.shape[0]).to(x.dtype)
        dx = (g @ emb).reshape(x.shape)
        demb = g.t() @ x.reshape(-1, x.shape[-1])
        return dx, demb


def _logits(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """x (..., C) @ embedding^T (V, C) -> (..., V) fp32."""
    if x.dtype == torch.float32 and embedding.dtype == torch.float32:
        return x @ embedding.t()
    return _LmHead.apply(x, embedding)


def unchunked_cross_entropy(x: torch.Tensor, embedding: torch.Tensor,
                            targets: torch.Tensor, *,
                            ignore_index: int = -1) -> torch.Tensor:
    """Mean CE over valid targets from the full (B, T, V) logits (the
    semantics oracle)."""
    logits = _logits(x, embedding)
    mask = targets != ignore_index
    safe = torch.where(mask, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    denom = mean_denominator(mask.sum())
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / denom


def _chunk_for(T: int, V: int, target_tokens: int = 128,
               min_chunk: int = 16) -> int:
    """Largest divisor of T that is <= target_tokens (0 = don't chunk):
    short sequences and small vocabularies skip chunking, and a divisor
    below `min_chunk` falls back to unchunked."""
    if T <= target_tokens or V < 8192:
        return 0
    for c in range(target_tokens, min_chunk - 1, -1):
        if T % c == 0 and T // c > 1:
            return c
    return 0


def _block_nll(x_c, embedding, t_c, ignore_index: int):
    """(sum of nll over valid targets, valid count) of one T-chunk."""
    logits = _logits(x_c, embedding)                  # (B, chunk, V) fp32
    mask = t_c != ignore_index
    safe = torch.where(mask, t_c, torch.zeros_like(t_c))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, safe[..., None])[..., 0]
    nll = lse - tgt
    return torch.where(mask, nll, torch.zeros_like(nll)).sum(), mask.sum()


def _nll_sum_chunked(x: torch.Tensor, embedding: torch.Tensor,
                     targets: torch.Tensor, ignore_index: int, chunk: int):
    """(sum of nll, valid count) with the T axis chunked, each chunk's
    logits recomputed in the backward; one unchunked block when chunking
    cannot help."""
    T = x.shape[1]
    if chunk <= 0:
        chunk = _chunk_for(T, embedding.shape[0])
    if chunk <= 0 or T % chunk != 0 or T // chunk <= 1:
        return _block_nll(x, embedding, targets, ignore_index)
    total, count = 0.0, 0
    for c0 in range(0, T, chunk):
        s, n = checkpoint(_block_nll, x[:, c0:c0 + chunk], embedding,
                          targets[:, c0:c0 + chunk], ignore_index,
                          use_reentrant=False, preserve_rng_state=False)
        total, count = total + s, count + n
    return total, count


def fused_cross_entropy(x: torch.Tensor, embedding: torch.Tensor,
                        targets: torch.Tensor, *, ignore_index: int = -1,
                        chunk: int = 0) -> torch.Tensor:
    """Chunked weight-tied CE: x (B, T, C) hidden states (compute dtype),
    embedding (V, C), targets (B, T). `chunk=0` picks a divisor of T, or
    falls back to the unchunked oracle when chunking cannot help."""
    T = x.shape[1]
    if chunk <= 0:
        chunk = _chunk_for(T, embedding.shape[0])
    if chunk <= 0 or T % chunk != 0 or T // chunk <= 1:
        return unchunked_cross_entropy(x, embedding, targets,
                                       ignore_index=ignore_index)
    total, count = _nll_sum_chunked(x, embedding, targets, ignore_index,
                                    chunk)
    return total / mean_denominator(count)


def sp_fused_cross_entropy(x: torch.Tensor, embedding: torch.Tensor,
                           targets: torch.Tensor, *, ignore_index: int = -1,
                           chunk: int = 0) -> torch.Tensor:
    """Sequence-parallel chunked CE (reference losses.py:122-166): x
    (B, T/sp, C) this rank's tokens. `chunk` is sized for the whole T: one
    that does not divide the local length into more than one piece is
    re-derived for it (`_chunk_for`, or one block), and the sum and count
    reduce over data x seq (`mean_denominator`)."""
    t_local = x.shape[1]
    c = chunk if (chunk > 0 and t_local % chunk == 0
                  and t_local // chunk > 1) else 0
    total, count = _nll_sum_chunked(x, embedding, targets, ignore_index, c)
    return total / mean_denominator(count)


# ---------------------------------------------------------------------------
# vocab-parallel cross-entropy (tensor parallelism)
# ---------------------------------------------------------------------------

class _VocabParallelNLL(torch.autograd.Function):
    """(sum of nll over valid targets, valid count) of x (B, T, C) against
    this model rank's rows v0 .. v0 + Vl of the tied (V, C) embedding,
    `emb` (Vl, C). Per T-chunk: fp32 logits of the local rows, their max,
    sum of exponentials and the target's logit (zero where the target
    lies on another rank) all-reduced over 'model', nll = log(sum) + max -
    target logit. The per-row logsumexp is kept and the chunk's logits are
    recomputed in the backward: dlogits = softmax - onehot on the local
    rows, dx = dlogits @ emb summed over 'model', dW = dlogits^T x of the
    local rows."""

    @staticmethod
    def forward(ctx, x, emb, targets, v0, chunk, ignore_index):
        B, T, C = x.shape
        Vl = emb.shape[0]
        mask = targets != ignore_index
        local = targets - v0
        inside = mask & (local >= 0) & (local < Vl)
        safe = torch.where(inside, local, torch.zeros_like(local))
        lses, total = [], x.new_zeros((), dtype=torch.float32)
        for c0 in range(0, T, chunk):
            xc = x[:, c0:c0 + chunk].reshape(-1, C)
            logits = _mm_f32(xc, emb.t())                   # (n, Vl) fp32
            m = context.model_all_reduce(logits.amax(dim=-1),
                                         dist.ReduceOp.MAX)
            se = context.model_all_reduce(
                torch.exp(logits - m[:, None]).sum(dim=-1))
            lse = m + torch.log(se)
            ins = inside[:, c0:c0 + chunk].reshape(-1)
            tgt = logits.gather(-1, safe[:, c0:c0 + chunk].reshape(-1, 1))
            tgt = context.model_all_reduce(
                torch.where(ins, tgt[:, 0], torch.zeros_like(lse)))
            nll = lse - tgt
            total = total + torch.where(
                mask[:, c0:c0 + chunk].reshape(-1), nll,
                torch.zeros_like(nll)).sum()
            lses.append(lse)
        ctx.save_for_backward(x, emb, mask, inside, safe, torch.cat(lses))
        ctx.chunk = chunk
        return total, mask.sum()

    @staticmethod
    def backward(ctx, g, _):
        x, emb, mask, inside, safe, lse = ctx.saved_tensors
        B, T, C = x.shape
        chunk = ctx.chunk
        dx = torch.empty(B, T, C, dtype=torch.float32, device=x.device)
        demb = torch.zeros(emb.shape, dtype=torch.float32, device=x.device)
        n0 = 0
        for c0 in range(0, T, chunk):
            xc = x[:, c0:c0 + chunk].reshape(-1, C)
            n = xc.shape[0]
            p = torch.exp(_mm_f32(xc, emb.t()) - lse[n0:n0 + n, None])
            ins = inside[:, c0:c0 + chunk].reshape(-1, 1)
            # - onehot of the targets on this rank's rows (no host sync)
            p.scatter_add_(1, safe[:, c0:c0 + chunk].reshape(-1, 1),
                           -ins.to(p.dtype))
            p = p * (mask[:, c0:c0 + chunk].reshape(-1, 1) * g)
            p = p.to(x.dtype)
            dx[:, c0:c0 + chunk] = _mm_f32(p, emb).reshape(B, -1, C)
            demb += _mm_f32(p.t(), xc)
            n0 += n
        dx = context.model_all_reduce(dx)
        return dx.to(x.dtype), demb.to(emb.dtype), None, None, None, None


def vocab_parallel_cross_entropy(x: torch.Tensor, embedding: torch.Tensor,
                                 targets: torch.Tensor, v0: int, *,
                                 ignore_index: int = -1,
                                 chunk: int = 0) -> torch.Tensor:
    """Mean weight-tied CE over valid targets with the vocabulary cut over
    'model' (the counterpart of the reference's chunked loss under a
    vocab-parallel `tkn_emb`, as GSPMD derives it, losses.py:79-120):
    `embedding` (V / tp, C) holds rows v0 .. of the whole (V, C). `chunk`
    as `fused_cross_entropy` picks it (0: a divisor of T, or one block).
    Every model rank returns the same loss; each gets dx whole and the
    gradient of its own rows."""
    T = x.shape[1]
    V = embedding.shape[0] * context.model_size()
    if chunk <= 0:
        chunk = _chunk_for(T, V)
    if chunk <= 0 or T % chunk != 0:
        chunk = T
    total, count = _VocabParallelNLL.apply(x, embedding, targets, v0, chunk,
                                           ignore_index)
    return total / mean_denominator(count)
