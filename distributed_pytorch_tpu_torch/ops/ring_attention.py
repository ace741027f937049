"""Sequence-parallel attention over the 'seq' group: ring, zig-zag and
Ulysses attention on the flash kernels.

Counterpart of the reference package's `ops/ring_attention.py`. Each rank
holds T / sp positions of every row (data/loader.py cuts them) and the
model runs on them; attention is the one layer that needs the others'
keys and values.

* **Ring** (`layout` 'contiguous', reference `ring_attention_local`
  :179): rank i holds positions [i T/sp, (i+1) T/sp). Hop 0 is the rank's
  own chunk through the causal flash call; on hop s the keys and values
  of rank i - s have come round the ring (`context.seq_permute_start`,
  one send and one receive a hop on every rank, so the schedule is the
  same everywhere): a past chunk goes through the full flash call, a
  future one is skipped.
* **Zig-zag** (`layout` 'zigzag', reference
  `zigzag_ring_attention_local` :247): the loader gives rank i the
  stripes i and 2 sp - 1 - i of length T / (2 sp) (`zigzag_permutation`),
  so every rank has the same causal work. Hop 0 runs (lo, lo) and (hi, hi)
  causal and (hi, lo) full; on every later hop (hi, lo') is visible and of
  (lo, lo') and (hi, hi') the one whose origin lies before; (lo, hi') is
  always future. At rate 0 the two visible blocks of a hop run as one
  call (all rows against lo', or hi against both stripes).
* **Ulysses** (reference `ulysses_attention_local` :364): a tiled
  all-to-all turns (B, T/sp, nh, D) into (B, T, nh/sp, D)
  (`context.seq_all_to_all`), one causal flash call runs over the rank's
  heads of the whole sequence, and the inverse all-to-all brings the rows
  back. It needs sp | nh and sp | nkv and a contiguous layout.

Every block runs the flash kernels (ops/flash_attention.py): the forward
returns (out, lse) and the blocks merge as the reference's `_merge_flash`
(:163-168), lse = logaddexp, each output weighted by exp(lse_c - lse).
The backward runs the dq and dkv kernels on every block with the merged
lse and delta = rowsum(dO O): that is the per-block gradient with its
dlse term folded in (delta_c - dlse_c = rowsum(dO O)), so the blocks'
dq, dk and dv are the exact gradient of the merged output. The keys and
values go round the ring again in the backward, each chunk's fp32 dk / dv
travelling with it and arriving home after one more hop. One autograd node
covers a layer's whole ring, so every rank issues its sends and receives
in one order whatever hops it skips.

Dropout: each block's kernels draw the mask at the block's global (row,
query position, key position) (`q_pos0` / `k_pos0`), so the hops together
draw the reference's `_hop_dropout_mask` bit for bit, and the seed is
folded per data rank (`fold_seed_for_data_shard`, reference
flash_attention.py:144). Ulysses at a rate above 0 reroutes as the
reference does (:420-428).

`sp_sdpa` is the dispatcher's entry (ops/attention_core.py); `ring_fwd`
and `ring_bwd` take a `ring` (`SeqRing` over the group, or `LocalRing`,
a one-process list of every rank's chunks) so the hops can be checked
against one whole flash call in one process.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_pytorch_tpu_torch.parallel import context

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# routing and layouts
# ---------------------------------------------------------------------------

def resolve_impl(impl: str, T: int, sp: int, nh: int, nkv: int,
                 rate: float) -> str:
    """The sp attention the reference runs for `impl` at sequence length
    T (attention_core.py:254-278, ring_attention.py:410-436): 'ulysses'
    where sp divides both head counts at rate 0, else zig-zag; 'ring'
    as asked; anything else zig-zag; zig-zag needs 2 sp | T, else ring."""
    if impl == "ulysses" and (nh % sp or nkv % sp or rate > 0.0):
        impl = "zigzag"
    if impl not in ("ring", "ulysses"):
        impl = "zigzag"
    if impl == "zigzag" and T % (2 * sp):
        impl = "ring"
    return impl


def config_impl(cfg, attn_impl: str, sp: int) -> str:
    """`resolve_impl` of a model config's training attention (MLA's keys
    have a head a query head): the run's sp attention, chosen once."""
    nkv = cfg.n_head if cfg.attn == "mla" else cfg.n_kv_heads
    return resolve_impl(attn_impl, cfg.block_size, sp, cfg.n_head, nkv,
                        cfg.dropout)


def zigzag_permutation(T: int, sp: int):
    """(perm, inv_perm): natural order to the zig-zag layout, rank i's
    rows being [stripe i, stripe 2 sp - 1 - i] of length T / (2 sp)
    (reference ring_attention.py:343)."""
    Ts = T // (2 * sp)
    parts = []
    for i in range(sp):
        parts.append(np.arange(i * Ts, (i + 1) * Ts))
        parts.append(np.arange((2 * sp - 1 - i) * Ts, (2 * sp - i) * Ts))
    perm = np.concatenate(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(T)
    return perm, inv


def local_positions(T: int, sp: int, rank: int, layout: str) -> np.ndarray:
    """The global positions of seq rank `rank`'s T / sp rows."""
    Tl = T // sp
    if layout == "zigzag":
        return zigzag_permutation(T, sp)[0][rank * Tl:(rank + 1) * Tl]
    return np.arange(rank * Tl, (rank + 1) * Tl)


_SEQ_ROWS: dict = {}


def seq_positions(T: int, device) -> torch.Tensor | None:
    """The global positions of this rank's T rows of each sequence under a
    published 'seq' axis (its layout's), else None."""
    sp = context.seq_size()
    if sp == 1:
        return None
    key = (T, sp, context.seq_rank(), context.seq_layout(), str(device))
    if key not in _SEQ_ROWS:
        _SEQ_ROWS[key] = torch.as_tensor(
            local_positions(T * sp, *key[1:4]), device=device)
    return _SEQ_ROWS[key]


def fold_seed_for_data_shard(seed: torch.Tensor, data_rank: int):
    """The (2,) int32 dropout seed decorrelated across 'data' ranks (the
    reference's fold: seed ^ data_rank * 0x9E3779B9 in int32)."""
    f = (data_rank * 0x9E3779B9) & 0xFFFFFFFF
    f = f - (1 << 32) if f >= 1 << 31 else f
    return seed ^ torch.tensor(f, dtype=torch.int32, device=seed.device)


# ---------------------------------------------------------------------------
# the hop schedule
# ---------------------------------------------------------------------------

def hop_blocks(idx: int, s: int, sp: int, Tl: int, layout: str,
               rate: float) -> list:
    """The flash calls of hop s on seq rank idx: (q rows, key rows of the
    resident chunk, causal, global position of the first query, of the
    first key); the resident chunk came from rank (idx - s) mod sp."""
    j = (idx - s) % sp
    full = slice(0, Tl)
    if layout == "contiguous":
        if s == 0:
            return [(full, full, True, idx * Tl, idx * Tl)]
        return [(full, full, False, idx * Tl, j * Tl)] if j < idx else []
    Ts = Tl // 2
    lo, hi = slice(0, Ts), slice(Ts, Tl)
    a_lo, a_hi = idx * Ts, (2 * sp - 1 - idx) * Ts
    b_lo, b_hi = j * Ts, (2 * sp - 1 - j) * Ts
    if s == 0:
        return [(lo, lo, True, a_lo, a_lo), (hi, hi, True, a_hi, a_hi),
                (hi, lo, False, a_hi, a_lo)]
    if rate == 0.0:
        # positions do not enter: one call for the hop's two blocks
        return [(full, lo, False, a_lo, b_lo)] if j < idx \
            else [(hi, full, False, a_hi, b_lo)]
    if j < idx:
        return [(lo, lo, False, a_lo, b_lo), (hi, lo, False, a_hi, b_lo)]
    return [(hi, lo, False, a_hi, b_lo), (hi, hi, False, a_hi, b_hi)]


class SeqRing:
    """The 'seq' group as a ring: this rank's place and the permute."""

    def __init__(self):
        self.idx, self.sp = context.seq_rank(), context.seq_size()

    def chunks(self, kv: torch.Tensor):
        """(s, kv_s) for s = 0 .. sp-1: the resident (2, B, Tl, nkv, D)
        keys and values of hop s, the next hop's received while this one
        computes."""
        for s in range(self.sp):
            wait = context.seq_permute_start(kv) if s < self.sp - 1 \
                else None
            yield s, kv
            if wait is not None:
                kv = wait()

    def grad_chunks(self, kv: torch.Tensor):
        """(s, kv_s, acc_s) for every hop: acc_s the fp32 (dk, dv)
        accumulator of the resident chunk, which travels with it;
        `self.home` is this rank's own chunk's after the last hop."""
        acc = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        for s, kv_s in self.chunks(kv):
            yield s, kv_s, acc
            acc = context.seq_permute(acc)
        self.home = acc


class LocalRing:
    """One process standing in for the ring of `kvs` (every rank's
    (2, B, Tl, nkv, D) chunk): rank `idx`'s hop s reads kvs[idx - s], and
    the gradient accumulators sit in `accs` (one per chunk, shared by the
    ranks of one simulation): `accs[r]` is rank r's (dk, dv) once every
    rank has run `ring_bwd`."""

    def __init__(self, kvs: list, idx: int, accs: dict):
        self.kvs, self.idx, self.sp, self.accs = kvs, idx, len(kvs), accs

    def chunks(self, kv):
        for s in range(self.sp):
            yield s, self.kvs[(self.idx - s) % self.sp]

    def grad_chunks(self, kv):
        for s, kv_s in self.chunks(kv):
            j = (self.idx - s) % self.sp
            if j not in self.accs:
                self.accs[j] = torch.zeros(kv_s.shape, dtype=torch.float32,
                                           device=kv_s.device)
            yield s, kv_s, self.accs[j]


def _merge(out: torch.Tensor, lse: torch.Tensor, out_c: torch.Tensor,
           lse_c: torch.Tensor) -> None:
    """The reference's `_merge_flash`, in place on views of the carry:
    out (B, Tq, nh, D) fp32 and lse (B, nh, Tq) fp32."""
    new = torch.logaddexp(lse, lse_c)
    w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_c - new).transpose(1, 2)[..., None]
    out.mul_(w_old).add_(out_c.float() * w_new)
    lse.copy_(new)


def ring_fwd(q, kv, ring, *, scale: float, layout: str, rate: float = 0.0,
             seed=None):
    """(out (B, Tl, nh, D) in q's dtype, lse (B, nh, Tl) fp32) of q
    against the whole sequence's causal keys, the chunks coming round
    `ring`; kv = stack(k, v) of this rank's chunk."""
    B, Tl, nh, D = q.shape
    out = torch.zeros(B, Tl, nh, D, dtype=torch.float32, device=q.device)
    lse = torch.full((B, nh, Tl), _NEG_INF, dtype=torch.float32,
                     device=q.device)
    for s, kv_s in ring.chunks(kv):
        for qr, kr, causal, q0, k0 in hop_blocks(ring.idx, s, ring.sp, Tl,
                                                 layout, rate):
            o_c, l_c = fa.flash_attn_fwd(
                q[:, qr], kv_s[0][:, kr], kv_s[1][:, kr], seed, scale=scale,
                causal=causal, dropout_rate=rate, q_pos0=q0, k_pos0=k0)
            _merge(out[:, qr], lse[:, :, qr], o_c, l_c)
    return out.to(q.dtype), lse


def ring_bwd(q, kv, out, lse, dout, ring, *, scale: float, layout: str,
             rate: float = 0.0, seed=None):
    """dq (B, Tl, nh, D) fp32 of `ring_fwd`; the chunks' fp32 (dk, dv)
    accumulate in the ring's accumulators."""
    Tl = q.shape[1]
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for s, kv_s, acc in ring.grad_chunks(kv):
        for qr, kr, causal, q0, k0 in hop_blocks(ring.idx, s, ring.sp, Tl,
                                                 layout, rate):
            args = (q[:, qr], kv_s[0][:, kr], kv_s[1][:, kr], dout[:, qr],
                    lse[:, :, qr], delta[:, :, qr], seed)
            kw = dict(scale=scale, causal=causal, dropout_rate=rate,
                      q_pos0=q0, k_pos0=k0)
            dq[:, qr] += fa.flash_attn_bwd_dq(*args, **kw).float()
            dk, dv = fa.flash_attn_bwd_dkv(*args, **kw)
            acc[0][:, kr] += dk.float()
            acc[1][:, kr] += dv.float()
    return dq


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, scale, layout, rate):
        kv = torch.stack([k, v])
        out, lse = ring_fwd(q, kv, SeqRing(), scale=scale, layout=layout,
                            rate=rate, seed=seed)
        ctx.save_for_backward(q, kv, out, lse)
        ctx.cfg = dict(scale=scale, layout=layout, rate=rate, seed=seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kv, out, lse = ctx.saved_tensors
        ring = SeqRing()
        dq = ring_bwd(q, kv, out, lse, dout.contiguous(), ring, **ctx.cfg)
        return (dq.to(q.dtype), ring.home[0].to(kv.dtype),
                ring.home[1].to(kv.dtype), None, None, None, None)


def ring_attention(q, k, v, *, scale: float, layout: str,
                   rate: float = 0.0, seed=None) -> torch.Tensor:
    """Causal attention of this rank's q (B, T/sp, nh, D) against the
    whole sequence's keys and values, k / v (B, T/sp, nkv, D) this rank's
    chunk, laid out over 'seq' as `layout` says."""
    return _RingAttention.apply(q, k, v, seed, float(scale), layout,
                                float(rate))


def ulysses_attention(q, k, v, *, scale: float) -> torch.Tensor:
    """Causal attention by heads: q, k and v (contiguous layout) go to
    (B, T, nh/sp | nkv/sp, D) in one all-to-all, the rank's heads run one
    flash call over the whole sequence, and the output comes back."""
    sp, r = context.seq_size(), context.seq_rank()
    B, Tl, nh, D = q.shape
    nkv = k.shape[2]
    hq, hk = nh // sp, nkv // sp
    qkv = torch.cat([q.reshape(B, Tl, sp, hq, D), k.reshape(B, Tl, sp, hk, D),
                     v.reshape(B, Tl, sp, hk, D)], dim=3)
    g = context.seq_all_to_all(qkv, split_dim=2, concat_dim=1)[:, :, 0]
    qg, kg, vg = g.split([hq, hk, hk], dim=2)
    out = fa.flash_attention(qg, kg, vg, scale=scale, causal=True,
                             head_offset=r * hq, total_heads=nh)
    return context.seq_all_to_all(out[:, :, None], split_dim=1,
                                  concat_dim=2).reshape(B, Tl, nh, D)


def sp_sdpa(q, k, v, *, scale: float, dropout_rate: float = 0.0,
            dropout_seed=None) -> torch.Tensor:
    """The dispatcher's entry (reference `sp_sdpa` :386): causal attention
    of this rank's T / sp rows under the published 'seq' axis, by the
    attention the world resolved from its config (`context.seq_impl`,
    `config_impl`: the reference's gates and reroutes), on the layout
    the loader cut for it."""
    impl = context.seq_impl()
    rate = float(dropout_rate)
    seed = None
    if rate > 0.0:
        if impl == "ulysses":
            raise ValueError("Ulysses attention was resolved at dropout 0 "
                             f"and is called at rate {rate}")
        seed = fold_seed_for_data_shard(dropout_seed, context.data_rank())
    with context.sp_region():
        if impl == "ulysses":
            return ulysses_attention(q, k, v, scale=scale)
        return ring_attention(q, k, v, scale=scale,
                              layout=context.seq_layout(), rate=rate,
                              seed=seed)
