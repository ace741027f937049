"""Ragged grouped matmul: the dropless MoE expert dispatch. Wrappers of the
hand-written CUDA kernels (csrc/grouped_mm_fwd.cu, csrc/grouped_mm_bwd.cu),
their plain PyTorch versions, the autograd glue and the host-side
packing.

Counterpart of the reference package's `ops/grouped_matmul.py`:

* Layout (`_pack_rows` :318, `_gmm_metadata` :298): routed assignments
  are stable-sorted by expert into one packed buffer whose groups are
  padded only to the next `bm`-row tile, so it holds every assignment —
  dropless by construction. `tile_group` maps each tile to its expert;
  empty experts own no tiles; the buffer has P = (ceil(A / bm) + E) bm
  rows, known on the host, so the dispatch is static-shape and never
  syncs. Unfilled rows read zero, with gate 0, and feed no token.
* `gather_rows` / `combine_rows`: the token gather into a packed buffer
  and the combine back, two `torch.autograd.Function`s, each one's
  backward the other's forward. Both run on two maps built once per
  forward: for each buffer row its token (or assignment) and whether it
  is filled, and for each token its at most `n_shared + k` rows. A token
  sums its own rows in a fixed order, so neither direction scatter-adds
  (no `index_add`, no `index_put(accumulate=True)`, no atomic) and both
  give the same bits on every run. The reference computes the same
  gather and scatter-add under XLA (:338, :399).
* `gmm_fwd` (reference `_fwd_kernel(_scaled)` :105-113 -> `_fwd_call`
  :148): y[r] = x_pad[r] @ W[tile_group[r // bm]], times the fp32 gate of
  the row at the output write in the scaled form.
* `gmm_bwd_dx` (`_dx_kernel(_scaled)` :116-124 -> `_dx_call` :178):
  dx = (dy * gate, rounded to dy's dtype) @ W_e^T.
* `gmm_bwd_dw` (`_dw_kernel` :127 -> `_dw_call_impl` :208): fp32
  dW[e] = sum over expert e's own tiles of x_tile^T (dy_tile * gate,
  rounded to x's dtype). Trailing tiles past the last expert's rows are
  not summed (the reference adds them to the last expert: they hold gate-0
  rows or zero dy rows, so the sums agree on every dispatch), and an expert
  with no rows gets zeros.
* `_GMM`, a `torch.autograd.Function` (reference `_gmm` :245 with
  `_gmm_bwd` :261): the gate cotangent sum_n dy * y_unscaled comes from a
  recomputed unscaled forward, not a stored one. dW of an expert with no
  rows is zero as both the kernel and the plain version compute it.
* `grouped_dispatch` (:436, `_local_grouped_dispatch` :354): the shared
  experts ride the same two products as always-on groups with gate 1.0,
  and `combine_rows` sums every token's rows. The caller passes the
  nonlinearity between the two products (`act`). Under an 'expert' axis
  (`ep` = (rank, ep), parallel/tensor.py) the weights are the rank's
  n_exp / ep experts, global ids lo = rank n_exp / ep onwards, and the
  rank packs only the assignments of those ids, the shared experts'
  included where it holds them; the reference instead keeps the other
  assignments in its buffer re-tagged to the last local group with gate 0
  (:386-388), which adds rows and no sum. The buffer's rows are bounded on
  the host without a sync: a token has one assignment per local shared
  expert and at most min(k, local routed experts) routed ones. The caller
  sums the ranks' outputs over 'expert' (models/mlp.py).

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take (dtypes other than fp32/bf16, mixed dtypes, widths
that are not multiples of 8, a tile `bm` that is not a multiple of 128 or
does not divide P, non-contiguous or misaligned operands); for CPU
tensors it runs the plain version: per-tile products over the same
metadata, fp32 accumulation, the same rounding points. Inside each C
entry the dtype picks the design before launch, never as a fallback:
bf16 runs on tensor cores (wgmma on TMA-fed shared memory; the forward
and dx raster their grids so the CTAs of one row tile run together and
the row operand is read from device memory about once), fp32 on FMA
loops. Each product is bound by operations (2 P K N FLOP: ~0.08 / 0.04 ms
in bf16 for the flagship's fc / proj on an H100), which the wgmma designs
approach and the FMA loops do not (PERF.md §6). `LAUNCHES[name]`
counts kernel launches, `PLAIN_CALLS[name]` plain-version calls, and
`DEGRADED["dense"]` MoE layers that asked for 'grouped' and took 'dense'
because `grouped_usable` refused (models/mlp.py).

Tiles: `bm` is 8 for CPU tensors, as the reference's interpret mode uses,
and the kernels' own 128 rows on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

CPU_BLOCK_M = 8         # the reference's interpret bm
KERNEL_BLOCK_M = 128    # the kernels' CTA rows: the card's bm
ALIGN = 8               # widths the kernels take

#: kernel launches per kernel, counted by the wrappers
LAUNCHES = {"grouped_mm_fwd": 0, "grouped_mm_bwd_dx": 0,
            "grouped_mm_bwd_dw": 0}
#: plain-version calls per kernel (CPU tensors)
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)
#: MoE layers degraded from moe_impl='grouped' to 'dense'
DEGRADED = {"dense": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, DEGRADED):
        for k in d:
            d[k] = 0


def block_m(device) -> int:
    """The row tile for tensors on `device`."""
    return CPU_BLOCK_M if torch.device(device).type == "cpu" \
        else KERNEL_BLOCK_M


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _expert_tiles(w, tile_group):
    """(n_tiles, K, N) fp32: each tile's expert weights."""
    return w.float()[tile_group.long()]


def _own_tiles(counts, pstart, n_tiles: int, bm: int):
    """(n_tiles,) expert of each tile and whether the tile is one of that
    expert's own ceil(count / bm) tiles (False for trailing tiles)."""
    t = torch.arange(n_tiles, device=counts.device)
    start = (pstart // bm).long()
    owner = torch.searchsorted(start, t, right=True) - 1
    n_own = (counts.long() + bm - 1) // bm
    return owner, t < start[owner] + n_own[owner]


def _scaled(dy, scales, dtype):
    """dy * gate rounded to `dtype` (dy's own values when unscaled)."""
    if scales is None:
        return dy.to(dtype)
    return (dy.float() * scales).to(dtype)


def gmm_fwd_plain(x_pad, w, tile_group, scales=None, *, bm: int):
    """Plain version of `gmm_fwd`: (P, N) in x's dtype."""
    PLAIN_CALLS["grouped_mm_fwd"] += 1
    P, K = x_pad.shape
    y = torch.bmm(x_pad.float().reshape(P // bm, bm, K),
                  _expert_tiles(w, tile_group)).reshape(P, -1)
    if scales is not None:
        y = y * scales
    return y.to(x_pad.dtype)


def gmm_bwd_dx_plain(dy, w, tile_group, scales=None, *, bm: int):
    """Plain version of `gmm_bwd_dx`: (P, K) in dy's dtype."""
    PLAIN_CALLS["grouped_mm_bwd_dx"] += 1
    P, N = dy.shape
    d = _scaled(dy, scales, dy.dtype).float().reshape(P // bm, bm, N)
    dx = torch.bmm(d, _expert_tiles(w, tile_group).transpose(1, 2))
    return dx.reshape(P, -1).to(dy.dtype)


def gmm_bwd_dw_plain(x_pad, dy, counts, pstart, scales=None, *, bm: int):
    """Plain version of `gmm_bwd_dw`: (E, K, N) fp32, the sum over each
    expert's own tiles (zeros for an expert with none)."""
    PLAIN_CALLS["grouped_mm_bwd_dw"] += 1
    P, K = x_pad.shape
    n_tiles = P // bm
    d = _scaled(dy, scales, x_pad.dtype).float()
    parts = torch.bmm(x_pad.float().reshape(n_tiles, bm, K).transpose(1, 2),
                      d.reshape(n_tiles, bm, -1))
    owner, own = _own_tiles(counts, pstart, n_tiles, bm)
    parts = parts * own[:, None, None]
    dw = torch.zeros(counts.shape[0], K, dy.shape[1], device=x_pad.device)
    return dw.index_add_(0, owner, parts)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, mats, w, ints, scales, bm):
    """Raise unless the kernel takes these operands: 2-D `mats` of P rows
    (and `w` (E, K, N) where given), all fp32 or all bf16, contiguous,
    16-byte aligned, widths multiples of 8; `ints` int32 and `scales`
    (P, 1) fp32 or None, contiguous; bm a multiple of 128 dividing P; all
    CUDA tensors on one device."""
    ops = [*mats] + ([w] if w is not None else [])
    dt = mats[0].dtype
    if dt not in _DTYPE_CODE or any(a.dtype != dt for a in ops):
        raise ValueError(f"{name} takes fp32 or bf16 operands of one dtype, "
                         f"got {[a.dtype for a in ops]}")
    P = mats[0].shape[0]
    if any(a.dim() != 2 or a.shape[0] != P for a in mats) or \
            (w is not None and w.dim() != 3):
        raise ValueError(f"{name}: operands {[tuple(a.shape) for a in ops]}")
    if any(d % ALIGN or d == 0 for a in ops for d in a.shape[1:]):
        raise ValueError(f"{name}: widths {[tuple(a.shape) for a in ops]} "
                         f"are not multiples of {ALIGN}")
    if bm % KERNEL_BLOCK_M or P % bm:
        raise ValueError(f"{name}: bm {bm} is not a multiple of "
                         f"{KERNEL_BLOCK_M} dividing P = {P}")
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: metadata must be int32, got {t.dtype}")
    if scales is not None and (scales.shape != (P, 1)
                               or scales.dtype != torch.float32):
        raise ValueError(f"{name}: scales must be (P, 1) fp32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    for a in ops + list(ints) + ([scales] if scales is not None else []):
        if a.device != mats[0].device:
            raise ValueError("kernel operands must share one device")
        if not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous operands")
    if not mats[0].is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got "
                         f"{mats[0].device}")
    if any(a.data_ptr() % 16 for a in ops):
        raise ValueError(f"{name}: operands must be 16-byte aligned")


def _launch(name, ptrs, dims, dev, dtype):
    from distributed_pytorch_tpu_torch.ops import cuda_build
    lib = cuda_build.load(name)
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            _DTYPE_CODE[dtype], *ptrs, *dims,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def gmm_fwd(x_pad, w, tile_group, scales=None, *, bm: int):
    """y (P, N) in x's dtype of the packed rows x_pad (P, K) against the
    stacked expert weights w (E, K, N); tile_group (P // bm,) int32 names
    each tile's expert; scales (P, 1) fp32 gates or None."""
    if x_pad.device.type == "cpu":
        return gmm_fwd_plain(x_pad, w, tile_group, scales, bm=bm)
    _check("grouped_mm_fwd", (x_pad,), w, (tile_group,), scales, bm)
    E, K, N = w.shape
    if x_pad.shape[1] != K:
        raise ValueError(f"grouped_mm_fwd: x {tuple(x_pad.shape)} against "
                         f"w {tuple(w.shape)}")
    P = x_pad.shape[0]
    y = torch.empty(P, N, dtype=x_pad.dtype, device=x_pad.device)
    _launch("grouped_mm_fwd",
            (x_pad.data_ptr(), w.data_ptr(), _ptr(scales),
             tile_group.data_ptr(), y.data_ptr()),
            (P, K, N, E, bm), x_pad.device, x_pad.dtype)
    return y


def gmm_bwd_dx(dy, w, tile_group, scales=None, *, bm: int):
    """dx (P, K) in dy's dtype: (dy * gate) @ W_e^T per tile."""
    if dy.device.type == "cpu":
        return gmm_bwd_dx_plain(dy, w, tile_group, scales, bm=bm)
    _check("grouped_mm_bwd_dx", (dy,), w, (tile_group,), scales, bm)
    E, K, N = w.shape
    if dy.shape[1] != N:
        raise ValueError(f"grouped_mm_bwd_dx: dy {tuple(dy.shape)} against "
                         f"w {tuple(w.shape)}")
    P = dy.shape[0]
    dx = torch.empty(P, K, dtype=dy.dtype, device=dy.device)
    _launch("grouped_mm_bwd_dx",
            (dy.data_ptr(), w.data_ptr(), _ptr(scales),
             tile_group.data_ptr(), dx.data_ptr()),
            (P, K, N, E, bm), dy.device, dy.dtype)
    return dx


def gmm_bwd_dw(x_pad, dy, counts, pstart, scales=None, *, bm: int):
    """dW (E, K, N) fp32 of the packed rows x_pad (P, K) and dy (P, N):
    expert e sums its own rows [pstart[e], pstart[e] + ceil(counts[e] / bm)
    bm); counts and pstart (E,) int32."""
    if x_pad.device.type == "cpu":
        return gmm_bwd_dw_plain(x_pad, dy, counts, pstart, scales, bm=bm)
    _check("grouped_mm_bwd_dw", (x_pad, dy), None, (counts, pstart), scales,
           bm)
    P, K = x_pad.shape
    N, E = dy.shape[1], counts.shape[0]
    if pstart.shape != (E,):
        raise ValueError(f"grouped_mm_bwd_dw: counts {tuple(counts.shape)}, "
                         f"pstart {tuple(pstart.shape)}")
    dw = torch.empty(E, K, N, dtype=torch.float32, device=x_pad.device)
    _launch("grouped_mm_bwd_dw",
            (x_pad.data_ptr(), dy.data_ptr(), _ptr(scales),
             counts.data_ptr(), pstart.data_ptr(), dw.data_ptr()),
            (P, K, N, E, bm), x_pad.device, x_pad.dtype)
    return dw


# ---------------------------------------------------------------------------
# autograd over the tile-aligned buffer
# ---------------------------------------------------------------------------

class _GMM(torch.autograd.Function):
    """y[r] = (x_pad[r] @ w[expert of r's tile]) * scales[r] — the
    reference's `_gmm` and its VJP (:245-283)."""

    @staticmethod
    def forward(ctx, x_pad, w, scales, tile_group, counts, pstart, bm):
        ctx.bm = bm
        ctx.save_for_backward(x_pad, w, scales, tile_group, counts, pstart)
        return gmm_fwd(x_pad, w, tile_group, scales, bm=bm)

    @staticmethod
    def backward(ctx, dy):
        x_pad, w, scales, tile_group, counts, pstart = ctx.saved_tensors
        bm = ctx.bm
        dy = dy.contiguous()
        ds = dx = dw = None
        if scales is not None and ctx.needs_input_grad[2]:
            # the gate cotangent needs the unscaled product: recomputed,
            # not stored (the reference's recompute-over-store trade)
            y_us = gmm_fwd(x_pad, w, tile_group, None, bm=bm)
            ds = (dy.float() * y_us.float()).sum(-1, keepdim=True)
        if ctx.needs_input_grad[0]:
            dx = gmm_bwd_dx(dy, w, tile_group, scales, bm=bm)
        if ctx.needs_input_grad[1]:
            dw = gmm_bwd_dw(x_pad, dy, counts, pstart, scales,
                            bm=bm).to(w.dtype)
        return dx, dw, ds, None, None, None, None


def gmm(x_pad, w, tile_group, counts, pstart, *, scales=None, bm: int):
    """Ragged grouped matmul over a tile-aligned expert-sorted buffer."""
    return _GMM.apply(x_pad, w, scales, tile_group, counts, pstart, bm)


# ---------------------------------------------------------------------------
# dispatch metadata + the routed/shared dispatch
# ---------------------------------------------------------------------------

def _gmm_metadata(flat_e, n_groups: int, n_tiles: int, bm: int):
    """(counts, pstart, starts, tile_group) for a flat expert-id vector:
    rows per group, each group's padded and packed offsets, and each tile's
    group (trailing unused tiles resolve to the last group). Groups are
    padded to the next bm multiple; empty groups own no tiles. An id of
    n_groups is no group's (an assignment that is not packed). The
    reference's `tile_first` is not kept: the dW kernel walks each
    expert's own rows instead of resetting on a group's first tile."""
    dev = flat_e.device
    counts = torch.zeros(n_groups + 1, dtype=torch.long,
                         device=dev).index_add_(
        0, flat_e.long(), torch.ones_like(flat_e, dtype=torch.long))[:-1]
    padded = (counts + bm - 1) // bm * bm
    pstart = torch.cumsum(padded, 0) - padded
    tile_start = pstart // bm
    t = torch.arange(n_tiles, device=dev)
    tile_group = torch.searchsorted(tile_start, t, right=True) - 1
    starts = torch.cumsum(counts, 0) - counts
    return (counts.to(torch.int32), pstart.to(torch.int32), starts,
            tile_group.to(torch.int32))


class Packing(NamedTuple):
    """Where each assignment sits in a packed buffer of R rows. Row r
    holds assignment `row_asg[r]` of token `row_tok[r]` when `filled[r]`
    (else it is zero and its token and assignment read 0); assignment a
    sits in row `slot[a]`, in the assignment's own order, or in R (a row
    of zeros) when it was dropped."""

    row_asg: torch.Tensor
    row_tok: torch.Tensor
    filled: torch.Tensor
    slot: torch.Tensor


def pack(order, slot_sorted, flat_t, n_rows: int) -> Packing:
    """The `Packing` of assignments stable-sorted by `order`, the i-th of
    which goes to row `slot_sorted[i]` (n_rows for a dropped one). Every
    write has a unique target but the dropped ones', which share a cell
    that is cut away."""
    dev = order.device
    row_asg = torch.zeros(n_rows + 1, dtype=torch.long, device=dev) \
        .index_put_((slot_sorted,), order)[:-1]
    filled = torch.zeros(n_rows + 1, dtype=torch.bool, device=dev) \
        .index_put_((slot_sorted,), torch.ones_like(order, dtype=torch.bool))
    filled = filled[:-1]
    row_tok = torch.where(filled, flat_t[row_asg], 0)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    return Packing(row_asg, row_tok, filled, slot)


def _gather_filled(src, rows, filled):
    """src[rows], zero on the rows that are not `filled`."""
    return src.index_select(0, rows).masked_fill_(~filled[:, None], 0)


def _sum_slots(src, slot_of):
    """out[n] = sum over j, in the order of j, of src[slot_of[n, j]]; a
    slot equal to len(src) reads a row of zeros."""
    ext = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
    out = ext.index_select(0, slot_of[:, 0])
    for j in range(1, slot_of.shape[1]):
        out += ext.index_select(0, slot_of[:, j])
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, filled, slot_of):
        ctx.save_for_backward(slot_of)
        return _gather_filled(x, rows, filled)

    @staticmethod
    def backward(ctx, dout):
        (slot_of,) = ctx.saved_tensors
        return _sum_slots(dout, slot_of), None, None, None


class _CombineRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, slot_of, rows, filled):
        ctx.save_for_backward(rows, filled)
        return _sum_slots(y, slot_of)

    @staticmethod
    def backward(ctx, dout):
        rows, filled = ctx.saved_tensors
        return _gather_filled(dout, rows, filled), None, None, None


def gather_rows(x, rows, filled, slot_of):
    """Packed buffer row r = x[rows[r]] where `filled[r]`, else zero. x
    (N, ...); rows, filled (R,); slot_of (N, J): the rows that row n of x
    feeds (R where it feeds none), which must be exactly those r with
    rows[r] == n and filled[r]. The backward sums each source row's
    gradient rows in the order of j."""
    return _GatherRows.apply(x, rows, filled, slot_of)


def combine_rows(y, slot_of, rows, filled):
    """out[n] = sum over j, in the order of j, of y[slot_of[n, j]] (a slot
    of R adds nothing): the transpose of `gather_rows` with the same maps.
    The backward gathers dout[rows[r]], zero on the unfilled rows."""
    return _CombineRows.apply(y, slot_of, rows, filled)


def _pack_rows(flat_e, flat_t, n_groups: int, bm: int, n_asg=None):
    """Sort assignments by expert into the tile-aligned buffer. Returns
    (Packing, counts, pstart, tile_group). The buffer's rows past each
    group's assignments are unfilled. Assignments whose id is outside [0,
    n_groups) are not packed (their slot is P, a row of zeros); `n_asg`
    bounds the count of those that are (default: all of them)."""
    A = flat_e.shape[0]
    n_tiles = -(-(A if n_asg is None else n_asg) // bm) + n_groups
    P = n_tiles * bm
    dev = flat_e.device

    local = (flat_e >= 0) & (flat_e < n_groups)
    key = torch.where(local, flat_e, n_groups)
    order = torch.argsort(key, stable=True)
    se = key[order]
    counts, pstart, starts, tile_group = _gmm_metadata(
        key, n_groups, n_tiles, bm)
    starts = torch.cat([starts, starts.new_zeros(1)])
    pos = torch.arange(A, device=dev) - starts[se]         # rank in group
    slot = torch.where(se < n_groups,                      # unique, < P
                       torch.cat([pstart.long(), pstart.new_zeros(
                           1, dtype=torch.long)])[se] + pos, P)
    return pack(order, slot, flat_t, P), counts, pstart, tile_group


def grouped_usable(cfg, dtype, device, tp: int = 1, ep: int = 1) -> bool:
    """Static gate for the grouped path. False -> callers fall back to the
    'dense' combine (identical dropless semantics, E/k x the FLOPs), as the
    reference does. Widths must be multiples of 8 (the reference's non-TPU
    rule, and the 16-byte vectors the kernels copy) — under a 'model' axis
    of tp the rank's local widths up_dim / tp; an 'expert' axis of ep must
    divide n_exp (the reference's rule, :431); on the card the dtype must
    be fp32 or bf16."""
    up = cfg.up_dim // tp
    fc_out = 2 * up if cfg.non_linearity.lower() in ("swiglu", "glu") else up
    if any(d % ALIGN for d in (cfg.n_embd, up, fc_out)):
        return False
    if cfg.n_exp % ep:
        return False
    if torch.device(device).type == "cpu":
        return True
    return dtype in _DTYPE_CODE


def grouped_dispatch(x_flat, topk_idx, topk_gates, experts_fc, experts_proj,
                     *, act: Callable[[torch.Tensor], torch.Tensor],
                     n_shared: int = 0, ep: tuple = (0, 1)):
    """Dropless grouped-matmul MoE dispatch of one device's experts.

    x_flat (N, C); topk_idx/topk_gates (N, k) over the ROUTED experts;
    experts_fc/experts_proj (E, ...) stacked weights in x's dtype: the
    whole n_exp INCLUDING the n_shared leading shared experts, or under
    `ep` = (rank, ep) the rank's E = n_exp / ep of them (global ids rank E
    .. rank E + E - 1); `act` maps the fc product to the proj input.
    Returns the shared + routed outputs of these experts combined, (N, C):
    under ep > 1 a part of the sum over the expert ranks. Gate with
    `grouped_usable` first."""
    N = x_flat.shape[0]
    k = topk_idx.shape[1]
    E = experts_fc.shape[0]
    dev = x_flat.device
    bm = block_m(dev)
    lo = ep[0] * E
    n_sh = max(0, min(n_shared, lo + E) - lo)      # local shared experts
    n_asg = None if ep[1] == 1 else N * (n_sh + min(k, E - n_sh))

    # assignments token-major: token n's shared experts, then its routed
    # ones; within a group the stable sort keeps token order either way;
    # ids are local (outside [0, E): another rank's expert)
    J = n_shared + k
    flat_e = torch.cat(
        [torch.arange(n_shared, device=dev).expand(N, n_shared),
         topk_idx.long() + n_shared], dim=1).reshape(-1) - lo
    flat_g = torch.cat(
        [torch.ones(N, n_shared, device=dev), topk_gates.float()],
        dim=1).reshape(-1, 1)
    flat_t = torch.arange(N, device=dev).repeat_interleave(J)

    pk, counts, pstart, tile_group = _pack_rows(flat_e, flat_t, E, bm, n_asg)
    slot_of = pk.slot.reshape(N, J)
    x_pad = gather_rows(x_flat, pk.row_tok, pk.filled, slot_of)
    row_gate = gather_rows(flat_g, pk.row_asg, pk.filled, pk.slot[:, None])
    h = act(gmm(x_pad, experts_fc, tile_group, counts, pstart, bm=bm))
    y = gmm(h.contiguous(), experts_proj, tile_group, counts, pstart,
            scales=row_gate, bm=bm)
    return combine_rows(y, slot_of, pk.row_tok, pk.filled)
