"""Feed-forward layers: the dense MLP and DeepSeekMoE.

Counterpart of the reference package's `models/mlp.py`:

* `MLP`/`mlp_apply`: bias-free up/down projections stored as bare (in,
  out) parameters `c_fc` (C, fc_out) and `c_proj` (up, C), as the
  reference stores them; gated variants ('swiglu'/'glu') split ONE fused
  (C, 2*up) product in half with the gate FIRST. The weights are cast to
  the activations' dtype at use (fp32 masters under bf16 compute); in
  training mode with `config.dropout > 0` the output takes residual
  dropout keyed on `dropout_seed`. Under an active quantized-weight store
  (the engine's decode forwards, ops/quant.py) both products read int8
  codes with a scale per output column, applied before the gating split
  (exact: the scale is per column of the fused product).
* `MoE` (reference :244-384): stacked expert weights `experts_fc`
  (n_exp, C, fc_out) and `experts_proj` (n_exp, up, C), the first n_shared
  always on; an fp32 router `gate` (C, n_routed) — kept in fp32 whatever
  the model's weight dtype, as the reference keeps fp32 params — picks
  the top n_act_routed experts. With `aux_free` the selection adds the
  `expert_bias` buffer while the gates come from the unbiased logits, the
  bias moves by gamma (1/n_routed - f_i) per training micro-step, and the
  complementary aux loss is alpha n_routed sum(p_i f_i); otherwise the
  classic aux loss coeff n_routed sum(p_i f_i). No output dropout (the
  reference's MoE has none). Three dispatches (`config.moe_impl`):
  'dense' runs every routed expert on every token and combines with a
  gate matrix that is zero outside the top-k; 'scatter'
  (`scatter_dispatch`) packs each expert's first `capacity` assignments
  and drops the rest, surfaced as the `dropped_frac` buffer; 'grouped'
  runs the dropless grouped-matmul kernels (ops/grouped_matmul.py), shared
  experts included. Both move tokens into their packed buffers and back
  with `gather_rows` / `combine_rows` (ops/grouped_matmul.py): no
  scatter-add in either direction, so both repeat bit for bit from run to
  run, and unfilled slots feed no token. 'grouped' degrades to 'dense'
  where `grouped_usable`
  refuses: counted in `grouped_matmul.DEGRADED` (the trainer's
  `moe_degraded_dense` stat) and warned once per layer, since 'dense'
  runs n_routed / n_act_routed times the routed experts' FLOPs.
* The reference's forward is pure: the new `moe_state` comes back from
  `apply` and the train step carries it. Here a training forward only
  computes the new `expert_bias` and `dropped_frac` (`pending_state`), and
  `commit_state()` writes them — the train step commits once per
  micro-step after its backward. A forward recomputed in the backward
  (`act_recomp`) therefore routes with the bias the micro-step started
  with, as the reference's remat does, and the bias moves once. Under
  pipeline parallelism (models/pipeline.py) the bias commits after each
  (layer, microbatch) forward with its step and the aux loss scaled by
  the microbatch's `stats_weight` 1/M, as the reference's `_PipeTick`
  has it, and a recomputed block gets the bias its microbatch routed
  with as `bias`.
* Under a data-parallel recipe (parallel/context.py) the statistics are
  the global batch's, as the reference's under pjit (:54-58): each rank's
  per-expert assignment counts are all-gathered over the ranks holding
  different tokens (data x seq; E floats per layer and forward), so the
  load `fi`, the bias update, the aux loss and `dropped_frac` match the
  reference's on every rank. `pi` needs no collective: with equal token
  counts per rank, the gradient mean over the ranks gives the global
  term. 'scatter' takes its capacity from the global token count, rounded
  up to a multiple of the 'data' axis's size as the reference does
  (:335-343), and drops by global position in the flattened (B, T) order
  (`scatter_positions`): an assignment's place in its expert's queue is
  the count of that expert's assignments in the data ranks before this
  one, in this data rank's rows before its row, and in its row before its
  position. Under a 'seq' axis a rank holds one run of each row's
  positions (contiguous) or two (zig-zag stripes), so the per-row,
  per-run counts are gathered over 'seq' (`context.seq_all_gather_stack`).
* Expert parallelism (an 'expert' axis of ep; parallel/tensor.py cuts the
  stacks and sets `ep` = (rank, ep)): a rank holds experts rank n_exp / ep
  .. (rank + 1) n_exp / ep - 1 of the global ids (the shared ones first),
  and its expert ranks hold the same rows, as the reference's specs put
  them (its `_expert_constraint` lets GSPMD place 'dense' and 'scatter',
  and its grouped dispatch runs in a `shard_map`). Each dispatch runs the
  rank's local experts only — 'dense' its routed ones on every token,
  'scatter' its routed ones' slots (the capacity and the positions are
  the global ones above), 'grouped' their assignments
  (ops/grouped_matmul.py), and the shared experts on the rank that holds
  them — and the ranks' partial outputs are summed by
  `context.reduce_from_expert`. The input and the gates enter through
  `context.copy_to_expert`, so their gradients are the sums over the
  expert ranks, as the reference's `shard_map` transposes them. The
  router, the statistics and the bias are whole and equal on every
  expert rank; the statistics reduce over the batch ranks only.
* Tensor parallelism (parallel/tensor.py sets `tp` = (rank, tp) and cuts
  the weights): `c_fc` / `experts_fc` are column-parallel in the per-rank
  [gate_r | up_r] layout and `c_proj` / `experts_proj` row-parallel, so a
  rank runs the MLP, and the grouped kernels, on its up_dim / tp local
  widths; the input enters through `copy_to_model` and the ranks' partial
  outputs are summed by `reduce_from_model`. The router `gate` and
  `expert_bias` stay whole: every model rank routes its (identical) tokens
  alike, and the gates enter the rank-local expert products through
  `copy_to_model`, so the router's gradient is the sum over the ranks'
  pieces. The routing statistics reduce over the 'data' group only: the
  model ranks of one data rank see the same tokens.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
from distributed_pytorch_tpu_torch.ops.dropout import dropout
from distributed_pytorch_tpu_torch.ops.quant import maybe_quantized_matmul
from distributed_pytorch_tpu_torch.parallel import context


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = name.lower()
    table = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "swish": F.silu,
        "silu": F.silu,
        "mish": F.mish,
        "selu": F.selu,
        "celu": F.celu,
        "elu": F.elu,
        "sigmoid": torch.sigmoid,
        "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "tanh": torch.tanh,
    }
    return table.get(name, lambda x: F.gelu(x, approximate="none"))


def _is_gated(name: str) -> bool:
    return name.lower() in ("swiglu", "glu")


def activate(h: torch.Tensor, non_linearity: str) -> torch.Tensor:
    """The nonlinearity on the fc product: gated variants split it in half,
    act(x1) * x2 with the gate first; the others map it elementwise."""
    if _is_gated(non_linearity):
        x1, x2 = h.chunk(2, dim=-1)
        gate = F.silu(x1) if non_linearity.lower() == "swiglu" \
            else torch.sigmoid(x1)
        return gate * x2
    return _activation(non_linearity)(h)


def mlp_apply(x: torch.Tensor, w_fc: torch.Tensor, w_proj: torch.Tensor,
              non_linearity: str, qnames=None) -> torch.Tensor:
    """Apply one MLP given its (in, out) weights. Gated variants: w_fc is
    (C, 2*up_dim), split in half, h = act(x1) * x2. `qnames` (fc name,
    proj name) offers both products to the active quantized store."""
    fc_name, proj_name = qnames or (None, None)
    h = maybe_quantized_matmul(x, fc_name)
    if h is None:
        h = x @ w_fc
    h = activate(h, non_linearity)
    y = maybe_quantized_matmul(h, proj_name)
    return h @ w_proj if y is None else y


class MLP(nn.Module):
    """Dense feed-forward block; weights in the model's compute dtype."""

    tp = (0, 1)

    def __init__(self, config: LLMConfig, *, device=None, dtype=None):
        super().__init__()
        C, up = config.n_embd, config.up_dim
        fc_out = 2 * up if _is_gated(config.non_linearity) else up
        self.non_linearity = config.non_linearity
        self.dropout = config.dropout
        self.c_fc = nn.Parameter(torch.empty(C, fc_out, device=device,
                                             dtype=dtype))
        self.c_proj = nn.Parameter(torch.empty(up, C, device=device,
                                               dtype=dtype))

    def forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        name = getattr(self, "qname", None)
        y = mlp_apply(context.copy_to_model(x), self.c_fc.to(x.dtype),
                      self.c_proj.to(x.dtype), self.non_linearity,
                      name and (name + ".c_fc", name + ".c_proj"))
        y = context.reduce_from_model(y)
        if self.training and self.dropout > 0.0:
            y = dropout(y, self.dropout, dropout_seed)
        return y


def scatter_positions(one_hot: torch.Tensor, topk_idx: torch.Tensor,
                      B: int, before=None) -> torch.Tensor:
    """(N, k): each assignment's place in its expert's queue in the global
    flattened (B, T) order. one_hot (N, k, E) of topk_idx (N, k), N = B x
    the rank's positions of a row; `before` (E,): the assignments of the
    data ranks before this one (None: none). Under a 'seq' axis a row's
    positions are this rank's runs of them (ops/ring_attention.py
    `local_positions`: one run contiguous, two zig-zag stripes), and the
    other seq ranks' counts of each run are gathered."""
    N, _, E = one_hot.shape
    sp, layout = context.seq_size(), context.seq_layout()
    runs = 2 if sp > 1 and layout == "zigzag" else 1
    hits = one_hot.sum(dim=1).view(B, runs, N // (B * runs), E)
    inside = hits.cumsum(dim=2) - hits               # within the run
    cnt = hits.sum(dim=2)                            # (B, runs, E)
    s = context.seq_rank()
    if sp > 1:
        cnt = context.seq_all_gather_stack(cnt)      # (sp, B, runs, E)
        # run i of seq rank r is stripe r (contiguous, or zig-zag's first)
        # or 2 sp - 1 - r (zig-zag's second) of the row's runs x sp
        stripe = [[r, 2 * sp - 1 - r][:runs] for r in range(sp)]
        order = torch.empty(runs * sp, dtype=torch.long, device=cnt.device)
        for r in range(sp):
            for i in range(runs):
                order[stripe[r][i]] = r * runs + i
        cnt = cnt.permute(1, 0, 2, 3).reshape(B, sp * runs, E)[:, order]
        mine = [stripe[s][i] for i in range(runs)]
    else:
        mine = list(range(runs))
    prev = cnt.cumsum(dim=1) - cnt                   # runs before, in a row
    row = cnt.sum(dim=1)
    rows_before = row.cumsum(dim=0) - row            # (B, E)
    pos = inside + (rows_before[:, None] + prev[:, mine])[:, :, None]
    if before is not None:
        pos = pos + before
    return pos.reshape(N, E).gather(1, topk_idx.long())


def scatter_dispatch(x_flat: torch.Tensor, topk_idx: torch.Tensor,
                     topk_gates: torch.Tensor, experts_fc: torch.Tensor,
                     experts_proj: torch.Tensor, *, non_linearity: str,
                     capacity: int, gpos=None) -> torch.Tensor:
    """Capacity-bounded sort-based routed-expert dispatch (reference
    :193). x_flat (N, C); topk_idx/topk_gates (N, k) over the E routed
    experts whose stacked weights are experts_fc (E, C, fc_out) /
    experts_proj (E, up, C), in x's dtype; ids outside [0, E) are other
    ranks' experts and dispatch nothing here. Returns (N, C). Assignments
    past an expert's `capacity` are dropped (earlier tokens win); `gpos`
    (N, k), where given, is each assignment's global place in its
    expert's queue (`scatter_positions`), else its place among these N
    tokens. The tokens and gates reach the (E, slots) grid, slots =
    min(capacity, N k), through `gather_rows` and come back through
    `combine_rows` (ops/grouped_matmul.py): unfilled slots are zero and
    feed no token, and no direction scatter-adds."""
    N, k = topk_idx.shape
    E = experts_fc.shape[0]
    slots = min(capacity, N * k)
    R = E * slots
    dev = x_flat.device

    flat_e = topk_idx.reshape(-1)
    local = (flat_e >= 0) & (flat_e < E)
    flat_e = torch.where(local, flat_e, E)
    flat_t = torch.arange(N * k, device=dev) // k          # owning token
    order = torch.argsort(flat_e, stable=True)             # group by expert
    se = flat_e[order]
    starts = torch.searchsorted(se, torch.arange(E + 1, device=dev))
    pos = torch.arange(N * k, device=dev) - starts[se]     # rank in expert
    glob = pos if gpos is None else gpos.reshape(-1)[order]
    keep = (se < E) & (glob < capacity)
    # dropped assignments point at row R: a row of zeros
    slot = torch.where(keep, se * slots + pos, R)
    pk = gm.pack(order, slot, flat_t, R)
    slot_of = pk.slot.reshape(N, k)
    gate = gm.gather_rows(topk_gates.reshape(-1, 1).float(), pk.row_asg,
                          pk.filled, pk.slot[:, None])
    xg = gm.gather_rows(x_flat, pk.row_tok, pk.filled, slot_of)
    C = x_flat.shape[1]          # explicit: a rank may hold E = 0 routed
    y = mlp_apply(xg.reshape(E, slots, C), experts_fc, experts_proj,
                  non_linearity)
    y = y * gate.reshape(E, slots, 1).to(x_flat.dtype)  # (E, slots, C)
    return gm.combine_rows(y.reshape(R, C), slot_of, pk.row_tok, pk.filled)


class MoE(nn.Module):
    """DeepSeekMoE layer (reference :244-384); `forward` returns (y,
    aux_loss). Expert e's weights are slice [e] of the stacks; the first
    n_shared are the shared experts. Under an 'expert' axis (`ep`) the
    stacks hold the rank's slice of the experts."""

    tp = (0, 1)
    ep = (0, 1)

    def __init__(self, config: LLMConfig, *, device=None, dtype=None):
        super().__init__()
        cfg = config
        C, up = cfg.n_embd, cfg.up_dim
        fc_out = 2 * up if _is_gated(cfg.non_linearity) else up
        self.config = cfg
        self.experts_fc = nn.Parameter(torch.empty(
            cfg.n_exp, C, fc_out, device=device, dtype=dtype))
        self.experts_proj = nn.Parameter(torch.empty(
            cfg.n_exp, up, C, device=device, dtype=dtype))
        self.gate = nn.Parameter(torch.empty(
            C, cfg.n_routed, device=device, dtype=torch.float32))
        if cfg.aux_free:
            self.register_buffer("expert_bias", torch.zeros(
                cfg.n_routed, device=device, dtype=torch.float32))
        self.register_buffer("dropped_frac", torch.zeros(
            (), device=device, dtype=torch.float32))
        self.pending_state = None
        self.warned_dense = False

    @torch.no_grad()
    def commit_state(self) -> None:
        """Write the `expert_bias` and `dropped_frac` of the last training
        forward into the buffers (a no-op when none is pending)."""
        if self.pending_state is None:
            return
        bias, drop = self.pending_state
        if bias is not None:
            self.expert_bias.copy_(bias)
        self.dropped_frac.copy_(drop)
        self.pending_state = None

    def forward(self, x: torch.Tensor, stats_weight: float = 1.0,
                bias=None):
        """(y, aux loss). `stats_weight` scales the aux loss and the
        aux-free bias step (a pipeline microbatch's 1/M,
        models/pipeline.py); `bias`, where given, is the routing bias to
        use in place of the `expert_bias` buffer (the one a recomputed
        pipeline block's microbatch routed with)."""
        cfg = self.config
        B, T, C = x.shape
        dt = x.dtype
        n_shared, n_routed, k = cfg.n_shared, cfg.n_routed, cfg.n_act_routed
        if self.ep[1] != context.expert_size():
            raise RuntimeError(
                f"an MoE cut for ep={self.ep[1]} runs under a world whose "
                f"'expert' axis has {context.expert_size()} rank(s)")
        # this rank's experts: global ids [lo, lo + E); n_sh of them shared,
        # then the routed ids [r_lo, r_lo + E - n_sh)
        E = self.experts_fc.shape[0]
        lo = self.ep[0] * E
        n_sh = max(0, min(n_shared, lo + E) - lo)
        r_lo = lo + n_sh - n_shared
        x_flat = x.reshape(-1, C)
        n_tokens = x_flat.shape[0]
        fc = self.experts_fc.to(dt)
        proj = self.experts_proj.to(dt)
        # the experts' input: its gradient summed over the model and expert
        # ranks
        x_exp = context.copy_to_expert(context.copy_to_model(x_flat))

        use_grouped = False
        if cfg.moe_impl == "grouped":
            use_grouped = gm.grouped_usable(cfg, dt, x.device,
                                            tp=self.tp[1], ep=self.ep[1])
            if not use_grouped:
                gm.DEGRADED["dense"] += 1
                if not self.warned_dense:
                    self.warned_dense = True
                    warnings.warn(
                        f"moe_impl='grouped' refused for {dt} on "
                        f"{x.device.type} (n_embd {C}, up_dim {cfg.up_dim}):"
                        f" this layer takes the 'dense' dispatch, "
                        f"{n_routed}/{k} x the routed experts' FLOPs",
                        RuntimeWarning, stacklevel=2)

        # shared experts (reference :286-297); the grouped path runs them
        # in its kernels as always-on groups
        shared_out = None
        if n_sh > 0 and not use_grouped:
            shared_out = mlp_apply(x_exp, fc[:n_sh], proj[:n_sh],
                                   cfg.non_linearity).sum(dim=0)

        # router in fp32 (reference :299-329)
        logits = x_flat.float() @ self.gate.float()        # (N, n_routed)
        if cfg.aux_free:
            if bias is None:
                bias = self.expert_bias
            topk_idx = (logits + bias).topk(k, dim=1).indices
            # gates from the UNbiased logits of the selected experts
            topk_gates = torch.softmax(logits.gather(1, topk_idx), dim=1)
        else:
            topk_vals, topk_idx = logits.topk(k, dim=1)
            topk_gates = torch.softmax(topk_vals, dim=1)
        # the rank-local expert products' gates: their gradient summed over
        # the model and expert ranks
        topk_gates = context.copy_to_expert(context.copy_to_model(topk_gates))
        one_hot = F.one_hot(topk_idx, n_routed).float()
        load = one_hot.sum(dim=(0, 1)).detach()             # per expert
        # the global batch's counts under a data-parallel recipe
        counts = context.batch_all_gather_stack(load)       # (W, E) | None
        W, before = 1, None
        if counts is not None:
            W, d = counts.shape[0], context.data_rank()
            load = counts.sum(dim=0)
            before = counts.view(context.data_size(), -1, n_routed)[:d] \
                .sum(dim=(0, 1))
        n_glob = n_tokens * W
        fi = load / n_glob
        pi = torch.softmax(logits, dim=1).mean(dim=0)
        coef = cfg.alpha if cfg.aux_free else cfg.coeff
        aux_loss = coef * n_routed * (pi * fi).sum()

        # routed dispatch (reference :331-371)
        dropped_frac = torch.zeros((), device=x.device)
        if cfg.moe_impl == "scatter":
            capacity = max(k, math.ceil(
                cfg.capacity_factor * n_glob * k / n_routed))
            dp = context.data_size()
            capacity = -(-capacity // dp) * dp
            gpos = None
            if W > 1:
                gpos = scatter_positions(one_hot.detach(), topk_idx, B,
                                         before)
            routed_out = scatter_dispatch(
                x_exp, topk_idx - r_lo, topk_gates, fc[n_sh:], proj[n_sh:],
                non_linearity=cfg.non_linearity, capacity=capacity,
                gpos=gpos)
            dropped_frac = (load - capacity).clamp_min(0).sum() \
                / float(n_glob * k)
        elif use_grouped:
            routed_out = gm.grouped_dispatch(
                x_exp, topk_idx, topk_gates, fc, proj,
                act=functools.partial(activate,
                                      non_linearity=cfg.non_linearity),
                n_shared=n_shared, ep=self.ep)
        else:
            combine = (one_hot * topk_gates[..., None]).sum(dim=1)  # (N, E)
            combine = combine[:, r_lo:r_lo + E - n_sh]
            all_routed = mlp_apply(x_exp, fc[n_sh:], proj[n_sh:],
                                   cfg.non_linearity)       # (E, N, C)
            routed_out = torch.einsum("enc,ne->nc", all_routed,
                                      combine.to(dt))

        if self.training:
            new_bias = None
            if cfg.aux_free:
                step = cfg.gamma * (1.0 / n_routed - fi)
                if stats_weight != 1.0:
                    step = step * stats_weight
                new_bias = bias + step
            self.pending_state = (new_bias, dropped_frac.detach())

        y = routed_out if shared_out is None else shared_out + routed_out
        y = context.reduce_from_expert(context.reduce_from_model(y))
        aux_loss = aux_loss.float()
        if stats_weight != 1.0:
            aux_loss = aux_loss * stats_weight
        return y.reshape(B, T, C), aux_loss
