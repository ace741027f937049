"""The ambient world: its data, seq, expert and model groups and the whole
of it.

Counterpart of the reference package's `parallel/context.py` (:20-52),
which publishes the trainer's mesh so that code inside the model can issue
collectives over it. The trainer publishes its `World` (parallel/mesh.py)
here for the length of a run, and these kinds of reduction stay apart:

* over the 'data' group (the ranks that hold the same model pieces and
  different rows): the sharded gradients' norm (train/state.py) —
  `all_reduce_sum`, `all_reduce_mean`, `all_gather_stack`, `data_size`,
  `data_rank`;
* over the batch ranks, data x seq (the ranks that hold different tokens:
  the 'data' group when there is no 'seq' axis): the loss's valid count
  and the logged loss (ops/losses.py, train/step.py), the eval means, the
  MoE's routing statistics (models/mlp.py) — `batch_size`, `batch_rank`,
  `batch_all_reduce_sum`, `batch_all_reduce_mean`,
  `batch_all_gather_stack`;
* over the 'seq' group (the sp ranks of one data rank, which hold
  different positions of the same rows): ring and Ulysses attention
  (ops/ring_attention.py) — `seq_size`, `seq_rank`, `seq_impl`,
  `seq_layout`, the neighbour permute `seq_permute` (the reference's
  `ppermute`; its gradient goes the other way) with its asynchronous form
  `seq_permute_start`, the tiled `seq_all_to_all` (the reference's
  `all_to_all`; its gradient is the inverse all-to-all), the MoE's
  'scatter' counts `seq_all_gather_stack`, and `sp_region`, inside which
  attention does not route to the 'seq' path again (the reference's
  `sp_region`, :29-52);
* over the 'expert' group (the ep ranks of one data rank, which hold the
  same rows and different experts): the MoE's expert-parallel dispatch
  (models/mlp.py, ops/grouped_matmul.py) — `expert_size`, `expert_rank`,
  `expert_all_reduce`, `expert_all_gather`, and the autograd pair
  `copy_to_expert` (identity forward, sum over the group backward: the
  experts' input and gates) / `reduce_from_expert` (sum forward, identity
  backward: the ranks' partial outputs), the counterparts of the
  reference's `shard_map` in and out of its 'expert' axis;
* over the 'model' group (the tp ranks of one data rank, which hold the
  same rows and different pieces of the model): the tensor-parallel
  layers' collectives — `model_size`, `model_rank`, `model_all_reduce`,
  and the autograd pair `copy_to_model` (identity forward, sum over the
  group backward) / `reduce_from_model` (sum forward, identity backward),
  Megatron's f and g, plus `gather_from_model`;
* over the whole world: the stop flag, broadcasts, barriers and the
  gradient norm's cut pieces — `any_rank`, `broadcast_object`, `barrier`,
  `world_all_reduce_sum`.

With no 'seq' axis the batch ranks are the data ranks (the expert ranks
of one data rank hold its rows, so they count as one); with no 'expert'
or 'model' axis every expert or model helper is the identity. With no world published, or the
single recipe's, every helper is the identity and nothing communicates:
serving and one-device training never see a collective.

The world is a module global rather than a context variable: the autograd
engine recomputes checkpointed blocks on its own threads, which do not see
the caller's context variables. The overlap context comes with its
recipe.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
import torch.distributed as dist

from distributed_pytorch_tpu_torch.parallel.mesh import World

_WORLD: Optional[World] = None


def get_world() -> Optional[World]:
    return _WORLD


def _live() -> Optional[World]:
    w = _WORLD
    return w if w is not None and w.distributed else None


def _model() -> Optional[World]:
    """The live world when it has a 'model' axis of more than one rank."""
    w = _live()
    return w if w is not None and w.tp > 1 else None


def _expert() -> Optional[World]:
    """The live world when it has an 'expert' axis of more than one
    rank."""
    w = _live()
    return w if w is not None and w.ep > 1 else None


def distributed() -> bool:
    """Whether a world with a group is published."""
    return _live() is not None


def data_size() -> int:
    """Ranks on the 'data' axis (1 with no group)."""
    w = _live()
    return w.dp if w is not None else 1


def data_rank() -> int:
    w = _live()
    return w.data_rank if w is not None else 0


def model_size() -> int:
    """Ranks on the 'model' axis (1 with no group)."""
    w = _live()
    return w.tp if w is not None else 1


def model_rank() -> int:
    w = _live()
    return w.model_rank if w is not None else 0


def expert_size() -> int:
    """Ranks on the 'expert' axis (1 with no group)."""
    w = _live()
    return w.ep if w is not None else 1


def expert_rank() -> int:
    w = _live()
    return w.expert_rank if w is not None else 0


@contextlib.contextmanager
def use_world(world: Optional[World]):
    global _WORLD
    prev, _WORLD = _WORLD, world
    try:
        yield world
    finally:
        _WORLD = prev


def seq_size() -> int:
    """Ranks on the 'seq' axis (1 with no group)."""
    w = _live()
    return w.sp if w is not None else 1


def seq_rank() -> int:
    w = _live()
    return w.seq_rank if w is not None else 0


def seq_impl() -> str:
    """The world's sequence-parallel attention: 'ring', 'zigzag' or
    'ulysses' (ops/ring_attention.py)."""
    w = _live()
    return w.seq_impl if w is not None else "ring"


def seq_layout() -> str:
    """How a row's positions are cut over 'seq': 'contiguous' or
    'zigzag' (ops/ring_attention.py)."""
    w = _live()
    return w.seq_layout if w is not None else "contiguous"


def batch_size() -> int:
    """Ranks holding different tokens, data x seq (1 with no group)."""
    w = _live()
    return w.dp * w.sp if w is not None else 1


def batch_rank() -> int:
    w = _live()
    return w.batch_rank if w is not None else 0


_SP_DEPTH = 0


def in_sp_region() -> bool:
    """Whether a sequence-parallel attention call is running: attention
    inside it does not route to the 'seq' path again."""
    return _SP_DEPTH > 0


@contextlib.contextmanager
def sp_region():
    global _SP_DEPTH
    _SP_DEPTH += 1
    try:
        yield
    finally:
        _SP_DEPTH -= 1


# ---------------------------------------------------------------------------
# the 'data' group
# ---------------------------------------------------------------------------

def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the data ranks (in place; returned)."""
    w = _live()
    if w is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=w.data_group)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """t averaged over the data ranks (in place; returned)."""
    w = _live()
    if w is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=w.data_group)
        t.div_(w.dp)
    return t


def all_gather_stack(t: torch.Tensor) -> Optional[torch.Tensor]:
    """(dp, *t.shape): every data rank's t in data-rank order, or None
    with no group."""
    w = _live()
    if w is None:
        return None
    out = torch.empty(w.dp * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1),
                                group=w.data_group)
    return out.view((w.dp,) + tuple(t.shape))


# ---------------------------------------------------------------------------
# the batch ranks, data x seq
# ---------------------------------------------------------------------------

def batch_all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the data x seq ranks (in place; returned)."""
    w = _live()
    if w is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=w.batch_group)
    return t


def batch_all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """t averaged over the data x seq ranks (in place; returned)."""
    w = _live()
    if w is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=w.batch_group)
        t.div_(w.dp * w.sp)
    return t


def batch_all_gather_stack(t: torch.Tensor) -> Optional[torch.Tensor]:
    """(dp sp, *t.shape): every data x seq rank's t in batch-rank order,
    or None with no group."""
    w = _live()
    if w is None:
        return None
    n = w.dp * w.sp
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1),
                                group=w.batch_group)
    return out.view((n,) + tuple(t.shape))


# ---------------------------------------------------------------------------
# the 'seq' group
# ---------------------------------------------------------------------------

def _seq() -> World:
    w = _live()
    if w is None or w.sp == 1:
        raise RuntimeError("a 'seq' collective needs a published world "
                           "with a 'seq' axis of more than one rank")
    return w


def seq_all_gather_stack(t: torch.Tensor) -> torch.Tensor:
    """(sp, *t.shape): every seq rank's t (same shape on each) in
    seq-rank order. No autograd."""
    w = _seq()
    t = t.contiguous()
    out = torch.empty(w.sp * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape(-1), group=w.seq_group)
    return out.view((w.sp,) + tuple(t.shape))


def seq_permute_start(t: torch.Tensor, shift: int = 1):
    """Start sending t to seq rank (r + shift) mod sp and receiving the
    t of rank (r - shift) mod sp; returns a function that waits and gives
    the received tensor. No autograd (`seq_permute` has it)."""
    w = _seq()
    g, sp, r = w.seq_group, w.sp, w.seq_rank
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(
               g, (r + shift) % sp), g),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(
               g, (r - shift) % sp), g)]
    reqs = dist.batch_isend_irecv(ops)

    def wait() -> torch.Tensor:
        for q in reqs:
            q.wait()
        return out
    return wait


class _SeqPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift):
        ctx.shift = shift
        return seq_permute_start(x, shift)()

    @staticmethod
    def backward(ctx, g):
        return seq_permute_start(g, -ctx.shift)(), None


def seq_permute(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """The t of seq rank (r - shift) mod sp, received while this rank's
    goes to (r + shift) mod sp (the reference's `ppermute` over 'seq');
    the gradient goes the other way."""
    return _SeqPermute.apply(x, shift)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int):
    w = _seq()
    parts = torch.stack(x.chunk(w.sp, dim=split_dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=w.seq_group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _SeqAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim):
        ctx.dims = (split_dim, concat_dim)
        return _all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, concat_dim, split_dim), None, None


def seq_all_to_all(x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """The reference's tiled `all_to_all` over 'seq': x cut into sp
    pieces along `split_dim`, piece i sent to seq rank i, and the pieces
    received from ranks 0 .. sp-1 joined along `concat_dim`; the gradient
    takes the inverse all-to-all."""
    return _SeqAllToAll.apply(x, split_dim % x.dim(), concat_dim % x.dim())


# ---------------------------------------------------------------------------
# the 'model' group
# ---------------------------------------------------------------------------

def model_all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t reduced over the model ranks (in place; returned)."""
    w = _model()
    if w is not None:
        dist.all_reduce(t, op=op, group=w.model_group)
    return t


def _gather_list(t: torch.Tensor, n: int, group) -> list:
    """Every rank's t (same shape on each) of a group of n, in rank
    order."""
    t = t.contiguous()
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out.view(-1), t.view(-1), group=group)
    return list(out.unbind(0))


def model_all_gather(t: torch.Tensor) -> list:
    """Every model rank's t (same shape on each), in model-rank order."""
    w = _model()
    return [t] if w is None else _gather_list(t, w.tp, w.model_group)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed by `reduce` (in place)."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.reduce(g.contiguous().clone()), None


class _ReduceFrom(torch.autograd.Function):
    """x summed by `reduce` forward; the gradient as it is."""

    @staticmethod
    def forward(ctx, x, reduce):
        return reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return torch.cat(model_all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = model_rank()
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x as it is, its gradient summed over the model ranks: the input of
    a column-parallel product, whose every rank adds its piece's part of
    the gradient."""
    return _CopyTo.apply(x, model_all_reduce) if _model() is not None else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model ranks (the output of a row-parallel
    product, each rank's partial sum); its gradient passes as it is."""
    return _ReduceFrom.apply(x, model_all_reduce) if _model() is not None \
        else x


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model ranks' x concatenated along `dim` in rank order; the
    gradient of each rank's slice comes back to it."""
    if _model() is None:
        return x
    return _GatherFromModel.apply(x, dim % x.dim())


# ---------------------------------------------------------------------------
# the 'expert' group
# ---------------------------------------------------------------------------

def expert_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """t summed over the expert ranks (in place; returned)."""
    w = _expert()
    if w is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=w.expert_group)
    return t


def expert_all_gather(t: torch.Tensor) -> list:
    """Every expert rank's t (same shape on each), in expert-rank order."""
    w = _expert()
    return [t] if w is None else _gather_list(t, w.ep, w.expert_group)


def copy_to_expert(x: torch.Tensor) -> torch.Tensor:
    """x as it is, its gradient summed over the expert ranks: the MoE's
    input and gates, of which every rank's local experts take a part."""
    return _CopyTo.apply(x, expert_all_reduce) if _expert() is not None \
        else x


def reduce_from_expert(x: torch.Tensor) -> torch.Tensor:
    """x summed over the expert ranks (each rank's local experts'
    partial output); its gradient passes as it is."""
    return _ReduceFrom.apply(x, expert_all_reduce) \
        if _expert() is not None else x


# ---------------------------------------------------------------------------
# the whole world
# ---------------------------------------------------------------------------

def world_all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over every rank of the world (in place; returned)."""
    if _live() is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def any_rank(flag: bool, device=None) -> bool:
    """Whether the flag is set on any rank (a max over the world)."""
    w = _live()
    if w is None:
        return flag
    t = torch.tensor([int(flag)], device=device or w.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_object(obj: Any) -> Any:
    """Rank 0's object on every rank (pickled through the group)."""
    w = _live()
    if w is None or w.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    w = _live()
    if w is not None:
        if w.backend == "nccl":
            dist.barrier(device_ids=[w.local_rank])
        else:
            dist.barrier()
