"""The ambient world: its data group, its model group and the whole of it.

Counterpart of the reference package's `parallel/context.py` (:20-30),
which publishes the trainer's mesh so that code inside the model can issue
collectives over it. The trainer publishes its `World` (parallel/mesh.py)
here for the length of a run, and three kinds of reduction stay apart:

* over the 'data' group (the ranks that hold the same model pieces and
  different rows): the loss's valid count and the logged loss
  (ops/losses.py, train/step.py), the MoE's routing statistics
  (models/mlp.py) — `all_reduce_sum`, `all_reduce_mean`,
  `all_gather_stack`, `data_size`, `data_rank`;
* over the 'model' group (the tp ranks of one data rank, which hold the
  same rows and different pieces of the model): the tensor-parallel
  layers' collectives — `model_size`, `model_rank`, `model_all_reduce`,
  and the autograd pair `copy_to_model` (identity forward, sum over the
  group backward) / `reduce_from_model` (sum forward, identity backward),
  Megatron's f and g, plus `gather_from_model`;
* over the whole world: the stop flag, broadcasts, barriers and the
  gradient norm's cut pieces — `any_rank`, `broadcast_object`, `barrier`,
  `world_all_reduce_sum`.

With no 'model' axis the data group is the whole world and every model
helper is the identity. With no world published, or the single recipe's,
every helper is the identity and nothing communicates: serving and
one-device training never see a collective.

The world is a module global rather than a context variable: the autograd
engine recomputes checkpointed blocks on its own threads, which do not see
the caller's context variables. The 'seq', expert and overlap contexts come
with their recipes.
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


@contextlib.contextmanager
def use_world(world: Optional[World]):
    global _WORLD
    prev, _WORLD = _WORLD, world
    try:
        yield world
    finally:
        _WORLD = prev


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
# the 'model' group
# ---------------------------------------------------------------------------

def model_all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t reduced over the model ranks (in place; returned)."""
    w = _model()
    if w is not None:
        dist.all_reduce(t, op=op, group=w.model_group)
    return t


def model_all_gather(t: torch.Tensor) -> list:
    """Every model rank's t (same shape on each), in model-rank order."""
    w = _model()
    if w is None:
        return [t]
    t = t.contiguous()
    out = torch.empty((w.tp,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out.view(-1), t.view(-1),
                                group=w.model_group)
    return list(out.unbind(0))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return model_all_reduce(g.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return model_all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g


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
    return _CopyToModel.apply(x) if _model() is not None else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model ranks (the output of a row-parallel
    product, each rank's partial sum); its gradient passes as it is."""
    return _ReduceFromModel.apply(x) if _model() is not None else x


def gather_from_model(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model ranks' x concatenated along `dim` in rank order; the
    gradient of each rank's slice comes back to it."""
    if _model() is None:
        return x
    return _GatherFromModel.apply(x, dim % x.dim())


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
