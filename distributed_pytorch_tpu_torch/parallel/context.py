"""The ambient data-parallel world.

Counterpart of the data-axis part of the reference package's
`parallel/context.py` (:20-30), which publishes the trainer's mesh so that
code inside the model can issue collectives over it. The trainer publishes
its `World` (parallel/mesh.py) here for the length of a run; the loss
(ops/losses.py, ops/fused_ce.py) and the MoE's routing statistics
(models/mlp.py) read it to compute over the global batch, as the
reference's do under pjit. With no world published, or the single
recipe's, every helper is the identity and nothing communicates: serving
and one-device training never see a collective.

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


def distributed() -> bool:
    """Whether a world with a group is published."""
    return _live() is not None


def data_size() -> int:
    """Ranks on the 'data' axis (1 with no group)."""
    w = _live()
    return w.size if w is not None else 1


def data_rank() -> int:
    w = _live()
    return w.rank if w is not None else 0


@contextlib.contextmanager
def use_world(world: Optional[World]):
    global _WORLD
    prev, _WORLD = _WORLD, world
    try:
        yield world
    finally:
        _WORLD = prev


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks (in place; returned)."""
    if _live() is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """t averaged over the ranks (in place; returned)."""
    w = _live()
    if w is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(w.size)
    return t


def all_gather_stack(t: torch.Tensor) -> Optional[torch.Tensor]:
    """(W, *t.shape): every rank's t in rank order, or None with no
    group."""
    w = _live()
    if w is None:
        return None
    out = torch.empty(w.size * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1))
    return out.view((w.size,) + tuple(t.shape))


def any_rank(flag: bool, device=None) -> bool:
    """Whether the flag is set on any rank (a max over the ranks)."""
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
