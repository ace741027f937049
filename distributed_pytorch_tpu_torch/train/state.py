"""Train state, learning-rate schedule and optimizer.

Counterpart of the reference package's `train/state.py`:
* `lr_schedule` (state.py:41-57): linear warmup max_lr*(i+1)/warmup, then
  cosine decay to 0.1*max_lr over a horizon of max_iters+2, computed in
  fp32 as the reference computes it, and evaluated at the 0-based count
  of updates applied so far, as optax's schedule count is.
* AdamW with betas (0.9, 0.999) and eps 1e-8 over two groups: weight
  decay iff `p.dim() >= 2` (`_decay_mask`, state.py:60-63).
* Global-norm clipping with optax's rule (`clip_by_global_norm`): grads
  scale by max_norm / norm only when norm >= max_norm. (torch's
  `clip_grad_norm_` adds 1e-6 to the norm and always scales, which moves
  the trajectory.)
* 'lion' and 'adafactor' come with a later slice and raise.

The state is mutable: the model's fp32 master weights, the optimizer, the
iteration count `step` (advances every iteration) and `updates` (the
updates applied; an anomaly-skipped step applies none).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.models.gpt import LLM


@dataclass
class TrainState:
    step: int
    model: LLM
    optimizer: torch.optim.Optimizer
    updates: int = 0


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at a 0-based update count."""
    f32 = np.float32
    max_lr = f32(cfg.learning_rate)
    min_lr = f32(0.1 * cfg.learning_rate)
    span = f32(cfg.learning_rate - 0.1 * cfg.learning_rate)
    warmup = cfg.warmup_steps
    horizon = cfg.max_iters + 2  # the reference: "avoid division by zero"

    def schedule(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(max_lr * (s + f32(1.0)) / f32(warmup))
        if s > horizon:
            return float(min_lr)
        ratio = np.clip((s - f32(warmup)) / f32(horizon - warmup), f32(0.0),
                        f32(1.0))
        coeff = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * ratio))
        return float(min_lr + coeff * span)

    return schedule


def _decay_mask(p: torch.Tensor) -> bool:
    """Weight decay iff the tensor has rank >= 2 (weights, embeddings)."""
    return p.dim() >= 2


def make_optimizer(model: torch.nn.Module,
                   cfg: TrainConfig) -> torch.optim.Optimizer:
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer={cfg.optimizer!r} comes with a later slice of the "
            "port (ROADMAP Queue 1); the training slice runs 'adamw'")
    params = list(model.parameters())
    groups = [{"params": [p for p in params if _decay_mask(p)],
               "weight_decay": cfg.weight_decay},
              {"params": [p for p in params if not _decay_mask(p)],
               "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=lr_schedule(cfg)(0),
                             betas=(0.9, 0.999), eps=1e-8)


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient element (fp32)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm(grads: list, norm: torch.Tensor,
                        max_norm: float) -> None:
    """optax's clip, in place: g * max_norm / norm when norm >= max_norm,
    else g unchanged. No host sync."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)


def build_model(model_cfg: LLMConfig, train_cfg: TrainConfig,
                device=None) -> LLM:
    """fp32 master weights computing in `train_cfg.compute_dtype`."""
    return LLM(model_cfg, device=device, dtype=torch.float32,
               compute_dtype=getattr(torch, train_cfg.compute_dtype),
               attn_impl=train_cfg.attn_impl)


def create_train_state(model_cfg: LLMConfig, train_cfg: TrainConfig,
                       device=None) -> TrainState:
    """A fresh state: N(0, 0.02) weights drawn from `train_cfg.seed` on
    the model's device, and a new optimizer."""
    model = build_model(model_cfg, train_cfg, device)
    g = torch.Generator(device=model.device)
    g.manual_seed(train_cfg.seed)
    model.init_weights(g)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, train_cfg))
