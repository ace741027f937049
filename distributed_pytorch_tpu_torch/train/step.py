"""The training and eval steps.

Counterpart of the reference package's `train/step.py` (`make_grads_fn`
:60-160, `make_train_step` :163-253, `make_eval_step` :300-322), run
eagerly: one call of `train_step(state, x, y)` takes x, y (A, B, T) — the
whole optimizer step, this rank's rows of it — runs A micro-batches
forward and backward (gradients accumulate in `.grad`), divides the
gradients by A, clips them by global norm and applies AdamW at the
schedule's learning rate.

* Data-parallel recipes (parallel/sharding.py): the forward runs through
  `state.recipe.module`, each micro-step inside `recipe.micro_step(last)`
  (DDP's `no_sync` on all but the last), followed by
  `recipe.after_backward()` (zero2's reduce-scatter); `recipe.grads()`
  hands back the local gradients, already averaged over the ranks, and
  `recipe.grad_norm` sums their squares over the ranks where they are
  sharded. The logged loss is all-reduced over the ranks holding
  different tokens (data x seq), so the `nonfinite` and
  `update_skipped` decisions read the same values on every rank and every
  rank steps or skips together.

* Dropout: micro-batch `m` of step `s` uses the seed `subseed(seed, s, m)`
  (ops/dropout.py), drawn here, outside every recomputed region, so
  activation recomputation regenerates the masks it drew.
* MoE routing state (models/mlp.py): after each micro-step's backward
  the step commits every MoE layer's new `expert_bias` and
  `dropped_frac`, so the bias moves once per micro-step and the next
  micro-step routes with it, as the reference's scan carries its
  `moe_state` (step.py:136-147).
* Fault injection: TRAIN_POISON_IT=k NaN-bombs iteration k's loss and
  gradients, as a poisoned batch would.
* Anomaly guard (`train_cfg.anomaly`): 'warn' and 'skip' add `nonfinite`
  (1.0 when the loss or the gradient norm is not finite) to the metrics;
  'skip' then withholds the update from the weights, the optimizer
  moments, the MoE routing state (restored to the step's start) and the
  schedule's count while `step` still advances, so the data stream stays
  step-keyed. 'skip' reads the flag on the host each
  step; 'warn' and 'off' never sync.

Metrics are 0-d device tensors: `loss` (mean over micro-batches),
`grad_norm` (before clipping), `nonfinite`, `update_skipped` under
'skip', and for MoE models `moe_dropped_frac` (the mean over layers of
the fraction of routed assignments 'scatter' dropped; 0 for 'dense' and
'grouped'; reference `_dropped_frac` :38).
"""

from __future__ import annotations

import torch

from distributed_pytorch_tpu_torch import config as cfg_mod
from distributed_pytorch_tpu_torch.config import TrainConfig
from distributed_pytorch_tpu_torch.ops.dropout import subseed
from distributed_pytorch_tpu_torch.parallel import context
from distributed_pytorch_tpu_torch.parallel import sharding
from distributed_pytorch_tpu_torch.train.state import (TrainState,
                                                       clip_by_global_norm,
                                                       lr_schedule)


def make_train_step(train_cfg: TrainConfig):
    """`train_step(state, x, y) -> metrics`, updating `state` in place."""
    poison_it = cfg_mod.knob("TRAIN_POISON_IT")
    anomaly = train_cfg.anomaly
    sched = lr_schedule(train_cfg)

    def train_step(state: TrainState, x: torch.Tensor,
                   y: torch.Tensor) -> dict:
        model, opt = state.model, state.optimizer
        rec = state.recipe or sharding.Recipe(model, opt)
        model.train()
        rec.zero_grad()
        accum = x.shape[0]
        moe = model.moe_layers()
        moe_start = [b.clone() for layer in moe for b in layer.buffers()] \
            if anomaly == "skip" else []
        losses = []
        for m in range(accum):
            with rec.micro_step(last=m == accum - 1):
                _, loss = rec.module(x[m], y[m], dropout_seed=subseed(
                    train_cfg.seed, state.step, m))
                loss.backward()
            rec.after_backward()
            model.commit_moe_state()
            losses.append(loss.detach())
        grads = rec.grads()
        torch._foreach_div_(grads, float(accum))
        losses = torch.stack(losses)
        if 0 <= poison_it == state.step:
            losses = losses * float("nan")
            torch._foreach_mul_(grads, float("nan"))
        gnorm = rec.grad_norm(grads)
        metrics = {"loss": context.batch_all_reduce_mean(losses.mean()),
                   "grad_norm": gnorm}
        apply = True
        if anomaly != "off":
            finite = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
            metrics["nonfinite"] = (~finite).float()
            if anomaly == "skip":
                metrics["update_skipped"] = metrics["nonfinite"]
                apply = bool(finite)
        if not apply:
            with torch.no_grad():
                for b, b0 in zip((b for layer in moe
                                  for b in layer.buffers()), moe_start):
                    b.copy_(b0)
        if moe:
            metrics["moe_dropped_frac"] = torch.stack(
                [layer.dropped_frac for layer in moe]).mean()
        if apply:
            clip_by_global_norm(grads, gnorm, train_cfg.grad_clip)
            lr = sched(state.updates)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            state.updates += 1
        state.step += 1
        return metrics

    return train_step


def make_eval_step():
    """`eval_step(state, x, y) -> loss` on one (B, T) batch, eval mode,
    no gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        _, loss = state.model(x, y)
        return loss

    return eval_step
