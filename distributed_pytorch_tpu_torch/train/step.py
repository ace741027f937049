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

Pipeline parallelism (a 'pipe' axis, models/pipeline.py): a micro-step is
one pipeline of M microbatches through `Pipeline.run`, forward and
mirrored backward; the last stage's loss is one call over the
micro-step's tokens (`head_loss` on the concatenated exits), so the
fused CE kernels launch once a micro-step as under the single recipe,
and the flash and grouped kernels once a (layer, microbatch). The
gradients are reduced over each stage's data group, the tied
embedding's summed over the first and last stage, and the loss (the
last stage's plus the stages' aux), the gradient norm (the tied weight
counted once) and the MoE statistics summed over the 'pipe' group, so
every stage reads the same values, clips alike and skips alike. Layer i
of microbatch m of micro-step k draws its dropout from its own subseed
(`LLM.run_layers`), so dropout does not repeat the single model's masks
(nor does the reference's pp, whose keys are per tick).

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


def _apply_update(states: list, grads: list, gnorm, train_cfg, sched
                  ) -> None:
    """Clip every state's gradients by the global norm and step its
    optimizer at the schedule's learning rate."""
    for st, gs in zip(states, grads):
        clip_by_global_norm(gs, gnorm, train_cfg.grad_clip)
        lr = sched(st.updates)
        for group in st.optimizer.param_groups:
            group["lr"] = lr
        st.optimizer.step()
        st.updates += 1


def make_train_step(train_cfg: TrainConfig):
    """`train_step(state, x, y) -> metrics`, updating `state` in place.
    Under a 'pipe' axis `state` is a rank's stage (a `PipeRecipe`), or
    the list of every stage's states of an in-process pipeline
    (train/state.py `create_pipeline_states`)."""
    poison_it = cfg_mod.knob("TRAIN_POISON_IT")
    anomaly = train_cfg.anomaly
    sched = lr_schedule(train_cfg)

    def guard(metrics: dict, gnorm) -> bool:
        """The anomaly flags; whether to apply the update."""
        if anomaly == "off":
            return True
        finite = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        metrics["nonfinite"] = (~finite).float()
        if anomaly != "skip":
            return True
        metrics["update_skipped"] = metrics["nonfinite"]
        return bool(finite)

    def restore(moe, moe_start) -> None:
        with torch.no_grad():
            for b, b0 in zip((b for layer in moe for b in layer.buffers()),
                             moe_start):
                b.copy_(b0)

    def pipe_step(states: list, x: torch.Tensor, y: torch.Tensor) -> dict:
        """The pp step (models/pipeline.py): each micro-step runs one
        pipeline of M microbatches, forward and mirrored backward; the
        gradients are reduced over each stage's data group, the tied
        embedding's summed over the first and last stage, and the norm,
        the loss and the MoE statistics summed over the 'pipe' group, so
        every stage clips, steps or skips alike."""
        pipe = states[0].recipe.pipe
        cfg = pipe.cfg
        step_no = states[0].step
        for st in states:
            st.model.train()
            st.recipe.zero_grad()
        accum = x.shape[0]
        moe = [layer for st in states for layer in st.model.moe_layers()]
        moe_start = [b.clone() for layer in moe for b in layer.buffers()] \
            if anomaly == "skip" else []
        dev = x.device
        main = torch.zeros((), device=dev)
        aux = torch.zeros((), device=dev)
        for m in range(accum):
            out = pipe.run(x[m], y[m], dropout_seed=subseed(
                train_cfg.seed, step_no, m))
            if out["main"] is not None:
                main = main + out["main"].float()
            if out["aux"] is not None:
                aux = aux + out["aux"].float()
        for layer in moe:
            layer.pending_state = None     # left by recomputed forwards
        grads = [st.recipe.grads() for st in states]
        pipe.tie_grads()
        for gs in grads:
            torch._foreach_div_(gs, float(accum))
        if 0 <= poison_it == step_no:
            main = main * float("nan")
            for gs in grads:
                torch._foreach_mul_(gs, float("nan"))
        sq = {st.model.stage: torch.stack(torch._foreach_norm(
            pipe.norm_grads(st.model.stage))).square().sum()
            for st in states}
        drop = sum((layer.dropped_frac for layer in moe),
                   torch.zeros((), device=dev))
        tot = pipe.sum_over_stages(torch.stack(
            [main, aux, drop, sum(sq.values()).to(main.dtype)]))
        gnorm = tot[3].sqrt()
        loss = (tot[0] + tot[1] / cfg.n_layer) / accum
        metrics = {"loss": context.batch_all_reduce_mean(loss),
                   "grad_norm": gnorm}
        apply = guard(metrics, gnorm)
        if not apply:
            restore(moe, moe_start)
            drop = pipe.sum_over_stages(sum(
                (layer.dropped_frac for layer in moe),
                torch.zeros((), device=dev)))
        else:
            drop = tot[2]
        if cfg.moe:
            metrics["moe_dropped_frac"] = drop / cfg.n_layer
        if apply:
            _apply_update(states, grads, gnorm, train_cfg, sched)
        for st in states:
            st.step += 1
        return metrics

    def train_step(state, x: torch.Tensor, y: torch.Tensor) -> dict:
        if isinstance(state, (list, tuple)):
            return pipe_step(list(state), x, y)
        if isinstance(state.recipe, sharding.PipeRecipe):
            return pipe_step([state], x, y)
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
        apply = guard(metrics, gnorm)
        if not apply:
            restore(moe, moe_start)
        if moe:
            metrics["moe_dropped_frac"] = torch.stack(
                [layer.dropped_frac for layer in moe]).mean()
        if apply:
            _apply_update([state], [grads], gnorm, train_cfg, sched)
        state.step += 1
        return metrics

    return train_step


def make_eval_step():
    """`eval_step(state, x, y) -> loss` on one (B, T) batch, eval mode,
    no gradients (through the pipeline for a pp stage, or the list of an
    in-process pipeline's stages; the loss summed over the 'pipe'
    group)."""

    @torch.no_grad()
    def eval_step(state, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        states = state if isinstance(state, (list, tuple)) else [state]
        if not isinstance(states[0].recipe, sharding.PipeRecipe):
            state.model.eval()
            _, loss = state.model(x, y)
            return loss
        pipe = states[0].recipe.pipe
        for st in states:
            st.model.eval()
        out = pipe.run(x, y, backward=False)
        main = torch.zeros((), device=x.device) if out["main"] is None \
            else out["main"].float()
        aux = torch.zeros((), device=x.device) if out["aux"] is None \
            else out["aux"].float()
        tot = pipe.sum_over_stages(torch.stack([main, aux]))
        return tot[0] + tot[1] / pipe.cfg.n_layer

    return eval_step
