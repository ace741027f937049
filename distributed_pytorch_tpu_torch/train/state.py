"""Train state, learning-rate schedule and optimizer.

Counterpart of the reference package's `train/state.py`:
* `lr_schedule` (state.py:41-57): linear warmup max_lr*(i+1)/warmup, then
  cosine decay to 0.1*max_lr over a horizon of max_iters+2, computed in
  fp32 as the reference computes it, and evaluated at the 0-based count
  of updates applied so far, as optax's schedule count is.
* AdamW with betas (0.9, 0.999) and eps 1e-8 over two groups: weight
  decay iff `p.dim() >= 2` (`_decay_mask`, state.py:60-63); on a pipeline
  stage every block parameter decays, as the reference's rank rule does
  on its stacked blocks under pp.
* Lion and Adafactor with optax's rules (state.py:77-99: `optax.lion`
  with b1 0.9, b2 0.99; `optax.adafactor` with its defaults and a
  constant weight_decay_rate = weight_decay * learning_rate), as
  `torch.optim.Optimizer`s on foreach ops. torch's own `Adafactor`
  follows other rules (its decay, clipping and scaling differ), so it is
  not used.
* Global-norm clipping with optax's rule (`clip_by_global_norm`): grads
  scale by max_norm / norm only when norm >= max_norm, before any of the
  three rules. (torch's `clip_grad_norm_` adds 1e-6 to the norm and always
  scales, which moves the trajectory.)

The state is mutable: the model's fp32 master weights, the optimizer, the
iteration count `step` (advances every iteration), `updates` (the
updates applied; an anomaly-skipped step applies none) and the parallel
`recipe` (parallel/sharding.py) that the train step drives. Under `fsdp`
the model's parameters are DTensor shards; under `zero1` / `zero2` the
optimizer is the recipe's `ZeroOptimizer`; under a 'model' axis the cut
parameters are this rank's pieces, and under an 'expert' axis the expert
stacks this rank's experts (parallel/tensor.py). Under a 'pipe' axis the
model is this rank's pipeline stage, cut from the whole seeded init
(models/pipeline.py); `create_pipeline_states` builds every stage in one
process.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Callable

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
    recipe: Any = None
    param_counts: Any = None


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


class Lion(torch.optim.Optimizer):
    """optax.lion (scale_by_lion, add_decayed_weights, scale by -lr): the
    update is sign((1 - b1) g + b1 m) (+ weight_decay p), then m = (1 - b2)
    g + b2 m. One moment per parameter (`exp_avg`)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            gs = [p.grad for p in ps]
            for p in ps:
                if "exp_avg" not in self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
            ms = [self.state[p]["exp_avg"] for p in ps]
            b1, b2 = group["b1"], group["b2"]
            u = torch._foreach_mul(gs, 1.0 - b1)
            torch._foreach_add_(u, torch._foreach_mul(ms, b1))
            torch._foreach_sign_(u)
            if group["weight_decay"]:
                torch._foreach_add_(u, torch._foreach_mul(
                    ps, group["weight_decay"]))
            torch._foreach_mul_(u, -group["lr"])
            torch._foreach_add_(ps, u)
            torch._foreach_mul_(ms, b2)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b2))


def _factored_dims(shape) -> tuple[int, int] | None:
    """optax's rule: the (second largest, largest) axes when both are at
    least 128 long, else None (an unfactored second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


class Adafactor(torch.optim.Optimizer):
    """optax.adafactor with its defaults: factored second moments (row and
    column means of g^2 + 1e-30 over the two largest axes) for parameters
    whose second-largest axis is >= 128,
    decay 1 - (k + 1)^-0.8 at the k-th update, the update clipped to block
    RMS 1, scaled by lr and by max(RMS(p), 1e-3), plus weight_decay p
    (a constant rate), subtracted."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 cut=()):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        # parameters an 'expert' axis cuts: their block RMS is the whole
        # tensor's, summed over the expert ranks
        self.cut = {id(p) for p in cut}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, group)

    def _rms(self, p, x):
        if id(p) not in self.cut:
            return _rms(x)
        from distributed_pytorch_tpu_torch.parallel import context
        sq = context.expert_all_reduce(x.square().sum())
        return (sq / (x.numel() * context.expert_size())).sqrt()

    def _update(self, p, g, group):
        st = self.state[p]
        dims = _factored_dims(tuple(p.shape))
        if not st:
            st["step"] = 0
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                st["v_row"] = torch.zeros_like(p.mean(dim=dims[1]))
                st["v_col"] = torch.zeros_like(p.mean(dim=dims[0]))
        t = np.float32(st["step"] + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-0.8))
        g_sqr = g * g + 1e-30
        if dims is None:
            v = st["v"]
            v.mul_(decay).add_(g_sqr.mul_(1.0 - decay))
            u = g * v.pow(-0.5)
        else:
            d1, d0 = dims
            v_row, v_col = st["v_row"], st["v_col"]
            v_row.mul_(decay).add_(g_sqr.mean(dim=d0).mul_(1.0 - decay))
            v_col.mul_(decay).add_(g_sqr.mean(dim=d1).mul_(1.0 - decay))
            # v_row lacks axis d0: normalise over what was axis d1 only,
            # so each leading index (each expert of a stacked MoE weight)
            # is normalised on its own, as optax's row_col_mean is
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)
                   ).pow(-0.5)
            u = g * row.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
        u = u / torch.clamp_min(self._rms(p, u), 1.0)  # clip_by_block_rms
        u = u * group["lr"]
        rms = self._rms(p, p)
        u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p.sub_(u)
        st["step"] += 1


def make_optimizer(model: torch.nn.Module,
                   cfg: TrainConfig) -> torch.optim.Optimizer:
    """`cfg.optimizer`'s rule over two groups: weight decay iff
    `_decay_mask`. The learning rate is set before every step (the
    schedule's value at the count of updates applied)."""
    # a pipeline stage's blocks decay whatever their rank: the reference
    # stacks them on a layer axis under pp, so its rank rule decays the
    # LayerNorm scales and the biases there too
    stage = getattr(model, "stage", None) is not None
    named = list(model.named_parameters())
    decayed = [p for n, p in named
               if _decay_mask(p) or (stage and n.startswith("blocks."))]
    ids = {id(p) for p in decayed}
    lr0 = lr_schedule(cfg)(0)

    def groups(wd):
        return [{"params": decayed, "weight_decay": wd},
                {"params": [p for _, p in named if id(p) not in ids],
                 "weight_decay": 0.0}]

    if cfg.optimizer == "lion":
        if cfg.learning_rate > 2e-4:
            warnings.warn(
                f"optimizer=lion with learning_rate={cfg.learning_rate:g}: "
                "Lion's sign-based update typically needs a ~3-10x smaller "
                "LR than AdamW (an AdamW-tuned 6e-4-class value usually "
                "diverges). Set --learning_rate explicitly for lion.",
                RuntimeWarning, stacklevel=2)
        return Lion(groups(cfg.weight_decay), lr=lr0, b1=0.9, b2=0.99)
    if cfg.optimizer == "adafactor":
        # an expert stack cut over 'expert' factors as the whole one only
        # where its expert axis is not factored
        cut = [p for n, p in model.named_parameters()
               if n in getattr(model, "expert_cuts", ())]
        for p in cut:
            whole = (p.shape[0] * model.ep[1],) + tuple(p.shape[1:])
            if 0 in (_factored_dims(whole) or ()):
                raise NotImplementedError(
                    f"optimizer='adafactor' under an 'expert' axis with an "
                    f"expert stack of {whole}: Adafactor would factor its "
                    "expert axis, which the ranks cut; it comes with slice 6 "
                    "(ROADMAP, Queue 1 item 4)")
        # optax's weight_decay_rate is a raw per-step multiplier; the
        # reference matches AdamW's magnitude at peak LR with a constant
        # weight_decay * learning_rate
        return Adafactor(groups(cfg.weight_decay * cfg.learning_rate),
                         lr=lr0, cut=cut)
    return torch.optim.AdamW(groups(cfg.weight_decay), lr=lr0,
                             betas=(0.9, 0.999), eps=1e-8)


def _locals(ts: list) -> list:
    """The local shards of DTensors (FSDP2's gradients); other tensors as
    they are."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t for t in ts]


def global_norm(grads: list, sharded: bool = False,
                cut=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient element (fp32). With
    `sharded`, each rank holds a disjoint piece of the gradients over the
    'data' group (zero2's pieces, FSDP2's shards) and the squares are
    summed over it (parallel/context.py). `cut` (one flag a gradient)
    marks the gradients a 'model' axis cuts into disjoint pieces: their
    squares are summed over 'model' too, while a gradient that is whole
    on every model rank (a LayerNorm's, the router's, a row-parallel
    bias) is counted once; so are the expert stacks an 'expert' axis
    cuts, summed over 'expert'."""
    grads = _locals(grads)
    if not cut or not any(cut):
        if not sharded:
            return torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        from distributed_pytorch_tpu_torch.parallel import context
        sq = torch.stack(torch._foreach_norm(grads)).square().sum()
        return context.all_reduce_sum(sq).sqrt()
    from distributed_pytorch_tpu_torch.parallel import context

    def sq_sum(gs):
        return torch.stack(torch._foreach_norm(gs)).square().sum() if gs \
            else torch.zeros((), device=grads[0].device)

    s_cut = sq_sum([g for g, c in zip(grads, cut) if c])
    s_whole = sq_sum([g for g, c in zip(grads, cut) if not c])
    if sharded:
        s_cut = context.world_all_reduce_sum(s_cut)
        s_whole = context.all_reduce_sum(s_whole)
    else:
        s_cut = context.expert_all_reduce(context.model_all_reduce(s_cut))
    return (s_cut + s_whole).sqrt()


def clip_by_global_norm(grads: list, norm: torch.Tensor,
                        max_norm: float) -> None:
    """optax's clip, in place: g * max_norm / norm when norm >= max_norm,
    else g unchanged. No host sync."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(_locals(grads), factor)


def build_model(model_cfg: LLMConfig, train_cfg: TrainConfig,
                device=None, stage=None) -> LLM:
    """fp32 master weights computing in `train_cfg.compute_dtype` (one
    pipeline stage with `stage`)."""
    return LLM(model_cfg, device=device, dtype=torch.float32,
               compute_dtype=getattr(torch, train_cfg.compute_dtype),
               attn_impl=train_cfg.attn_impl, stage=stage)


def _whole_init(model_cfg: LLMConfig, train_cfg: TrainConfig, device,
                init) -> tuple[dict, tuple]:
    """The whole single model's state dict (`init`, or N(0, 0.02) drawn
    from `train_cfg.seed` on `device`) and its (total, active) parameter
    counts: a pipeline run starts from the single model's weights bit for
    bit, as the reference's pp init (a loop model's, restacked) does."""
    from distributed_pytorch_tpu_torch.models.gpt import count_params
    whole = dataclasses.replace(model_cfg, pp_stages=1)
    counts = count_params(LLM(whole, device="meta"), model_cfg)
    if init is None:
        model = build_model(whole, train_cfg, device)
        g = torch.Generator(device=model.device)
        g.manual_seed(train_cfg.seed)
        model.init_weights(g)
        init = model.state_dict()
    return init, counts


def _stage_model(model_cfg, train_cfg, device, sd, stage) -> LLM:
    from distributed_pytorch_tpu_torch.models.pipeline import \
        stage_state_dict
    model = build_model(model_cfg, train_cfg, device, stage=stage)
    model.load_state_dict(stage_state_dict(sd, model_cfg, stage))
    return model


def create_pipeline_states(model_cfg: LLMConfig, train_cfg: TrainConfig,
                           device=None, init=None) -> list:
    """Every stage of a pipeline-parallel model in this process, as one
    `TrainState` a stage (`PipeRecipe` over one `Pipeline` with
    `LocalTransport`, models/pipeline.py), from the whole seeded init or
    the whole state dict `init`. `train/step.py`'s train step takes the
    list."""
    from distributed_pytorch_tpu_torch.models.pipeline import (
        LocalTransport, Pipeline)
    from distributed_pytorch_tpu_torch.parallel import sharding
    sd, counts = _whole_init(model_cfg, train_cfg, device, init)
    models = {s: _stage_model(model_cfg, train_cfg, device, sd, s)
              for s in range(model_cfg.pp_stages)}
    pipe = Pipeline(model_cfg, models, LocalTransport())
    states = []
    for s, model in models.items():
        opt = make_optimizer(model, train_cfg)
        states.append(TrainState(
            step=0, model=model, optimizer=opt, param_counts=counts,
            recipe=sharding.PipeRecipe(model, opt, None, pipe)))
    return states


def create_train_state(model_cfg: LLMConfig, train_cfg: TrainConfig,
                       device=None, world=None, init=None) -> TrainState:
    """A fresh state under `train_cfg.parallelism`: N(0, 0.02) weights
    drawn from `train_cfg.seed` on the model's device (or the whole state
    dict `init`), under a 'model' axis cut into this rank's pieces
    (parallel/tensor.py `shard_model`) and under an 'expert' axis into its
    experts (`shard_experts`), a new optimizer, and the recipe's
    wrappers over both (parallel/sharding.py `wrap`; `world` is the run's
    parallel/mesh.World, None for one process). `param_counts` holds the
    whole model's (total, active) counts."""
    from distributed_pytorch_tpu_torch.models.gpt import count_params
    from distributed_pytorch_tpu_torch.parallel import sharding, tensor
    if model_cfg.pp_stages > 1:
        if world is None or world.pp != model_cfg.pp_stages:
            raise ValueError(
                f"pp_stages={model_cfg.pp_stages} needs a world whose "
                f"'pipe' axis has as many ranks (got "
                f"{world.pp if world is not None else 1}); "
                "create_pipeline_states holds every stage in one process")
        sd, counts = _whole_init(model_cfg, train_cfg, device, init)
        model = _stage_model(model_cfg, train_cfg, device, sd,
                             world.pipe_rank)
        del sd
        recipe = sharding.wrap(model, make_optimizer(model, train_cfg),
                               train_cfg.parallelism, world)
        return TrainState(step=0, model=recipe.model,
                          optimizer=recipe.optimizer, recipe=recipe,
                          param_counts=counts)
    model = build_model(model_cfg, train_cfg, device)
    if init is None:
        g = torch.Generator(device=model.device)
        g.manual_seed(train_cfg.seed)
        model.init_weights(g)
    else:
        model.load_state_dict(init)
    counts = count_params(model, model_cfg)
    if world is not None and world.tp > 1:
        tensor.shard_model(model, world.model_rank, world.tp)
    if world is not None and world.ep > 1:
        tensor.shard_experts(model, world.expert_rank, world.ep)
    recipe = sharding.wrap(model, make_optimizer(model, train_cfg),
                           train_cfg.parallelism, world)
    return TrainState(step=0, model=recipe.model,
                      optimizer=recipe.optimizer, recipe=recipe,
                      param_counts=counts)
