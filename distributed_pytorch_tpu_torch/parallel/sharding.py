"""The parallel recipes: what each rank holds whole, what it holds 1/W of
over the 'data' axis, and what it holds 1/tp of over the 'model' axis or
1/ep of over the 'expert' axis.

Counterpart of the reference package's `parallel/sharding.py`, whose
PartitionSpec tables (`_PARAM_SHARDED`, `_OPT_SHARDED`, `_GRAD_SHARDED`,
sharding.py:38-42) let GSPMD derive every collective. Here the same tables
pick a wrapper that issues them by hand over the 'data' group
(parallel/mesh.py):

| recipe | params | moments | grad accum | wrapper |
|--------|--------|---------|------------|---------|
| single | whole  | whole   | whole      | none |
| dp     | whole  | whole   | whole      | DistributedDataParallel |
| zero1  | whole  | 1/W     | whole      | `ZeroOptimizer`, all-reduce |
| zero2  | whole  | 1/W     | 1/W        | `ZeroOptimizer`, reduce-scatter |
| fsdp   | 1/W    | 1/W     | 1/W        | FSDP2, each Block, then the root |
| tp     | 1/tp   | 1/tp    | 1/tp       | cut layers, DDP on 'data' |
| fsdp_tp| 1/(tpW)| 1/(tpW) | 1/(tpW)    | cut layers, FSDP2 on 'data' |
| sp     | 1/W    | 1/W     | 1/W        | FSDP2 on ('seq', 'data') |
| ep     | experts 1/ep | experts 1/ep | experts 1/ep | cut experts, DDP on 'data' |
| fsdp, ep_size | 1/(epW) experts, 1/W the rest | the same | the same | cut experts, FSDP2 on 'data' |
| pp     | a stage's layers | a stage's | a stage's | `PipeRecipe`: all-reduce on the stage's 'data' |

With a 'model' axis (`tp_size` > 1) W is the 'data' axis's size: the world
is dp x tp ranks (parallel/mesh.py), the leftover ranks landing on 'data'
as the reference's `resolve_plan` puts them. So `tp` is dp x model and
`fsdp_tp` is fsdp x model, and `dp` / `fsdp` with `tp_size` > 1 mean the
same two recipes. The tensor-parallel table (`_TP_RULES`, the reference's
sharding.py:44-71 in the port's names) picks each parameter's 'model'
axis: column-parallel outputs (the fused qkv and its bias, the MLP's up
projection, MLA's per-head up-projections, the experts' up projections),
row-parallel inputs (the attention and MLP output projections, MLA's W_o,
the experts' down projections) and the vocab-parallel tied embedding;
every other parameter (LayerNorms, the row-parallel biases, MLA's
down-projections and shared rotary key, the router) is whole on every
model rank. `spec_for_param` gives the axis; parallel/tensor.py cuts the
model into each rank's pieces (per-rank layouts of the fused tensors) and
the layers issue the 'model' collectives. Under zero1 / zero2 a 'model'
axis is refused (ROADMAP, Queue 1 item 4).

With a 'seq' axis (`sp_size` > 1, sequence parallelism) W is again the
'data' axis's size: the world is dp x sp ranks, a rank holds T / sp
positions of its data rank's rows (data/loader.py), and every tensor is
held over 'data' as the table says and replicated over 'seq', as the
reference's specs hold it (`sp` is `fsdp`'s row, sharding.py:16-42). A
rank's gradient is then a part of the sum over the data x seq ranks:
`dp` runs DDP over all of them; zero1 all-reduces over them; zero2
reduce-scatters over 'data' and all-reduces its piece over 'seq'; `fsdp`
and `sp` run FSDP2 on a ('seq', 'data') mesh that replicates over 'seq'
and shards over 'data' (HSDP: reduce-scatter over 'data', all-reduce over
'seq'). A 'seq' axis beside a 'model' axis is refused (ROADMAP, Queue 1
item 4).

With an 'expert' axis (`ep_size` > 1, expert parallelism) W is again the
'data' axis's size: the world is dp x ep ranks, and the expert ranks of
one data rank hold the same rows (data/loader.py) and different experts.
As the reference's `spec_for_param` puts the leading axis of every
`experts_*` stack over 'expert' and replicates everything else over it,
`shard_experts` (parallel/tensor.py) cuts `experts_fc` / `experts_proj`
on dim 0 into a rank's n_exp / ep experts before the wrapper sees the
model, and the MoE layer runs its dispatch on them (models/mlp.py).
`ep` (dp with `ep_size` > 1, the reference's `ep` row) runs DDP over the
'data' group, and `fsdp` with `ep_size` FSDP2 over the 'data' group on
the plain pieces, as `fsdp_tp` does. The input's and the gates' gradients
are summed over 'expert' inside the layer (`context.copy_to_expert`), so
every gradient that is whole on the expert ranks is equal on them, and no
gradient is reduced over 'expert'. The reference's table leaves the `ep`
recipe's optimizer moments replicated (`shard_like_params`: `ep` shards
no moments), which holds every expert's moments on every device; the
port holds a rank's experts' only (ROADMAP lists the difference). An
'expert' axis beside a 'seq' or 'model' axis, and under zero1 / zero2, is
refused (ROADMAP, Queue 1 item 4).

* `dp`: `broadcast_buffers=False`, since the MoE's `expert_bias` is kept
  equal on every rank by its global statistics (models/mlp.py) and must
  not be overwritten from rank 0; `no_sync()` on all but the last
  micro-step, so gradients all-reduce once per optimizer step.
* `zero1` / `zero2`: every tensor is cut into W contiguous pieces of
  ceil(n/W) elements of its flattened view (the last one short, padded in
  the collectives), the counterpart of the reference's
  `_largest_divisible_axis` split (:87) that needs no divisible axis. The
  inner optimizer steps this rank's pieces, which are views of the
  parameters, with the per-tensor groups (and so the weight-decay mask) of
  the optimizer it replaces; the updated pieces are then all-gathered
  into every rank's parameters. zero1 all-reduces the accumulated
  gradients once per step; zero2 reduce-scatters each micro-step's
  gradients into this rank's piece and frees the rest.
* `fsdp`: each `Block` is one FSDP2 unit and the root holds the rest,
  among it the tied `tkn_emb` / LM head, where the fused CE's dW and the
  embedding's gradient meet. Parameters are shards (DTensors) outside
  forward and backward, on every mesh by one rule: on dim 0 where the
  'data' size divides it, else on the axis the reference's
  `_largest_divisible_axis` (:87) picks, so a rank holds the bytes the
  reference's specs give a device (FSDP2's padded dim 0 where no axis
  divides); FSDP2 gathers a unit's whole fp32 parameters before
  its forward and again before its backward (custom autograd Functions
  that saved them read the gathered storage), and reduce-scatters its
  gradients after every micro-step's backward.
* `tp` / `fsdp_tp`: the model is cut (parallel/tensor.py `shard_model`)
  before the data-parallel wrapper sees it, so DDP and FSDP2 run over the
  mesh's 'data' group on plain tensors that are already this rank's
  pieces: FSDP2 shards each piece dim 0 over 'data' (the 2-D recipe with
  the 'model' cut done by the layers rather than by DTensor), and the
  kernels always receive plain tensors.
* `pp` (`--pp_size` S > 1; dp with it is `pp`): a rank is one pipeline
  stage (models/pipeline.py) and holds its own layers whole, as the
  reference's specs put the stacked layer axis over 'pipe'; across
  'data' it is dp: `PipeRecipe` all-reduces the stage's gradients over
  its data group (the ranks that hold the same layers) once a step. The
  tied embedding / head lives on the first and the last stage (one rank
  when S = 1), and its gradient is summed over exactly those two before
  the update (`Pipeline.tie_grads`), so both copies and both copies'
  moments stay equal bit for bit; the reference has one replicated leaf,
  whose gradient autodiff sums. The norm sums the stages' squares over
  the 'pipe' group, the tied weight once. Every block parameter of a
  stage decays (train/state.py `make_optimizer`), as the reference's rank
  rule does on its stacked blocks. With S = 1, `pp` is `dp`.
  The 'pipe' axis beside another axis or under zero1 / zero2 / fsdp is
  refused (ROADMAP, Queue 1 item 4).
* Adafactor factors its second moments over whole tensors (the
  reference's stacked blocks under pp), so it runs under `single` and
  `dp` and raises under the sharded recipes and a 'pipe' axis.

Every recipe steps a rank's data rows only (data/loader.py; the model
and expert ranks of one data rank take the same rows); the gradient is
the mean over the global batch, as the reference's. The gradient norm sums
the squares of the cut pieces over 'model' or 'expert' and counts a whole
gradient once (train/state.py `global_norm`). Checkpoints hold whole tensors in the
reference's layout whatever the recipe (`full_state_dicts`,
`load_full_state`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from distributed_pytorch_tpu_torch.parallel.mesh import World
from distributed_pytorch_tpu_torch.train.state import global_norm

# Recipes whose *parameters* are sharded over 'data' (ZeRO-3 family).
PARAM_SHARDED = ("fsdp", "fsdp_tp", "sp")
# Recipes whose *optimizer state* is sharded over 'data' (ZeRO-1 and up).
OPT_SHARDED = ("zero1", "zero2") + PARAM_SHARDED
# Recipes whose *gradient accumulator* is sharded over 'data' (ZeRO-2 and
# up).
GRAD_SHARDED = ("zero2",) + PARAM_SHARDED
# The recipes the port trains.
PORTED = ("single", "dp", "zero1", "zero2", "fsdp", "tp", "fsdp_tp", "sp",
          "ep", "pp")
# What the rest of slice 6 brings (ROADMAP, Queue 1 items 4-6).
SLICE6_LEFT = ("the compositions (the 'pipe' axis beside a 'seq', "
               "'expert' or 'model' axis or under zero1 / zero2 / fsdp, ep "
               "beside a 'seq' or 'model' axis, a 'seq' axis beside a "
               "'model' axis, zero1 / zero2 with a 'model' or 'expert' "
               "axis, Adafactor under the sharded recipes), offload and "
               "the collective-matmul overlap (ROADMAP, Queue 1 items "
               "4-6)")

# Tensor-parallel table, the reference's `_TP_RULES` (sharding.py:44-71) in
# the port's names: (suffix of the dotted name) -> the axis cut over
# 'model'. nn.Linear stores (out, in), so its weights' axes are the
# reference kernels' transposed; bare parameters keep (in, out).
_TP_RULES: tuple[tuple[tuple[str, ...], int], ...] = (
    (("tkn_emb", "weight"), 0),      # vocab-parallel tied embedding / head
    (("c_attn", "weight"), 0),       # qkv: the reference's kernel axis 1
    (("c_attn", "bias"), 0),
    (("c_proj", "weight"), 1),       # attention out: kernel axis 0
    (("c_fc",), 1),                  # mlp up (bare (in, out))
    (("c_proj",), 0),                # mlp down (bare (in, out))
    (("W_uq",), 1),                  # MLA: per-head dims are outputs
    (("W_uk",), 1),
    (("W_uv",), 1),
    (("W_qr",), 1),
    (("W_o",), 0),
    (("experts_fc",), 2),
    (("experts_proj",), 1),
)


def tp_axis(name: str) -> Optional[int]:
    """The axis `_TP_RULES` cuts over 'model' for the parameter `name`
    (a dotted state-dict key), or None: whole on every model rank."""
    names = tuple(name.split("."))
    for suffix, axis in _TP_RULES:
        if names[-len(suffix):] == suffix:
            return axis
    return None


def expert_cut(name: str) -> bool:
    """Whether the parameter `name` is an expert stack, whose leading axis
    the 'expert' axis cuts (the reference's `spec_for_param`: a leaf whose
    name starts with 'experts_')."""
    return name.rsplit(".", 1)[-1].startswith("experts_")


def spec_for_param(name: str, shape: tuple, tp: int, ep: int = 1) -> tuple:
    """The parameter's placement over the 'expert' and 'model' axes, one
    entry per dim: 'expert' or 'model' where it is cut, None where whole
    (the counterpart of the reference's `spec_for_param`'s 'expert' and
    'model' entries). As there, an expert stack's leading axis goes to
    'expert', and an axis is cut over 'model' only where tp divides it
    and 'expert' has not taken it."""
    axes = [None] * len(shape)
    if ep > 1 and expert_cut(name):
        axes[0] = "expert"
    ax = tp_axis(name)
    if tp > 1 and ax is not None and ax < len(shape) \
            and shape[ax] % tp == 0 and axes[ax] is None:
        axes[ax] = "model"
    return tuple(axes)


def holds(recipe: str) -> dict[str, bool]:
    """Which tensor classes the recipe holds 1/W of over 'data' on each
    rank (the 'model' cut, 1/tp of the cut parameters and of their
    moments and gradients, comes on top under tp_size > 1)."""
    return {"params": recipe in PARAM_SHARDED,
            "moments": recipe in OPT_SHARDED,
            "grads": recipe in GRAD_SHARDED}


def tp_recipe(recipe: str, tp_size: int, ep_size: int = 1,
              pp_size: int = 1) -> str:
    """The recipe a 'model' axis of `tp_size`, an 'expert' axis of
    `ep_size` or a 'pipe' axis of `pp_size` makes of `recipe`: dp -> tp,
    fsdp -> fsdp_tp, dp -> ep, dp -> pp (the same things, as in the
    reference)."""
    if tp_size > 1:
        return {"dp": "tp", "fsdp": "fsdp_tp"}.get(recipe, recipe)
    if ep_size > 1 and recipe == "dp":
        return "ep"
    if pp_size > 1 and recipe == "dp":
        return "pp"
    return recipe


def check_recipe(recipe: str, optimizer: str, tp_size: int = 1,
                 sp_size: int = 1, ep_size: int = 1,
                 pp_size: int = 1) -> None:
    """Refuse a recipe the port does not train, a 'model', 'expert' or
    'pipe' axis where the port does not run one (under zero1 / zero2 /
    fsdp, beside a 'seq' axis or each other), or Adafactor (whole-tensor
    row and column statistics) under a recipe that shards the moments or
    a 'model' axis."""
    if recipe not in PORTED:
        raise NotImplementedError(
            f"parallelism={recipe!r} comes with the rest of slice 6: "
            f"{SLICE6_LEFT}")
    if (pp_size > 1 and recipe != "pp") or (
            recipe == "pp" and max(tp_size, sp_size, ep_size) > 1):
        raise NotImplementedError(
            f"pp_size={pp_size} under parallelism={recipe!r} with "
            f"tp_size={tp_size}, sp_size={sp_size}, ep_size={ep_size} "
            f"comes with the rest of slice 6: {SLICE6_LEFT}")
    if tp_size > 1 and (recipe in ("zero1", "zero2", "sp") or sp_size > 1):
        raise NotImplementedError(
            f"tp_size={tp_size} under parallelism={recipe!r} with "
            f"sp_size={sp_size} comes with the rest of slice 6: "
            f"{SLICE6_LEFT}")
    if (ep_size > 1 or recipe == "ep") and (
            recipe in ("zero1", "zero2", "sp") or sp_size > 1
            or tp_size > 1):
        raise NotImplementedError(
            f"ep_size={ep_size} under parallelism={recipe!r} with "
            f"sp_size={sp_size}, tp_size={tp_size} comes with the rest of "
            f"slice 6: {SLICE6_LEFT}")
    if optimizer == "adafactor" and (recipe in OPT_SHARDED or tp_size > 1
                                     or pp_size > 1):
        raise NotImplementedError(
            f"optimizer='adafactor' under parallelism={recipe!r}: Adafactor "
            "factors its moments over whole tensors (under pp the "
            "reference's stacked blocks); under a sharded recipe or a "
            "'pipe' axis it comes with slice 6 (ROADMAP, Queue 1 item 4); "
            "use 'dp'")


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    """t flattened and zero-padded to n elements (a collective's equal
    shares)."""
    flat = t.reshape(-1)
    if flat.numel() == n:
        return flat
    return torch.cat([flat, flat.new_zeros(n - flat.numel())])


def _piece(n: int, world: World) -> tuple[int, int, int]:
    """(lo, hi, chunk) of this data rank's piece of n flattened
    elements."""
    c = -(-n // world.dp)
    lo = min(world.data_rank * c, n)
    return lo, min(lo + c, n), c


def _data_chunk(full: torch.Tensor, world: World,
                dim: int = 0) -> torch.Tensor:
    """This rank's 'data' shard of `full` along `dim` (torch.chunk's
    split, which is DTensor's Shard(dim) and FSDP2's)."""
    lo, hi, _ = _piece(full.shape[dim], world)
    return full.narrow(dim, lo, hi - lo)


def _rebuild(optimizer: torch.optim.Optimizer,
             params_of) -> torch.optim.Optimizer:
    """A fresh optimizer of the same class over `params_of(group)` for
    each group, keeping every group's settings (lr, betas, weight decay)."""
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": params_of(g)} for g in optimizer.param_groups]
    return type(optimizer)(groups, lr=optimizer.defaults["lr"])


# ---------------------------------------------------------------------------
# the recipes
# ---------------------------------------------------------------------------

class Recipe:
    """'single', and what every recipe provides to the train step:
    `module` (what the forward runs through), `micro_step(last)` (the
    context of one micro-step's forward and backward), `after_backward`,
    `grads` (the local tensors the norm, clip and step read), `grad_norm`
    and `zero_grad`."""

    sharded_grads = False

    def __init__(self, model, optimizer, world: Optional[World] = None):
        self.model = model
        self.optimizer = optimizer
        self.world = world
        self.module = model
        # which of params() the 'model' or 'expert' axis cuts (their norms
        # sum over it)
        cuts = set(getattr(model, "tp_cuts", {})) \
            | set(getattr(model, "expert_cuts", ()))
        names = {p: n for n, p in model.named_parameters()}
        self.cut = [names.get(p) in cuts for p in self.params()] \
            if cuts else None

    def params(self) -> list:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def micro_step(self, last: bool):
        return contextlib.nullcontext()

    def after_backward(self) -> None:
        pass

    def grads(self) -> list:
        return [_local(p.grad) for p in self.params()]

    def grad_norm(self, grads: list) -> torch.Tensor:
        return global_norm(grads, sharded=self.sharded_grads, cut=self.cut)

    def zero_grad(self) -> None:
        for p in self.params():
            p.grad = None

    def held_bytes(self) -> dict[str, int]:
        """Bytes this rank holds of parameters, optimizer moments and
        gradients."""
        def nbytes(ts):
            return sum(_local(t).numel() * t.element_size() for t in ts)
        moments = [v for st in self.optimizer.state.values()
                   for v in st.values()
                   if torch.is_tensor(v) and v.dim() > 0]
        return {"params": nbytes(self.model.parameters()),
                "moments": nbytes(moments),
                "grads": nbytes(g for g in self.grad_tensors()
                                if g is not None)}

    def grad_tensors(self) -> list:
        return [p.grad for p in self.model.parameters()]


class DDPRecipe(Recipe):

    def __init__(self, model, optimizer, world: World):
        super().__init__(model, optimizer, world)
        from torch.nn.parallel import DistributedDataParallel
        ids = [world.device.index] if world.device.type == "cuda" else None
        self.module = DistributedDataParallel(
            model, device_ids=ids, broadcast_buffers=False,
            process_group=world.batch_group)

    def micro_step(self, last: bool):
        return contextlib.nullcontext() if last else self.module.no_sync()


class ZeroOptimizer:
    """ZeRO-1/2's optimizer: the wrapped optimizer's rule over this rank's
    piece of every parameter (see the module docstring). `state_dict` and
    `load_state_dict` speak whole tensors, in the wrapped optimizer's
    layout, so a checkpoint does not depend on the world."""

    def __init__(self, optimizer: torch.optim.Optimizer, world: World,
                 stage: int):
        self.world, self.stage = world, stage
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.span = {}
        pieces = {}
        for p in self.params:
            lo, hi, c = _piece(p.numel(), world)
            self.span[p] = (lo, hi, c)
            pieces[p] = p.detach().view(-1)[lo:hi]
        self.pieces = [pieces[p] for p in self.params]
        self.inner = _rebuild(optimizer,
                              lambda g: [pieces[p] for p in g["params"]])
        self.param_groups = self.inner.param_groups
        self.state = self.inner.state

    def reduce_scatter_grads(self) -> None:
        """zero2, after a micro-step's backward: sum every gradient over
        the data ranks into this rank's piece, and that over the seq
        ranks (accumulated), and free it."""
        w0 = self.world
        outs, works = [], []
        for p in self.params:
            c = self.span[p][2]
            out = p.grad.new_empty(c)
            works.append(dist.reduce_scatter_tensor(
                out, _pad(p.grad, c * w0.dp), group=w0.data_group,
                async_op=True))
            outs.append(out)
        for w in works:
            w.wait()
        if w0.sp > 1:
            works = [dist.all_reduce(out, group=w0.seq_group, async_op=True)
                     for out in outs]
            for w in works:
                w.wait()
        for p, piece, out in zip(self.params, self.pieces, outs):
            g = out[:piece.numel()]
            piece.grad = g if piece.grad is None else piece.grad.add_(g)
            p.grad = None

    def all_reduce_grads(self) -> None:
        """zero1, once per step: sum the accumulated gradients over the
        data x seq ranks and hand this rank's piece to the inner
        optimizer."""
        works = [dist.all_reduce(p.grad, group=self.world.batch_group,
                                 async_op=True) for p in self.params]
        for w in works:
            w.wait()
        for p, piece in zip(self.params, self.pieces):
            lo, hi, _ = self.span[p]
            piece.grad = p.grad.reshape(-1)[lo:hi]

    def _gather(self, vs: list) -> list:
        """Every parameter's whole flattened tensor from the data ranks'
        pieces (`vs`: this rank's piece of each, in `self.params`
        order)."""
        fulls, works = [], []
        for p, v in zip(self.params, vs):
            c = self.span[p][2]
            full = v.new_empty(c * self.world.dp)
            works.append(dist.all_gather_into_tensor(
                full, _pad(v, c), group=self.world.data_group,
                async_op=True))
            fulls.append(full)
        for w in works:
            w.wait()
        return [f[:p.numel()] for p, f in zip(self.params, fulls)]

    @torch.no_grad()
    def step(self) -> None:
        self.inner.step()
        for p, full in zip(self.params, self._gather(self.pieces)):
            p.view(-1).copy_(full)

    def state_dict(self) -> dict:
        """The wrapped optimizer's state dict with whole tensors (a
        collective: every rank calls it)."""
        sd = self.inner.state_dict()
        state = {i: dict(st) for i, st in sd["state"].items()}
        if state:
            assert len(state) == len(self.params), "partial optimizer state"
            for k, v in state[0].items():
                if torch.is_tensor(v) and v.dim() == 1:   # per element
                    wholes = self._gather([state[i][k] for i in
                                           range(len(self.params))])
                    for i, w in enumerate(wholes):
                        state[i][k] = w.view(self.params[i].shape)
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        """Load a whole-tensor state dict (any recipe's, any world's)."""
        state = {}
        for idx, st in sd["state"].items():
            p = self.params[int(idx)]
            lo, hi, _ = self.span[p]
            state[idx] = {k: v.reshape(-1)[lo:hi].clone()
                          if torch.is_tensor(v) and v.shape == p.shape
                          and v.dim() > 0 else v for k, v in st.items()}
        self.inner.load_state_dict({"state": state,
                                    "param_groups": sd["param_groups"]})
        self.param_groups = self.inner.param_groups
        self.state = self.inner.state


class ZeroRecipe(Recipe):
    sharded_grads = True

    def __init__(self, model, optimizer, world: World, stage: int):
        super().__init__(model, ZeroOptimizer(optimizer, world, stage),
                         world)

    def params(self) -> list:
        return self.optimizer.params

    def after_backward(self) -> None:
        if self.optimizer.stage == 2:
            self.optimizer.reduce_scatter_grads()

    def grads(self) -> list:
        opt = self.optimizer
        if opt.stage == 1:
            opt.all_reduce_grads()
        g = [piece.grad for piece in opt.pieces]
        torch._foreach_div_(g, float(self.world.dp * self.world.sp))
        return g

    def zero_grad(self) -> None:
        super().zero_grad()
        for piece in self.optimizer.pieces:
            piece.grad = None

    def grad_tensors(self) -> list:
        if self.optimizer.stage == 1:
            return super().grad_tensors()
        return [piece.grad for piece in self.optimizer.pieces]


class FSDPRecipe(Recipe):
    sharded_grads = True

    def __init__(self, model, optimizer, world: World):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard
        names = {p: n for n, p in model.named_parameters()}
        from torch.distributed.tensor import Shard
        if world.sp > 1:
            # HSDP: replicated over 'seq' (dim 0), sharded over 'data';
            # entry [s, d] is the rank (d, s) of the world's mesh
            from torch.distributed.device_mesh import DeviceMesh
            mesh = DeviceMesh(world.device.type,
                              torch.arange(world.size).view(world.dp,
                                                            world.sp).t(),
                              mesh_dim_names=("seq", "data"))
        elif world.mesh is not None:
            mesh = world.mesh["data"]
        else:
            mesh = init_device_mesh(world.device.type, (world.size,),
                                    mesh_dim_names=("data",))

        def place(p):
            # dim 0 where 'data' divides it (FSDP2's default), else the
            # reference's `_largest_divisible_axis`: either holds the bytes
            # the reference's specs give a device; with no divisible axis,
            # FSDP2's padded dim 0
            dims = [i for i, n in enumerate(p.shape) if n % world.dp == 0]
            if not dims or dims[0] == 0:
                return None
            return Shard(max(dims, key=lambda i: (p.shape[i], -i)))

        for blk in model.blocks:
            fully_shard(blk, mesh=mesh, shard_placement_fn=place)
        fully_shard(model, mesh=mesh, shard_placement_fn=place)
        # fully_shard swaps in DTensor parameters: the optimizer is rebuilt
        # over them, group by group
        now = dict(model.named_parameters())
        optimizer = _rebuild(optimizer,
                             lambda g: [now[names[p]] for p in g["params"]])
        super().__init__(model, optimizer, world)


class PipeRecipe(Recipe):
    """pp: one pipeline stage (`model`, an `LLM` stage) a rank; its
    gradients all-reduced and averaged over the stage's data group. The
    train step drives the stages through `pipe` (models/pipeline.py)."""

    def __init__(self, model, optimizer, world: Optional[World], pipe):
        super().__init__(model, optimizer, world)
        self.pipe = pipe
        pipe.optimizers[model.stage] = optimizer

    def grads(self) -> list:
        gs = [p.grad for p in self.params()]
        w = self.world
        if w is not None and w.distributed and w.dp > 1:
            works = [dist.all_reduce(g, group=w.data_group, async_op=True)
                     for g in gs]
            for work in works:
                work.wait()
            torch._foreach_div_(gs, float(w.dp))
        return gs


def _broadcast_params(model, world: World) -> None:
    """Batch rank 0's parameters and buffers on every rank of its data x
    seq ranks (the model ranks hold different pieces)."""
    g = world.batch_group
    src = 0 if g is None else dist.get_global_rank(g, 0)
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=src, group=g)


def wrap(model, optimizer, recipe: str, world: Optional[World]) -> Recipe:
    """Apply `recipe`'s rules to a freshly built model (cut into this
    rank's pieces under a 'model' axis, parallel/tensor.py) and its
    optimizer (every rank builds the same ones); returns the `Recipe` the
    train step drives. The model is data rank 0's afterwards on every
    rank."""
    check_recipe(recipe, type(optimizer).__name__.lower(),
                 world.tp if world is not None else 1,
                 world.sp if world is not None else 1,
                 world.ep if world is not None else 1,
                 world.pp if world is not None else 1)
    if recipe == "single":
        return Recipe(model, optimizer, world)
    if recipe == "pp" and world.pp > 1:
        from distributed_pytorch_tpu_torch.models.pipeline import (
            GroupTransport, Pipeline)
        if world.dp > 1:
            _broadcast_params(model, world)
        pipe = Pipeline(model.config, {model.stage: model},
                        GroupTransport(world))
        return PipeRecipe(model, optimizer, world, pipe)
    if recipe in ("dp", "tp", "ep", "pp"):
        return DDPRecipe(model, optimizer, world)
    _broadcast_params(model, world)
    if recipe in ("zero1", "zero2"):
        return ZeroRecipe(model, optimizer, world, int(recipe[-1]))
    return FSDPRecipe(model, optimizer, world)


# ---------------------------------------------------------------------------
# whole-tensor state, whatever the recipe
# ---------------------------------------------------------------------------

def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _tp_whole(name: str, v: torch.Tensor, model) -> torch.Tensor:
    """`v`, this model or expert rank's piece of the parameter `name` (or
    a tensor of its shape), whole again from every model or expert rank's
    (a collective over 'model' or 'expert'); anything neither axis cuts as
    it is."""
    from distributed_pytorch_tpu_torch.parallel import context, tensor
    if name in getattr(model, "expert_cuts", ()):
        return torch.cat(context.expert_all_gather(v), dim=0)
    cut = getattr(model, "tp_cuts", {}).get(name)
    if cut is None:
        return v
    return tensor.join(context.model_all_gather(v), cut)


def _opt_names(model, optimizer) -> list:
    """The parameter name of each optimizer state index."""
    names = {p: n for n, p in model.named_parameters()}
    return [names[p] for g in optimizer.param_groups for p in g["params"]]


def full_model_state_dict(model) -> dict:
    """The model's state dict of whole tensors in the reference's layout
    (a collective under 'fsdp', under a 'model' or 'expert' axis and
    under a 'pipe' axis, whose stages' entries it gathers)."""
    if getattr(model, "pipe", None) is not None:
        return model.pipe.full_state_dicts(with_optimizer=False)[0]
    return {k: _tp_whole(k, _full(v), model)
            for k, v in model.state_dict().items()}


def full_state_dicts(model, optimizer) -> tuple[dict, dict]:
    """(model, optimizer) state dicts of whole tensors in the single
    recipe's layout. A collective under the sharded recipes and under a
    'model', 'expert' or 'pipe' axis: every rank calls it."""
    if getattr(model, "pipe", None) is not None:
        return model.pipe.full_state_dicts()
    model_sd = full_model_state_dict(model)
    sd = optimizer.state_dict()
    names = _opt_names(model, optimizer) \
        if getattr(model, "tp_cuts", None) \
        or getattr(model, "expert_cuts", None) else None
    opt_sd = {"state": {i: {k: _tp_whole(names[i], _full(v), model)
                            if names and torch.is_tensor(v) and v.dim() > 0
                            else _full(v) for k, v in st.items()}
                        for i, st in sd["state"].items()},
              "param_groups": sd["param_groups"]}
    return model_sd, opt_sd


def _shard_like(v: torch.Tensor, ref: torch.Tensor, world: World):
    """`v` (whole) as `ref` holds it: this rank's 'data' shard, on the
    axis `ref`'s placements shard, for a DTensor `ref`, else as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return v
    dim = next(p.dim for p in ref.placements if p.is_shard())
    piece = _data_chunk(v.to(device=ref.device, dtype=ref.dtype), world, dim)
    return DTensor.from_local(piece.contiguous(), ref.device_mesh,
                              ref.placements, run_check=False,
                              shape=v.shape, stride=v.stride())


def load_full_state(model, optimizer, model_sd: dict, opt_sd: dict,
                    world: Optional[World] = None) -> None:
    """Load whole-tensor state dicts (`full_state_dicts`' or the single
    recipe's) under any recipe: under a 'model' or 'expert' axis each rank
    first takes its pieces (parallel/tensor.py `split`, `expert_piece`),
    a pipeline stage its layers and their moments."""
    from distributed_pytorch_tpu_torch.parallel import tensor
    if getattr(model, "pipe", None) is not None:
        model.pipe.load_full_state(model_sd, opt_sd)
        return
    cuts = getattr(model, "tp_cuts", None) or {}
    experts = getattr(model, "expert_cuts", None) or ()
    if cuts or experts:
        def piece(name, v):
            if name in experts:
                return tensor.expert_piece(v, *model.ep)
            return tensor.split(v, cuts[name], *model.tp)
        model_sd = {k: piece(k, v) if k in cuts or k in experts else v
                    for k, v in model_sd.items()}
        names = _opt_names(model, optimizer)
        opt_sd = {"state": {
            i: {k: piece(names[int(i)], v)
                if (names[int(i)] in cuts or names[int(i)] in experts)
                and torch.is_tensor(v) and v.dim() > 0 else v
                for k, v in st.items()}
            for i, st in opt_sd["state"].items()},
            "param_groups": opt_sd["param_groups"]}
    params = dict(model.named_parameters())
    if world is not None and world.distributed:
        model_sd = {k: _shard_like(v, params[k], world) if k in params
                    else v for k, v in model_sd.items()}
    model.load_state_dict(model_sd)
    if isinstance(optimizer, ZeroOptimizer) or world is None \
            or not world.distributed:
        optimizer.load_state_dict(opt_sd)
        return
    plist = [p for g in optimizer.param_groups for p in g["params"]]
    state = {}
    for idx, st in opt_sd["state"].items():
        p = plist[int(idx)]
        state[idx] = {k: _shard_like(v, p, world)
                      if torch.is_tensor(v) and v.shape == p.shape
                      and v.dim() > 0 else v for k, v in st.items()}
    optimizer.load_state_dict({"state": state,
                               "param_groups": opt_sd["param_groups"]})
