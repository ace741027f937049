"""Pipeline parallelism: the interleaved-1F1B and carry schedules, one
stage a process.

Counterpart of the reference package's `models/pipeline.py`. The
reference stacks the blocks on a layer axis, shards that axis over its
'pipe' mesh axis and scans ticks, letting GSPMD turn `jnp.roll` into
collective-permutes. Here the same schedule runs the PyTorch way:

* Each stage is one `LLM` holding only its own blocks (models/gpt.py,
  `LLM(cfg, stage=s)`), under the single model's names. Under '1f1b',
  chunk q (layers [q Lc, (q + 1) Lc), Lc = L / (S vpp)) lives on stage
  q mod S, the reference's placement (`_build_1f1b_schedule`); under
  'carry' stage s holds the contiguous layers [s L / S, (s + 1) L / S).
  Stage 0 holds the embedding (and `pos_emb` or the sinusoidal table),
  the last stage `ln_f` and the tied head: the tied `tkn_emb` is on both,
  and its gradient is summed over the two before every update.
* `Pipeline.run` drives a (B, T) micro-step through the tick table of
  `_build_1f1b_schedule` (vpp 1 under 'carry', where a stage's layers
  are one chunk): stage 0 embeds the whole batch and splits it into M
  microbatches; each tick a stage runs the (chunk, microbatch) the table
  gives it and hands its output to the next stage, the wrap from stage
  S - 1 to 0 being the interleave hand-back. The last stage keeps the
  exits and computes ln_f and the loss over their concatenation (one
  loss call over the micro-step's tokens, as the reference computes its
  head on the whole batch). The backward runs the table mirrored, tick
  for tick in reverse (the reference's autodiff through its scan), each
  (chunk, microbatch) backpropagated explicitly with
  `torch.autograd.backward(out, grad from the next stage)` and its input's
  gradient handed to the previous stage. A stage holds every
  microbatch's activations until the backward, as the reference does.
* Activations and their gradients move through a transport, always
  passed explicitly: `GroupTransport` (one stage a process,
  `torch.distributed.batch_isend_irecv` of each tick's sends and
  receives over the world's ranks, so neither side of a pair blocks the
  other) or `LocalTransport` (every stage in this process, the tensor
  handed over as it is). Neither is ever chosen for the other.
* MoE (the carry schedule only, as the reference's `resolve_schedule`
  has it): a layer's aux loss and aux-free bias step are scaled by 1/M
  (`stats_weight`), the bias commits after each (layer, microbatch)
  forward in microbatch order, and a recomputed block routes with the
  bias its microbatch used (models/gpt.py `run_layers`). The grouped
  dispatch runs on a stage's layers: the reference degrades 'grouped' to
  'dense' under pp, a limit of its vmapped stack, and the dropless
  semantics are the same.

The pure-numpy parts (`resolve_vpp`, `resolve_schedule`, `_Schedule`,
`_build_1f1b_schedule`, `schedule_timeline`, `stack_block_params`,
`unstack_block_params`) are copies of the reference's, the stacking ones
on nested dicts of numpy arrays (the reference's param trees after
`jax.device_get`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_pytorch_tpu_torch.config import LLMConfig, knob
from distributed_pytorch_tpu_torch.parallel import context


def resolve_vpp(cfg: LLMConfig) -> int:
    """Virtual chunks per stage for the 1f1b schedule: the PP_VPP knob,
    else cfg.pp_vpp, else auto = n_layer/pp_stages (one-layer chunks — the
    carry schedule's interleave granularity, minimal bubble)."""
    vpp = knob("PP_VPP") or cfg.pp_vpp
    if vpp <= 0:
        vpp = max(1, cfg.n_layer // max(cfg.pp_stages, 1))
    return vpp


def resolve_schedule(cfg: LLMConfig) -> str:
    """'1f1b' | 'carry' for this config. Resolution order: PP_SCHEDULE
    knob > cfg.pp_schedule > 'auto'. Auto picks 1f1b whenever it is
    admissible (dense model, chunk count divides the layer count) and
    falls back to carry otherwise; asking for 1f1b explicitly when it is
    not admissible fails loudly instead of silently degrading."""
    choice = knob("PP_SCHEDULE") or cfg.pp_schedule
    if choice not in ("auto", "carry", "1f1b"):
        raise ValueError(f"unknown pp schedule {choice!r} "
                         "(expected auto|carry|1f1b)")
    vpp = resolve_vpp(cfg)
    admissible = (not cfg.moe
                  and cfg.n_layer % (max(cfg.pp_stages, 1) * vpp) == 0)
    if choice == "1f1b" and not admissible:
        raise ValueError(
            f"pp_schedule=1f1b needs a dense model with pp_stages*vpp "
            f"({cfg.pp_stages}*{vpp}) dividing n_layer ({cfg.n_layer}); "
            f"MoE models use the carry schedule (its per-tick validity "
            f"masking keeps the router load statistics exact)")
    if choice == "auto":
        return "1f1b" if admissible else "carry"
    return choice


@dataclasses.dataclass(frozen=True)
class _Schedule:
    """Static interleaved-1F1B tick table (pure numpy)."""

    n_stages: int
    vpp: int
    n_microbatches: int
    ticks: int
    q_idx: np.ndarray       # (ticks, S) chunk each stage computes (a
                            # stage-owned dummy chunk on idle ticks)
    valid: np.ndarray       # (ticks, S) bool: real microbatch in flight
    mb_idx: np.ndarray      # (ticks, S) microbatch per stage (-1 = idle)
    inject: np.ndarray      # (ticks,) 1 when a microbatch enters stage 0
    inject_src: np.ndarray  # (ticks,) which microbatch (0 on no-op ticks)
    exit_ticks: np.ndarray  # (M,) tick whose stage-(S-1) output finishes m


def _build_1f1b_schedule(S: int, vpp: int, M: int) -> _Schedule:
    """Interleaved-1F1B placement: chunk q (of S*vpp) belongs to stage
    q mod S; microbatch m = g*S + j computes chunk q at tick
    g*S*vpp + j + q. Per (stage, tick) the decomposition
    u = t - s = S*(g*vpp + v) + j is unique, so a stage computes at most
    one (chunk, microbatch) per tick, every chunk's input is exactly the
    previous tick's neighbour output (or the injected embedding for
    chunk 0), and the schedule is valid for ANY M (not only S | M)."""
    n_chunks = S * vpp
    g_last, j_last = (M - 1) // S, (M - 1) % S
    ticks = g_last * n_chunks + j_last + n_chunks
    q_idx = np.zeros((ticks, S), np.int32)
    valid = np.zeros((ticks, S), bool)
    mb_idx = np.full((ticks, S), -1, np.int32)
    inject = np.zeros((ticks,), np.int32)
    inject_src = np.zeros((ticks,), np.int32)
    exit_ticks = np.zeros((M,), np.int32)
    for t in range(ticks):
        for s in range(S):
            u = t - s
            if u < 0:
                q_idx[t, s] = s  # idle: compute the stage's own chunk 0
                continue
            j, r = u % S, u // S
            v, g = r % vpp, r // vpp
            m = g * S + j
            q = v * S + s
            q_idx[t, s] = q
            if m < M:
                valid[t, s] = True
                mb_idx[t, s] = m
                if q == 0:
                    inject[t] = 1
                    inject_src[t] = m
                if q == n_chunks - 1:
                    exit_ticks[m] = t
    return _Schedule(S, vpp, M, ticks, q_idx, valid, mb_idx, inject,
                     inject_src, exit_ticks)


def schedule_timeline(n_stages: int, vpp: int, n_microbatches: int
                      ) -> tuple[list, dict]:
    """Per-(tick, stage) phase rows of one 1f1b optimizer step + a bubble
    summary. The forward half comes straight from the static schedule
    table; the backward half is its exact mirror (the cooldown is the
    mirrored warmup). Rows: {tick, stage, chunk, microbatch,
    phase('fwd'|'bwd')}. Summary: {ticks, busy_per_stage, bubble_frac,
    bubble_model} where bubble_frac = 1 - busy/ticks (measured on the
    table) and bubble_model = (S-1)/(vpp*M) (the Megatron
    interleaved-1F1B model)."""
    sched = _build_1f1b_schedule(n_stages, vpp, n_microbatches)
    fwd = [{"tick": int(t), "stage": int(s),
            "chunk": int(sched.q_idx[t, s]),
            "microbatch": int(sched.mb_idx[t, s]), "phase": "fwd"}
           for t in range(sched.ticks) for s in range(n_stages)
           if sched.valid[t, s]]
    total = 2 * sched.ticks
    bwd = [{**row, "tick": total - 1 - row["tick"], "phase": "bwd"}
           for row in fwd]
    rows = sorted(fwd + bwd, key=lambda r: (r["tick"], r["stage"]))
    busy = 2 * n_microbatches * vpp
    summary = {
        "schedule": "1f1b", "n_stages": n_stages, "vpp": vpp,
        "n_microbatches": n_microbatches, "ticks": total,
        "busy_per_stage": busy,
        "bubble_frac": round(1.0 - busy / total, 6),
        "bubble_model": round((n_stages - 1)
                              / max(vpp * n_microbatches, 1), 6),
    }
    return rows, summary


def _tree_map(fn, *trees):
    """fn over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_block_params(params: dict, n_layer: int) -> dict:
    """Restructure loop-model trees (block_0..block_{L-1} siblings) into
    the reference's pipeline layout ({'blocks': {'stack': <leading-L
    leaves>}}), leaving every other entry as it is."""
    stacked = _tree_map(lambda *ls: np.stack([np.asarray(x) for x in ls]),
                        *(params[f"block_{i}"] for i in range(n_layer)))
    out = {k: v for k, v in params.items() if not k.startswith("block_")}
    out["blocks"] = {"stack": stacked}
    return out


def unstack_block_params(params: dict, n_layer: int) -> dict:
    """Inverse of stack_block_params (a pipeline tree -> loop layout)."""
    stacked = params["blocks"]["stack"]
    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(n_layer):
        out[f"block_{i}"] = _tree_map(lambda x, i=i: np.asarray(x)[i],
                                      stacked)
    return out


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def chunk_vpp(cfg: LLMConfig) -> int:
    """Chunks a stage holds: `resolve_vpp` under '1f1b', 1 under 'carry'
    (a stage's contiguous layers are one chunk)."""
    return resolve_vpp(cfg) if resolve_schedule(cfg) == "1f1b" else 1


def chunk_layers(cfg: LLMConfig) -> list:
    """The layer ids of each chunk q = 0 .. S vpp - 1, in order."""
    n = cfg.pp_stages * chunk_vpp(cfg)
    lc = cfg.n_layer // n
    return [list(range(q * lc, (q + 1) * lc)) for q in range(n)]


def stage_layers(cfg: LLMConfig, stage: int) -> list:
    """The layers stage `stage` holds, ascending: chunk q lives on stage
    q mod S (under 'carry' the contiguous layers [s L / S, (s + 1) L /
    S))."""
    S = cfg.pp_stages
    return sorted(i for q, ids in enumerate(chunk_layers(cfg))
                  if q % S == stage for i in ids)


def stage_keys(key: str, cfg: LLMConfig) -> list:
    """The stages that hold the whole-model state-dict entry `key`."""
    S = cfg.pp_stages
    if key.startswith("blocks."):
        layer = int(key.split(".")[1])
        return [next(s for s in range(S) if layer in stage_layers(cfg, s))]
    if key.startswith("tkn_emb."):
        return sorted({0, S - 1})
    if key.startswith("ln_f."):
        return [S - 1]
    return [0]                                   # pos_emb


def stage_state_dict(sd: dict, cfg: LLMConfig, stage: int) -> dict:
    """A stage's entries of the whole model's state dict."""
    return {k: v for k, v in sd.items() if stage in stage_keys(k, cfg)}


def _auto_microbatches(B: int, S: int) -> int:
    """min(B, 2 S) shrunk until it divides B (the reference's
    `run_pipeline`)."""
    M = min(B, 2 * S)
    while B % M:
        M -= 1
    return M


def n_microbatches(cfg: LLMConfig, B: int, dp: int = 1) -> int:
    """Microbatches of a micro-step of B rows a data rank over `dp` data
    ranks: `pp_microbatches`, where 0 means the reference's count on the
    global batch of B dp rows. A data rank runs its B / M rows of each
    microbatch (data/loader.py `data_rows`), so M must divide B. Where the
    reference's count does not, a dense model runs the most microbatches
    that divide B (its loss and gradients do not depend on the count) and
    an MoE, whose routing statistics are a microbatch's, is refused."""
    M = cfg.pp_microbatches
    if M <= 0:
        M = _auto_microbatches(B * dp, cfg.pp_stages)
        if B % M and cfg.moe:
            raise ValueError(
                f"the reference's pp_microbatches {M} of the global batch "
                f"of {B * dp} rows does not divide a data rank's {B}: an "
                f"MoE's routing statistics would not be its microbatches'; "
                f"set --pp_microbatches to a divisor of {B}")
        if B % M:
            M = _auto_microbatches(B, cfg.pp_stages)
    if B % M:
        raise ValueError(f"pp_microbatches {M} must divide a data rank's "
                         f"batch of {B} rows")
    return M


def single_param_names(cfg: LLMConfig) -> tuple[list, list]:
    """(the single model's state-dict keys, its parameter names in the
    optimizer's index order: the decayed group, then the rest), from a
    model on the meta device."""
    from distributed_pytorch_tpu_torch.models.gpt import LLM
    meta = LLM(dataclasses.replace(cfg, pp_stages=1), device="meta")
    params = list(meta.named_parameters())
    return (list(meta.state_dict()),
            [n for n, p in params if p.dim() >= 2]
            + [n for n, p in params if p.dim() < 2])


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class LocalTransport:
    """Every stage in this process: a tensor sent is the tensor
    received."""

    def exchange(self, sends: list, recvs: list) -> dict:
        box = {(src, dst): t for src, dst, t in sends}
        return {dst: box.pop((src, dst)) for dst, src, _, _ in recvs}

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def tie(self, grads: dict) -> None:
        """grads: stage -> the tied weight's gradient (stages 0 and S -
        1); both become their sum."""
        total = sum(grads.values())
        for g in grads.values():
            g.copy_(total)

    def gather(self, parts: list) -> list:
        return parts


class GroupTransport:
    """One stage a process: the stage's peers are the ranks of its data
    rank's 'pipe' group (parallel/mesh.py `World.pipe_group`), the tied
    weight's pair `World.tied_group`."""

    def __init__(self, world):
        self.world = world
        base = world.rank - world.pipe_rank
        self.ranks = [base + s for s in range(world.pp)]
        # the pipe group's first collective includes every rank of it
        probe = torch.zeros(1, device=world.device)
        dist.all_reduce(probe, group=world.pipe_group)

    def exchange(self, sends: list, recvs: list) -> dict:
        ops, out = [], {}
        for _, dst, t in sends:
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self.ranks[dst]))
        for dst, src, shape, dtype in recvs:
            buf = torch.empty(shape, dtype=dtype, device=self.world.device)
            out[dst] = buf
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.world.pipe_group)
        return t

    def tie(self, grads: dict) -> None:
        for g in grads.values():
            dist.all_reduce(g, group=self.world.tied_group)

    def gather(self, parts: list) -> list:
        box = [None] * self.world.pp
        dist.all_gather_object(box, parts, group=self.world.pipe_group)
        return [p for got in box for p in got]


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

class Pipeline:
    """The stages this process holds (`stages`: stage -> `LLM` stage,
    every stage under `LocalTransport`, one under `GroupTransport`) and
    their transport. `optimizers` (stage -> optimizer) is set by the
    trainer (parallel/sharding.py `PipeRecipe`) for the checkpoint's
    whole-tensor state."""

    def __init__(self, cfg: LLMConfig, stages: dict, transport):
        self.cfg = cfg
        self.stages = dict(sorted(stages.items()))
        self.transport = transport
        self.optimizers: dict = {}
        for model in self.stages.values():
            model.pipe = self

    @property
    def last(self) -> int:
        return self.cfg.pp_stages - 1

    def run(self, idx: torch.Tensor, targets: Optional[torch.Tensor], *,
            dropout_seed=None, backward: bool = True) -> dict:
        """One (B, T) micro-step through the schedule: forward ticks,
        then (with `backward` and gradients enabled) the mirrored
        backward, leaving the gradients of the micro-step's mean loss
        (main + aux / n_layer) in the stages' `.grad`. Returns {'main':
        the last stage's loss (None elsewhere), 'aux': the sum of this
        process's stages' aux losses (None for dense models), 'M': the
        microbatch count}, detached."""
        cfg = self.cfg
        S = cfg.pp_stages
        chunks = chunk_layers(cfg)
        last_q = len(chunks) - 1
        B, T = idx.shape
        M = n_microbatches(cfg, B, context.data_size())
        b = B // M
        sched = _build_1f1b_schedule(S, len(chunks) // S, M)
        grad = backward and torch.is_grad_enabled()
        sw = 1.0 / M
        any_model = next(iter(self.stages.values()))
        shape = (b, T, cfg.n_embd)
        dt = any_model.dtype

        x_emb, mb_in = None, None
        if 0 in self.stages:
            x_emb = self.stages[0].embed(idx, dropout_seed)
            src = x_emb.detach()
            mb_in = [src[m * b:(m + 1) * b].requires_grad_(grad)
                     for m in range(M)]
        acts, exits, aux_sum = {}, {}, None
        inbox: dict = {}
        for t in range(sched.ticks):
            sends = []
            for s, model in self.stages.items():
                if not sched.valid[t, s]:
                    continue
                q, m = int(sched.q_idx[t, s]), int(sched.mb_idx[t, s])
                inp = mb_in[m] if q == 0 else inbox.pop(s).requires_grad_(
                    grad)
                out, aux = model.run_layers(
                    chunks[q], inp, dropout_seed=dropout_seed,
                    microbatch=m, stats_weight=sw)
                model.commit_moe_state(chunks[q])
                if aux is not None:
                    d = aux.detach()
                    aux_sum = d if aux_sum is None else aux_sum + d
                acts[(s, q, m)] = (inp, out, aux)
                if q == last_q:
                    exits[m] = out.detach().requires_grad_(grad)
                else:
                    sends.append((s, (s + 1) % S, out.detach()))
            recvs = [(s, (s - 1) % S, shape, dt) for s in self.stages
                     if t + 1 < sched.ticks and sched.valid[t + 1, s]
                     and sched.q_idx[t + 1, s] != 0]
            inbox = self.transport.exchange(sends, recvs)

        main = None
        if self.last in self.stages:
            h = torch.cat([exits[m] for m in range(M)])
            main = self.stages[self.last].head_loss(h, targets)
            if grad:
                main.backward()
        if grad:
            self._backward(sched, chunks, acts, exits, mb_in, x_emb, shape,
                           dt)
        return {"main": None if main is None else main.detach(),
                "aux": aux_sum, "M": M}

    def _backward(self, sched, chunks, acts, exits, mb_in, x_emb, shape,
                  dt) -> None:
        """The forward table mirrored, tick for tick in reverse."""
        S = self.cfg.pp_stages
        last_q = len(chunks) - 1
        coef = 1.0 / self.cfg.n_layer
        emb_grads = {}
        inbox: dict = {}
        for t in reversed(range(sched.ticks)):
            sends = []
            for s in self.stages:
                if not sched.valid[t, s]:
                    continue
                q, m = int(sched.q_idx[t, s]), int(sched.mb_idx[t, s])
                inp, out, aux = acts.pop((s, q, m))
                g = exits[m].grad if q == last_q else inbox.pop(s)
                outs, grads = [out], [g]
                if aux is not None:
                    outs.append(aux)
                    grads.append(torch.full_like(aux, coef))
                torch.autograd.backward(outs, grads)
                if q == 0:
                    emb_grads[m] = inp.grad
                else:
                    sends.append((s, (s - 1) % S, inp.grad))
            recvs = [(s, (s + 1) % S, shape, dt) for s in self.stages
                     if t > 0 and sched.valid[t - 1, s]
                     and sched.q_idx[t - 1, s] != last_q]
            inbox = self.transport.exchange(sends, recvs)
        if x_emb is not None:
            x_emb.backward(torch.cat([emb_grads[m]
                                      for m in range(len(mb_in))]))

    def sum_over_stages(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over every stage of `t`, this process's stages' part of
        it (in place under `GroupTransport`)."""
        return self.transport.all_reduce(t)

    def tie_grads(self) -> None:
        """Sum the tied embedding's gradient over stage 0 and the last
        stage, so both copies, and their moments, stay equal."""
        grads = {s: m.tkn_emb.weight.grad for s, m in self.stages.items()
                 if s in (0, self.last)}
        if grads and self.last > 0:
            self.transport.tie(grads)

    def norm_grads(self, s: int) -> list:
        """Stage s's gradients that the global norm counts: the tied weight
        once (on stage 0)."""
        model = self.stages[s]
        skip = model.tkn_emb.weight if s == self.last and s > 0 else None
        return [p.grad for p in model.parameters()
                if p is not skip and p.grad is not None]

    # -- whole-tensor state ------------------------------------------------

    def full_state_dicts(self, with_optimizer: bool = True
                         ) -> tuple[dict, dict]:
        """(model, optimizer) state dicts of whole tensors in the single
        model's layout, gathered from every stage (a collective over the
        'pipe' group)."""
        from distributed_pytorch_tpu_torch.parallel.sharding import \
            _opt_names
        remote = isinstance(self.transport, GroupTransport)
        parts = []
        for s, model in self.stages.items():
            msd = {k: v.detach().cpu() if remote else v.detach()
                   for k, v in model.state_dict().items()}
            named, groups = {}, None
            opt = self.optimizers.get(s)
            if with_optimizer and opt is not None:
                osd = opt.state_dict()
                names = _opt_names(model, opt)
                named = {names[int(i)]: {k: v.cpu() if remote
                                         and torch.is_tensor(v) else v
                                         for k, v in st.items()}
                         for i, st in osd["state"].items()}
                groups = osd["param_groups"]
            parts.append((s, msd, named, groups))
        parts = sorted(self.transport.gather(parts), key=lambda p: p[0])
        keys, names = single_param_names(self.cfg)
        model_sd, by_name = {}, {}
        for _, msd, named, _ in parts:
            for k, v in msd.items():
                model_sd.setdefault(k, v)
            for k, v in named.items():
                by_name.setdefault(k, v)
        model_sd = {k: model_sd[k] for k in keys}
        if not with_optimizer or parts[0][3] is None:
            return model_sd, {}
        index = {n: i for i, n in enumerate(names)}
        n_decay = sum(1 for n in names if model_sd[n].dim() >= 2)
        spans = [range(0, n_decay), range(n_decay, len(names))]
        groups = [dict(g, params=list(span))
                  for g, span in zip(parts[0][3], spans)]
        return model_sd, {"state": {index[n]: st for n, st in
                                    by_name.items()},
                          "param_groups": groups}

    def load_full_state(self, model_sd: dict, opt_sd: dict) -> None:
        """Every local stage takes its entries of whole-tensor state dicts
        in the single model's layout (a pp checkpoint's or any recipe's)
        and its optimizer its moments."""
        from distributed_pytorch_tpu_torch.parallel.sharding import \
            _opt_names
        _, names = single_param_names(self.cfg)
        index = {n: i for i, n in enumerate(names)}
        state = {int(i): st for i, st in opt_sd.get("state", {}).items()}
        for s, model in self.stages.items():
            model.load_state_dict({k: model_sd[k]
                                   for k in model.state_dict()})
            opt = self.optimizers.get(s)
            if opt is None or not opt_sd:
                continue
            mine = _opt_names(model, opt)
            own = opt.state_dict()["param_groups"]
            # each stage its own copies: two stages hold the tied moments
            st = {j: {k: v.clone() if torch.is_tensor(v) else v
                      for k, v in state[index[n]].items()}
                  for j, n in enumerate(mine) if index[n] in state}
            groups = [dict(g, params=o["params"])
                      for g, o in zip(opt_sd["param_groups"], own)]
            opt.load_state_dict({"state": st, "param_groups": groups})
