"""The training loop, on one card or over a parallel world.

Counterpart of the reference package's `train/loop.py` (`_data_paths`
:147-180, `_agree_stop` :221-235, `estimate_loss` :290-306, `train`
:309-832) for the 'single', 'dp', 'zero1', 'zero2', 'fsdp', 'tp',
'fsdp_tp', 'sp', 'ep' and 'pp' recipes.
Per optimizer step one `train_step` call runs the micro-batch
accumulation, clip and AdamW update (train/step.py) while the host
prefetches the next batch; the host syncs on the step metrics only at
log, eval and checkpoint boundaries, so the step time is a window
average. Log lines carry loss, step ms, tok/s, MFU per card against the
card's peak (train/metrics.py) and peak device memory.

Data parallelism (parallel/): `train` joins or makes the process group
(parallel/mesh.py `init_world`: torchrun's environment, NCCL on
`cuda:LOCAL_RANK` or gloo with `platform='cpu'`, a group of one rank
without torchrun), publishes it for the run (parallel/context.py) and
tears it down at the end, also when the run raises. `--batch_size` is
per data rank: grad_accum = total_batch_size / (B W T) with W the 'data'
axis's size, as the reference's (:346-351), and data rank r reads its rows
of each global batch (data/loader.py).

Tensor parallelism (`--parallelism tp|fsdp_tp --tp_size N`, or dp / fsdp
with `--tp_size N`, the same two recipes): the world is W x N ranks, the
model groups of N adjacent ranks (parallel/mesh.py), every rank of one
model group reading the same rows; the model is cut into each rank's
pieces (parallel/tensor.py) and the log names `tp=`.

The log and stats.json come from rank 0; the logged loss and the eval
means are all-reduced; checkpoints are whole tensors written by rank 0
(train/checkpoint.py). Launch with

    python -m torch.distributed.run --nproc_per_node N \
        -m distributed_pytorch_tpu_torch --parallelism fsdp ...

Checkpoints (train/checkpoint.py): `ckpt_interval` saves verified step
dirs under checkpoints/<file_name>/, `resume` restores the newest good
one (falling back past corrupt ones), `keep_ckpts` (or the
TRAIN_KEEP_CKPTS knob) prunes old ones; `save_model` writes a final one.
stats.json (loss curves, throughput, peak memory) lands beside them.
Preemption (`_graceful_stop`, reference :183-219, :589-612): on SIGTERM or
SIGINT the loop, at its next log or eval boundary, drains the pending
metrics, saves `step_<k>` and stops (`stats["stopped_early"]`); the flag
is a max over the ranks there (`_agree_stop`), so a signal to one rank
stops every rank at the same step. A later `--resume` continues the same
step-keyed data stream.

MoE models (slice 5) log `moe_drop`, the share of routed assignments the
'scatter' dispatch dropped, and keep it as `stats["moe_dropped_frac"]`;
`stats["moe_degraded_dense"]` counts the layer forwards of the run that
asked for 'grouped' and took 'dense' (`grouped_matmul.DEGRADED`).

MLA models (`--attn mla`) train through the same path; FullMLA's
training forward reaches the flash kernels at head size hs +
rope_head_dim.

Sequence parallelism (`--parallelism sp`, or `--sp_size N` under dp /
zero1 / zero2 / fsdp): the world is dp x sp ranks, and the loaders give
each rank its data rank's rows and its seq rank's positions of them, cut
as the attention the config resolves to once wants them
(ops/ring_attention.py `config_impl`, kept as `World.seq_impl`: zig-zag
stripes, or contiguous for ring and Ulysses); the grad-accum arithmetic
counts the 'data' axis only, as the reference's does, and tok/s and MFU
a step's global tokens over the world.

Expert parallelism (`--parallelism ep --ep_size N`, or dp / fsdp with
`--ep_size N`; dp with it is `ep`): the world is dp x N ranks, the expert
groups of N adjacent ranks (parallel/mesh.py), every rank of one expert
group reading its data rank's rows; the MoE stacks are cut into each
rank's n_exp / N experts (parallel/tensor.py `shard_experts`) and the log
names `expert=`. 'scatter' runs under every recipe, under a 'seq' axis
too (models/mlp.py `scatter_positions`).

Pipeline parallelism (`--parallelism pp --pp_size S`, or dp with
`--pp_size S`; `--pp_vpp`, `--pp_microbatches`, `--pp_schedule`): the
world is dp x S ranks, the 'pipe' groups of S adjacent ranks
(parallel/mesh.py), every stage of one data rank reading its rows; the
flag sets the model's `pp_stages`, as the reference links them
(:330-336), each rank builds its stage from the whole seeded init, the
train and eval steps run through the schedule (models/pipeline.py,
train/step.py), and the log names `pipe=` and the schedule with its
bubble on the static table (`pp schedule: ...`, reference :490-505).
Telemetry records nothing here either.

Not here yet, and refused where a config asks for them: the rest of slice
6 (parallel/sharding.py `SLICE6_LEFT`: the compositions — the 'pipe' axis
beside another axis or under zero1 / zero2 / fsdp, ep beside a 'seq' or
'model' axis, a 'seq' axis beside a 'model' axis, zero1 / zero2 with a
'model' or 'expert' axis, Adafactor under a sharded recipe — offload and
the collective-matmul overlap); the
profiler and the live metrics endpoint (slice 7). The reference's
telemetry flight recorder, memory planner, AOT program store and
multi-host bring-up also come with slices 6-7; `telemetry` is accepted
and records nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from distributed_pytorch_tpu_torch import config as cfg_mod
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.data.loader import (DataLoader,
                                                       make_synthetic_bin)
from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
from distributed_pytorch_tpu_torch.ops.attention_core import LATER_IMPLS
from distributed_pytorch_tpu_torch.parallel import context
from distributed_pytorch_tpu_torch.parallel import sharding
from distributed_pytorch_tpu_torch.parallel.mesh import (World, close_world,
                                                         init_world,
                                                         resolve_plan)
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train import metrics as M
from distributed_pytorch_tpu_torch.train.state import create_train_state
from distributed_pytorch_tpu_torch.train.step import (make_eval_step,
                                                      make_train_step)


def check_slice(model_cfg: LLMConfig, train_cfg: TrainConfig) -> None:
    """Refuse, naming the slice that brings it, what the port's training
    slice does not run."""
    later = []
    tp, ep, sp = train_cfg.tp_size, train_cfg.ep_size, train_cfg.sp_size
    pp = train_cfg.pp_size
    recipe = sharding.tp_recipe(train_cfg.parallelism, tp, ep, pp)
    if recipe not in sharding.PORTED:
        later.append(f"parallelism={train_cfg.parallelism!r}")
    if pp > 1 and recipe != "pp":
        later.append(f"pp_size={pp} under parallelism={recipe!r}")
    if recipe == "pp" and max(tp, sp, ep) > 1:
        later.append(f"the 'pipe' axis (parallelism='pp', pp_size={pp}) "
                     f"beside a 'seq', 'expert' or 'model' axis "
                     f"(sp_size={sp}, ep_size={ep}, tp_size={tp})")
    if tp > 1 and recipe in ("zero1", "zero2"):
        later.append(f"tp_size={tp} under parallelism={recipe!r}")
    if tp > 1 and (recipe == "sp" or sp > 1):
        later.append(f"tp_size={tp} beside a 'seq' axis "
                     f"(parallelism={recipe!r}, sp_size={sp})")
    if ep > 1 and recipe in ("zero1", "zero2"):
        later.append(f"ep_size={ep} under parallelism={recipe!r}")
    if (ep > 1 or recipe == "ep") and (recipe == "sp" or sp > 1 or tp > 1):
        later.append(f"ep (parallelism={recipe!r}, ep_size={ep}) beside a "
                     f"'seq' or 'model' axis (sp_size={sp}, tp_size={tp})")
    if train_cfg.offload == "on":
        later.append("offload='on'")
    if train_cfg.overlap == "on":
        later.append("overlap='on' (the collective-matmul overlap)")
    if train_cfg.optimizer == "adafactor" \
            and (recipe in sharding.OPT_SHARDED or tp > 1 or pp > 1):
        later.append(f"optimizer='adafactor' under "
                     f"parallelism={train_cfg.parallelism!r}")
    if later:
        later = [", ".join(later) + " come with the rest of slice 6: "
                 + sharding.SLICE6_LEFT]
    if train_cfg.attn_impl in LATER_IMPLS:
        later.append(f"attn_impl={train_cfg.attn_impl!r}: "
                     f"{LATER_IMPLS[train_cfg.attn_impl]}")
    if train_cfg.profile or train_cfg.metrics_port >= 0:
        later.append("the profiler and the metrics endpoint come with "
                     "slice 7 (operations tooling)")
    if later:
        raise NotImplementedError("; ".join(later))


def _pp_schedule_line(model_cfg: LLMConfig, B: int, dp: int,
                      stage: int) -> str:
    """The schedule of a pipeline run and its bubble on the static table
    (reference loop.py:490-505): the forward table and its mirror, the
    'carry' schedule's as vpp 1 (a stage's layers one chunk), with the
    layers rank 0's stage holds."""
    from distributed_pytorch_tpu_torch.models import pipeline as pipe_mod
    S = model_cfg.pp_stages
    vpp = pipe_mod.chunk_vpp(model_cfg)
    M = pipe_mod.n_microbatches(model_cfg, B, dp)
    _, summ = pipe_mod.schedule_timeline(S, vpp, M)
    return (f"pp schedule: {pipe_mod.resolve_schedule(model_cfg)} S={S} "
            f"vpp={vpp} M={M} | bubble {summ['bubble_frac']:.3f} (model "
            f"(S-1)/(vpp*M)={summ['bubble_model']:.3f}) | stage {stage} "
            f"layers {pipe_mod.stage_layers(model_cfg, stage)}")


def data_paths(train_cfg: TrainConfig, vocab_size: int) -> tuple[str, str]:
    """(train.bin, val.bin) of the dataset. `synthetic` writes both with
    `make_synthetic_bin` when missing, or when a file left by a run with a
    larger vocabulary holds out-of-range ids."""
    d = os.path.join(train_cfg.data_dir, train_cfg.dataset)
    train_bin = os.path.join(d, "train.bin")
    val_bin = os.path.join(d, "val.bin")
    if train_cfg.dataset == "synthetic" and os.path.exists(train_bin):
        try:
            probe = np.memmap(train_bin, dtype=np.uint16, mode="r")
            stale = int(probe[:65536].max()) >= vocab_size
            del probe
        except (ValueError, OSError):
            stale = True
        if stale:
            for p in (train_bin, val_bin):
                if os.path.exists(p):
                    os.remove(p)
    if not os.path.exists(train_bin):
        if train_cfg.dataset != "synthetic":
            raise FileNotFoundError(
                f"{train_bin} not found — prepare the dataset's .bin files "
                f"(or use --dataset synthetic)")
        make_synthetic_bin(train_bin, n_tokens=2 ** 21,
                           vocab_size=vocab_size)
        make_synthetic_bin(val_bin, n_tokens=2 ** 17, seed=271828,
                           vocab_size=vocab_size)
    return train_bin, val_bin


def estimate_loss(eval_step, state, loaders: dict, eval_iters: int) -> dict:
    """Mean eval loss over `eval_iters` batches per split, keyed on the
    eval iteration k (the same batches at every eval), micro-batch 0;
    averaged over the ranks, whose tokens make up the global batch."""
    out = {}
    for split, loader in loaders.items():
        losses = [eval_step(state, *(t[0] for t in loader.next_batch(step=k)))
                  for k in range(eval_iters)]
        out[split] = float(context.batch_all_reduce_mean(
            torch.stack(losses).mean()))
    return out


def _write_stats(path: str, stats: dict, model_cfg, train_cfg) -> None:
    record = {k: v for k, v in stats.items() if k != "state"}
    record["model_config"] = dataclasses.asdict(model_cfg)
    record["train_config"] = dataclasses.asdict(train_cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(record, f, indent=1)
    os.replace(path + ".tmp", path)


@contextlib.contextmanager
def _graceful_stop():
    """Preemption-safe shutdown: on SIGTERM (what a preempted machine is
    sent before it is reclaimed) or SIGINT (Ctrl-C), set a flag that the
    loop checks at its log and eval boundaries, where it writes a
    checkpoint and stops; `--resume` then continues the exact stream.
    Installed only from the main thread (the signal API's constraint);
    the previous handlers come back on exit. The handler only sets the
    flag: printing from a signal handler can re-enter a locked stdout."""
    stop = {"flag": False, "signame": ""}
    prevs: list[tuple[int, object]] = []
    if threading.current_thread() is threading.main_thread():
        def _handler(signum, frame):
            stop["flag"] = True
            stop["signame"] = signal.Signals(signum).name
        for signum in (signal.SIGTERM, signal.SIGINT):
            prevs.append((signum, signal.signal(signum, _handler)))
    try:
        yield stop
    finally:
        # None: the previous handler was installed from C; leave ours
        for signum, prev in prevs:
            if prev is not None:
                signal.signal(signum, prev)


def _agree_stop(local_flag: bool) -> bool:
    """Whether every process stops: the preemption flag is seen by the
    signalled process alone, but the save (a collective) and the stop
    must happen on every rank in the same iteration, so the flag is a max
    over the ranks (reference :221-235). One process: the flag itself."""
    return context.any_rank(local_flag)


def _prune(ckpt_root: str, train_cfg: TrainConfig, say) -> None:
    keep = train_cfg.keep_ckpts if train_cfg.keep_ckpts > 0 \
        else cfg_mod.knob("TRAIN_KEEP_CKPTS")
    for d in ckpt.prune_checkpoints(ckpt_root, keep):
        say(f"retention: pruned {d} (keeping newest {keep})")


def train(model_cfg: LLMConfig, train_cfg: TrainConfig,
          log: Callable[[str], None] = print) -> dict[str, Any]:
    """Run the training job; returns the stats dict (loss curves, step
    times, tok/s, MFU, peak memory) with the final state under 'state'.
    Every rank of a data-parallel run calls it and gets its own stats
    (the same losses); rank 0 logs and writes the files."""
    check_slice(model_cfg, train_cfg)
    if train_cfg.tp_size > 1 and train_cfg.parallelism == "single":
        raise ValueError(f"tp_size={train_cfg.tp_size} under "
                         "parallelism='single': use 'tp' or 'fsdp_tp'")
    if train_cfg.sp_size > 1 and train_cfg.parallelism == "single":
        raise ValueError(f"sp_size={train_cfg.sp_size} under "
                         "parallelism='single': use 'sp', or --sp_size "
                         "under dp, zero1, zero2 or fsdp")
    if train_cfg.ep_size > 1 and train_cfg.parallelism == "single":
        raise ValueError(f"ep_size={train_cfg.ep_size} under "
                         "parallelism='single': use 'ep', or --ep_size "
                         "under dp or fsdp")
    if train_cfg.pp_size > 1 and train_cfg.parallelism == "single":
        raise ValueError(f"pp_size={train_cfg.pp_size} under "
                         "parallelism='single': use 'pp', or --pp_size "
                         "under dp")
    if model_cfg.block_size % train_cfg.sp_size:
        raise ValueError(f"sp_size={train_cfg.sp_size} does not divide "
                         f"block_size {model_cfg.block_size}")
    train_cfg = dataclasses.replace(train_cfg, parallelism=sharding.tp_recipe(
        train_cfg.parallelism, train_cfg.tp_size, train_cfg.ep_size,
        train_cfg.pp_size))
    linked = []
    if model_cfg.pp_stages != train_cfg.pp_size:
        # the 'pipe' axis and the model's stage count are one decision;
        # the trainer flag wins (reference loop.py:330-336)
        linked.append(f"pp: setting model pp_stages = pp_size = "
                      f"{train_cfg.pp_size}")
        model_cfg = dataclasses.replace(model_cfg,
                                        pp_stages=train_cfg.pp_size)
    world = make_world(model_cfg, train_cfg)
    try:
        with context.use_world(world):
            say = log if world.is_main else (lambda s: None)
            for line in linked:
                say(line)
            return _train(model_cfg, train_cfg, world, say)
    finally:
        close_world(world)


def make_world(model_cfg: LLMConfig, train_cfg: TrainConfig) -> World:
    """The run's world (parallel/mesh.py `init_world`) with the attention
    of its 'seq' axis (ops/ring_attention.py `config_impl`)."""
    world = init_world(train_cfg.parallelism, train_cfg.platform,
                       train_cfg.dp_size, train_cfg.tp_size,
                       train_cfg.sp_size, train_cfg.ep_size,
                       train_cfg.pp_size)
    if world.sp == 1:
        return world
    from distributed_pytorch_tpu_torch.ops.ring_attention import \
        config_impl
    return dataclasses.replace(world, seq_impl=config_impl(
        model_cfg, train_cfg.attn_impl, world.sp))


def _train(model_cfg: LLMConfig, train_cfg: TrainConfig, world: World,
           say: Callable[[str], None]) -> dict[str, Any]:
    main = world.is_main
    if model_cfg.moe:
        # moe_impl lives in both configs (the CLI routes the flag to both);
        # for programmatic callers a non-default TrainConfig value wins,
        # but its default ('dense') never downgrades a model configured
        # otherwise (reference loop.py:318-328)
        want = train_cfg.moe_impl if train_cfg.moe_impl != "dense" \
            else model_cfg.moe_impl
        if want != model_cfg.moe_impl:
            say(f"moe_impl: TrainConfig overrides model config -> {want}")
            model_cfg = dataclasses.replace(model_cfg, moe_impl=want)
    device = world.device
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    W = world.dp                                  # ranks on 'data'
    plan = resolve_plan(train_cfg.parallelism, world.size,
                        tp_size=world.tp, sp_size=world.sp,
                        ep_size=world.ep, pp_size=world.pp,
                        dp_size=train_cfg.dp_size)
    seq = f" seq={plan.seq} ({world.seq_impl})" if world.sp > 1 else ""
    say(f"device {device} ({name}); tp={world.tp} "
        f"recipe={train_cfg.parallelism} world={world.size} "
        f"backend={world.backend} data={plan.data} model={plan.model}"
        f"{seq} expert={plan.expert} pipe={plan.pipe}")

    # grad accumulation arithmetic (reference loop.py:346-351)
    B, T = train_cfg.batch_size, model_cfg.block_size
    b_glob = B * W
    assert train_cfg.total_batch_size % (b_glob * T) == 0, (
        f"total_batch_size {train_cfg.total_batch_size} not divisible by "
        f"B*T*dp = {b_glob * T}")
    grad_accum = train_cfg.total_batch_size // (b_glob * T)
    tokens_per_step = train_cfg.total_batch_size
    say(f"grad_accum={grad_accum} micro-steps of {b_glob}x{T} tokens "
        f"-> {tokens_per_step} tokens/step")

    if main:
        train_bin, val_bin = data_paths(train_cfg, model_cfg.vocab_size)
    context.barrier()       # rank 0 writes a missing synthetic dataset
    if not main:
        train_bin, val_bin = data_paths(train_cfg, model_cfg.vocab_size)

    # under a 'pipe' axis a data rank's rows are its share of each
    # pipeline microbatch of the global batch
    n_micro = 1
    if world.pp > 1:
        from distributed_pytorch_tpu_torch.models import pipeline as pipe_mod
        n_micro = pipe_mod.n_microbatches(model_cfg, B, W)

    def mk(path, seed):
        return DataLoader(path, B, T, grad_accum=grad_accum, seed=seed,
                          device=device, rank=world.data_rank, world=W,
                          seq_rank=world.seq_rank, sp=world.sp,
                          layout=world.seq_layout, microbatches=n_micro)

    train_loader = mk(train_bin, train_cfg.seed)
    # eval streams of their own: the training batches do not depend on the
    # eval cadence
    val_loader = mk(val_bin, train_cfg.seed + 1)
    eval_train_loader = mk(train_bin, train_cfg.seed + 2)

    state = create_train_state(model_cfg, train_cfg, device, world)
    total, active = state.param_counts
    say(f"params: {total / 1e6:.2f}M total, {active / 1e6:.2f}M active")
    if world.pp > 1:
        say(_pp_schedule_line(model_cfg, B, W, world.pipe_rank))

    ckpt_root = os.path.join("checkpoints", train_cfg.file_name)
    start_step = 0
    if train_cfg.resume:
        restored = ckpt.restore_latest(ckpt_root, state)
        if restored is not None:
            state, last, skipped = restored
            start_step = state.step
            for bad in skipped:
                say(f"resume: skipped unusable checkpoint {bad}")
            say(f"resumed from {last} at step {start_step}")

    train_step = make_train_step(train_cfg)
    eval_step = make_eval_step()
    stats = {"train_losses": [], "val_losses": [], "step_times": [],
             "tokens_per_sec": [], "mfu": []}
    if model_cfg.moe:
        stats["moe_dropped_frac"] = []  # per-synced-step drop fractions
        degraded0 = gm.DEGRADED["dense"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    x, y = train_loader.next_batch(step=start_step)
    pending: list = []
    win_t0 = time.perf_counter()
    stopped_early = False
    with _graceful_stop() as stop:
        for it in range(start_step, train_cfg.max_iters + 1):
            # stop checks at deterministic boundaries (the first
            # iteration, log and eval), where the metrics sync anyway
            check_due = (it == start_step
                         or it % train_cfg.log_interval == 0
                         or (train_cfg.eval
                             and it % train_cfg.eval_interval == 0))
            if check_due and _agree_stop(stop["flag"]):
                # drain queued metrics, checkpoint the state as of the last
                # completed step, exit before another eval or step
                stats["train_losses"].extend(float(g["loss"])
                                             for g in pending)
                pending.clear()
                stop["signame"] = stop["signame"] or "a peer's SIGTERM"
                path = ckpt.save_checkpoint(
                    os.path.join(ckpt_root, f"step_{state.step}"), state,
                    model_cfg, train_cfg)
                say(f"[signal] {stop['signame']}: checkpoint "
                    f"-> {path}; stopping at iter {it} (resume with "
                    "--resume)")
                stopped_early = True
                break

            if train_cfg.eval and it % train_cfg.eval_interval == 0:
                t0 = time.perf_counter()
                ev = estimate_loss(eval_step, state,
                                   {"train": eval_train_loader,
                                    "val": val_loader}, train_cfg.eval_iters)
                stats["val_losses"].append((it, ev["val"]))
                say(f"iter {it}: train {ev['train']:.4f} val {ev['val']:.4f} "
                    f"({time.perf_counter() - t0:.1f}s)")
                win_t0 = time.perf_counter()   # eval time is not step time

            m = train_step(state, x, y)
            pending.append(m)
            if it < train_cfg.max_iters:       # prefetch while the device runs
                x, y = train_loader.next_batch(step=it + 1)

            ckpt_due = bool(train_cfg.ckpt_interval and it
                            and it % train_cfg.ckpt_interval == 0)
            eval_next = (train_cfg.eval
                         and (it + 1) % train_cfg.eval_interval == 0)
            if (it % train_cfg.log_interval == 0 or ckpt_due or eval_next
                    or it == train_cfg.max_iters):
                got = [{k: float(v) for k, v in g.items()} for g in pending]
                t_now = time.perf_counter()
                dt = (t_now - win_t0) / len(got)
                win_t0 = t_now
                mfu = M.mfu(model_cfg, tokens_per_step, T, dt,
                            n_chips=world.size,
                            device=device)
                first_window = not stats["train_losses"]
                for k, g in enumerate(got):
                    it_k = it - len(got) + 1 + k
                    stats["train_losses"].append(g["loss"])
                    if "moe_dropped_frac" in g:
                        stats["moe_dropped_frac"].append(
                            g["moe_dropped_frac"])
                    if g.get("nonfinite"):
                        ev = {"it": it_k, "loss": g["loss"],
                              "grad_norm": g["grad_norm"],
                              "skipped": bool(g.get("update_skipped", 0.0))}
                        stats.setdefault("anomalies", []).append(ev)
                        say(f"[anomaly] iter {it_k}: loss {g['loss']:.4g}, "
                            f"grad_norm {g['grad_norm']:.4g}"
                            f"{', update skipped' if ev['skipped'] else ''}")
                    if not first_window:       # the first window holds warmup
                        stats["step_times"].append(dt)
                        stats["tokens_per_sec"].append(tokens_per_step / dt)
                        if mfu is not None:
                            stats["mfu"].append(mfu)
                pending.clear()
                if it % train_cfg.log_interval == 0:
                    mem = M.device_memory_gb(device)
                    mfu_s = f" | mfu {mfu:6.2%}" if mfu is not None else ""
                    mem_s = f" | mem {mem:5.2f}GB" if mem else ""
                    # the dropped share of routed assignments ('scatter'
                    # drops past capacity; 0 for dense and grouped)
                    drop_s = (f" | moe_drop "
                              f"{stats['moe_dropped_frac'][-1]:6.2%}"
                              if stats.get("moe_dropped_frac") else "")
                    say(f"iter {it:5d} | loss {got[-1]['loss']:.4f} | "
                        f"dt {dt * 1e3:7.1f}ms | tok/s "
                        f"{tokens_per_step / dt:10.0f}{mfu_s}{mem_s}"
                        f"{drop_s}")

            if ckpt_due:
                path = ckpt.save_checkpoint(
                    os.path.join(ckpt_root, f"step_{it}"), state, model_cfg,
                    train_cfg)
                say(f"checkpoint -> {path}")
                if train_cfg.save_stats and main:
                    _write_stats(os.path.join(ckpt_root, "stats.json"), stats,
                                 model_cfg, train_cfg)
                if main:
                    _prune(ckpt_root, train_cfg, say)
                win_t0 = time.perf_counter()   # not step time

    if train_cfg.save_model and not stopped_early:
        path = ckpt.save_checkpoint(
            os.path.join(ckpt_root, f"step_{state.step}"), state, model_cfg,
            train_cfg)
        say(f"final checkpoint -> {path}")
    if main:
        _prune(ckpt_root, train_cfg, say)

    stats["final_loss"] = stats["train_losses"][-1] \
        if stats["train_losses"] else None
    stats["peak_mem_gb"] = M.device_memory_gb(device)
    if stats["step_times"]:
        med = float(np.median(stats["step_times"]))
        stats["median_step_time"] = med
        stats["median_tokens_per_sec"] = tokens_per_step / med
        stats["median_mfu"] = M.mfu(model_cfg, tokens_per_step, T, med,
                                    n_chips=world.size, device=device)
    stats["params_total"], stats["params_active"] = int(total), int(active)
    if stats.get("moe_dropped_frac"):
        stats["final_moe_dropped_frac"] = stats["moe_dropped_frac"][-1]
    if model_cfg.moe:
        stats["moe_degraded_dense"] = gm.DEGRADED["dense"] - degraded0
    stats["stopped_early"] = stopped_early
    stats["device"] = name
    stats["recipe"] = train_cfg.parallelism
    stats["world"] = world.size
    stats["tp"] = world.tp
    stats["sp"] = world.sp
    stats["ep"] = world.ep
    stats["pp"] = world.pp
    stats["backend"] = world.backend
    if stats.get("anomalies"):
        stats["n_anomalies"] = len(stats["anomalies"])
    if train_cfg.save_stats and main:
        path = os.path.join(ckpt_root, "stats.json")
        _write_stats(path, stats, model_cfg, train_cfg)
        say(f"stats -> {path}")
    stats["state"] = state
    return stats
