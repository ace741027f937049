"""One rank of a parallel run of the port, for the multi-process tests
(tests/test_torch_parallel*.py). Imports no JAX: the tests compute
the reference's side in their own process and hand this module a spec.

    PYTHONPATH=. python tests/torch_parallel_ranks.py SPEC RANK

SPEC is a `torch.save`d dict: `world` (W), `store` (a file for the gloo
group's `file://` rendezvous, unique per test), `out` (a directory) and
`cases`, run in order in one group so that the ranks start once per
test. Each case is a dict with a `kind`:

* 'steps': build the state under `tc['parallelism']` (and `tc['tp_size']`,
  `tc['sp_size']`, `tc['ep_size']`, `tc['pp_size']`, with the model's
  `pp_stages` equal to it) from the whole state dict `init`, then run
  `make_train_step` over the global batches `batches` ((A, B W, T) arrays,
  W the 'data' axis's size), this rank taking its data rank r's rows
  of each micro-step (data/loader.py `data_rows`: r B .. r B + B - 1, or
  under a 'pipe' axis r's share of each pipeline microbatch), and under
  a 'seq' axis its seq rank's positions of them (the loader's cut). Records each step's metrics, the whole parameters,
  the MoE buffers, under a 'pipe' axis the first and last stage's tied
  embedding and its moments (`tied`), and at the end the bytes held
  (`held_bytes`) and the
  fused CE's `DEGRADED` counts. With
  `poison` = (rank, step), that rank alone NaN-bombs that step
  (TRAIN_POISON_IT).
* 'train': `train()` through the trainer loop in the directory `cwd`; with
  `sigterm` = (rank, step), that rank signals itself when its loader
  prefetches that step. Records the stats (the state as whole tensors).
* 'raises': `create_train_state` must raise NotImplementedError.
* 'restore': build the state under `tc['parallelism']` and restore the
  step dir `path` into it; records the whole state.
* 'ce': the fused CE (`pallas_cross_entropy`, its plain versions on the
  CPU) over this rank's rows of `x` / `t` against the whole `w`; records
  the loss and dW averaged over the ranks and this rank's dx.
* 'vp_ce': the vocab-parallel CE (`vocab_parallel_cross_entropy`) over a
  world of `tp`-rank model groups: this data rank's rows of `x` / `t`
  against this model rank's rows of `w`, chunk `chunk`; records the loss,
  this rank's dx and the whole dW (averaged over 'data', joined over
  'model').
* 'sp_attn': `ring_attention.sp_sdpa` under a world of one 'seq' axis over
  every rank whose attention is `impl` (resolved): this rank's positions
  of the whole `q`, `k`, `v` (natural order) in that attention's layout
  forward with `rate` and `seed`, then backward from its rows of `dout`;
  records out, dq, dk, dv and the positions.

Rank r writes its records to `out/rank<r>.pt`. `spawn` starts the W
ranks from a test and returns their records.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.data import loader as loader_mod
from distributed_pytorch_tpu_torch.models import pipeline as pipe_mod
from distributed_pytorch_tpu_torch.ops import fused_ce
from distributed_pytorch_tpu_torch.parallel import context, sharding
from distributed_pytorch_tpu_torch.ops import ring_attention
from distributed_pytorch_tpu_torch.parallel.mesh import init_world
from distributed_pytorch_tpu_torch.train import checkpoint
from distributed_pytorch_tpu_torch.train.loop import make_world, train
from distributed_pytorch_tpu_torch.train.state import create_train_state
from distributed_pytorch_tpu_torch.train.step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clone(sd: dict) -> dict:
    return {k: v.detach().clone() for k, v in sd.items()}


def _world(cfg: LLMConfig, tc: TrainConfig):
    return make_world(cfg, dataclasses.replace(
        tc, parallelism=sharding.tp_recipe(tc.parallelism, tc.tp_size,
                                           tc.ep_size, tc.pp_size)))


def _tied(state) -> dict:
    """Under a 'pipe' axis, the first or last stage's copy of the tied
    embedding and its AdamW moments (empty elsewhere)."""
    model = state.model
    if getattr(model, "pipe", None) is None or not hasattr(model,
                                                           "tkn_emb"):
        return {}
    w = model.tkn_emb.weight
    st = state.optimizer.state.get(w, {})
    return {"stage": model.stage, "weight": w.detach().clone(),
            **{k: v.clone() for k, v in st.items() if torch.is_tensor(v)
               and v.dim() > 0}}


def run_steps(case: dict, rank: int, W: int) -> dict:
    cfg, tc = LLMConfig(**case["cfg"]), TrainConfig(**case["tc"])
    world = _world(cfg, tc)
    poison = case.get("poison")
    fused_ce.reset_counts()
    if poison is not None and poison[0] == rank:
        os.environ["TRAIN_POISON_IT"] = str(poison[1])
    with context.use_world(world):
        state = create_train_state(cfg, tc, "cpu", world, init=case["init"])
        step = make_train_step(tc)
        os.environ.pop("TRAIN_POISON_IT", None)
        out = {"steps": []}
        for x, y in case["batches"]:
            B = x.shape[1] // world.dp
            M = pipe_mod.n_microbatches(cfg, B, world.dp) if world.pp > 1 \
                else 1
            rows = loader_mod.data_rows(B, world.dp, world.data_rank, M)
            x, y = x[:, rows], y[:, rows]
            if world.sp > 1:
                cols = ring_attention.local_positions(
                    x.shape[2], world.sp, world.seq_rank, world.seq_layout)
                x, y = x[:, :, cols], y[:, :, cols]
            m = step(state, torch.from_numpy(x).long(),
                     torch.from_numpy(y).long())
            rec = {k: float(v) for k, v in m.items()}
            rec["params"] = _clone(sharding.full_model_state_dict(
                state.model))
            rec["moe"] = [{k: b.clone() for k, b in layer.named_buffers()}
                          for layer in state.model.moe_layers()]
            rec["tied"] = _tied(state)
            out["steps"].append(rec)
        out["held"] = state.recipe.held_bytes()
    out["ce_degraded"] = dict(fused_ce.DEGRADED)
    return out


def run_train(case: dict, rank: int, W: int) -> dict:
    cfg, tc = LLMConfig(**case["cfg"]), TrainConfig(**case["tc"])
    os.makedirs(case["cwd"], exist_ok=True)
    os.chdir(case["cwd"])
    sig = case.get("sigterm")
    orig = loader_mod.DataLoader.next_batch
    if sig is not None and sig[0] == rank:
        def next_batch(self, step=None):
            if step == sig[1]:
                os.kill(os.getpid(), signal.SIGTERM)
            return orig(self, step)
        loader_mod.DataLoader.next_batch = next_batch
    lines: list[str] = []
    try:
        stats = train(cfg, tc, log=lines.append)
    finally:
        loader_mod.DataLoader.next_batch = orig
    state = stats.pop("state")
    with context.use_world(state.recipe.world):
        model_sd, opt_sd = sharding.full_state_dicts(state.model,
                                                     state.optimizer)
    stats["model"], stats["optimizer"] = _clone(model_sd), opt_sd
    stats["step"], stats["updates"] = state.step, state.updates
    stats["log"] = lines
    return stats


def run_restore(case: dict, rank: int, W: int) -> dict:
    cfg, tc = LLMConfig(**case["cfg"]), TrainConfig(**case["tc"])
    world = _world(cfg, tc)
    with context.use_world(world):
        state = create_train_state(cfg, tc, "cpu", world)
        checkpoint.restore_checkpoint(case["path"], state)
        model_sd, opt_sd = sharding.full_state_dicts(state.model,
                                                     state.optimizer)
    return {"model": _clone(model_sd), "optimizer": opt_sd,
            "step": state.step, "updates": state.updates}


def run_raises(case: dict, rank: int, W: int) -> dict:
    cfg, tc = LLMConfig(**case["cfg"]), TrainConfig(**case["tc"])
    world = _world(cfg, tc)
    try:
        create_train_state(cfg, tc, "cpu", world)
    except NotImplementedError as e:
        return {"raised": str(e)}
    return {"raised": None}


def run_ce(case: dict, rank: int, W: int) -> dict:
    world = init_world("dp", "cpu")
    B = case["x"].shape[0] // W
    rows = slice(rank * B, (rank + 1) * B)
    x = torch.from_numpy(case["x"][rows]).requires_grad_()
    w = torch.from_numpy(case["w"]).requires_grad_()
    fused_ce.reset_counts()
    with context.use_world(world):
        loss = fused_ce.pallas_cross_entropy(
            x, w, torch.from_numpy(case["t"][rows]).long())
        loss.backward()
        return {"loss": float(context.all_reduce_mean(loss.detach())),
                "dw": context.all_reduce_mean(w.grad.clone()),
                "dx": x.grad.clone(), "plain": dict(fused_ce.PLAIN_CALLS)}


def run_vp_ce(case: dict, rank: int, W: int) -> dict:
    from distributed_pytorch_tpu_torch.ops.losses import \
        vocab_parallel_cross_entropy
    from distributed_pytorch_tpu_torch.parallel import tensor
    tp = case["tp"]
    world = init_world("tp", "cpu", -1, tp)
    B = case["x"].shape[0] // world.dp
    rows = slice(world.data_rank * B, (world.data_rank + 1) * B)
    V = case["w"].shape[0]
    cut = (0, (V,))
    x = torch.from_numpy(case["x"][rows]).requires_grad_()
    w = tensor.split(torch.from_numpy(case["w"]), cut, world.model_rank,
                     tp).requires_grad_()
    with context.use_world(world):
        loss = vocab_parallel_cross_entropy(
            x, w, torch.from_numpy(case["t"][rows]).long(),
            world.model_rank * w.shape[0], chunk=case["chunk"])
        loss.backward()
        dw = tensor.join(context.model_all_gather(
            context.all_reduce_mean(w.grad.clone())), cut)
        return {"loss": float(loss.detach()), "dx": x.grad.clone(),
                "dw": dw, "data_rank": world.data_rank}


def run_sp_attn(case: dict, rank: int, W: int) -> dict:
    world = dataclasses.replace(init_world("sp", "cpu", sp_size=W),
                                seq_impl=case["impl"])
    T = case["q"].shape[1]
    cols = ring_attention.local_positions(T, W, rank, world.seq_layout)
    q, k, v = (torch.from_numpy(case[n][:, cols]).requires_grad_()
               for n in ("q", "k", "v"))
    seed = torch.tensor(case["seed"], dtype=torch.int32)
    with context.use_world(world):
        out = ring_attention.sp_sdpa(q, k, v, scale=case["scale"],
                                     dropout_rate=case["rate"],
                                     dropout_seed=seed)
        out.backward(torch.from_numpy(case["dout"][:, cols]))
    return {"cols": cols, "out": out.detach(), "dq": q.grad, "dk": k.grad,
            "dv": v.grad}


KINDS = {"steps": run_steps, "train": run_train, "raises": run_raises,
         "ce": run_ce, "restore": run_restore, "vp_ce": run_vp_ce,
         "sp_attn": run_sp_attn}


def spawn(tmp, world: int, cases: list, timeout: float = 240.0) -> list:
    """Run `cases` on `world` gloo ranks started as processes of this
    module (rendezvous through a file under `tmp`); returns each rank's
    records. A rank that fails, or a run past `timeout` seconds, fails
    the calling test with the ranks' output."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    spec = os.path.join(tmp, "spec.pt")
    torch.save({"world": world, "store": os.path.join(tmp, "store"),
                "out": tmp, "cases": cases}, spec)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               spec, str(r)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        tails = "\n".join(
            f"--- rank {r} (rc {rc}):\n"
            + open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:]
            for r, rc in enumerate(rcs))
        raise AssertionError(f"ranks failed or timed out after "
                             f"{timeout:.0f}s: {rcs}\n{tails}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(2)
    spec = torch.load(spec_path, weights_only=False)
    W = spec["world"]
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=W)
    try:
        results = [KINDS[c["kind"]](c, rank, W) for c in spec["cases"]]
        torch.save(results, os.path.join(spec["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
