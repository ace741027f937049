"""Pipeline parallelism in the port ('pp', and --pp_size under dp) against
the reference package's 'pp' recipe on the CPU.

The harness of test_torch_parallel_train.py: the reference runs its 'pp'
recipe on W virtual CPU devices (`build_mesh(resolve_plan('pp', W,
pp_size=S))`, data W / S x pipe S, the blocks stacked over 'pipe'), the
port on W gloo ranks spawned from tests/torch_parallel_ranks.py, one
pipeline stage a rank, from the reference's init (its stacked tree
through `params_from_jax`) and on the same global batches; the stages of
one data rank take its rows. The model is TINY at four layers. The ranks
run while the reference computes. Each test states its tolerance."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.config import TrainConfig as JTrainConfig
from distributed_pytorch_tpu.parallel import context as jcontext
from distributed_pytorch_tpu.parallel import sharding as jshd
from distributed_pytorch_tpu.parallel.mesh import build_mesh
from distributed_pytorch_tpu.parallel.mesh import resolve_plan as jplan
from distributed_pytorch_tpu.train.state import create_train_state as jstate
from distributed_pytorch_tpu.train.step import make_train_step as jstep
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.parallel import sharding
from distributed_pytorch_tpu_torch.train.loop import check_slice
from test_torch_parallel_train import (TINY, assert_trajectory,
                                       global_batches, steps_case, train_kw)
import torch_parallel_ranks as ranks

PP = dict(TINY, n_layer=4)
MOE = dict(PP, moe=True, n_exp=4, n_shared=1, n_act=2, moe_impl="grouped")

# name: (model, pipe stages S, extra model flags)
CASES_W2 = {
    # pipe 2, vpp 2: chunks 0 and 2 on stage 0, 1 and 3 on stage 1
    "pp2_vpp2": (PP, 2, dict(pp_vpp=2, pp_schedule="1f1b")),
    # the carry schedule with the MoE (aux-free, grouped on the port,
    # dense on the reference) at M 2
    "pp2_moe_carry": (MOE, 2, dict(pp_microbatches=2)),
}
CASES_W4 = {
    # data 2 x pipe 2, the auto schedule (1f1b, vpp 2, M auto)
    "dp2_pp2": (PP, 2, {}),
    # data 2 x pipe 2, the MoE under 'carry' at M 2: microbatch m's
    # routing statistics are the reference's rows [m b, (m + 1) b) of the
    # global batch, half of them on each data rank
    "dp2_pp2_moe_carry": (MOE, 2, dict(pp_microbatches=2)),
}


class _Reference:
    """The reference's 'pp' recipe on W devices with a 'pipe' axis of S:
    its init in the port's layout now, its 5 steps in `run()`."""

    def __init__(self, mdict, S, W, seed):
        self.dp = W // S
        self.kw = train_kw(self.dp, pp_size=S)
        self.mc = JConfig(**mdict, pp_stages=S)
        self.jtc = JTrainConfig(**self.kw, parallelism="pp")
        self.mesh = build_mesh(jplan("pp", W, pp_size=S))
        with jcontext.use_mesh(self.mesh):
            self.jmodel, self.tx, self.js, self.sh = jstate(
                self.mc, self.jtc, self.mesh)
        self.cfg = LLMConfig(**mdict, pp_stages=S)
        self.batches = global_batches(5, self.dp, mdict["vocab_size"],
                                      seed=seed)
        self.case = steps_case(dict(mdict, pp_stages=S), self.kw, "pp",
                               self._sd(self.js), self.batches)

    def _sd(self, s):
        return params_from_jax(jax.device_get(s.params), self.cfg,
                               jax.device_get(s.moe_state))

    def run(self):
        with jcontext.use_mesh(self.mesh):
            step = jstep(self.jmodel, self.tx, self.mc, self.jtc,
                         self.mesh, self.sh)
            bsh = NamedSharding(self.mesh, jshd.batch_pspec(
                "pp", self.mesh, leading_accum=True))
            js, out = self.js, []
            for x, y in self.batches:
                js, m = step(js, jax.device_put(jnp.asarray(x, jnp.int32),
                                                bsh),
                             jax.device_put(jnp.asarray(y, jnp.int32), bsh))
                out.append(dict({k: float(v) for k, v in m.items()},
                                state=self._sd(js)))
        return out


def _ckpt_cases(tmp):
    """The trainer loop under pp 2 (vpp 2) with eval and a final save,
    then that step dir restored under 'single' and under pp 2."""
    kw = dict(dataset="synthetic", data_dir=str(tmp / "data"),
              batch_size=2, total_batch_size=2 * 2 * 32, warmup_steps=2,
              platform="cpu", compute_dtype="float32", log_interval=1,
              save_stats=False, max_iters=3, parallelism="pp", pp_size=2,
              eval=True, eval_interval=2, eval_iters=1, save_model=True)
    d = str(tmp / "run")
    step = os.path.join(d, "checkpoints", "llm_model", "step_4")
    return [dict(kind="train", cfg=dict(PP, pp_vpp=2), tc=kw, cwd=d),
            dict(kind="restore", cfg=dict(PP, pp_vpp=2),
                 tc=dict(kw, parallelism="single", pp_size=1), path=step),
            dict(kind="restore", cfg=dict(PP, pp_vpp=2, pp_stages=2),
                 tc=kw, path=step)]


def _raises_cases():
    """--pp_size 2 under the recipes that do not compose with it yet."""
    cfg = dict(PP, pp_stages=2)
    return [dict(kind="raises", cfg=cfg,
                 tc=dict(platform="cpu", parallelism=r, pp_size=2))
            for r in ("fsdp", "zero1", "zero2")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (reference steps, the ranks' records)}: CASES_W2 and the
    refused recipes in one spawn of two ranks, CASES_W4 in one of four."""
    tmp = tmp_path_factory.mktemp("pp")
    refs = {}
    for i, (name, (m, S, extra)) in enumerate(
            list(CASES_W2.items()) + list(CASES_W4.items())):
        W = 2 if name in CASES_W2 else 4
        refs[name] = _Reference(dict(m, **extra), S, W, seed=90 + i)
    w2 = [refs[n].case for n in CASES_W2] + _raises_cases() \
        + _ckpt_cases(tmp)
    w4 = [refs[n].case for n in CASES_W4]
    with ThreadPoolExecutor(2) as pool:
        g2 = pool.submit(ranks.spawn, tmp / "w2", 2, w2, 300)
        g4 = pool.submit(ranks.spawn, tmp / "w4", 4, w4, 300)
        want = {name: ref.run() for name, ref in refs.items()}
        got2, got4 = g2.result(), g4.result()
    out = {name: (want[name], [g[i] for g in got2])
           for i, name in enumerate(CASES_W2)}
    out.update({name: (want[name], [g[i] for g in got4])
                for i, name in enumerate(CASES_W4)})
    n = len(CASES_W2)
    out["raises"] = [g[n:n + 3] for g in got2]
    out["ckpt"] = [g[n + 3:] for g in got2]
    return out


@pytest.mark.parametrize("case", list(CASES_W2) + list(CASES_W4))
def test_pp_trajectory_matches_reference(runs, case):
    """5 AdamW steps, accum 2, clipping active, fp32: each rank's whole
    parameters (gathered from the stages) within atol 1e-4 of the
    reference's 'pp' recipe after every step, the loss within rtol 1e-5,
    the grad norm within rtol 1e-4, every expert_bias within 1e-6 (the
    tolerances of test_torch_parallel_ep.py). World 2: pipe 2 at vpp 2,
    and the MoE under 'carry' at M 2 (the bias commits once a (layer,
    microbatch)); world 4: data 2 x pipe 2."""
    ref, got = runs[case]
    assert all(r["grad_norm"] > 0.05 for r in ref)
    assert_trajectory(ref, got, atol=1e-4)
    if "moe" in case:
        for g in got:
            bias = g["steps"][-1]["params"]["blocks.3.moe.expert_bias"]
            assert not (bias == 0).all()


@pytest.mark.parametrize("case", list(CASES_W2) + list(CASES_W4))
def test_tied_copies_stay_bit_identical(runs, case):
    """The tied embedding / head lives on the first and the last stage:
    after every step both copies, and both copies' AdamW moments, are
    equal bit for bit, on every data rank."""
    _, got = runs[case]
    for k in range(len(got[0]["steps"])):
        tied = [g["steps"][k]["tied"] for g in got if g["steps"][k]["tied"]]
        assert sorted(t["stage"] for t in tied) == \
            sorted([0, 1] * (len(got) // 2))
        for t in tied[1:]:
            for key in ("weight", "exp_avg", "exp_avg_sq"):
                assert torch.equal(t[key], tied[0][key]), (k, key)


def test_pp_size_under_other_recipes_is_refused(runs):
    """--pp_size 2 under fsdp, zero1 and zero2 (ranks: the recipe's wrap)
    and under tp, sp, ep, fsdp, zero1 and zero2 (check_slice) raises
    NotImplementedError naming ROADMAP Queue 1 item 4, the compositions;
    dp with --pp_size 2 is pp."""
    for g in runs["raises"]:
        for rec in g:
            assert "Queue 1 items 4-6" in rec["raised"], rec
    mc = LLMConfig(**PP)
    for recipe, extra in (("fsdp", {}), ("zero1", {}), ("zero2", {}),
                          ("tp", dict(tp_size=2)), ("sp", dict(sp_size=2)),
                          ("ep", dict(ep_size=2)), ("pp", dict(sp_size=2)),
                          ("pp", dict(tp_size=2))):
        tc = TrainConfig(platform="cpu", parallelism=recipe, pp_size=2,
                         **extra)
        with pytest.raises(NotImplementedError,
                           match=r"compositions.*Queue 1 items 4-6"):
            check_slice(mc, tc)
    for recipe in ("pp", "dp"):
        check_slice(mc, TrainConfig(platform="cpu", parallelism=recipe,
                                    pp_size=2))
    assert sharding.tp_recipe("dp", 1, 1, 2) == "pp"
    assert "pp" in sharding.PORTED and not \
        sharding.SLICE6_LEFT.startswith("pp")


def test_pp_checkpoint_saves_whole_tensors_and_restores(runs):
    """The trainer loop under pp 2 (vpp 2, eval every 2 iterations, a
    final save): every rank logs the schedule and the eval, the step dir
    holds the single model's tensors and moments gathered from both
    stages, and restored under 'single' and under pp 2 it gives back the
    run's whole state bit for bit, on every rank."""
    for train, single, pp in runs["ckpt"]:
        assert any(line.startswith("pp schedule: 1f1b S=2 vpp=2")
                   for line in train["log"]) or not train["log"]
        assert train["step"] == 4 and len(train["val_losses"]) == 2
        for got in (single, pp):
            assert got["step"] == 4 and got["updates"] == 4
            assert set(got["model"]) == set(train["model"])
            for k, v in train["model"].items():
                assert torch.equal(got["model"][k], v), k
            want = train["optimizer"]["state"]
            assert set(got["optimizer"]["state"]) == set(want)
            for i, st in want.items():
                for key in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(got["optimizer"]["state"][i][key],
                                       st[key]), (i, key)
