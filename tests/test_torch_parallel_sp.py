"""Sequence parallelism in the port ('sp', and --sp_size under dp / zero2 /
fsdp) against the reference package's same recipe on the CPU.

The harness of test_torch_parallel_train.py: the reference runs its recipe
on W virtual CPU devices (`build_mesh(resolve_plan(recipe, W, sp_size=
sp))`, so its attention takes `sp_sdpa` and its loss
`sp_fused_cross_entropy`), the port on W gloo ranks spawned from
tests/torch_parallel_ranks.py, from the reference's init and on the same
global batches; a rank takes its data rank's rows and its seq rank's
positions of them (the loader's cut: zig-zag stripes for 'auto',
contiguous for 'ring' and 'ulysses'). The ranks run while the reference
computes. Each test states its tolerance."""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.config import TrainConfig as JTrainConfig
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.parallel import context as jcontext
from distributed_pytorch_tpu.parallel import sharding as jshd
from distributed_pytorch_tpu.parallel.mesh import build_mesh
from distributed_pytorch_tpu.parallel.mesh import resolve_plan as jplan
from distributed_pytorch_tpu.train.state import create_train_state as jstate
from distributed_pytorch_tpu.train.step import make_train_step as jstep
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train.loop import check_slice
from distributed_pytorch_tpu_torch.train.state import create_train_state
from distributed_pytorch_tpu_torch.train.step import make_train_step
from test_torch_parallel_train import (TINY, assert_trajectory,
                                       global_batches, steps_case, train_kw)
import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one layer beside TINY's two: the reference's compile of its ring hops
# sets this file's time
TINY1 = dict(TINY, n_layer=1)
MHA_LEARN = dict(TINY1, attn="mha", n_kv_heads=4, pos_emb="learn")
SIN = dict(TINY1, pos_emb="sin")
# MLA whose flash calls run at head size 128 + 128 = 256
MLA = dict(TINY1, attn="mla", n_embd=256, n_head=2, n_kv_heads=2,
           q_latent_dim=32, kv_latent_dim=32, rope_head_dim=128, up_dim=64)
MOE_GROUPED = dict(TINY1, moe=True, n_exp=8, n_shared=1, n_act=3,
                   moe_impl="grouped")

# name: (model, recipe, sp_size, extra train flags); world 2
CASES_W2 = {
    "sp_tiny": (TINY, "sp", 2, {}),
    "fsdp_sp_mha_learn": (MHA_LEARN, "fsdp", 2, {}),
    "zero2_sp_sin": (SIN, "zero2", 2, {}),
    "dp_sp_ulysses": (TINY1, "dp", 2, dict(attn_impl="ulysses")),
    "sp_mla": (MLA, "sp", 2, {}),
    "sp_moe_grouped": (MOE_GROUPED, "sp", 2, dict(moe_impl="grouped")),
}
# world 4: 'seq' over all four ranks, and 2 data x 2 seq
CASES_W4 = {"sp4": (TINY1, "sp", 4, {}), "sp2x2": (TINY1, "sp", 2, {})}


class _Reference:
    """The reference's `recipe` on W devices with a 'seq' axis of sp: its
    init in the port's layout now, its 5 steps in `run()`."""

    def __init__(self, mdict, recipe, sp, W, extra, seed):
        self.dp = W // sp
        self.kw = train_kw(self.dp, sp_size=sp, **extra)
        self.mc = JConfig(**mdict)
        self.jtc = JTrainConfig(**self.kw, parallelism=recipe)
        self.mesh = build_mesh(jplan(recipe, W, sp_size=sp))
        with jcontext.use_mesh(self.mesh):
            self.jmodel, self.tx, self.js, self.sh = jstate(
                self.mc, self.jtc, self.mesh)
        self.cfg = LLMConfig(**mdict)
        self.batches = global_batches(5, self.dp, mdict["vocab_size"],
                                      seed=seed)
        self.case = steps_case(mdict, self.kw, recipe, self._sd(self.js),
                               self.batches)

    def _sd(self, s):
        return params_from_jax(jax.device_get(s.params), self.cfg,
                               jax.device_get(s.moe_state))

    def run(self):
        step = jstep(self.jmodel, self.tx, self.mc, self.jtc, self.mesh,
                     self.sh)
        bsh = NamedSharding(self.mesh, jshd.batch_pspec(
            self.jtc.parallelism, self.mesh, leading_accum=True))
        js, out = self.js, []
        for x, y in self.batches:
            js, m = step(js, jax.device_put(jnp.asarray(x, jnp.int32), bsh),
                         jax.device_put(jnp.asarray(y, jnp.int32), bsh))
            out.append(dict({k: float(v) for k, v in m.items()},
                            state=self._sd(js)))
        return out


def _one_process(mdict, kw, batches):
    """The port's own one-process run from its init: (init, [per step:
    loss, grad norm, the state dict after the step])."""
    st = create_train_state(LLMConfig(**mdict),
                            TrainConfig(**kw, platform="cpu"), "cpu")
    init = {k: v.clone() for k, v in st.model.state_dict().items()}
    step = make_train_step(TrainConfig(**kw, platform="cpu"))
    out = []
    for x, y in batches:
        m = step(st, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        out.append(dict({k: float(v) for k, v in m.items()},
                        state={k: v.clone()
                               for k, v in st.model.state_dict().items()}))
    return init, out


def _ckpt_cases(tmp):
    """The trainer loop under sp 2 x 2 (straight, resumed from step_3) and
    step_3 restored under dp 4 and fsdp 4."""
    kw = dict(dataset="synthetic", data_dir=str(tmp / "data"),
              batch_size=2, total_batch_size=2 * 2 * 2 * 32,
              warmup_steps=2, platform="cpu", compute_dtype="float32",
              log_interval=1, save_stats=False, max_iters=5,
              parallelism="sp", sp_size=2, ckpt_interval=3)
    d = str(tmp / "run")
    step3 = os.path.join(d, "checkpoints", "llm_model", "step_3")
    return kw, [dict(kind="train", cfg=TINY, tc=kw, cwd=d),
                dict(kind="train", cfg=TINY,
                     tc=dict(kw, resume=True, ckpt_interval=0), cwd=d)] + [
        dict(kind="restore", cfg=TINY,
             tc=dict(kw, parallelism=r, sp_size=1), path=step3)
        for r in ("dp", "fsdp")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (reference steps, the ranks' records)} of CASES_W2 (one
    spawn of two ranks, with 'sp_pallas': sp_tiny's model asking for
    loss_impl='pallas', which the reference's gate sends to the same
    chunked sp loss as sp_tiny's, so sp_tiny's reference serves it) and
    CASES_W4 (one spawn of four, with the checkpoint cases)."""
    tmp = tmp_path_factory.mktemp("sp")
    refs = {name: _Reference(m, r, sp, 2, extra, seed=50 + i)
            for i, (name, (m, r, sp, extra)) in enumerate(CASES_W2.items())}
    pallas = dataclasses.replace(LLMConfig(**TINY), loss_impl="pallas")
    # dropout 0.1 under sp 2 against the port's own one-process run (the
    # reference's element-dropout masks are not the port's)
    drop = dict(TINY1, dropout=0.1)
    batches = global_batches(3, 1, TINY1["vocab_size"], seed=70)
    init, one = _one_process(drop, train_kw(1), batches)
    w2 = [ref.case for ref in refs.values()] + [
        dict(refs["sp_tiny"].case, cfg=dataclasses.asdict(pallas)),
        steps_case(drop, train_kw(1, sp_size=2), "sp", init, batches)]
    refs.update({name: _Reference(m, r, sp, 4, extra, seed=60 + i)
                 for i, (name, (m, r, sp, extra))
                 in enumerate(CASES_W4.items())})
    kw, ckpt_cases = _ckpt_cases(tmp)
    w4 = [refs[name].case for name in CASES_W4] + ckpt_cases
    with ThreadPoolExecutor(2) as pool:
        g2 = pool.submit(ranks.spawn, tmp / "w2", 2, w2, 300)
        g4 = pool.submit(ranks.spawn, tmp / "w4", 4, w4, 300)
        want = {name: ref.run() for name, ref in refs.items()}
        got2, got4 = g2.result(), g4.result()
    out = {name: (want[name], [g[i] for g in got2])
           for i, name in enumerate(CASES_W2)}
    out["sp_pallas"] = (want["sp_tiny"], [g[len(CASES_W2)] for g in got2])
    out["sp_dropout"] = (one, [g[len(CASES_W2) + 1] for g in got2])
    out.update({name: (want[name], [g[i] for g in got4])
                for i, name in enumerate(CASES_W4)})
    out["ckpt"] = (kw, [g[len(CASES_W4):] for g in got4])
    return out


@pytest.mark.parametrize("case", list(CASES_W2) + ["sp_pallas"]
                         + list(CASES_W4))
def test_sp_trajectory_matches_reference(runs, case):
    """5 AdamW steps, accum 2, clipping active, fp32: each rank's whole
    parameters within atol 1e-4 of the reference's same recipe after every
    step, the loss within rtol 1e-5, the grad norm within rtol 1e-4 and
    every MoE expert_bias within 1e-6. World 2 is one data rank x seq 2
    (sp on TINY with zig-zag stripes; fsdp on MHA with learned positions;
    zero2 with sinusoidal ones; dp with Ulysses; MLA through flash calls
    of head size 256; the MoE's 'grouped' dispatch; loss_impl='pallas',
    which takes the sp loss and counts it in fused_ce.DEGRADED); world 4
    is seq 4, and 2 data x 2 seq."""
    ref, got = runs[case]
    assert all(r["grad_norm"] > 0.05 for r in ref)
    assert_trajectory(ref, got, atol=1e-4)
    degraded = [g["ce_degraded"]["sequence_parallel"] for g in got]
    assert degraded == [10 if case == "sp_pallas" else 0] * len(got)
    if case == "sp_moe_grouped":
        assert not (got[0]["steps"][-1]["moe"][0]["expert_bias"] == 0).all()


def test_sp_dropout_matches_one_process(runs):
    """At dropout 0.1 (embedding, attention weights, attention output and
    MLP), 3 AdamW steps under sp 2 (zig-zag stripes) against the port's
    own one-process run from the same init and batches: the attention
    masks are drawn at global positions and the element masks are the
    whole rows' taken at a rank's positions, so every rank's parameters
    are within 1e-4, the loss within rtol 1e-5 and the grad norm within
    rtol 1e-4 of the one-process run's."""
    ref, got = runs["sp_dropout"]
    assert_trajectory(ref, got, atol=1e-4)


def test_sp_ranks_hold_the_data_shard(runs):
    """Under sp 2 x 2 every rank holds of the parameters, AdamW moments and
    gradients the bytes the reference's specs give a device of its (2, 2)
    ('data', 'seq') mesh (`params_pspecs`: sharded over 'data',
    replicated over 'seq'; the moments and gradient accumulator sharded as
    the parameters, sharding.py:38-42), exactly; at seq 2 x data 1 every
    rank holds them whole."""
    mesh = build_mesh(jplan("sp", 4, sp_size=2))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    shapes = jax.eval_shape(
        lambda r: JLLM(JConfig(**TINY1)).init({"params": r, "dropout": r},
                                              jnp.zeros((1, 8), jnp.int32)),
        jax.random.PRNGKey(0))["params"]
    specs = jax.tree_util.tree_leaves(
        jshd.params_pspecs(shapes, "sp", mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    per_device = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(shapes), specs):
        axes = [a for entry in spec if entry is not None
                for a in ((entry,) if isinstance(entry, str) else entry)]
        per_device += 4 * int(np.prod(leaf.shape)) // int(
            np.prod([sizes[a] for a in axes]))
    want = {"params": per_device, "moments": 2 * per_device,
            "grads": per_device}
    assert all(g["held"] == want for g in runs["sp2x2"][1])
    whole = 4 * sum(v.numel()
                    for v in runs["sp_tiny"][0][0]["state"].values())
    assert all(g["held"] == {"params": whole, "moments": 2 * whole,
                             "grads": whole} for g in runs["sp_tiny"][1])


def test_sp_checkpoint_resumes_and_restores(runs, tmp_path):
    """sp 2 x 2 through the trainer loop: a run of iterations 0..5 saves
    step_3 (whole tensors); a second run resumes from it and its losses,
    final parameters and AdamW moments equal the uninterrupted run's bit
    for bit. step_3 restores with equal parameters and moments under dp 4,
    under fsdp 4 and under single in this process."""
    kw, got = runs["ckpt"]
    path = os.path.join(os.path.dirname(kw["data_dir"]), "run",
                        "checkpoints", "llm_model", "step_3")
    saved = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    for rank, (straight, resumed, *restored) in enumerate(got):
        assert len(straight["train_losses"]) == 6
        assert resumed["train_losses"] == straight["train_losses"][4:]
        for k, v in straight["model"].items():
            assert torch.equal(resumed["model"][k], v), k
        for i, st in straight["optimizer"]["state"].items():
            for name, v in st.items():
                assert torch.equal(resumed["optimizer"]["state"][i][name],
                                   v), (i, name)
        for r in restored:
            assert r["step"] == saved["step"] == 4
            for k, v in saved["model"].items():
                assert torch.equal(r["model"][k], v), k
            for i, st in saved["optimizer"]["state"].items():
                for name, v in st.items():
                    assert torch.equal(r["optimizer"]["state"][i][name],
                                       v), (i, name)
        assert any("recipe=sp world=4 backend=gloo data=2 model=1 seq=2 "
                   "(zigzag)" in line
                   for line in straight["log"]) == (rank == 0)
    tc = TrainConfig(**dict(kw, parallelism="single", sp_size=1))
    single = create_train_state(LLMConfig(**TINY), tc, "cpu")
    ckpt.restore_checkpoint(path, single)
    for k, v in saved["model"].items():
        assert torch.equal(single.model.state_dict()[k], v), k


def test_torchrun_entry_point_trains_sp_on_two_gloo_ranks(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    distributed_pytorch_tpu_torch --platform cpu --parallelism fsdp
    --sp_size 2` trains 3 iterations of a tiny model: exit 0, rank 0's log
    names the recipe, the world of two, gloo, seq 2 and its zig-zag
    layout, and every iteration's loss is finite."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "distributed_pytorch_tpu_torch",
            "--platform", "cpu", "--parallelism", "fsdp", "--sp_size", "2",
            "--compute_dtype", "float32", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"), "--vocab_size", "128",
            "--block_size", "32", "--n_embd", "32", "--n_head", "4",
            "--n_kv_heads", "2", "--n_layer", "2", "--up_dim", "64",
            "--batch_size", "2", "--total_batch_size_str", "2**6",
            "--max_iters", "2", "--no-save_stats"]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert ("recipe=fsdp world=2 backend=gloo data=1 model=1 seq=2 "
            "(zigzag)") in r.stdout, r.stdout
    losses = [float(line.split("| loss")[1].split("|")[0])
              for line in r.stdout.splitlines() if line.startswith("iter ")
              and "| loss" in line]
    assert len(losses) == 3 and np.isfinite(losses).all(), r.stdout


@pytest.mark.parametrize("field,value", [
    ("parallelism", "ep"), ("parallelism", "pp"), ("ep_size", 2),
    ("pp_size", 2), ("tp_size", 2)])
def test_sp_beside_tp_ep_pp_is_refused(field, value):
    """sp runs (check_slice passes under 'sp' and under fsdp with sp_size
    2); beside a 'model' axis, ep or pp it raises NotImplementedError
    naming what is left of slice 6 and ROADMAP."""
    tc = TrainConfig(platform="cpu", parallelism="sp", sp_size=2)
    check_slice(LLMConfig(**TINY), tc)
    check_slice(LLMConfig(**TINY), dataclasses.replace(tc,
                                                       parallelism="fsdp"))
    with pytest.raises(NotImplementedError, match="rest of slice 6.*ROADMAP"):
        check_slice(LLMConfig(**TINY), dataclasses.replace(
            tc, **{field: value}))

