"""The port's data-parallel layer on the CPU: axis plans and the loader's
rank rows against the reference package's, the bytes each rank holds
under each recipe (the counterparts of the reference's
`test_fsdp_params_actually_sharded` and
`test_zero1_opt_state_sharded_params_replicated`), the refusals of what
slice 6 still lacks, the world's set-up, and the trainer loop over gloo
ranks spawned from tests/torch_parallel_ranks.py: a checkpoint written
under fsdp resumes bit for bit and restores under other recipes, a SIGTERM
to one rank stops both at the same step, and the torchrun entry point
trains. Each test states its tolerance."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.data.loader import DataLoader as JLoader
from distributed_pytorch_tpu.parallel import mesh as jmesh
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.data.loader import (DataLoader,
                                                       make_synthetic_bin)
from distributed_pytorch_tpu_torch.models.gpt import LLM
from distributed_pytorch_tpu_torch.parallel import context, mesh, sharding
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train.loop import check_slice
from distributed_pytorch_tpu_torch.train.state import create_train_state

import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=97, block_size=32, n_embd=64, n_head=4, n_kv_heads=2,
            attn="gqa", n_layer=2, up_dim=96, non_linearity="swiglu",
            pos_emb="rope")
RECIPES = ("single", "dp", "zero1", "zero2", "fsdp", "tp", "fsdp_tp", "ep",
           "sp", "pp")


# ---------------------------------------------------------------------------
# plans and the loader against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", RECIPES)
def test_resolve_plan_matches_reference(recipe):
    """Every (device count, axis sizes) of a grid resolves to the
    reference's MeshPlan, field for field, or fails as the reference's
    does (exact)."""
    for n in (1, 2, 4, 8, 16):
        for tp in (1, 2):
            for ep in (1, 2):
                for sp in (1, 2):
                    for dp in (-1, 1, 2, 4):
                        kw = dict(tp_size=tp, ep_size=ep, sp_size=sp,
                                  dp_size=dp)
                        try:
                            want = dataclasses.astuple(
                                jmesh.resolve_plan(recipe, n, **kw))
                        except AssertionError:
                            with pytest.raises(AssertionError):
                                mesh.resolve_plan(recipe, n, **kw)
                            continue
                        got = mesh.resolve_plan(recipe, n, **kw)
                        assert dataclasses.astuple(got) == want, (n, kw)
                        assert got.n_devices == jmesh.resolve_plan(
                            recipe, n, **kw).n_devices


def test_rung_down_matches_reference():
    assert [mesh.rung_down(n) for n in range(2, 70)] == \
        [jmesh.rung_down(n) for n in range(2, 70)]
    with pytest.raises(AssertionError):
        mesh.rung_down(1)


@pytest.mark.parametrize("W", [2, 4])
def test_rank_rows_make_the_reference_global_batch(tmp_path, W):
    """The W ranks' batches, concatenated in rank order along the batch
    axis, equal the reference loader's global batch (B W rows a
    micro-step) at every micro-step of steps 0..3 (exact)."""
    path = make_synthetic_bin(str(tmp_path / "train.bin"), n_tokens=40_000,
                              vocab_size=300)
    B, A, T = 3, 2, 16
    ref = JLoader(path, B * W, T, grad_accum=A, seed=7, backend="numpy")
    got = [DataLoader(path, B, T, grad_accum=A, seed=7, rank=r, world=W)
           for r in range(W)]
    for step in range(4):
        rx, ry = (np.asarray(t) for t in ref.next_batch(step=step))
        xs = [g.next_batch(step=step) for g in got]
        np.testing.assert_array_equal(
            torch.cat([x for x, _ in xs], dim=1).numpy(), rx)
        np.testing.assert_array_equal(
            torch.cat([y for _, y in xs], dim=1).numpy(), ry)


# ---------------------------------------------------------------------------
# what each rank holds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def held(tmp_path_factory):
    """One AdamW step of every recipe at W=2 (the bytes each rank holds
    after it) and Adafactor under zero1, in one spawn."""
    kw = dict(batch_size=2, total_batch_size=2 * 2 * 2 * 32, max_iters=4,
              warmup_steps=2, compute_dtype="float32", platform="cpu")
    st = create_train_state(LLMConfig(**TINY), TrainConfig(**kw), "cpu")
    init = st.model.state_dict()
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, 97, (2, 4, 32)),
                rng.integers(0, 97, (2, 4, 32)))]
    cases = [dict(kind="steps", cfg=TINY, tc=dict(kw, parallelism=r),
                  init=init, batches=batches)
             for r in ("dp", "zero1", "zero2", "fsdp")]
    cases.append(dict(kind="raises", cfg=TINY,
                      tc=dict(kw, parallelism="zero1",
                              optimizer="adafactor")))
    got = ranks.spawn(tmp_path_factory.mktemp("held"), 2, cases)
    whole = {"params": 0, "moments": 0, "grads": 0}
    for p in st.model.parameters():
        n = p.numel() * p.element_size()
        whole["params"] += n
        whole["moments"] += 2 * n           # AdamW's exp_avg, exp_avg_sq
        whole["grads"] += n
    return whole, got


@pytest.mark.parametrize("recipe", ["dp", "zero1", "zero2", "fsdp"])
def test_each_rank_holds_its_recipes_share(held, recipe):
    """At W=2, of parameters, AdamW moments and gradients each rank holds
    the whole where the reference's tables replicate (parallel/sharding.py
    `holds`) and half where they shard: at most 1/2 + 2% (padding and
    uneven dim-0 splits), the two ranks' shares adding up to at least the
    whole."""
    whole, got = held
    i = ["dp", "zero1", "zero2", "fsdp"].index(recipe)
    per_rank = [g[i]["held"] for g in got]
    for cls, sharded in sharding.holds(recipe).items():
        for h in per_rank:
            if sharded:
                assert h[cls] <= 0.52 * whole[cls], (cls, h, whole)
            else:
                assert h[cls] == whole[cls], (cls, h, whole)
        if sharded:
            assert sum(h[cls] for h in per_rank) >= whole[cls]
    if recipe == "fsdp":
        assert all(h["params"] < whole["params"] for h in per_rank)
    if recipe == "zero1":
        assert all(h["moments"] < whole["moments"]
                   and h["params"] == whole["params"] for h in per_rank)


@pytest.mark.parametrize("recipe", ["zero1", "zero2", "fsdp"])
def test_adafactor_under_a_sharded_recipe_raises(held, recipe):
    """Adafactor's whole-tensor statistics: refused under the recipes
    that shard the moments, by the loop's check and by the wrapper on the
    ranks (zero1, W=2), naming slice 6; it runs under dp."""
    tc = TrainConfig(platform="cpu", optimizer="adafactor",
                     parallelism=recipe)
    with pytest.raises(NotImplementedError, match="slice 6"):
        check_slice(LLMConfig(**TINY), tc)
    check_slice(LLMConfig(**TINY), dataclasses.replace(tc, parallelism="dp"))
    for g in held[1]:
        assert "slice 6" in g[-1]["raised"]


@pytest.mark.parametrize("field,value", [
    ("parallelism", "tp"), ("parallelism", "fsdp_tp"),
    ("parallelism", "ep"), ("parallelism", "sp"), ("parallelism", "pp"),
    ("tp_size", 2), ("ep_size", 2), ("sp_size", 2), ("pp_size", 2),
    ("offload", "on"), ("overlap", "on")])
def test_rest_of_slice_6_is_refused(field, value):
    """What the recipes of this slice do not cover raises
    NotImplementedError, naming what is left of slice 6. tp and fsdp_tp
    (and fsdp with tp_size 2, which is fsdp_tp) run since tensor
    parallelism came (tests/test_torch_parallel_tp.py), sp (and fsdp with
    sp_size 2) since sequence parallelism came
    (tests/test_torch_parallel_sp.py), ep (and fsdp with ep_size 2) since
    expert parallelism came (tests/test_torch_parallel_ep.py): beside
    pp_size 2 they are refused so; pp since pipeline parallelism came
    (tests/test_torch_parallel_pp.py): beside sp_size 2 it is refused
    so."""
    tc = dataclasses.replace(TrainConfig(platform="cpu", parallelism="fsdp"),
                             **{field: value})
    if (field, value) in (("parallelism", "tp"), ("parallelism", "fsdp_tp"),
                          ("tp_size", 2), ("parallelism", "sp"),
                          ("sp_size", 2), ("parallelism", "ep"),
                          ("ep_size", 2), ("parallelism", "pp")):
        check_slice(LLMConfig(**TINY), tc)
        tc = dataclasses.replace(
            tc, **({"sp_size": 2} if value == "pp" else {"pp_size": 2}))
    with pytest.raises(NotImplementedError,
                       match="rest of slice 6: the compositions"):
        check_slice(LLMConfig(**TINY), tc)


def test_world_without_torchrun_is_one_rank(monkeypatch):
    """No torchrun environment: 'single' makes no group, a data-parallel
    recipe a gloo group of one rank (published collectives run), and
    `close_world` tears it down; a dp_size other than the world's, and
    'single' under a torchrun world of two, raise."""
    for k in mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    w = mesh.init_world("single", "cpu")
    assert not w.distributed and w.size == 1
    w = mesh.init_world("dp", "cpu")
    try:
        assert (w.backend, w.size, w.rank, w.owns_group) == \
            ("gloo", 1, 0, True)
        with context.use_world(w):
            assert context.data_size() == 1
            assert float(context.all_reduce_sum(torch.ones(()))) == 1.0
            assert context.all_gather_stack(torch.arange(3.0)).shape == \
                (1, 3)
    finally:
        mesh.close_world(w)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="dp_size"):
        mesh.init_world("dp", "cpu", dp_size=2)
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="single"):
        mesh.init_world("single", "cpu")


# ---------------------------------------------------------------------------
# the loop over spawned ranks
# ---------------------------------------------------------------------------

def _loop_kw(tmp, **kw):
    base = dict(dataset="synthetic", data_dir=str(tmp / "data"),
                batch_size=2, total_batch_size=2 * 2 * 2 * 32,
                warmup_steps=2, platform="cpu", compute_dtype="float32",
                log_interval=1, save_stats=False, max_iters=5,
                parallelism="fsdp")
    base.update(kw)
    return base


def test_fsdp_checkpoint_resumes_bit_for_bit_and_restores_anywhere(tmp_path):
    """fsdp at W=2 through the trainer loop: an uninterrupted run of
    iterations 0..5 saves `step_3` on the way (ckpt_interval 3); a second
    run resumes from it. Its losses equal the uninterrupted run's
    iterations 4 and 5 and its final parameters and AdamW moments equal
    the uninterrupted run's, bit for bit (fp32, CPU). The checkpoint then
    restores, with equal parameters and moments, under dp and zero2 at
    W=2 and under single in this process, and `restore_for_inference`
    reads its weights."""
    d = tmp_path / "run"
    kw = _loop_kw(tmp_path, ckpt_interval=3)
    step3 = str(d / "checkpoints" / "llm_model" / "step_3")
    got = ranks.spawn(tmp_path / "ranks", 2, [
        dict(kind="train", cfg=TINY, tc=kw, cwd=str(d)),
        dict(kind="train", cfg=TINY, tc=dict(kw, resume=True, ckpt_interval=0),
             cwd=str(d)),
        dict(kind="restore", cfg=TINY, tc=dict(kw, parallelism="dp"),
             path=step3),
        dict(kind="restore", cfg=TINY, tc=dict(kw, parallelism="zero2"),
             path=step3)])
    payload = torch.load(os.path.join(step3, "state.pt"), weights_only=True)
    for straight, resumed, dp, z2 in got:
        assert len(straight["train_losses"]) == 6
        assert resumed["train_losses"] == straight["train_losses"][4:]
        assert resumed["step"] == straight["step"] == 6
        for k, v in straight["model"].items():
            assert torch.equal(resumed["model"][k], v), k
        for i, st in straight["optimizer"]["state"].items():
            for name, v in st.items():
                assert torch.equal(resumed["optimizer"]["state"][i][name],
                                   v), (i, name)
        for r in (dp, z2):
            assert r["step"] == payload["step"] == 4
            for k, v in payload["model"].items():
                assert torch.equal(r["model"][k], v), k
            for i, st in payload["optimizer"]["state"].items():
                for name, v in st.items():
                    assert torch.equal(r["optimizer"]["state"][i][name],
                                       v), (i, name)
        assert any("recipe=fsdp world=2 backend=gloo" in line
                   for line in straight["log"]) == (straight is got[0][0])
    tc = TrainConfig(**dict(kw, parallelism="single"))
    single = create_train_state(LLMConfig(**TINY), tc, "cpu")
    ckpt.restore_checkpoint(step3, single)
    for k, v in payload["model"].items():
        assert torch.equal(single.model.state_dict()[k], v), k
    assert single.step == 4
    model = ckpt.restore_for_inference(step3, LLM(LLMConfig(**TINY),
                                                  device="cpu"))
    for k, v in payload["model"].items():
        assert torch.equal(model.state_dict()[k], v), k


def test_sigterm_to_one_rank_stops_both_at_the_same_step(tmp_path):
    """dp at W=2, log_interval 1: rank 1 alone receives SIGTERM while it
    prefetches step 2. The flag is a max over the ranks at the next log
    boundary, so both ranks stop at the top of iteration 2 with the same
    state (step 2), one verified `step_2` is written (by rank 0), and
    neither writes the final checkpoint."""
    d = tmp_path / "run"
    kw = _loop_kw(tmp_path, parallelism="dp", save_model=True)
    got = ranks.spawn(tmp_path / "ranks", 2, [
        dict(kind="train", cfg=TINY, tc=kw, cwd=str(d), sigterm=(1, 2))])
    (a,), (b,) = got
    assert a["stopped_early"] and b["stopped_early"]
    assert a["step"] == b["step"] == 2
    assert a["train_losses"] == b["train_losses"] and \
        len(a["train_losses"]) == 2
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    root = d / "checkpoints" / "llm_model"
    assert sorted(os.listdir(root)) == ["step_2"]
    assert ckpt.verify_manifest(str(root / "step_2")) == []
    assert any("a peer's SIGTERM" in line for line in a["log"])


def test_torchrun_entry_point_trains_fsdp_on_two_gloo_ranks(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2
    -m distributed_pytorch_tpu_torch --platform cpu --parallelism fsdp`
    trains 3 iterations of a tiny model: exit 0, and rank 0's log names
    the recipe, the world of two and gloo, and logs every iteration with
    a finite loss."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "distributed_pytorch_tpu_torch",
            "--platform", "cpu", "--parallelism", "fsdp",
            "--compute_dtype", "float32", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"), "--vocab_size", "97",
            "--block_size", "32", "--n_embd", "64", "--n_head", "4",
            "--n_kv_heads", "2", "--n_layer", "2", "--up_dim", "96",
            "--batch_size", "2", "--total_batch_size_str", "2**8",
            "--max_iters", "2", "--no-save_stats"]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "recipe=fsdp world=2 backend=gloo" in r.stdout, r.stdout
    losses = [float(line.split("| loss")[1].split("|")[0])
              for line in r.stdout.splitlines() if line.startswith("iter ")
              and "| loss" in line]
    assert len(losses) == 3 and np.isfinite(losses).all(), r.stdout
