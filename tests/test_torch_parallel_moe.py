"""The MoE under the port's data-parallel recipes against the reference
package's same recipe at W=2, on the CPU (the harness of
test_torch_parallel_train.py): the load statistics, the aux-free bias and
the 'scatter' drops follow the global batch, as the reference's do under
pjit; then the anomaly guard, whose decision every rank takes together.
Each test states its tolerance."""

import pytest

from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.train.state import create_train_state
from test_torch_parallel_train import (assert_trajectory, global_batches,
                                       reference_run, steps_case, train_kw)
import torch_parallel_ranks as ranks

MOE = dict(vocab_size=97, block_size=32, n_embd=32, n_head=4, n_kv_heads=2,
           attn="gqa", n_layer=2, up_dim=48, non_linearity="swiglu",
           pos_emb="rope", moe=True, n_exp=6, n_shared=1, n_act=3,
           gamma=1e-2)
DENSE = dict(vocab_size=97, block_size=32, n_embd=64, n_head=4, n_kv_heads=2,
             attn="gqa", n_layer=2, up_dim=96, non_linearity="swiglu",
             pos_emb="rope")
# (model, recipe): 'scatter' at capacity factor 0.5 drops assignments
MOE_CASES = {
    "grouped_dp": (dict(MOE, moe_impl="grouped"), "dp"),
    "grouped_fsdp": (dict(MOE, moe_impl="grouped"), "fsdp"),
    "scatter_dp": (dict(MOE, moe_impl="scatter", capacity_factor=0.5), "dp"),
}


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    refs, cases = {}, []
    for name, (mdict, recipe) in MOE_CASES.items():
        kw = train_kw(2, grad_clip=1.0, moe_impl=mdict["moe_impl"])
        batches = global_batches(5, 2, 97, seed=len(name))
        init, ref = reference_run(mdict, kw, recipe, 2, batches)
        refs[name] = ref
        cases.append(steps_case(mdict, kw, recipe, init, batches))
    got = ranks.spawn(tmp_path_factory.mktemp("moe"), 2, cases)
    return {name: (refs[name], [g[i] for g in got])
            for i, name in enumerate(MOE_CASES)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_under_recipe_matches_reference(moe_runs, case):
    """5 AdamW steps at W=2, accum 2 (gamma 1e-2, so the bias moves at
    every micro-step): after every step each rank's loss within rtol 1e-5,
    parameters within 1e-4, and every layer's expert_bias and
    dropped_frac within 1e-6 of the reference's same recipe, and the
    step's moe_dropped_frac equal to the reference's: above 0 for
    'scatter' at capacity factor 0.5, which drops by global position with
    the capacity of the global batch; 0 for 'grouped'."""
    ref, got = moe_runs[case]
    assert_trajectory(ref, got, atol=1e-4)
    for rank, g in enumerate(got):
        for k, (r, s) in enumerate(zip(ref, g["steps"])):
            assert s["moe_dropped_frac"] == r["moe_dropped_frac"], \
                (rank, k, s["moe_dropped_frac"], r["moe_dropped_frac"])
    drops = [r["moe_dropped_frac"] for r in ref]
    if case.startswith("scatter"):
        assert min(drops) > 0.0
    else:
        assert max(drops) == 0.0
    bias0 = got[0]["steps"][0]["moe"][0]["expert_bias"]
    assert not (bias0 == 0).all()


def test_anomaly_skip_is_taken_by_every_rank(tmp_path):
    """anomaly='skip' under dp at W=2 with rank 1 alone NaN-bombing step
    1 (its loss and gradients, after the all-reduce): the all-reduced
    loss is NaN on both ranks, so both flag step 1 nonfinite and withhold
    its update (each rank's parameters after step 1 equal its own after
    step 0, exactly), and both apply steps 0 and 2; the two ranks end
    equal."""
    kw = train_kw(2, anomaly="skip")
    batches = global_batches(3, 2, 97, seed=6)
    init = create_train_state(LLMConfig(**DENSE),
                              TrainConfig(**kw, platform="cpu"),
                              "cpu").model.state_dict()
    case = steps_case(DENSE, kw, "dp", init, batches)
    case["poison"] = (1, 1)
    got = ranks.spawn(tmp_path, 2, [case])
    for g in got:
        steps = g[0]["steps"]
        assert [s["update_skipped"] for s in steps] == [0.0, 1.0, 0.0]
        assert [s["nonfinite"] for s in steps] == [0.0, 1.0, 0.0]
        for name, p in steps[0]["params"].items():
            assert (steps[1]["params"][name] == p).all(), name
            if name.endswith("weight"):
                assert not (steps[2]["params"][name] == p).all(), name
    for name, p in got[0][0]["steps"][2]["params"].items():
        assert (got[1][0]["steps"][2]["params"][name] == p).all(), name
