"""The port's data-parallel recipes against the reference package's same
recipe on the same number of devices, on the CPU: the reference runs on W
of the 8 virtual CPU devices (`build_mesh(resolve_plan(recipe, W))`), the
port on W gloo ranks spawned from tests/torch_parallel_ranks.py (which
imports no JAX), from the reference's init converted to the port's
layout, on the same global batches; rank r takes rows r B .. r B + B - 1
of each micro-step. Every rank's whole parameters are held after every
step. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.config import TrainConfig as JTrainConfig
from distributed_pytorch_tpu.ops import fused_ce as jce
from distributed_pytorch_tpu.parallel import context as jcontext
from distributed_pytorch_tpu.parallel import sharding as jshd
from distributed_pytorch_tpu.parallel.mesh import build_mesh
from distributed_pytorch_tpu.parallel.mesh import resolve_plan as jplan
from distributed_pytorch_tpu.train.state import create_train_state as jstate
from distributed_pytorch_tpu.train.step import make_train_step as jstep
from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax

import torch_parallel_ranks as ranks

TINY = dict(vocab_size=97, block_size=32, n_embd=64, n_head=4, n_kv_heads=2,
            attn="gqa", n_layer=2, up_dim=96, non_linearity="swiglu",
            pos_emb="rope")
# n_embd a multiple of 128: the fused CE's gate
WIDE = dict(TINY, vocab_size=160, n_embd=128, up_dim=256)
B, A = 2, 2     # rows per rank, micro-steps


def train_kw(W, **kw):
    """5-step AdamW settings: accum 2 at B rows per rank, clipping active
    (grad_clip 0.05 under a grad norm near 1), fp32, dropout 0."""
    return dict(dict(batch_size=B, total_batch_size=B * W * A * 32,
                     max_iters=10, warmup_steps=2, learning_rate=1e-3,
                     grad_clip=0.05, compute_dtype="float32", seed=5), **kw)


def global_batches(n, W, V, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, (A, B * W, 32)),
             rng.integers(0, V, (A, B * W, 32))) for _ in range(n)]


def reference_run(mdict, kw, recipe, W, batches):
    """The reference's `recipe` on W devices (a 'model' axis of
    kw['tp_size'] where given): (init state dict in the port's layout, [per step: loss, grad_norm, moe_dropped_frac, the
    state dict after the step])."""
    mc, jtc = JConfig(**mdict), JTrainConfig(**kw, parallelism=recipe)
    mesh = build_mesh(jplan(recipe, W, tp_size=kw.get("tp_size", 1)))
    jmodel, tx, js, sh = jstate(mc, jtc, mesh)
    cfg = LLMConfig(**mdict)

    def sd(s):
        return params_from_jax(jax.device_get(s.params), cfg,
                               jax.device_get(s.moe_state))

    init = sd(js)
    step = jstep(jmodel, tx, mc, jtc, mesh, sh)
    bsh = NamedSharding(mesh, jshd.batch_pspec(recipe, mesh,
                                               leading_accum=True))
    out = []
    for x, y in batches:
        js, m = step(js, jax.device_put(jnp.asarray(x, jnp.int32), bsh),
                     jax.device_put(jnp.asarray(y, jnp.int32), bsh))
        rec = {k: float(v) for k, v in m.items()}
        rec["state"] = sd(js)
        out.append(rec)
    return init, out


def steps_case(mdict, kw, recipe, init, batches):
    return dict(kind="steps", cfg=mdict,
                tc=dict(kw, parallelism=recipe, platform="cpu"),
                init=init, batches=batches)


def assert_trajectory(ref, got, atol, loss_rtol=1e-5, norm_rtol=1e-4,
                      buffer_atol=1e-6, lion_lr=None):
    """Every rank's records against the reference's, step by step. With
    `lion_lr`, an entry farther than atol must be a Lion sign tie: a
    whole number of updates lr apart (within 1e-6), at most 4 in the
    model, since sign((1 - b1) g + b1 m) of an argument within float noise
    of 0 can come out the other way in the other framework."""
    for rank, steps in enumerate(got):
        assert len(steps["steps"]) == len(ref)
        for k, (r, g) in enumerate(zip(ref, steps["steps"])):
            where = f"rank {rank} step {k}"
            np.testing.assert_allclose(g["loss"], r["loss"], rtol=loss_rtol,
                                       err_msg=where)
            np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                       rtol=norm_rtol, err_msg=where)
            ties = 0
            for name, want in r["state"].items():
                buf = name.endswith(("expert_bias", "dropped_frac"))
                have, want = g["params"][name].numpy(), want.numpy()
                if lion_lr is not None and not buf:
                    d = np.abs(have - want)
                    far = d > atol
                    q = np.round(d[far] / lion_lr)
                    assert (q >= 1).all() and np.allclose(
                        d[far], q * lion_lr, rtol=0, atol=1e-6), \
                        f"{where}: {name}: {d[far]}"
                    ties += int(far.sum())
                    continue
                np.testing.assert_allclose(
                    have, want, atol=buffer_atol if buf else atol, rtol=0,
                    err_msg=f"{where}: {name}")
            assert ties <= 4, f"{where}: {ties} Lion sign ties"


# the port's side of every case at W=2 runs in one spawn of two ranks
CASES_W2 = {
    "dp": (TINY, {}), "zero1": (TINY, {}), "zero2": (TINY, {}),
    "fsdp": (TINY, {}),
    "lion_zero2": (TINY, dict(optimizer="lion", learning_rate=1e-4,
                              weight_decay=10.0)),
    "lion_fsdp": (TINY, dict(optimizer="lion", learning_rate=1e-4,
                             weight_decay=10.0)),
}
N_STEPS = {"lion_zero2": 3, "lion_fsdp": 3}


def _recipe(name):
    return name.split("_")[-1]


@pytest.fixture(scope="module")
def w2_runs(tmp_path_factory):
    """{case: (reference steps, the ranks' records)} for CASES_W2."""
    refs, cases = {}, []
    for name, (mdict, extra) in CASES_W2.items():
        kw = train_kw(2, **extra)
        batches = global_batches(N_STEPS.get(name, 5), 2,
                                 mdict["vocab_size"], seed=len(name))
        init, ref = reference_run(mdict, kw, _recipe(name), 2, batches)
        refs[name] = ref
        cases.append(steps_case(mdict, kw, _recipe(name), init, batches))
    got = ranks.spawn(tmp_path_factory.mktemp("w2"), 2, cases)
    return {name: (refs[name], [g[i] for g in got])
            for i, name in enumerate(CASES_W2)}


@pytest.mark.parametrize("recipe", ["dp", "zero1", "zero2", "fsdp"])
def test_recipe_trajectory_matches_reference_w2(w2_runs, recipe):
    """5 AdamW steps at W=2, accum 2, clipping active (the reference's
    grad norm above the clip), fp32: each rank's parameters within atol
    1e-4 of the reference's same recipe after every step, the loss within
    rtol 1e-5 and the grad norm within rtol 1e-4 (the limits of the
    one-device trajectory test in test_torch_train.py)."""
    ref, got = w2_runs[recipe]
    assert all(r["grad_norm"] > 0.05 for r in ref)
    assert_trajectory(ref, got, atol=1e-4)


def test_fsdp_trajectory_matches_reference_w4(tmp_path):
    """fsdp at W=4 (the embedding's 97 rows split 25/25/25/22 on the
    port's side): the same 5 steps and limits as at W=2."""
    kw = train_kw(4)
    batches = global_batches(5, 4, 97, seed=4)
    init, ref = reference_run(TINY, kw, "fsdp", 4, batches)
    got = ranks.spawn(tmp_path, 4,
                      [steps_case(TINY, kw, "fsdp", init, batches)])
    assert_trajectory(ref, [g[0] for g in got], atol=1e-4)


@pytest.mark.parametrize("recipe", ["zero2", "fsdp"])
def test_lion_under_sharded_recipes_matches_reference(w2_runs, recipe):
    """3 Lion steps (lr 1e-4, weight decay 10, so lr x wd = 1e-3 shows)
    under zero2 (the moments in 1/W pieces) and fsdp at W=2: every
    parameter within 1e-5 of the reference's same recipe after every
    step, but for Lion sign ties (`assert_trajectory`). These batches
    have one: an embedding entry whose first update takes the other sign
    in the two frameworks, under dp, zero2 and fsdp alike (the tie does
    not come from the sharding)."""
    ref, got = w2_runs[f"lion_{recipe}"]
    assert_trajectory(ref, got, atol=1e-5, lion_lr=1e-4)


def test_pallas_loss_under_fsdp_matches_reference(tmp_path):
    """The fused CE at W=2. (1) The loss function: each rank runs the
    port's `pallas_cross_entropy` (its plain versions on the CPU) over
    its rows, with ignored targets spread unevenly over the ranks, against
    the reference's shard_map face over a 2-device 'data' mesh in
    interpret mode: the loss averaged over the ranks and dW (within 1e-5),
    and each rank's dx times W (within 1e-6; the reference's dx is the
    global mean's). (2) The trainer: 3 fsdp steps at W=2 of a model with
    loss_impl='pallas' (n_embd 128) against the reference's fsdp run,
    whose CPU model takes its chunked loss: every parameter within 1e-4
    after every step, loss rtol 1e-5."""
    rng = np.random.default_rng(8)
    n, T, C, V = 4, 32, 128, 160
    x = rng.standard_normal((n, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((V, C))).astype(np.float32)
    t = rng.integers(0, V, (n, T))
    t[0, :13] = -1                      # rank 0's rows: 13 ignored
    t[3, 5:7] = -1                      # rank 1's rows: 2 ignored

    mesh = build_mesh(jplan("fsdp", 2))

    def f(x, w):
        with jcontext.use_mesh(mesh):
            return jce.pallas_cross_entropy(x, w, jnp.asarray(t),
                                            interpret=True)

    loss, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))

    kw = train_kw(2)
    mdict = dict(WIDE, loss_impl="pallas")
    batches = global_batches(3, 2, 160, seed=9)
    init, ref = reference_run(WIDE, kw, "fsdp", 2, batches)
    got = ranks.spawn(tmp_path, 2, [
        dict(kind="ce", x=x, w=w, t=t),
        steps_case(mdict, kw, "fsdp", init, batches)])

    for rank, (ce, _) in enumerate(got):
        assert ce["plain"] == {"fused_ce_fwd": 1, "fused_ce_bwd_dx": 1,
                               "fused_ce_bwd_dw": 1}
        np.testing.assert_allclose(ce["loss"], float(loss), rtol=1e-6)
        np.testing.assert_allclose(ce["dw"].numpy(), np.asarray(gw),
                                   atol=1e-5, rtol=0)
        rows = slice(rank * 2, rank * 2 + 2)
        np.testing.assert_allclose(ce["dx"].numpy() / 2,
                                   np.asarray(gx)[rows], atol=1e-6, rtol=0)
    assert_trajectory(ref, [g[1] for g in got], atol=1e-4)
