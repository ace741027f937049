"""Tensor parallelism in the port ('tp', 'fsdp_tp') against the reference
package on the CPU: each parameter's 'model' axis and per-rank shape
against the reference's `spec_for_param`, the per-rank layouts of the
fused tensors, the vocab-parallel loss, the flash kernels' plain versions
over a slice of the heads, and the trainer's trajectory against the
reference's same recipe on as many virtual CPU devices (the harness of
test_torch_parallel_train.py: the port on gloo ranks spawned from
tests/torch_parallel_ranks.py, the model ranks of one data rank on the
same rows). The models are the reference's own test configurations
(tests/test_parallel.py). Each test states its tolerance."""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.config import flagship_gpt124m as jflagship
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.parallel import sharding as jshd
from distributed_pytorch_tpu.parallel.mesh import build_mesh
from distributed_pytorch_tpu.parallel.mesh import resolve_plan as jplan
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.models.gpt import LLM
from distributed_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_pytorch_tpu_torch.ops.losses import fused_cross_entropy
from distributed_pytorch_tpu_torch.parallel import sharding, tensor
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train.loop import check_slice
from distributed_pytorch_tpu_torch.train.state import create_train_state
from distributed_pytorch_tpu_torch.train.step import make_train_step
from test_torch_parallel_train import (assert_trajectory, global_batches,
                                       reference_run, steps_case, train_kw)
import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_parallel.py:19-47
TINY = dict(vocab_size=128, block_size=32, n_embd=32, n_head=4,
            n_kv_heads=2, n_layer=2, up_dim=64)
TINY_CHUNKED = dict(TINY, loss_chunk=8)
MOE_GROUPED = dict(TINY, moe=True, n_exp=8, n_shared=1, n_act=3,
                   moe_impl="grouped")
MLA = dict(vocab_size=128, block_size=32, n_embd=32, n_head=4,
           n_kv_heads=4, n_layer=2, up_dim=64, attn="mla",
           q_latent_dim=8, kv_latent_dim=8, rope_head_dim=4)


# ---------------------------------------------------------------------------
# (a) the 'model' axis of every parameter against the reference's specs
# ---------------------------------------------------------------------------

def _flagship(**kw):
    return dataclasses.asdict(jflagship(**kw))


# full-width configurations: the flagship, the default LLMConfig, the
# flagship with MLA, and bench.py's BENCH_MOE ('grouped')
FULL = {"flagship": _flagship(), "default": {},
        "flagship_mla": _flagship(attn="mla"),
        "bench_moe": _flagship(moe=True, n_exp=8, n_shared=1, n_act=3,
                               up_dim=1024, moe_impl="grouped")}


@functools.lru_cache(maxsize=None)
def _reference_shapes(name):
    """{flax path: shape} of the reference's params (traced, not built)."""
    mc = JConfig(**FULL[name])
    dummy = jnp.zeros((1, 16), jnp.int32)
    shapes = jax.eval_shape(
        lambda r: JLLM(mc).init({"params": r, "dropout": r}, dummy, dummy),
        jax.random.PRNGKey(0))["params"]
    return shapes


def _port_name(path):
    """(the port's state-dict key, whether the port stores it transposed)
    of a flax param path."""
    if path[0] == "tkn_emb":
        return "tkn_emb.weight", False
    if path[0] in ("ln_f", "pos_emb"):
        return ".".join(path), False
    i = path[0].split("_")[1]
    if path[1] == "attn" and path[2] in ("c_attn", "c_proj"):
        leaf = "weight" if path[3] == "kernel" else "bias"
        return f"blocks.{i}.attn.{path[2]}.{leaf}", leaf == "weight"
    return f"blocks.{i}." + ".".join(path[1:]), False


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(FULL))
def test_tp_axes_and_shapes_match_reference(name, tp):
    """At full width, every parameter's 'model' axis (`spec_for_param`)
    and its per-rank shape (parallel/tensor.py's cut) equal the
    reference's `params_pspecs` under 'tp' on a 'model' axis of tp
    virtual devices, axis for axis with nn.Linear's weights transposed
    (exact)."""
    cfg = LLMConfig(**FULL[name])
    mesh = build_mesh(jplan("tp", tp, tp_size=tp))
    shapes = _reference_shapes(name)
    specs = jshd.params_pspecs(shapes, "tp", mesh)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_of = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    n_cut = 0
    for path, leaf in flat:
        keys = tuple(p.key for p in path)
        port, transposed = _port_name(keys)
        ref = tuple(spec_of[path]) + (None,) * (len(leaf.shape)
                                                - len(spec_of[path]))
        shape = tuple(leaf.shape)
        if transposed:
            ref, shape = ref[::-1], shape[::-1]
        assert sharding.spec_for_param(port, shape, tp) == ref, (port, ref)
        cut = tensor.segments(port, shape, cfg, tp)
        assert (cut is not None) == ("model" in ref), port
        want = tuple(d // tp if a == "model" else d
                     for d, a in zip(shape, ref))
        for r in range(tp):
            piece = tensor.split(torch.empty(shape, device="meta"), cut, r,
                                 tp) if cut else torch.empty(shape)
            assert tuple(piece.shape) == want, (port, r)
        n_cut += cut is not None
    assert n_cut >= 1 + 4 * cfg.n_layer


# ---------------------------------------------------------------------------
# (b) the per-rank layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mdict", [TINY, MOE_GROUPED, MLA],
                         ids=["tiny", "moe", "mla"])
def test_per_rank_layouts_round_trip(mdict, tp):
    """whole -> every rank's pieces -> whole gives the state dict back bit
    for bit; `shard_model`'s parameters are `split_state`'s pieces; a
    rank's fused qkv holds [q_r | k_r | v_r], its query heads r nh/tp ..
    and kv heads r nkv/tp .., and a gated up projection [gate_r | up_r]
    (exact)."""
    cfg = LLMConfig(**dict(mdict, n_kv_heads=4))
    model = LLM(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(3))
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    pieces = [tensor.split_state(whole, cfg, r, tp) for r in range(tp)]
    back = tensor.join_state(pieces, cfg)
    assert back.keys() == whole.keys()
    for k, v in whole.items():
        assert torch.equal(back[k], v), k
    tensor.shard_model(model, 1, tp)
    for k, v in model.state_dict().items():
        assert torch.equal(v, pieces[1][k]), k
    hs, C = cfg.head_size, cfg.n_embd
    if cfg.attn != "mla":
        w, p = whole["blocks.0.attn.c_attn.weight"], \
            pieces[1]["blocks.0.attn.c_attn.weight"]
        nq, nk = cfg.n_head // tp * hs, cfg.n_kv_heads // tp * hs
        kv = cfg.n_kv_heads * hs
        assert torch.equal(p[:nq], w[nq:2 * nq])
        assert torch.equal(p[nq:nq + nk], w[C + nk:C + 2 * nk])
        assert torch.equal(p[nq + nk:], w[C + kv + nk:C + kv + 2 * nk])
    key = "blocks.0.moe.experts_fc" if cfg.moe else "blocks.0.mlp.c_fc"
    w, p = whole[key], pieces[1][key]
    u = cfg.up_dim // tp
    assert torch.equal(p[..., :u], w[..., u:2 * u])
    assert torch.equal(p[..., u:], w[..., cfg.up_dim + u:cfg.up_dim + 2 * u])


# ---------------------------------------------------------------------------
# (d) the flash kernels' plain versions over a slice of the heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nkv", [4, 2])
def test_flash_plain_versions_with_a_head_offset(nkv):
    """At dropout 0.2, the keep-mask of heads h0 .. h0 + 1 of a call over 4
    heads is those heads of the whole call's mask, and the forward (out,
    lse), dq and dk / dv of each tp 2 rank's heads (and its kv heads)
    equal the whole call's slice (exact); at offset 0 over its own heads
    the mask is the one a call without the arguments draws."""
    g = torch.Generator().manual_seed(7)
    B, T, nh, D = 2, 24, 4, 16
    q, do = (torch.randn(B, T, nh, D, generator=g) for _ in range(2))
    k, v = (torch.randn(B, T, nkv, D, generator=g) for _ in range(2))
    seed = torch.tensor([123, -45], dtype=torch.int32)
    kw = dict(scale=D ** -0.5, dropout_rate=0.2)
    whole = fa.keep_mask(seed, 0.2, B, nh, T, T)
    assert torch.equal(fa.keep_mask(seed, 0.2, B, nh, T, T, None, 0, nh),
                       whole)
    assert 0.1 < float((whole == 0).float().mean()) < 0.3
    out, lse = fa.flash_attn_fwd_plain(q, k, v, seed, **kw)
    delta = (do * out).sum(-1).transpose(1, 2)
    dq = fa.flash_attn_bwd_dq_plain(q, k, v, do, lse, delta, seed, **kw)
    dk, dv = fa.flash_attn_bwd_dkv_plain(q, k, v, do, lse, delta, seed,
                                         **kw)
    for r in range(2):
        hq, hk = slice(2 * r, 2 * r + 2), slice(r * nkv // 2,
                                                (r + 1) * nkv // 2)
        part = dict(kw, head_offset=2 * r, total_heads=nh)
        assert torch.equal(
            fa.keep_mask(seed, 0.2, B, 2, T, T, None, 2 * r, nh),
            whole[:, hq])
        args = (q[:, :, hq], k[:, :, hk], v[:, :, hk])
        o_r, l_r = fa.flash_attn_fwd_plain(*args, seed, **part)
        assert torch.equal(o_r, out[:, :, hq]) and torch.equal(l_r,
                                                               lse[:, hq])
        bw = (*args, do[:, :, hq], lse[:, hq], delta[:, hq], seed)
        assert torch.equal(fa.flash_attn_bwd_dq_plain(*bw, **part),
                           dq[:, :, hq])
        dk_r, dv_r = fa.flash_attn_bwd_dkv_plain(*bw, **part)
        if nkv == 4:
            assert torch.equal(dk_r, dk[:, :, hk])
            assert torch.equal(dv_r, dv[:, :, hk])


# ---------------------------------------------------------------------------
# (e) trajectories against the reference's same recipe
# ---------------------------------------------------------------------------

# name: (model, recipe, tp_size, world); the W=2 cases run in one spawn
CASES_W2 = {
    "tp_tiny": (TINY, "tp", 2),
    "tp_tiny_chunked": (TINY_CHUNKED, "tp", 2),
    "fsdp_tp_mla": (MLA, "fsdp_tp", 2),
    "tp_moe_grouped": (MOE_GROUPED, "tp", 2),
    "tp_pallas": (dict(TINY, loss_impl="pallas"), "tp", 2),
}


def _tp_case(mdict, recipe, tp, W, seed):
    kw = train_kw(W // tp, tp_size=tp)
    if mdict.get("moe"):
        kw["moe_impl"] = mdict["moe_impl"]
    batches = global_batches(5, W // tp, mdict["vocab_size"], seed=seed)
    init, ref = reference_run(mdict, kw, recipe, W, batches)
    return ref, steps_case(mdict, kw, recipe, init, batches)


@pytest.fixture(scope="module")
def w2_runs(tmp_path_factory):
    """{case: (reference steps, the ranks' records)} for CASES_W2."""
    refs, cases = {}, []
    for i, (name, (mdict, recipe, tp)) in enumerate(CASES_W2.items()):
        refs[name], case = _tp_case(mdict, recipe, tp, 2, seed=20 + i)
        cases.append(case)
    # dropout 0.1 under tp 2 against the port's own single-process run
    # (the reference's element-dropout masks are not the port's)
    mdict = dict(TINY, dropout=0.1)
    kw = train_kw(1)
    batches = global_batches(3, 1, TINY["vocab_size"], seed=30)
    single = create_train_state(LLMConfig(**mdict),
                                TrainConfig(**kw, platform="cpu"), "cpu")
    init = {k: v.clone() for k, v in single.model.state_dict().items()}
    step = make_train_step(TrainConfig(**kw, platform="cpu"))
    refs["tp_dropout"] = []
    for x, y in batches:
        m = step(single, torch.from_numpy(x).long(),
                 torch.from_numpy(y).long())
        refs["tp_dropout"].append(dict(
            {k: float(v) for k, v in m.items()},
            state={k: v.clone() for k, v in
                   single.model.state_dict().items()}))
    cases.append(steps_case(mdict, dict(kw, tp_size=2), "tp", init,
                            batches))
    got = ranks.spawn(tmp_path_factory.mktemp("tp_w2"), 2, cases)
    return {name: (refs[name], [g[i] for g in got])
            for i, name in enumerate(list(CASES_W2) + ["tp_dropout"])}


@pytest.mark.parametrize("case", list(CASES_W2))
def test_tp_trajectory_matches_reference_w2(w2_runs, case):
    """5 AdamW steps at W=2 (one data rank, tp 2), accum 2, clipping
    active, fp32: each rank's whole parameters within atol 1e-4 of the
    reference's same recipe after every step, the loss within rtol 1e-5,
    the grad norm within rtol 1e-4, every MoE expert_bias within 1e-6.
    'tp_pallas' asks for loss_impl='pallas', which both packages' gates
    send to the chunked (here vocab-parallel) loss under tp; the port
    counts it in fused_ce.DEGRADED."""
    ref, got = w2_runs[case]
    assert all(r["grad_norm"] > 0.05 for r in ref)
    assert_trajectory(ref, got, atol=1e-4)
    if case == "tp_moe_grouped":
        bias0 = got[0]["steps"][-1]["moe"][0]["expert_bias"]
        assert not (bias0 == 0).all()
    if case == "tp_pallas":
        # 5 steps x 2 micro-steps
        assert all(g["ce_degraded"]["vocab_parallel"] == 10 for g in got)


def test_tp_dropout_matches_one_process(w2_runs):
    """At dropout 0.1 (embedding, attention weights in the flash kernels'
    plain versions, residual), 3 AdamW steps under tp 2 against the port's
    own one-process run from the same init and batches: the attention
    masks of a rank's heads are the whole layer's (head offset), the
    element masks are drawn whole on every model rank, so every rank's
    parameters are within 1e-4, the loss within rtol 1e-5 and the grad
    norm within rtol 1e-4 of the one-process run's."""
    ref, got = w2_runs["tp_dropout"]
    assert_trajectory(ref, got, atol=1e-4)


def test_tp_ranks_hold_their_pieces(w2_runs):
    """Under tp 2 each rank holds half of every cut parameter, of its AdamW
    moments and of its gradient, and the whole of the rest (exact
    bytes)."""
    _, got = w2_runs["tp_tiny"]
    model = LLM(LLMConfig(**TINY), device="cpu")
    cuts = tensor.plan(((n, p.shape) for n, p in model.named_parameters()),
                       LLMConfig(**TINY), 2)
    want = sum(p.numel() * 4 // (2 if n in cuts else 1)
               for n, p in model.named_parameters())
    assert len(cuts) == 1 + 5 * TINY["n_layer"]
    for g in got:
        assert g["held"] == {"params": want, "moments": 2 * want,
                             "grads": want}


@pytest.fixture(scope="module")
def w4_runs(tmp_path_factory):
    """At W=4 in one spawn: fsdp_tp 2 x 2 against the reference's, the
    vocab-parallel CE over 2 x 2, and the trainer loop under fsdp_tp 2 x 2
    (straight, resumed, and its checkpoint restored under tp 2 x 2 and dp
    4)."""
    tmp = tmp_path_factory.mktemp("tp_w4")
    ref, steps = _tp_case(TINY, "fsdp_tp", 2, 4, seed=40)
    rng = np.random.default_rng(8)
    n, T, C, V = 4, 32, 32, 128
    x = rng.standard_normal((n, T, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((V, C))).astype(np.float32)
    t = rng.integers(0, V // 2, (n, T))     # targets mostly in rank 0's rows
    t[1, 3:7] = 100
    t[0, :13] = -1                          # data rank 0: 13 ignored
    t[3, 5:7] = -1                          # data rank 1: 2 ignored
    d = tmp / "run"
    kw = dict(dataset="synthetic", data_dir=str(tmp / "data"),
              batch_size=2, total_batch_size=2 * 2 * 2 * 32,
              warmup_steps=2, platform="cpu", compute_dtype="float32",
              log_interval=1, save_stats=False, max_iters=5,
              parallelism="fsdp_tp", tp_size=2, ckpt_interval=3)
    step3 = str(d / "checkpoints" / "llm_model" / "step_3")
    got = ranks.spawn(tmp / "ranks", 4, [
        steps,
        dict(kind="vp_ce", x=x, w=w, t=t, tp=2, chunk=8),
        dict(kind="train", cfg=TINY, tc=kw, cwd=str(d)),
        dict(kind="train", cfg=TINY, tc=dict(kw, resume=True,
                                              ckpt_interval=0), cwd=str(d)),
        dict(kind="restore", cfg=TINY, tc=dict(kw, parallelism="tp"),
             path=step3),
        dict(kind="restore", cfg=TINY, tc=dict(kw, parallelism="dp",
                                               tp_size=1), path=step3)])
    return dict(ref=ref, got=got, ce=(x, w, t), kw=kw, step3=step3)


def test_fsdp_tp_trajectory_matches_reference_w4(w4_runs):
    """fsdp_tp at W=4 (2 data x 2 model ranks): the limits of the W=2
    test against the reference's fsdp_tp on a (2, 2) mesh."""
    assert_trajectory(w4_runs["ref"], [g[0] for g in w4_runs["got"]],
                      atol=1e-4)


def test_vocab_parallel_ce_matches_the_chunked_loss(w4_runs):
    """(c) The vocab-parallel CE over 2 data x 2 model ranks (chunk 8 of T
    32), with ignored targets spread unevenly over the data ranks and the
    targets mostly in model rank 0's rows, against the port's plain
    chunked loss over the whole batch and the whole embedding, in fp32:
    every rank's loss (the data rank's share of the global mean: their
    average) and dW (averaged over 'data', joined over 'model') within
    1e-6, each rank's dx times 2 (its data rank's rows) within 1e-6."""
    x, w, t = w4_runs["ce"]
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = fused_cross_entropy(xt, wt, torch.from_numpy(t).long(), chunk=8)
    loss.backward()
    got = [g[1] for g in w4_runs["got"]]
    mean = np.mean([g["loss"] for g in got])
    np.testing.assert_allclose(mean, float(loss.detach()), rtol=0,
                               atol=1e-6)
    for g in got:
        np.testing.assert_allclose(g["dw"].numpy(), wt.grad.numpy(),
                                   atol=1e-6, rtol=0)
        rows = slice(2 * g["data_rank"], 2 * g["data_rank"] + 2)
        np.testing.assert_allclose(g["dx"].numpy() / 2,
                                   xt.grad.numpy()[rows], atol=1e-6, rtol=0)
    assert got[0]["loss"] == got[1]["loss"] != got[2]["loss"]


def test_fsdp_tp_checkpoint_resumes_and_restores(w4_runs):
    """(f) fsdp_tp 2 x 2 through the trainer loop: an uninterrupted run of
    iterations 0..5 saves step_3 (whole tensors in the reference's
    layout); a second run resumes from it, and its losses, final
    parameters and AdamW moments equal the uninterrupted run's bit for
    bit. The checkpoint restores, with equal parameters and moments,
    under tp 2 x 2, under dp 4 and under single in this process."""
    step3 = w4_runs["step3"]
    payload = torch.load(os.path.join(step3, "state.pt"), weights_only=True)
    ref_shapes = {k: v.shape for k, v in LLM(
        LLMConfig(**TINY), device="cpu").state_dict().items()}
    assert {k: v.shape for k, v in payload["model"].items()} == ref_shapes
    for rank, (_, _, straight, resumed, tp, dp) in enumerate(
            w4_runs["got"]):
        assert len(straight["train_losses"]) == 6
        assert resumed["train_losses"] == straight["train_losses"][4:]
        for k, v in straight["model"].items():
            assert torch.equal(resumed["model"][k], v), k
        for i, st in straight["optimizer"]["state"].items():
            for name, v in st.items():
                assert torch.equal(resumed["optimizer"]["state"][i][name],
                                   v), (i, name)
        for r in (tp, dp):
            assert r["step"] == payload["step"] == 4
            for k, v in payload["model"].items():
                assert torch.equal(r["model"][k], v), k
            for i, st in payload["optimizer"]["state"].items():
                for name, v in st.items():
                    assert torch.equal(r["optimizer"]["state"][i][name],
                                       v), (i, name)
        assert any("tp=2 recipe=fsdp_tp world=4 backend=gloo" in line
                   for line in straight["log"]) == (rank == 0)
    tc = TrainConfig(**dict(w4_runs["kw"], parallelism="single", tp_size=1))
    single = create_train_state(LLMConfig(**TINY), tc, "cpu")
    ckpt.restore_checkpoint(step3, single)
    for k, v in payload["model"].items():
        assert torch.equal(single.model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# (g) torchrun, (h) what stays refused
# ---------------------------------------------------------------------------

def test_torchrun_entry_point_trains_tp_on_two_gloo_ranks(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    distributed_pytorch_tpu_torch --platform cpu --parallelism tp
    --tp_size 2` trains 3 iterations of a tiny model: exit 0, and rank
    0's log names tp 2, the recipe, the world of two and gloo, and logs
    every iteration with a finite loss."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "distributed_pytorch_tpu_torch",
            "--platform", "cpu", "--parallelism", "tp", "--tp_size", "2",
            "--compute_dtype", "float32", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"), "--vocab_size", "128",
            "--block_size", "32", "--n_embd", "32", "--n_head", "4",
            "--n_kv_heads", "2", "--n_layer", "2", "--up_dim", "64",
            "--batch_size", "2", "--total_batch_size_str", "2**7",
            "--max_iters", "2", "--no-save_stats"]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "tp=2 recipe=tp world=2 backend=gloo data=1 model=2" in r.stdout, \
        r.stdout
    losses = [float(line.split("| loss")[1].split("|")[0])
              for line in r.stdout.splitlines() if line.startswith("iter ")
              and "| loss" in line]
    assert len(losses) == 3 and np.isfinite(losses).all(), r.stdout


@pytest.mark.parametrize("field,value", [
    ("parallelism", "ep"), ("parallelism", "sp"), ("parallelism", "pp"),
    ("ep_size", 2), ("sp_size", 2), ("pp_size", 2),
    ("parallelism", "zero1"), ("parallelism", "zero2")])
def test_ep_sp_pp_still_raise_under_tp(field, value):
    """(h) Beside a 'model' axis of 2, ep, sp and pp still raise
    NotImplementedError naming what is left of slice 6, and so do zero1
    and zero2, naming the 'model' axis under them."""
    tc = dataclasses.replace(
        TrainConfig(platform="cpu", parallelism="tp", tp_size=2),
        **{field: value})
    what = "zero1 / zero2 with a 'model'" if value in ("zero1", "zero2") \
        else "rest of slice 6: the compositions"
    with pytest.raises(NotImplementedError, match=what):
        check_slice(LLMConfig(**TINY), tc)


@pytest.mark.parametrize("mdict,tp", [
    (dict(TINY, n_kv_heads=1, attn="mqa"), 2), (dict(TINY, n_head=2,
                                                     n_kv_heads=2), 4),
    (dict(TINY, up_dim=66), 4)], ids=["mqa", "heads", "up_dim"])
def test_indivisible_heads_and_widths_raise(mdict, tp):
    """A head count or an MLP width that tp does not divide raises
    ValueError naming ROADMAP (the reference would cut through a head
    under GSPMD); tp dividing them passes."""
    with pytest.raises(ValueError, match="ROADMAP"):
        tensor.check_tp(LLMConfig(**mdict), tp)
    tensor.check_tp(LLMConfig(**TINY), 2)
