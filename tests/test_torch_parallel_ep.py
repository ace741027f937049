"""Expert parallelism in the port ('ep', and --ep_size under dp / fsdp) and
'scatter' under a 'seq' axis, against the reference package's same recipe
on the CPU.

The harness of test_torch_parallel_sp.py: the reference runs its recipe
on W virtual CPU devices (`build_mesh(resolve_plan(recipe, W, ep_size=,
sp_size=))`: its grouped dispatch in a `shard_map` over ('data',
'expert'), 'dense' and 'scatter' placed by GSPMD), the port on W gloo
ranks spawned from tests/torch_parallel_ranks.py, from the reference's
init and on the same global batches; the expert ranks of one data rank
take its rows. The model is the reference's `MOE` (tests/test_parallel.py
:21) at one layer: 8 experts, 1 shared, 3 active. 'scatter' runs at a
capacity factor of 1, where assignments drop. The ranks run while the
reference computes. Each test states its tolerance."""

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
import torch.nn.functional as F
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
from distributed_pytorch_tpu_torch.models.mlp import (activate,
                                                      scatter_positions)
from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
from distributed_pytorch_tpu_torch.ops.ring_attention import local_positions
from distributed_pytorch_tpu_torch.models.gpt import LLM
from distributed_pytorch_tpu_torch.parallel import context, sharding, tensor
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train.loop import check_slice
from distributed_pytorch_tpu_torch.train.state import create_train_state
from test_torch_parallel_tp import FULL, _port_name, _reference_shapes
from test_torch_parallel_train import (TINY, assert_trajectory,
                                       global_batches, steps_case, train_kw)
import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = dict(TINY, n_layer=1, moe=True, n_exp=8, n_shared=1, n_act=3)
# capacity factor 1: the busiest experts drop assignments
SCATTER = dict(MOE, moe_impl="scatter", capacity_factor=1.0)

# name: (model, recipe, (ep, sp), extra train flags)
CASES_W2 = {
    "ep2_grouped": (MOE, "ep", (2, 1), {}),
    "ep2_dense": (MOE, "ep", (2, 1), {}),
    "ep2_scatter": (SCATTER, "ep", (2, 1), {}),
    # unfactored (every width under 128): the block RMS of an expert
    # stack is the whole stack's, over the expert ranks
    "ep2_adafactor_grouped": (MOE, "ep", (2, 1),
                              dict(optimizer="adafactor")),
    "fsdp_sp2_scatter_zigzag": (SCATTER, "fsdp", (1, 2), {}),
    "fsdp_sp2_scatter_ring": (SCATTER, "fsdp", (1, 2),
                              dict(attn_impl="ring")),
}
CASES_W4 = {
    "ep4_grouped": (MOE, "ep", (4, 1), {}),
    # two shared experts of eight at ep 4: rank 0 holds no routed expert
    "ep4_scatter_shared_only": (dict(SCATTER, n_shared=2, n_act=4), "ep",
                                (4, 1), {}),
    "dp_ep2_scatter": (SCATTER, "dp", (2, 1), {}),
    "fsdp_ep2_grouped": (MOE, "fsdp", (2, 1), {}),
}
SCATTER_CASES = ("ep2_scatter", "fsdp_sp2_scatter_zigzag",
                 "fsdp_sp2_scatter_ring", "dp_ep2_scatter",
                 "ep4_scatter_shared_only")


def _impl(name: str) -> str:
    return next(i for i in ("grouped", "dense", "scatter") if i in name)


class _Reference:
    """The reference's `recipe` on W devices with an 'expert' axis of ep
    and a 'seq' axis of sp: its init in the port's layout now, its 5 steps
    in `run()`."""

    def __init__(self, mdict, recipe, ep, sp, W, extra, seed):
        self.dp = W // (ep * sp)
        self.kw = train_kw(self.dp, ep_size=ep, sp_size=sp, **extra)
        self.mc = JConfig(**mdict)
        self.jtc = JTrainConfig(**self.kw, parallelism=recipe)
        self.mesh = build_mesh(jplan(recipe, W, ep_size=ep, sp_size=sp))
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


def _ckpt_cases(tmp):
    """The trainer loop under ep 2 (straight, resumed from step_3) and
    step_3 restored under fsdp 2."""
    kw = dict(dataset="synthetic", data_dir=str(tmp / "data"),
              batch_size=2, total_batch_size=2 * 2 * 32,
              warmup_steps=2, platform="cpu", compute_dtype="float32",
              log_interval=1, save_stats=False, max_iters=5,
              parallelism="ep", ep_size=2, ckpt_interval=3)
    cfg = dict(MOE, moe_impl="grouped")
    d = str(tmp / "run")
    step3 = os.path.join(d, "checkpoints", "llm_model", "step_3")
    return kw, [dict(kind="train", cfg=cfg, tc=kw, cwd=d),
                dict(kind="train", cfg=cfg,
                     tc=dict(kw, resume=True, ckpt_interval=0), cwd=d),
                dict(kind="restore", cfg=cfg,
                     tc=dict(kw, parallelism="fsdp", ep_size=1),
                     path=step3)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (reference steps, the ranks' records)} of CASES_W2 (one
    spawn of two ranks, with the checkpoint cases) and CASES_W4 (one
    spawn of four)."""
    tmp = tmp_path_factory.mktemp("ep")
    refs = {}
    for i, (name, (m, r, (ep, sp), extra)) in enumerate(
            list(CASES_W2.items()) + list(CASES_W4.items())):
        W = 2 if name in CASES_W2 else 4
        refs[name] = _Reference(dict(m, moe_impl=_impl(name)), r, ep, sp, W,
                                dict(extra, moe_impl=_impl(name)),
                                seed=80 + i)
    kw, ckpt_cases = _ckpt_cases(tmp)
    w2 = [refs[n].case for n in CASES_W2] + ckpt_cases
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
    out["ckpt"] = (kw, [g[len(CASES_W2):] for g in got2])
    return out


@pytest.mark.parametrize("case", list(CASES_W2) + list(CASES_W4))
def test_ep_trajectory_matches_reference(runs, case):
    """5 AdamW steps, accum 2, clipping active, fp32: each rank's whole
    parameters within atol 1e-4 of the reference's same recipe after every
    step, the loss within rtol 1e-5, the grad norm within rtol 1e-4, every
    expert_bias within 1e-6 and `moe_dropped_frac` equal. World 2: ep 2
    with each dispatch, and fsdp --sp_size 2 with 'scatter' under zig-zag
    stripes and under the contiguous ring, ep 2 with Adafactor; world 4:
    ep 4 (one shared and one routed expert on rank 0, two routed on the
    others), 'scatter' at ep 4 with two shared experts (rank 0 holds no
    routed one), dp --ep_size 2 (2 data x 2 expert) and fsdp --ep_size
    2. Under 'scatter' every
    case drops (dropped_frac > 0 at every step)."""
    ref, got = runs[case]
    assert all(r["grad_norm"] > 0.05 for r in ref)
    assert_trajectory(ref, got, atol=1e-4)
    for g in got:
        assert [s["moe_dropped_frac"] for s in g["steps"]] == \
            [r["moe_dropped_frac"] for r in ref]
        bias = g["steps"][-1]["moe"][0]["expert_bias"]
        assert not (bias == 0).all()
    drops = [r["moe_dropped_frac"] for r in ref]
    if case in SCATTER_CASES:
        assert min(drops) > 0, drops
    else:
        assert drops == [0.0] * len(ref)


def _per_device_bytes(recipe, W, ep):
    """Bytes of the parameters, AdamW moments and gradient accumulator
    the reference's specs give one device of its ('data', 'expert') mesh
    (`params_pspecs`, `shard_like_params`, `grads_pspecs`)."""
    mesh = build_mesh(jplan(recipe, W, ep_size=ep))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    shapes = jax.eval_shape(
        lambda r: JLLM(JConfig(**MOE)).init({"params": r, "dropout": r},
                                            jnp.zeros((1, 8), jnp.int32)),
        jax.random.PRNGKey(0))["params"]
    leaves = jax.tree_util.tree_leaves(shapes)
    p_specs = jshd.params_pspecs(shapes, recipe, mesh)
    shape_tree = jax.tree_util.tree_map(lambda l: tuple(l.shape), shapes)
    g_specs = jshd.grads_pspecs(shape_tree, p_specs, recipe, mesh)
    o_specs = jshd.shard_like_params(shapes, shape_tree, p_specs, recipe,
                                     mesh)

    def total(specs):
        flat = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        n = 0
        for leaf, spec in zip(leaves, flat):
            axes = [a for entry in spec if entry is not None
                    for a in ((entry,) if isinstance(entry, str) else entry)]
            n += 4 * int(np.prod(leaf.shape)) // int(
                np.prod([sizes[a] for a in axes]))
        return n
    return {"params": total(p_specs), "moments": 2 * total(o_specs),
            "grads": total(g_specs)}


@pytest.mark.parametrize("ep", [2, 4])
def test_expert_axes_and_shapes_match_reference(ep):
    """At full width (bench.py's BENCH_MOE: the flagship with 8 experts),
    every parameter's 'expert' axis (`spec_for_param`) equals the
    reference's `params_pspecs` under 'ep' on an 'expert' axis of ep
    virtual devices, and `shard_experts` leaves each rank the reference's
    per-device shape, rank r holding experts r 8 / ep .. (r + 1) 8 / ep - 1
    of the whole stack (exact)."""
    mesh = build_mesh(jplan("ep", ep, ep_size=ep))
    shapes = _reference_shapes("bench_moe")
    specs = jshd.params_pspecs(shapes, "ep", mesh)
    spec_of = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        port, transposed = _port_name(tuple(p.key for p in path))
        ref = tuple(spec_of[path]) + (None,) * (len(leaf.shape)
                                                - len(spec_of[path]))
        shape = tuple(leaf.shape)
        if transposed:
            ref, shape = ref[::-1], shape[::-1]
        assert sharding.spec_for_param(port, shape, 1, ep) == ref, port
        if "expert" in ref:
            want[port] = tuple(d // ep if a == "expert" else d
                               for d, a in zip(shape, ref))
    assert len(want) == 2 * 12
    cfg = LLMConfig(**FULL["bench_moe"])
    whole = LLM(cfg, device="meta")
    for r in (0, ep - 1):
        model = LLM(cfg, device="meta")
        cut = tensor.shard_experts(model, r, ep)
        assert sorted(cut) == sorted(want)
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  whole.named_parameters()):
            assert tuple(p.shape) == want.get(n, tuple(q.shape)), n
        assert all(m.ep == (r, ep) for m in model.moe_layers())
    stack = torch.arange(8.0).view(8, 1, 1).expand(8, 2, 3)
    for r in range(ep):
        assert tensor.expert_piece(stack, r, ep)[:, 0, 0].tolist() == \
            list(range(r * 8 // ep, (r + 1) * 8 // ep))
    assert whole.ep == (0, 1)


def test_ep_ranks_hold_their_experts(runs):
    """Under fsdp --ep_size 2 (2 data x 2 expert) every rank holds of the
    parameters, AdamW moments and gradients the bytes the reference's
    specs give a device, exactly. Under ep 2 and ep 4 every rank holds the
    parameters the reference's specs give a device (the expert stacks 1 /
    ep, the rest whole), and moments and gradients of that same layout:
    the reference's table replicates the ep recipe's moments and
    accumulator (`shard_like_params`, `grads_pspecs`: ep shards neither),
    which the port does not."""
    want = _per_device_bytes("fsdp", 4, 2)
    assert all(g["held"] == want for g in runs["fsdp_ep2_grouped"][1])
    for case, W, ep in (("ep2_grouped", 2, 2), ("ep4_grouped", 4, 4)):
        params = _per_device_bytes("ep", W, ep)["params"]
        assert all(g["held"] == {"params": params, "moments": 2 * params,
                                 "grads": params} for g in runs[case][1])


def test_ep_checkpoint_resumes_and_restores(runs):
    """ep 2 through the trainer loop: a run of iterations 0..5 saves step_3
    with whole expert stacks in the reference's layout (8 experts); a
    second run resumes from it and its losses, final parameters and AdamW
    moments equal the uninterrupted run's bit for bit. step_3 restores with
    equal parameters and moments under fsdp 2 and under single in this
    process."""
    kw, got = runs["ckpt"]
    path = os.path.join(os.path.dirname(kw["data_dir"]), "run",
                        "checkpoints", "llm_model", "step_3")
    saved = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert saved["model"]["blocks.0.moe.experts_fc"].shape[0] == 8
    assert saved["model"]["blocks.0.moe.experts_proj"].shape[0] == 8
    for rank, (straight, resumed, restored) in enumerate(got):
        assert len(straight["train_losses"]) == 6
        assert resumed["train_losses"] == straight["train_losses"][4:]
        for k, v in straight["model"].items():
            assert torch.equal(resumed["model"][k], v), k
        for i, st in straight["optimizer"]["state"].items():
            for name, v in st.items():
                assert torch.equal(resumed["optimizer"]["state"][i][name],
                                   v), (i, name)
        assert restored["step"] == saved["step"] == 4
        for k, v in saved["model"].items():
            assert torch.equal(restored["model"][k], v), k
        for i, st in saved["optimizer"]["state"].items():
            for name, v in st.items():
                assert torch.equal(restored["optimizer"]["state"][i][name],
                                   v), (i, name)
        assert any("recipe=ep world=2 backend=gloo data=1 model=1 expert=2"
                   in line for line in straight["log"]) == (rank == 0)
    tc = TrainConfig(**dict(kw, parallelism="single", ep_size=1))
    single = create_train_state(LLMConfig(**dict(MOE, moe_impl="grouped")),
                                tc, "cpu")
    ckpt.restore_checkpoint(path, single)
    for k, v in saved["model"].items():
        assert torch.equal(single.model.state_dict()[k], v), k


def test_torchrun_entry_point_trains_ep_on_two_gloo_ranks(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    distributed_pytorch_tpu_torch --platform cpu --moe ... --parallelism
    ep --ep_size 2` trains 3 iterations of a tiny MoE: exit 0, rank 0's
    log names the recipe, the world of two, gloo and expert 2, and every
    iteration's loss is finite."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "distributed_pytorch_tpu_torch",
            "--platform", "cpu", "--parallelism", "ep", "--ep_size", "2",
            "--moe", "--n_exp", "8", "--n_shared", "1", "--n_act", "3",
            "--moe_impl", "grouped",
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
    assert ("recipe=ep world=2 backend=gloo data=1 model=1 expert=2"
            in r.stdout), r.stdout
    losses = [float(line.split("| loss")[1].split("|")[0])
              for line in r.stdout.splitlines() if line.startswith("iter ")
              and "| loss" in line]
    assert len(losses) == 3 and np.isfinite(losses).all(), r.stdout


# ---------------------------------------------------------------------------
# one process: a rank's dispatch, its empty slice, the global positions
# ---------------------------------------------------------------------------

def _dispatch_inputs(seed, N=40, C=16, up=24, E=8, k=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, C)).astype(np.float32)
    idx = np.stack([rng.choice(E - 1, k, replace=False) for _ in range(N)])
    gates = rng.random((N, k)).astype(np.float32)
    fc = (0.2 * rng.standard_normal((E, C, 2 * up))).astype(np.float32)
    proj = (0.2 * rng.standard_normal((E, up, C))).astype(np.float32)
    dy = rng.standard_normal((N, C)).astype(np.float32)
    return x, idx, gates, fc, proj, dy


def _grads(x, idx, gates, fc, proj, dy, ep):
    """The summed output of the ep slices' local dispatches and the
    gradients of x, the gates and the (joined) weights."""
    xs = torch.from_numpy(x).requires_grad_()
    gs = torch.from_numpy(gates).requires_grad_()
    n = fc.shape[0] // ep
    ws = [(torch.from_numpy(fc[r * n:(r + 1) * n]).requires_grad_(),
           torch.from_numpy(proj[r * n:(r + 1) * n]).requires_grad_())
          for r in range(ep)]
    y = sum(gm.grouped_dispatch(
        xs, torch.from_numpy(idx).long(), gs, a, b, n_shared=1,
        act=lambda h: activate(h, "swiglu"), ep=(r, ep))
        for r, (a, b) in enumerate(ws))
    y.backward(torch.from_numpy(dy))
    return (y.detach(), xs.grad, gs.grad, torch.cat([a.grad for a, _ in ws]),
            torch.cat([b.grad for _, b in ws]))


@pytest.mark.parametrize("ep", [2, 4])
def test_local_dispatch_slices_sum_to_the_whole(ep):
    """The grouped dispatch of 8 experts (1 shared) cut into ep slices,
    each rank's local dispatch on its experts' assignments only: the sum
    of the slices' outputs, and the gradients of x, the gates and every
    expert's weights, within 1e-5 of the whole dispatch's (plain
    versions, fp32)."""
    args = _dispatch_inputs(seed=ep)
    whole = _grads(*args, ep=1)
    for a, b in zip(_grads(*args, ep=ep), whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_a_slice_with_no_rows_gives_zeros():
    """At ep 4 a slice whose two routed experts (global ids 6, 7; routed 5,
    6) receive no assignment runs its local dispatch on an empty buffer:
    zero output, zero gradients of x, the gates and its weights."""
    x, idx, gates, fc, proj, dy = _dispatch_inputs(seed=3)
    idx = idx % 5                              # routed ids 0..4 only
    xs = torch.from_numpy(x).requires_grad_()
    gs = torch.from_numpy(gates).requires_grad_()
    a = torch.from_numpy(fc[6:]).requires_grad_()
    b = torch.from_numpy(proj[6:]).requires_grad_()
    gm.reset_counts()
    y = gm.grouped_dispatch(xs, torch.from_numpy(idx).long(), gs, a, b,
                            n_shared=1, act=lambda h: activate(h, "swiglu"),
                            ep=(3, 4))
    y.backward(torch.from_numpy(dy))
    assert gm.PLAIN_CALLS["grouped_mm_fwd"] == 3
    for t in (y, xs.grad, gs.grad, a.grad, b.grad):
        assert not t.any()


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_scatter_positions_from_chunked_counts(layout, monkeypatch):
    """Each assignment's place in its expert's queue in the global (b, t)
    order, computed on one data rank (the second of two) from a seq rank's
    positions of each row and the per-row, per-run counts of every seq
    rank (sp 4; one run a rank contiguous, two zig-zag), equals the place
    the whole rows give it and a count over the flattened batch, exactly."""
    rng = np.random.default_rng(11)
    B, T, E, k, sp = 3, 16, 7, 2, 4
    idx = torch.from_numpy(np.stack([rng.choice(E, k, replace=False)
                                     for _ in range(B * T)])).view(B, T, k)
    before = torch.from_numpy(rng.integers(0, 9, E).astype(np.float32))
    oh = F.one_hot(idx, E).float()
    whole = scatter_positions(oh.view(-1, k, E), idx.view(-1, k), B, before)
    flat = idx.view(-1, k).numpy()
    seen = before.numpy().astype(np.int64).copy()
    direct = np.zeros_like(flat)
    for n in range(flat.shape[0]):
        for j in range(k):
            direct[n, j] = seen[flat[n, j]]
        seen[flat[n]] += 1
    assert (whole.numpy() == direct).all()

    cols = [local_positions(T, sp, s, layout) for s in range(sp)]
    counts = []
    monkeypatch.setattr(context, "seq_size", lambda: sp)
    monkeypatch.setattr(context, "seq_layout", lambda: layout)
    for stage in ("count", "place"):
        for s in range(sp):
            monkeypatch.setattr(context, "seq_rank", lambda s=s: s)
            if stage == "count":
                def gather(t):
                    counts.append(t.clone())
                    return torch.stack([t] * sp)
            else:
                def gather(t):
                    return torch.stack(counts)
            monkeypatch.setattr(context, "seq_all_gather_stack", gather)
            o, i = oh[:, cols[s]], idx[:, cols[s]]
            got = scatter_positions(o.reshape(-1, k, E), i.reshape(-1, k),
                                    B, before)
            if stage == "place":
                want = whole.view(B, T, k)[:, cols[s]].reshape(-1, k)
                assert torch.equal(got, want), (layout, s)


@pytest.mark.parametrize("field,value", [
    ("parallelism", "ep"), ("ep_size", 2)])
def test_ep_runs_and_refuses_what_is_left(field, value):
    """ep, and dp / fsdp with ep_size 2, pass check_slice; beside a 'seq'
    or 'model' axis, and under zero1 / zero2, they raise
    NotImplementedError naming what is left of slice 6 and ROADMAP; an
    'expert' axis that does not divide n_exp raises ValueError."""
    base = TrainConfig(**{"platform": "cpu", "parallelism": "dp",
                          field: value})
    for recipe in ("dp", "fsdp") if field == "ep_size" else ("ep",):
        check_slice(LLMConfig(**MOE),
                    dataclasses.replace(base, parallelism=recipe))
    bad = [dict(sp_size=2), dict(tp_size=2)]
    if field == "ep_size":
        bad += [dict(parallelism="zero1"), dict(parallelism="zero2")]
    for kw in bad:
        with pytest.raises(NotImplementedError,
                           match="rest of slice 6.*ROADMAP"):
            check_slice(LLMConfig(**MOE), dataclasses.replace(base, **kw))
    with pytest.raises(ValueError, match="n_exp 8"):
        tensor.check_ep(LLMConfig(**MOE), 3)


def test_adafactor_factoring_the_expert_axis_is_refused():
    """Adafactor factors a stack's two largest axes once the second is 128
    long: with 256 experts of 128 x 192 it would factor the expert axis,
    which an 'expert' axis cuts, so building it over a rank's experts
    raises NotImplementedError naming ROADMAP; with 8 experts it builds."""
    from distributed_pytorch_tpu_torch.models.gpt import LLM
    from distributed_pytorch_tpu_torch.train.state import make_optimizer
    tc = TrainConfig(platform="cpu", optimizer="adafactor")
    for n_exp, fails in ((256, True), (8, False)):
        cfg = LLMConfig(**dict(MOE, n_embd=128, n_exp=n_exp))
        model = LLM(cfg, device="cpu")
        tensor.shard_experts(model, 0, 2)
        if fails:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                make_optimizer(model, tc)
        else:
            make_optimizer(model, tc)
