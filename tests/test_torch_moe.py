"""The port's MoE (models/mlp.py `MoE`, ops/grouped_matmul.py) against the
reference package's on the CPU: the layer under each dispatch and both
balancing modes (output, aux loss, and the routing state it leaves), a
tiny MoE model's logits and loss from converted weights, a 5-step AdamW
trajectory with the aux-free bias moving, and greedy engine tokens. Then
the port's own guarantees: recomputing blocks leaves the trajectory and
the bias exactly as they are, a skipped step restores the bias, and
restore_for_inference brings it back. The token gather and combine of
'scatter' and 'grouped' (`gather_rows` / `combine_rows`): outputs and the
gradients of x, the gates and both expert stacks against the reference's
dispatch and against the autograd-native formulation (an index gather and
an `index_add` combine), with unfilled slots, dropped assignments and
shared experts, and each token's gradient summed over its own slots
only. The reference's grouped dispatch
runs its Pallas kernels in interpret mode (bm 8), as its own tests do.
Each test states its tolerance."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.config import TrainConfig as JTrainConfig
from distributed_pytorch_tpu.engine import DecodeEngine as JEngine
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.models.mlp import MoE as JMoE
from distributed_pytorch_tpu.models.mlp import \
    scatter_dispatch as jscatter_dispatch
from distributed_pytorch_tpu.ops import grouped_matmul as jgm
from distributed_pytorch_tpu.train.state import create_train_state as jstate
from distributed_pytorch_tpu.train.step import make_train_step as jstep
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.engine import DecodeEngine
from distributed_pytorch_tpu_torch.models.gpt import LLM
from distributed_pytorch_tpu_torch.models.mlp import (MoE, activate,
                                                     mlp_apply,
                                                     scatter_dispatch)
from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train.state import (TrainState,
                                                       build_model,
                                                       make_optimizer)
from distributed_pytorch_tpu_torch.train.step import make_train_step
from torch_threads import one_thread  # noqa: F401

TINY = dict(vocab_size=97, block_size=32, n_embd=32, n_head=4, n_kv_heads=2,
            attn="gqa", n_layer=2, up_dim=48, non_linearity="swiglu",
            pos_emb="rope", moe=True, n_exp=6, n_shared=1, n_act=3,
            gamma=1e-2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aux_free", [True, False], ids=["aux_free", "aux"])
@pytest.mark.parametrize("impl", ["dense", "scatter", "grouped"])
def test_moe_layer_matches_reference(impl, aux_free):
    """One training forward of the layer from the same weights, input and
    (nonzero, so that it changes the selection) expert bias: output, aux
    loss, the updated expert_bias and dropped_frac against the
    reference's `MoE.apply(..., mutable=['moe_state'])`, fp32, atol 1e-5.
    'scatter' runs at capacity_factor 0.5, so it drops assignments."""
    cfg = dict(TINY, moe_impl=impl, aux_free=aux_free, capacity_factor=0.5)
    jcfg, tcfg = JConfig(**cfg), LLMConfig(**cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    var = JMoE(jcfg).init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))
    var = jax.tree_util.tree_map(np.array, jax.device_get(dict(var)))
    bias0 = (0.3 * rng.standard_normal(tcfg.n_routed)).astype(np.float32)
    if aux_free:
        var["moe_state"]["expert_bias"] = bias0
    (y_ref, aux_ref), mut = JMoE(jcfg).apply(
        var, jnp.asarray(x), deterministic=False, mutable=["moe_state"])

    layer = MoE(tcfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for name in ("experts_fc", "experts_proj", "gate"):
            getattr(layer, name).copy_(_t(var["params"][name]))
        if aux_free:
            layer.expert_bias.copy_(_t(bias0))
    layer.train()
    gm.reset_counts()
    y, aux = layer(_t(x))
    layer.commit_state()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux.item(), float(aux_ref), atol=1e-5)
    st = mut["moe_state"]
    if aux_free:
        np.testing.assert_allclose(layer.expert_bias.numpy(),
                                   np.asarray(st["expert_bias"]), atol=1e-5)
        assert not np.allclose(layer.expert_bias.numpy(), bias0)
    np.testing.assert_allclose(layer.dropped_frac.item(),
                               float(st["dropped_frac"]), atol=1e-5)
    if impl == "scatter":
        assert layer.dropped_frac.item() > 0
    assert gm.PLAIN_CALLS["grouped_mm_fwd"] == (2 if impl == "grouped"
                                                else 0)
    assert gm.DEGRADED["dense"] == 0


def test_eval_forward_never_moves_the_bias_and_grouped_degrades_counted():
    """In eval mode the layer reads the bias and leaves nothing to commit;
    a grouped layer whose widths the gate refuses (up_dim 44) runs the
    dense dispatch, counted in DEGRADED and warned once, with the dense
    layer's output."""
    cfg = LLMConfig(**dict(TINY, up_dim=44, moe_impl="grouped"))
    layer = MoE(cfg, device="cpu")
    torch.manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.2)
        layer.expert_bias.normal_()
    bias = layer.expert_bias.clone()
    layer.eval()
    x = torch.randn(2, 8, 32)
    gm.reset_counts()
    with pytest.warns(RuntimeWarning, match="'dense' dispatch"):
        y, _ = layer(x)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(layer(x)[0], y)       # warned once per layer
    assert layer.pending_state is None
    layer.commit_state()
    assert torch.equal(layer.expert_bias, bias)
    assert gm.DEGRADED["dense"] == 2 and gm.PLAIN_CALLS["grouped_mm_fwd"] == 0
    layer.config = dataclasses.replace(cfg, moe_impl="dense")
    assert torch.equal(layer(x)[0], y)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "grouped"])
def test_tiny_moe_model_matches_reference(impl):
    """A 2-layer MoE LLM (n_embd 32) from converted weights and moe_state
    (a nonzero bias): every position's logits and the loss (the mean CE
    plus the layers' aux losses over n_layer) in eval mode, fp32, atol
    1e-4; the active parameter count equals the reference's."""
    from distributed_pytorch_tpu.models.gpt import count_params as jcount

    from distributed_pytorch_tpu_torch.models.gpt import count_params
    cfg = dict(TINY, moe_impl=impl)
    jm = JLLM(JConfig(**cfg), attn_impl="naive")
    rng = np.random.default_rng(2)
    x = rng.integers(0, 97, (2, 32))
    y = rng.integers(0, 97, (2, 32))
    key = jax.random.PRNGKey(3)
    var = dict(jm.init({"params": key, "dropout": key}, jnp.asarray(x),
                       jnp.asarray(y)))
    var = jax.tree_util.tree_map(np.array, jax.device_get(var))
    for i in range(2):
        var["moe_state"][f"block_{i}"]["moe"]["expert_bias"] = \
            (0.3 * rng.standard_normal(5)).astype(np.float32)
    logits_ref, loss_ref, _ = jm.apply(var, jnp.asarray(x), jnp.asarray(y),
                                       all_logits=True)
    tcfg = LLMConfig(**cfg)
    model = LLM(tcfg, device="cpu", attn_impl="naive")
    model.load_state_dict(params_from_jax(var["params"], tcfg,
                                          var["moe_state"]))
    model.eval()
    with torch.no_grad():
        logits, loss = model(torch.from_numpy(x), torch.from_numpy(y),
                             all_logits=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss.item(), float(loss_ref), atol=1e-4)
    assert count_params(model, tcfg) == jcount(var["params"], JConfig(**cfg))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 97, (2, 2, 32)), rng.integers(0, 97, (2, 2, 32)))
            for _ in range(n)]


def _port_state(cfg, tc, jparams, jmoe):
    model = build_model(cfg, tc, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg, jmoe))
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, tc))


TRAIN_KW = dict(batch_size=2, total_batch_size=2 * 2 * 32, max_iters=10,
                warmup_steps=2, learning_rate=1e-3, grad_clip=1.0,
                compute_dtype="float32", seed=5)


def test_five_step_moe_trajectory_matches_reference():
    """5 AdamW steps at accum 2 of the grouped MoE model (gamma 1e-2, so
    the aux-free bias moves visibly at each micro-step) from the
    reference's init, on the same batches: the loss (rtol 1e-5), every
    parameter (atol 1e-4, as the dense trajectory test) and every layer's
    expert_bias (atol 1e-5) after every step; moe_dropped_frac is 0."""
    mc = JConfig(**TINY, moe_impl="grouped")
    jtc = JTrainConfig(**TRAIN_KW, moe_impl="grouped")
    jmodel, tx, js, _ = jstate(mc, jtc, None)
    jtrain = jstep(jmodel, tx, mc, jtc, None, None)
    cfg = LLMConfig(**TINY, moe_impl="grouped")
    tc = TrainConfig(**TRAIN_KW, moe_impl="grouped", platform="cpu")
    state = _port_state(cfg, tc, jax.device_get(js.params),
                        jax.device_get(js.moe_state))
    step = make_train_step(tc)
    bias0 = [m.expert_bias.clone() for m in state.model.moe_layers()]
    for x, y in _batches(5):
        js, jm = jtrain(js, jnp.asarray(x, jnp.int32),
                        jnp.asarray(y, jnp.int32))
        m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(m["moe_dropped_frac"]) == 0.0
        ref = params_from_jax(jax.device_get(js.params), cfg,
                              jax.device_get(js.moe_state))
        sd = state.model.state_dict()
        for name, r in ref.items():
            atol = 1e-5 if name.endswith(("expert_bias", "dropped_frac")) \
                else 1e-4
            np.testing.assert_allclose(sd[name].numpy(), r.numpy(),
                                       atol=atol, rtol=0, err_msg=name)
    for b0, layer in zip(bias0, state.model.moe_layers()):
        assert not torch.equal(b0, layer.expert_bias)


def _run_steps(cfg, tc, n, poison=None, monkeypatch=None):
    model = build_model(cfg, tc, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model, tc))
    step = make_train_step(tc)
    snaps, metrics = [], []
    for x, y in _batches(n, seed=7):
        metrics.append(step(state, torch.from_numpy(x), torch.from_numpy(y)))
        snaps.append({k: v.clone() for k, v in
                      state.model.state_dict().items()})
    return state, snaps, metrics


@pytest.mark.parametrize("impl", ["grouped", "scatter"])
def test_block_recompute_keeps_trajectory_and_bias(impl):
    """act_recomp with policy 'block' re-runs each MoE forward in the
    backward: routing there uses the bias the micro-step started with and
    the bias moves once per micro-step, so 3 steps at accum 2 leave every
    parameter and buffer exactly equal to the run without recomputation
    (fp32, bitwise)."""
    cfg = LLMConfig(**TINY, moe_impl=impl, capacity_factor=0.5)
    tc = TrainConfig(**TRAIN_KW, platform="cpu")
    runs = []
    for recomp in (False, True):
        c = dataclasses.replace(cfg, act_recomp=recomp,
                                act_recomp_policy="block")
        runs.append(_run_steps(c, tc, 3)[1])
    for a, b in zip(*runs):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert not torch.equal(runs[0][0]["blocks.0.moe.expert_bias"],
                           runs[0][1]["blocks.0.moe.expert_bias"])


def test_skipped_step_restores_the_routing_state(monkeypatch):
    """anomaly='skip' with iteration 1 poisoned: the step applies no
    update and leaves every layer's expert_bias and dropped_frac as step
    0 left them; the next step moves them again."""
    monkeypatch.setenv("TRAIN_POISON_IT", "1")
    cfg = LLMConfig(**TINY, moe_impl="scatter", capacity_factor=0.5)
    tc = TrainConfig(**TRAIN_KW, platform="cpu", anomaly="skip")
    state, snaps, metrics = _run_steps(cfg, tc, 3)
    assert [float(m["update_skipped"]) for m in metrics] == [0.0, 1.0, 0.0]
    assert state.updates == 2
    for k in snaps[0]:
        assert torch.equal(snaps[0][k], snaps[1][k]), k
    assert not torch.equal(snaps[1]["blocks.1.moe.expert_bias"],
                           snaps[2]["blocks.1.moe.expert_bias"])
    assert float(metrics[1]["moe_dropped_frac"]) == \
        float(metrics[0]["moe_dropped_frac"]) > 0


def test_restore_for_inference_brings_the_bias_back(tmp_path):
    """A trained MoE model's checkpoint restored into a fresh bf16 serving
    model: every expert_bias and dropped_frac buffer equal, the weights
    equal after the cast."""
    cfg = LLMConfig(**TINY, moe_impl="scatter", capacity_factor=0.5)
    tc = TrainConfig(**TRAIN_KW, platform="cpu")
    state, _, _ = _run_steps(cfg, tc, 2)
    path = ckpt.save_checkpoint(str(tmp_path / "step_2"), state, cfg, tc)
    served = LLM(cfg, device="cpu", dtype=torch.bfloat16)
    ckpt.restore_for_inference(path, served)
    sd, live = served.state_dict(), state.model.state_dict()
    for k, v in live.items():
        if k.endswith(("expert_bias", "dropped_frac")):
            assert torch.equal(sd[k], v), k
            assert v.abs().sum() > 0, k
        else:
            assert torch.equal(sd[k], v.to(sd[k].dtype)), k


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the token gather and combine of 'scatter' and 'grouped'
# ---------------------------------------------------------------------------

def _native_scatter(x_flat, topk_idx, topk_gates, fc, proj, capacity):
    """The autograd-native scatter dispatch: x_flat[tok_grid] with unfilled
    slots on token 0 and gate 0, and an index_add combine."""
    N, k = topk_idx.shape
    E = fc.shape[0]
    flat_e = topk_idx.reshape(-1)
    flat_g = topk_gates.reshape(-1)
    flat_t = torch.arange(N * k) // k
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = torch.zeros(E, dtype=torch.long).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    pos = torch.arange(N * k) - (torch.cumsum(counts, 0) - counts)[se]
    slot = torch.where(pos < capacity, se * capacity + pos,
                       torch.full_like(pos, E * capacity))
    tok = torch.zeros(E * capacity + 1, dtype=torch.long).index_put(
        (slot,), st)[:-1].reshape(E, capacity)
    gate = torch.zeros(E * capacity + 1).index_put(
        (slot,), sg)[:-1].reshape(E, capacity)
    y = mlp_apply(x_flat[tok], fc, proj, "swiglu") * gate[..., None]
    return torch.zeros_like(x_flat).index_add(
        0, tok.reshape(-1), y.reshape(E * capacity, -1))


def _native_grouped(x_flat, topk_idx, topk_gates, fc, proj, n_shared):
    """The autograd-native grouped dispatch: the same packing, x_flat[row]
    with unfilled rows on token 0 and gate 0, and an index_add combine."""
    N, k = topk_idx.shape
    E = fc.shape[0]
    bm = gm.block_m(x_flat.device)
    flat_e = torch.cat([torch.full((N,), e) for e in range(n_shared)]
                       + [(topk_idx + n_shared).reshape(-1)])
    flat_g = torch.cat([torch.ones(N) for _ in range(n_shared)]
                       + [topk_gates.reshape(-1)])
    flat_t = torch.cat([torch.arange(N)] * n_shared
                       + [torch.arange(N).repeat_interleave(k)])
    A = flat_e.shape[0]
    n_tiles = -(-A // bm) + E
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts, pstart, starts, tile_group = gm._gmm_metadata(flat_e, E,
                                                          n_tiles, bm)
    slot = pstart.long()[se] + torch.arange(A) - starts[se]
    row_tok = torch.zeros(n_tiles * bm, dtype=torch.long).index_put(
        (slot,), st)
    row_gate = torch.zeros(n_tiles * bm).index_put((slot,), sg)[:, None]
    h = activate(gm.gmm(x_flat[row_tok], fc, tile_group, counts, pstart,
                        bm=bm), "swiglu")
    y = gm.gmm(h.contiguous(), proj, tile_group, counts, pstart,
               scales=row_gate, bm=bm)
    return torch.zeros_like(x_flat).index_add(0, row_tok, y)


#: (dispatch, n_shared, capacity factor): unfilled slots (capacity twice
#: the mean load), dropped assignments (half of it), shared experts
DISPATCH_CASES = {"scatter-unfilled": ("scatter", 0, 2.0),
                  "scatter-dropped": ("scatter", 0, 0.5),
                  "grouped-unfilled": ("grouped", 0, None),
                  "grouped-shared": ("grouped", 2, None)}


def _dispatch_inputs(n_shared, seed=7):
    Nt, C, up, n_exp, k = 24, 32, 16, 6, 2
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Nt, C)).astype(np.float32)
    fc = (0.2 * rng.standard_normal((n_exp, C, 2 * up))).astype(np.float32)
    proj = (0.2 * rng.standard_normal((n_exp, up, C))).astype(np.float32)
    logits = rng.standard_normal((Nt, n_exp - n_shared)).astype(np.float32)
    # a skewed router, so that some experts overflow and some sit idle
    logits[:, 0] += 1.5
    idx = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
    vals = np.take_along_axis(logits, idx, axis=1)
    gates = (np.exp(vals) / np.exp(vals).sum(1, keepdims=True)) \
        .astype(np.float32)
    dy = rng.standard_normal((Nt, C)).astype(np.float32)
    return x, idx, gates, fc, proj, dy


def _capacity(cf, Nt, k, E):
    return max(k, int(np.ceil(cf * Nt * k / E)))


@pytest.mark.parametrize("case", DISPATCH_CASES.values(),
                         ids=DISPATCH_CASES.keys())
def test_dispatch_matches_reference_and_native(case):
    """The port's dispatch against the reference's (`jax.vjp`; the grouped
    one in interpret mode), fp32, atol 1e-5, and against the
    autograd-native formulation, atol 1e-6: the output and the gradients
    of x, the gates and both expert stacks. The case's packed buffer has
    unfilled slots, and the dropped case drops assignments."""
    impl, n_shared, cf = case
    x, idx, gates, fc, proj, dy = _dispatch_inputs(n_shared)
    Nt, k = idx.shape
    E = fc.shape[0] - n_shared
    if impl == "scatter":
        cap = _capacity(cf, Nt, k, E)
        load = np.bincount(idx.reshape(-1), minlength=E)
        assert (load > cap).any() if cf < 1 else (load < cap).any()

        def jf(x, g, a, b):
            return jscatter_dispatch(x, jnp.asarray(idx), g, a, b,
                                     non_linearity="swiglu", capacity=cap)

        def tf(x, g, a, b):
            return scatter_dispatch(x, _t(idx).long(), g, a, b,
                                    non_linearity="swiglu", capacity=cap)

        def nf(x, g, a, b):
            return _native_scatter(x, _t(idx).long(), g, a, b, cap)
    else:
        def jf(x, g, a, b):
            return jgm.grouped_dispatch(x, jnp.asarray(idx), g, a, b,
                                        non_linearity="swiglu",
                                        n_shared=n_shared, interpret=True)

        def tf(x, g, a, b):
            return gm.grouped_dispatch(x, _t(idx).long(), g, a, b,
                                       act=lambda h: activate(h, "swiglu"),
                                       n_shared=n_shared)

        def nf(x, g, a, b):
            return _native_grouped(x, _t(idx).long(), g, a, b, n_shared)

    y_ref, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (x, gates, fc, proj)))
    g_ref = vjp(jnp.asarray(dy))
    outs = []
    for f in (tf, nf):
        leaves = [_t(a).requires_grad_() for a in (x, gates, fc, proj)]
        y = f(*leaves)
        y.backward(_t(dy))
        outs.append([y.detach()] + [t.grad for t in leaves])
    for name, got, ref, native in zip(("y", "x", "gates", "fc", "proj"),
                                      outs[0], [y_ref, *g_ref], outs[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(got.numpy(), native.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("impl", ["scatter", "grouped"])
def test_token_zero_gradient_is_its_own_assignments_only(impl):
    """Token 0's gradient is the sum over its own kept assignments of the
    expert's gate-weighted vector-Jacobian product at token 0 (fp32, atol
    1e-6), with unfilled slots in the buffer; and the gather's backward
    reads no unfilled row: a NaN cotangent there leaves every token's
    gradient finite."""
    n_shared = 1 if impl == "grouped" else 0
    x, idx, gates, fc, proj, dy = _dispatch_inputs(n_shared, seed=9)
    Nt, k = idx.shape
    E = fc.shape[0] - n_shared
    cap = _capacity(2.0, Nt, k, E)
    xs = _t(x).requires_grad_()
    if impl == "scatter":
        y = scatter_dispatch(xs, _t(idx).long(), _t(gates), _t(fc),
                             _t(proj), non_linearity="swiglu", capacity=cap)
        keep = []
        for e in idx[0]:     # token 0 is first in every expert's queue
            keep.append((int(e), float(gates[0][list(idx[0]).index(e)])))
    else:
        y = gm.grouped_dispatch(xs, _t(idx).long(), _t(gates), _t(fc),
                                _t(proj), act=lambda h: activate(h, "swiglu"),
                                n_shared=n_shared)
        keep = [(e, 1.0) for e in range(n_shared)] + [
            (int(e) + n_shared, float(g)) for e, g in zip(idx[0], gates[0])]
    y.backward(_t(dy))

    x0 = _t(x[:1]).requires_grad_()
    own = sum(g * mlp_apply(x0, _t(fc[e]), _t(proj[e]), "swiglu")
              for e, g in keep)
    (want,) = torch.autograd.grad((own * _t(dy[:1])).sum(), x0)
    np.testing.assert_allclose(xs.grad[:1].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)

    # the packed buffer's unfilled rows carry a NaN cotangent
    flat_e = np.concatenate([np.repeat(np.arange(n_shared)[None], Nt, 0),
                             idx + n_shared], axis=1).reshape(-1) \
        if impl == "grouped" else idx.reshape(-1)
    flat_e = torch.from_numpy(flat_e.astype(np.int64))
    J = flat_e.shape[0] // Nt
    flat_t = torch.arange(Nt).repeat_interleave(J)
    if impl == "grouped":
        pk = gm._pack_rows(flat_e, flat_t, E + n_shared, gm.CPU_BLOCK_M)[0]
    else:
        order = torch.argsort(flat_e, stable=True)
        se = flat_e[order]
        pos = torch.arange(flat_e.shape[0]) - torch.searchsorted(
            se, torch.arange(E))[se]
        pk = gm.pack(order, torch.where(pos < cap, se * cap + pos, E * cap),
                     flat_t, E * cap)
    assert not pk.filled.all()
    xs = _t(x).requires_grad_()
    rows = gm.gather_rows(xs, pk.row_tok, pk.filled, pk.slot.reshape(Nt, J))
    cot = torch.ones_like(rows).masked_fill(~pk.filled[:, None],
                                            float("nan"))
    rows.backward(cot)
    assert torch.isfinite(xs.grad).all()
    kept = (pk.slot.reshape(Nt, J) < pk.filled.shape[0]).sum(1)
    np.testing.assert_array_equal(
        xs.grad.numpy(), np.broadcast_to(kept.numpy()[:, None], x.shape)
        .astype(np.float32))


ENGINE_KW = dict(TINY, block_size=64)


@pytest.fixture(scope="module")
def engine_models():
    """The reference's MoE model (dense dispatch: the same dropless
    semantics) and the port's grouped one from the same weights and a
    nonzero bias."""
    jm = JLLM(JConfig(**ENGINE_KW), attn_impl="naive")
    x = jnp.zeros((1, 64), jnp.int32)
    key = jax.random.PRNGKey(0)
    var = dict(jm.init({"params": key, "dropout": key}, x, x))
    var = jax.tree_util.tree_map(np.array, jax.device_get(var))
    rng = np.random.default_rng(3)
    for i in range(2):
        var["moe_state"][f"block_{i}"]["moe"]["expert_bias"] = \
            (0.3 * rng.standard_normal(5)).astype(np.float32)
    cfg = LLMConfig(**ENGINE_KW, moe_impl="grouped")
    tm = LLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(var["params"], cfg, var["moe_state"]))
    tm.eval()
    return jm, var, tm, jax.jit(jm.apply, static_argnames="all_logits")


def _margins(japply, var, seq, prompt_len):
    buf = np.zeros((1, 64), np.int32)
    buf[0, :len(seq) - 1] = seq[:-1]
    logits, _, _ = japply(var, jnp.asarray(buf), all_logits=True)
    top2 = np.sort(np.asarray(logits)[0, prompt_len - 1:len(seq) - 1],
                   axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


ENGINE_RUN = dict(n_slots=2, temperature=0.0, min_bucket=8, block_size=8)


def _engine_prompts():
    rng = np.random.default_rng(1)
    return [[int(t) for t in rng.integers(1, 97, n)] for n in (5, 17, 2)]


@pytest.fixture(scope="module")
def engine_ref(engine_models):
    """The reference engine's tokens for `_engine_prompts` and their top-2
    margins, computed once for the wave and chunked cases."""
    jm, var, _, japply = engine_models
    prompts = _engine_prompts()
    ref = JEngine(jm, var, **ENGINE_RUN).run(prompts, 6)
    return ref, [_margins(japply, var, r, len(p))
                 for p, r in zip(prompts, ref)]


@pytest.mark.parametrize("chunk", [0, 16], ids=["wave", "chunked"])
def test_engine_tokens_match_reference_engine(engine_models, engine_ref,
                                              chunk):
    """Greedy tokens of the port's engine (the grouped dispatch, plain
    versions at bm 8: 2 forward calls per layer per decode step and per
    prefill forward) against the reference's engine, compared where the
    reference's top-2 margin exceeds 1e-4; the bias is read, never moved."""
    jm, var, tm, japply = engine_models
    prompts = _engine_prompts()
    kw = ENGINE_RUN
    ref, ref_margins = engine_ref
    bias = [m.expert_bias.clone() for m in tm.moe_layers()]
    forwards = []
    hook = tm.moe_layers()[0].register_forward_hook(
        lambda *a: forwards.append(1))
    gm.reset_counts()
    try:
        eng = DecodeEngine(tm, prefill_chunk=chunk, **kw)
        out = eng.run(prompts, 6)
    finally:
        hook.remove()
    if chunk == 0:
        assert len(forwards) == eng.n_steps + eng.n_admitted
    assert gm.PLAIN_CALLS["grouped_mm_fwd"] == 2 * 2 * len(forwards)
    assert gm.DEGRADED["dense"] == 0
    for b, m in zip(bias, tm.moe_layers()):
        assert torch.equal(b, m.expert_bias)
    for p, r, o, margins in zip(prompts, ref, out, ref_margins):
        assert o[:len(p)] == r[:len(p)]
        for i, mg in enumerate(margins):
            if mg <= 1e-4:
                break
            assert o[len(p) + i] == r[len(p) + i], (i, mg)
