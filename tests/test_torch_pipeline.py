"""Pipeline parallelism (models/pipeline.py) in one process against the
reference package's pp model on the CPU: the schedule tables, the
schedule choice, and S stages driven over the in-process transport
(`LocalTransport`) against the reference's `LLM` with pp_stages S on the
same weights (its stacked tree through `params_from_jax`) and the same
tokens, dense and MoE; then a stage's decode call, and a pp checkpoint
restored into the single model and sampled. Each test states its
tolerance."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.models import pipeline as jpipe
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu_torch import sample
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.data.loader import data_rows
from distributed_pytorch_tpu_torch.models import pipeline as pipe
from distributed_pytorch_tpu_torch.models.generate import generate
from distributed_pytorch_tpu_torch.models.gpt import LLM
from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                          build_engine)
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train.state import (
    create_pipeline_states, create_train_state)
from distributed_pytorch_tpu_torch.train.step import make_train_step
from torch_threads import one_thread  # noqa: F401

# the reference's tests/test_pipeline.py config
KW = dict(vocab_size=96, block_size=32, n_embd=32, n_head=4, n_kv_heads=2,
          n_layer=4, up_dim=48, pos_emb="rope", attn="gqa",
          non_linearity="swiglu")
MOE_KW = dict(moe=True, n_exp=4, n_shared=1, n_act=2, alpha=1e-2,
              gamma=0.1, coeff=0.01)


def _tokens():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 96, (8, 16)).astype(np.int32),
            rng.integers(0, 96, (8, 16)).astype(np.int32))


@pytest.mark.parametrize("S,vpp,M", [(2, 1, 1), (2, 2, 8), (2, 2, 3),
                                     (4, 1, 6), (4, 3, 8), (3, 2, 5),
                                     (4, 2, 1)])
def test_schedule_tables_equal_the_reference(S, vpp, M):
    """The tick table and the timeline (rows and bubble summary) are the
    reference's exactly, M divisible by S or not."""
    a, b = pipe._build_1f1b_schedule(S, vpp, M), \
        jpipe._build_1f1b_schedule(S, vpp, M)
    for f in dataclasses.fields(a):
        assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), \
            f.name
    assert pipe.schedule_timeline(S, vpp, M) == \
        jpipe.schedule_timeline(S, vpp, M)


def test_stack_and_unstack_equal_the_reference():
    """`stack_block_params` / `unstack_block_params` on a reference param
    tree (numpy) give the reference's trees."""
    idx, tgt = _tokens()
    params = jax.device_get(JLLM(JConfig(**KW)).init(
        jax.random.PRNGKey(0), idx, tgt)["params"])
    got, want = pipe.stack_block_params(params, 4), \
        jpipe.stack_block_params(params, 4)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = pipe.unstack_block_params(got, 4)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B,dp,S", [(8, 1, 2), (6, 1, 4), (4, 2, 2),
                                    (8, 2, 4), (2, 2, 2), (3, 2, 4)])
def test_microbatch_count_and_data_rows(B, dp, S):
    """The auto microbatch count is the reference's on the global batch of
    B dp rows (`run_pipeline`: min(B dp, 2 S) shrunk until it divides B
    dp) wherever it divides a data rank's B. There data rank r's m-th
    microbatch holds its share of the reference's m-th (rows [m b, (m +
    1) b) of the global micro-batch) and the ranks' rows are the batch
    once. Elsewhere a dense model runs the most microbatches that divide
    B, and an MoE, whose routing statistics are a microbatch's, is
    refused."""
    ref = min(B * dp, 2 * S)
    while (B * dp) % ref:
        ref -= 1
    dense = LLMConfig(**KW, pp_stages=S)
    moe = LLMConfig(**KW, **MOE_KW, pp_stages=S)
    if B % ref:
        with pytest.raises(ValueError, match="routing statistics"):
            pipe.n_microbatches(moe, B, dp)
        assert pipe.n_microbatches(dense, B, dp) == max(
            d for d in range(1, min(B, 2 * S) + 1) if B % d == 0)
        return
    assert pipe.n_microbatches(dense, B, dp) == ref == \
        pipe.n_microbatches(moe, B, dp)
    rows = [data_rows(B, dp, r, ref) for r in range(dp)]
    assert sorted(np.concatenate(rows).tolist()) == list(range(B * dp))
    b, share = B * dp // ref, B // ref
    for r in range(dp):
        for m in range(ref):
            mine = rows[r][m * share:(m + 1) * share]
            assert ((mine >= m * b) & (mine < (m + 1) * b)).all()
    assert (data_rows(B, dp, dp - 1) == np.arange(B) + (dp - 1) * B).all()


@pytest.mark.parametrize("extra,env", [
    ({}, {}), (dict(pp_vpp=1), {}), (dict(pp_schedule="carry"), {}),
    (dict(**MOE_KW), {}), (dict(pp_stages=4), {}),
    (dict(n_layer=6, pp_stages=2), {"PP_VPP": "2"}),
    ({}, {"PP_SCHEDULE": "carry"}), (dict(pp_schedule="1f1b"), {}),
    (dict(pp_schedule="1f1b", **MOE_KW), {}),
    (dict(n_layer=6, pp_stages=2, pp_schedule="1f1b"), {"PP_VPP": "2"}),
    ({}, {"PP_SCHEDULE": "zigzag"})])
def test_resolve_schedule_is_the_reference_choice(extra, env, monkeypatch):
    """`resolve_vpp` and `resolve_schedule` pick what the reference
    picks, knobs included, and refuse (ValueError) where it refuses."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(dict(KW, pp_stages=2), **extra)
    got, want = [], []
    for mod, cls, out in ((pipe, LLMConfig, got), (jpipe, JConfig, want)):
        try:
            cfg = cls(**kw)
            out += [mod.resolve_vpp(cfg), mod.resolve_schedule(cfg)]
        except ValueError as e:
            out.append(("raises", str(e)))
    assert got == want


def _reference(kw, S, M, tokens, moe_state=False, **extra):
    """The reference's loop init restacked for its pp model, and the pp
    model's (loss, gradients in the port's layout, updated moe_state or
    None) on `tokens`, training-mode for an MoE."""
    idx, tgt = tokens
    loop = JLLM(JConfig(**kw))
    variables = loop.init(jax.random.PRNGKey(0), idx, tgt)
    pp_cfg = JConfig(**kw, pp_stages=S, pp_microbatches=M, **extra)
    params = jpipe.stack_block_params(variables["params"], kw["n_layer"])
    state = jpipe.stack_block_params(variables["moe_state"], kw["n_layer"]) \
        if "moe_state" in variables else {}
    model = JLLM(pp_cfg)

    def loss_fn(p):
        if not moe_state:
            return model.apply({"params": p}, idx, tgt)[1], None
        (_, loss, _), upd = model.apply(
            {"params": p, **({"moe_state": state} if state else {})}, idx,
            tgt, deterministic=False, mutable=["moe_state"],
            rngs={"dropout": jax.random.PRNGKey(3)})
        return loss, upd

    (loss, upd), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    port_cfg = LLMConfig(**kw, pp_stages=S, pp_microbatches=M, **extra)
    init = params_from_jax(jax.device_get(params), port_cfg,
                           jax.device_get(state) if state else None)
    grads = params_from_jax(jax.device_get(g), port_cfg)
    new_state = None
    if upd is not None and upd.get("moe_state"):
        new_state = params_from_jax(jax.device_get(params), port_cfg,
                                    jax.device_get(upd["moe_state"]))
    return port_cfg, init, float(loss), grads, new_state


def _port(cfg, init, tokens, train=False):
    """S in-process stages from the whole state dict `init`: the
    pipeline's loss (the last stage's plus the aux over n_layer), the
    gradients and the state dicts after the pass."""
    models = {}
    for s in range(cfg.pp_stages):
        m = LLM(cfg, device="cpu", stage=s)
        m.load_state_dict(pipe.stage_state_dict(init, cfg, s))
        m.train(train)
        models[s] = m
    p = pipe.Pipeline(cfg, models, pipe.LocalTransport())
    idx, tgt = (torch.from_numpy(t).long() for t in tokens)
    out = p.run(idx, tgt)
    p.tie_grads()
    loss = float(out["main"]) + (0.0 if out["aux"] is None
                                 else float(out["aux"]) / cfg.n_layer)
    grads, sd = {}, {}
    for m in models.values():
        grads.update({n: q.grad for n, q in m.named_parameters()})
        sd.update(m.state_dict())
    return loss, grads, sd


def _assert_grads(grads, want, rtol, atol):
    assert set(grads) == set(k for k in want
                             if not k.endswith(("expert_bias",
                                                "dropped_frac")))
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=rtol,
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize("S,schedule,vpp,M,recomp", [
    (2, "1f1b", 1, 2, None), (2, "1f1b", 2, 8, None),
    (2, "1f1b", 2, 1, "attn"), (2, "carry", 0, 8, None),
    (2, "carry", 0, 2, "block"), (4, "1f1b", 1, 8, "block")])
def test_pp_loss_and_gradients_match_reference(S, schedule, vpp, M,
                                               recomp):
    """S stages over the in-process transport against the reference's pp
    model on the same weights: the loss within rtol 1e-5, every gradient
    (the tied embedding's summed over the first and last stage) within
    rtol 5e-4 / atol 1e-5, the bound of the reference's own
    `test_pp_gradients_match_loop`. 1f1b at vpp 1 and 2, carry, M 1, 2
    and 8, act_recomp 'attn' and 'block'."""
    extra = dict(pp_schedule=schedule, pp_vpp=vpp)
    if recomp:
        extra.update(act_recomp=True, act_recomp_policy=recomp)
    tokens = _tokens()
    cfg, init, loss, grads, _ = _reference(KW, S, M, tokens, **extra)
    assert pipe.resolve_schedule(cfg) == schedule
    got, got_grads, _ = _port(cfg, init, tokens)
    np.testing.assert_allclose(got, loss, rtol=1e-5)
    _assert_grads(got_grads, grads, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("aux_free,M,recomp", [(True, 2, None),
                                              (False, 2, None),
                                              (True, 2, "block")])
def test_pp_moe_matches_reference(aux_free, M, recomp):
    """The MoE under 'carry' at two layers, one a stage (grouped here on
    the plain versions, dense in the reference, which degrades 'grouped'
    under pp), training mode: the loss within rtol 1e-6, every layer's
    expert_bias after the pass within atol 1e-6 (the bias commits once a
    (layer, microbatch), its step scaled by 1/M), and the gradients within
    rtol 5e-4 / atol 1e-6. Under 'block' act_recomp a block's backward
    recomputes its forward after the later microbatch moved the bias, and
    must route with the bias its own microbatch used."""
    kw = dict(KW, **MOE_KW, aux_free=aux_free, moe_impl="grouped",
              n_layer=2)
    extra = dict(act_recomp=True, act_recomp_policy=recomp) if recomp \
        else {}
    tokens = _tokens()
    cfg, init, loss, grads, new_state = _reference(kw, 2, M, tokens,
                                                   moe_state=True, **extra)
    assert pipe.resolve_schedule(cfg) == "carry"
    got, got_grads, sd = _port(cfg, init, tokens, train=True)
    np.testing.assert_allclose(got, loss, rtol=1e-6)
    _assert_grads(got_grads, grads, rtol=5e-4, atol=1e-6)
    if aux_free:
        for i in range(kw["n_layer"]):
            key = f"blocks.{i}.moe.expert_bias"
            np.testing.assert_allclose(sd[key].numpy(),
                                       new_state[key].numpy(), atol=1e-6,
                                       err_msg=key)
            assert not torch.equal(sd[key], init[key])


def test_stage_decode_raises():
    """A stage refuses KV-cached decoding, as the reference's pp model
    does, and any call of `forward`; a stage without its blocks' owner
    index is refused too."""
    cfg = LLMConfig(**KW, pp_stages=2)
    stage = LLM(cfg, device="cpu", stage=0)
    with pytest.raises(ValueError, match="pp_stages=1"):
        generate(stage, torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="Pipeline.run"):
        stage(torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="stage="):
        LLM(cfg, device="cpu")
    assert sorted(pipe.stage_layers(cfg, 0) + pipe.stage_layers(cfg, 1)) \
        == list(range(KW["n_layer"]))


def test_pp_checkpoint_round_trip(tmp_path, monkeypatch):
    """Two steps of an in-process pp run (S 2, vpp 2, AdamW), saved: the
    step dir holds the single model's tensors and moments; restored into
    'single' they equal the stages' (the moments by name), restored into
    a fresh pipeline they equal them again, and `sample` decodes the
    checkpoint (pp_stages=1) to the tokens the restored single model
    generates, and `serve --ckpt` builds its engine on those weights."""
    monkeypatch.chdir(tmp_path)
    cfg = LLMConfig(**KW, pp_stages=2, pp_vpp=2)
    tc = TrainConfig(batch_size=4, total_batch_size=4 * 16, learning_rate=
                     1e-3, warmup_steps=1, compute_dtype="float32")
    states = create_pipeline_states(cfg, tc, "cpu")
    step = make_train_step(tc)
    rng = np.random.default_rng(0)
    for _ in range(2):
        x, y = (torch.from_numpy(rng.integers(0, 96, (1, 4, 16)))
                for _ in range(2))
        step(states, x, y)
    path = ckpt.save_checkpoint(str(tmp_path / "run" / "step_2"), states[0],
                                cfg, tc)
    assert ckpt.verify_manifest(path) == []
    model_sd, opt_sd = states[0].model.pipe.full_state_dicts()

    single = create_train_state(dataclasses.replace(cfg, pp_stages=1), tc,
                                "cpu")
    ckpt.restore_checkpoint(path, single)
    assert single.step == 2 and single.updates == 2
    for k, v in single.model.state_dict().items():
        assert torch.equal(v, model_sd[k]), k
    names = {p: n for n, p in single.model.named_parameters()}
    for p, st in single.optimizer.state.items():
        i = opt_sd_index(opt_sd, cfg, names[p])
        assert torch.equal(st["exp_avg"], opt_sd["state"][i]["exp_avg"])

    again = create_pipeline_states(cfg, tc, "cpu")
    ckpt.restore_checkpoint(path, again[0])
    for a, b in zip(states, again):
        for (n, p), (_, q) in zip(a.model.named_parameters(),
                                  b.model.named_parameters()):
            assert torch.equal(p, q), n
            assert torch.equal(a.optimizer.state[p]["exp_avg_sq"],
                               b.optimizer.state[q]["exp_avg_sq"]), n

    prompt = [5, 6, 7]
    got = sample.main(["--ckpt", str(tmp_path / "run"), "--cpu",
                       "--prompt", ",".join(map(str, prompt)),
                       "--max_new_tokens", "4", "--temperature", "0"])
    want = generate(single.model.eval(), torch.tensor([prompt]), 4,
                    temperature=0.0)
    assert got[0] == want[0].tolist()
    eng, _, version, _ = build_engine(build_args(
        ["--ckpt", str(tmp_path / "run"), "--cpu", "--dtype", "float32",
         "--temperature", "0", "--port", "0", "--slots", "1"]))
    assert eng.model.config.pp_stages == 1 and version.startswith("step_2")
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, model_sd[k]), k


def opt_sd_index(opt_sd, cfg, name):
    """The single layout's optimizer index of parameter `name`."""
    return pipe.single_param_names(cfg)[1].index(name)
