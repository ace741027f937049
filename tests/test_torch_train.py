"""The port's training slice against the reference package, on the CPU:
the chunked and unchunked losses and their gradients, the learning-rate
schedule, the loader's token stream, the CLI's configs, and a 5-step fp32
parameter trajectory against the reference's `make_train_step` from
converted weights on the same batches; then the port's own guarantees —
the anomaly guard's 'skip', bit-identical resume, checkpoint fallback past
a flipped byte, recomputation and dropout determinism. Each test states
its tolerance."""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu import __main__ as jmain
from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.config import TrainConfig as JTrainConfig
from distributed_pytorch_tpu.data.loader import DataLoader as JLoader
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.ops import losses as jlosses
from distributed_pytorch_tpu.train.state import create_train_state as jstate
from distributed_pytorch_tpu.train.state import lr_schedule as jlr
from distributed_pytorch_tpu.train.step import make_train_step as jstep
from distributed_pytorch_tpu_torch import __main__ as tmain
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.data.loader import (DataLoader,
                                                       make_synthetic_bin)
from distributed_pytorch_tpu_torch.ops import losses
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train.loop import check_slice, train
from distributed_pytorch_tpu_torch.train.state import (TrainState,
                                                       build_model,
                                                       lr_schedule,
                                                       make_optimizer)
from distributed_pytorch_tpu_torch.train.step import make_train_step
from torch_threads import one_thread  # noqa: F401

TINY = dict(vocab_size=97, block_size=32, n_embd=64, n_head=4, n_kv_heads=2,
            attn="gqa", n_layer=2, up_dim=96, non_linearity="swiglu",
            pos_emb="rope")


# ---------------------------------------------------------------------------
# losses, schedule, data, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["fused_cross_entropy",
                                "unchunked_cross_entropy"])
def test_losses_match_reference(fn):
    """T=256, V=8192 chunks the fused path (two chunks of 128); targets
    hold ignored -1s. fp32, rtol 1e-5 on the loss and atol 1e-6 on the
    gradients (summation order)."""
    rng = np.random.default_rng(0)
    B, T, C, V = 2, 256, 32, 8192
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    emb = (0.1 * rng.standard_normal((V, C))).astype(np.float32)
    t = rng.integers(0, V, (B, T))
    t[0, :7] = -1
    assert losses._chunk_for(T, V) == 128
    ref, ref_g = jax.value_and_grad(
        lambda a, b: getattr(jlosses, fn)(a, b, jnp.asarray(t)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    loss = getattr(losses, fn)(tx, te, torch.from_numpy(t))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_g[0]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ref_g[1]),
                               atol=1e-6, rtol=0)


def test_lr_schedule_matches_reference():
    """Both compute in fp32: rtol 1e-6 at every step 0 .. max_iters + 5."""
    cfg = dict(learning_rate=6e-4, warmup_steps=7, max_iters=40)
    ref = jlr(JTrainConfig(**cfg))
    got = lr_schedule(TrainConfig(**cfg))
    for s in range(cfg["max_iters"] + 6):
        np.testing.assert_allclose(got(s), float(ref(s)), rtol=1e-6,
                                   err_msg=f"step {s}")


def test_loader_stream_matches_reference(tmp_path):
    """Exactly the reference's numpy-backend batches for steps 0..3."""
    path = make_synthetic_bin(str(tmp_path / "train.bin"), n_tokens=50_000,
                              vocab_size=500)
    ref = JLoader(path, 3, 16, grad_accum=2, seed=11, backend="numpy")
    got = DataLoader(path, 3, 16, grad_accum=2, seed=11)
    for step in range(4):
        rx, ry = ref.next_batch(step=step)
        x, y = got.next_batch(step=step)
        assert x.dtype == torch.int64 and x.shape == (2, 3, 16)
        np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "gpt2_124m", "--attn_impl", "PALLAS", "--batch_size", "8",
     "--total_batch_size_str", "2**14", "--dataset", "synthetic",
     "--act_recomp", "--no-aux_free", "--learning_rate", "1e-3"],
    ["--preset", "gpt2_124m", "--moe", "--n_exp", "8", "--n_shared", "1",
     "--n_act", "3", "--up_dim", "1024", "--moe_impl", "grouped",
     "--attn_impl", "pallas", "--batch_size", "8",
     "--total_batch_size_str", "2**14", "--dataset", "synthetic"],
], ids=["defaults", "flagship", "flagship_moe"])
def test_cli_configs_match_reference(argv):
    jm, jt = jmain.parse_train_argv(argv)
    tm, tt = tmain.parse_train_argv(argv)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

def _batches(n, accum, B, T, V, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, (accum, B, T)),
             rng.integers(0, V, (accum, B, T))) for _ in range(n)]


def _params_close(model, jparams, cfg, atol):
    ref = params_from_jax(jax.device_get(jparams), cfg)
    sd = model.state_dict()
    for name, r in ref.items():
        np.testing.assert_allclose(sd[name].numpy(), r.numpy(), atol=atol,
                                   rtol=0, err_msg=name)


def test_five_step_trajectory_matches_reference():
    """5 AdamW steps, accum 2, clipping active (grad_clip 0.05 under a
    grad norm near 1), dropout 0, from the reference's init converted into
    the port's fp32-master model, on the same batches. fp32, atol 1e-4 on
    every parameter after every step (AdamW's first steps are sign-like,
    so near-zero gradient elements amplify float noise toward lr)."""
    mc = JConfig(**TINY)
    kw = dict(batch_size=2, total_batch_size=2 * 2 * 32, max_iters=10,
              warmup_steps=2, learning_rate=1e-3, grad_clip=0.05,
              compute_dtype="float32", seed=5)
    jtc = JTrainConfig(**kw)
    jmodel, tx, js, _ = jstate(mc, jtc, None)
    jparams0 = jax.tree_util.tree_map(np.array, jax.device_get(js.params))
    jtrain = jstep(jmodel, tx, mc, jtc, None, None)

    cfg, tc = LLMConfig(**TINY), TrainConfig(**kw, platform="cpu")
    model = build_model(cfg, tc, device="cpu")
    model.load_state_dict(params_from_jax(jparams0, cfg))
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model, tc))
    step = make_train_step(tc)
    for x, y in _batches(5, 2, 2, 32, 97):
        js, jm = jtrain(js, jnp.asarray(x, jnp.int32),
                        jnp.asarray(y, jnp.int32))
        m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert float(jm["grad_norm"]) > tc.grad_clip      # clipping active
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        _params_close(model, js.params, cfg, atol=1e-4)


# widths of >= 128 on both axes, so Adafactor factors the embedding and
# the attention/MLP matrices (optax's min_dim_size_to_factor)
WIDE = dict(TINY, vocab_size=160, n_embd=128, up_dim=256)


def _flips(model, jparams, cfg, atol):
    """Entries farther than atol from the reference (all parameters)."""
    ref = params_from_jax(jax.device_get(jparams), cfg)
    sd = model.state_dict()
    return sum(int(((sd[k] - r).abs() > atol).sum()) for k, r in ref.items())


@pytest.mark.parametrize("optimizer,lr,wd", [("lion", 1e-4, 10.0),
                                             ("adafactor", 1e-2, 0.1)])
def test_five_step_optimizer_trajectory_matches_reference(optimizer, lr, wd):
    """5 steps of Lion or Adafactor (optax's rules, after the global-norm
    clip, which is active), accum 2, from the reference's init converted
    into the port's fp32-master model, on the same batches. Adafactor:
    fp32, atol 1e-5 on every parameter after every step. Lion's update is
    sign(0.1 g + 0.9 m): an entry whose argument lies within float noise
    of 0 can take the other sign in the other framework and then sits
    2 lr = 2e-4 away; these inputs flip no entry (counted: 0 of the
    model's 317,440 entries farther than 1e-5 after any step). The weight
    decay is large enough to show: Lion's lr x wd = 1e-3 moves a weight of
    |p| ~0.02 by ~2e-5 a step (2x the limit), and decaying the norm scales
    (p = 1) would move them by 1e-3; Adafactor's wd x lr = 1e-3 likewise."""
    mc = JConfig(**WIDE)
    kw = dict(batch_size=2, total_batch_size=2 * 2 * 32, max_iters=10,
              warmup_steps=2, learning_rate=lr, grad_clip=0.05,
              compute_dtype="float32", seed=5, optimizer=optimizer,
              weight_decay=wd)
    jtc = JTrainConfig(**kw)
    jmodel, tx, js, _ = jstate(mc, jtc, None)
    jparams0 = jax.tree_util.tree_map(np.array, jax.device_get(js.params))
    jtrain = jstep(jmodel, tx, mc, jtc, None, None)

    cfg, tc = LLMConfig(**WIDE), TrainConfig(**kw, platform="cpu")
    model = build_model(cfg, tc, device="cpu")
    model.load_state_dict(params_from_jax(jparams0, cfg))
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model, tc))
    step = make_train_step(tc)
    for x, y in _batches(5, 2, 2, 32, 160, seed=3):
        js, jm = jtrain(js, jnp.asarray(x, jnp.int32),
                        jnp.asarray(y, jnp.int32))
        m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert float(jm["grad_norm"]) > tc.grad_clip      # clipping active
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert _flips(model, js.params, cfg, 1e-5) == 0


def test_converted_tree_loads_into_fp32_master_model():
    """A converted reference tree round-trips into the training model
    (fp32 masters): every tensor equal, and the loss with targets equal to
    the reference's (fp32, rtol 1e-5)."""
    jm = JLLM(JConfig(**TINY), attn_impl="naive")
    x = np.random.default_rng(1).integers(0, 97, (2, 32))
    y = np.random.default_rng(2).integers(0, 97, (2, 32))
    key = jax.random.PRNGKey(3)
    var = jm.init({"params": key, "dropout": key}, jnp.asarray(x),
                  jnp.asarray(y))
    _, ref, _ = jm.apply(var, jnp.asarray(x), jnp.asarray(y))
    cfg = LLMConfig(**TINY)
    model = build_model(cfg, TrainConfig(compute_dtype="float32"), "cpu")
    sd = params_from_jax(jax.device_get(var["params"]), cfg)
    model.load_state_dict(sd)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name
    _, loss = model(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# the port's own guarantees
# ---------------------------------------------------------------------------

def _tiny_run(tmp_path, monkeypatch, **kw):
    tmp_path.mkdir(exist_ok=True)
    monkeypatch.chdir(tmp_path)
    base = dict(dataset="synthetic", data_dir=str(tmp_path / "data"),
                batch_size=2, total_batch_size=2 * 2 * 32, warmup_steps=2,
                platform="cpu", compute_dtype="float32", log_interval=100,
                save_stats=False)
    base.update(kw)
    model_kw = {k: base.pop(k) for k in list(base) if k in ("dropout",)}
    return train(LLMConfig(**TINY, **model_kw), TrainConfig(**base),
                 log=lambda s: None)


def _weights(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_anomaly_skip_withholds_the_update(tmp_path, monkeypatch):
    """TRAIN_POISON_IT=1 under anomaly 'skip': iteration 1 is nonfinite,
    its update is withheld from the weights and the AdamW moments, the
    step still advances, and the run goes on finite."""
    monkeypatch.setenv("TRAIN_POISON_IT", "1")
    seen = []
    from distributed_pytorch_tpu_torch.train import step as step_mod
    orig = step_mod.make_train_step

    def spy(train_cfg):
        fn = orig(train_cfg)

        def wrapped(state, x, y):
            before = (_weights(state), {k: v["exp_avg"].clone() for k, v in
                                        state.optimizer.state.items()})
            m = fn(state, x, y)
            seen.append((before, _weights(state), {
                k: v["exp_avg"].clone()
                for k, v in state.optimizer.state.items()}, m, state.step))
            return m
        return wrapped

    monkeypatch.setattr("distributed_pytorch_tpu_torch.train.loop."
                        "make_train_step", spy)
    stats = _tiny_run(tmp_path, monkeypatch, max_iters=3, anomaly="skip")
    assert [int(s[3]["nonfinite"]) for s in seen] == [0, 1, 0, 0]
    (w0, mom0), w1, mom1, m, step_after = seen[1]
    assert step_after == 2 and float(m["update_skipped"]) == 1.0
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert all(torch.equal(mom0[k], mom1[k]) for k in mom0)
    assert not all(torch.equal(seen[2][0][0][k], seen[2][1][k])
                   for k in w0)                      # step 2 updates
    assert stats["n_anomalies"] == 1 and np.isfinite(stats["final_loss"])
    assert stats["state"].updates == 3 and stats["state"].step == 4


def test_resume_is_bit_identical(tmp_path, monkeypatch):
    """Iterations 0..5 straight, against 0..2, a checkpoint, a restore
    into a fresh state and 3..5: every weight equal bit for bit (CPU)."""
    straight = _weights(_tiny_run(tmp_path / "a", monkeypatch, max_iters=5,
                                  dropout=0.1)["state"])
    _tiny_run(tmp_path / "b", monkeypatch, max_iters=2, ckpt_interval=2,
              dropout=0.1)
    resumed = _tiny_run(tmp_path / "b", monkeypatch, max_iters=5,
                        resume=True, dropout=0.1)["state"]
    assert resumed.step == 6
    got = _weights(resumed)
    assert all(torch.equal(straight[k], got[k]) for k in straight)


def test_restore_latest_falls_back_past_a_flipped_byte(tmp_path,
                                                       monkeypatch):
    state = _tiny_run(tmp_path / "r", monkeypatch, max_iters=4,
                      ckpt_interval=2, keep_ckpts=3)["state"]
    root = str(tmp_path / "r" / "checkpoints" / "llm_model")
    assert [os.path.basename(p) for _, p in ckpt._step_dirs(root)] == \
        ["step_2", "step_4"]
    assert ckpt.verify_manifest(os.path.join(root, "step_4")) == []
    f = os.path.join(root, "step_4", "state.pt")
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    assert ckpt.verify_manifest(os.path.join(root, "step_4"))
    assert ckpt.latest_step_dir(root).endswith("step_4")  # sizes still fit
    restored, path, skipped = ckpt.restore_latest(root, state)
    assert path.endswith("step_2") and len(skipped) == 1
    assert restored.step == 3
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore_checkpoint(os.path.join(root, "step_4"), state)
    mc, tc, step = ckpt.load_configs(os.path.join(root, "step_2"))
    assert mc == LLMConfig(**TINY) and step == 3


@pytest.mark.parametrize("policy", ["block", "attn"])
def test_recompute_and_dropout_keep_the_gradients(policy):
    """With dropout 0.1, recomputing blocks or the attention sublayer in
    the backward gives the same loss and gradients as storing them: every
    dropout mask is regenerated from its seed (fp32, exact)."""
    cfg = LLMConfig(**TINY, dropout=0.1)
    tc = TrainConfig(compute_dtype="float32")
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 97, (2, 32)))
    grads = []
    for recomp in (False, True):
        c = dataclasses.replace(cfg, act_recomp=recomp,
                                act_recomp_policy=policy)
        torch.manual_seed(0)
        model = build_model(c, tc, "cpu")
        g = torch.Generator().manual_seed(0)
        model.init_weights(g)
        model.train()
        _, loss = model(x, x.roll(-1, 1), dropout_seed=77)
        loss.backward()
        grads.append([loss.detach()] + [p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with pytest.raises(ValueError, match="dropout_seed"):
        model(x, x)


@pytest.mark.parametrize("field,value", [
    ("parallelism", "tp"), ("parallelism", "sp"), ("parallelism", "pp"),
    ("parallelism", "ep"), ("attn_impl", "xla"), ("attn_impl", "ring")])
def test_later_slices_raise(field, value):
    """What later slices bring raises NotImplementedError; 'tp' runs since
    tensor parallelism came (tests/test_torch_parallel_tp.py), 'sp' and
    attn_impl 'ring' since sequence parallelism came
    (tests/test_torch_parallel_sp.py), 'ep' since expert parallelism came
    (tests/test_torch_parallel_ep.py), and beside pp_size 2 they raise
    so; 'pp' since pipeline parallelism came
    (tests/test_torch_parallel_pp.py), and beside tp_size 2 it raises."""
    mc, tc = LLMConfig(**TINY), TrainConfig(platform="cpu")
    tc = dataclasses.replace(tc, **{field: value})
    if (field, value) in (("parallelism", "tp"), ("parallelism", "sp"),
                          ("parallelism", "ep"), ("attn_impl", "ring"),
                          ("parallelism", "pp")):
        check_slice(mc, tc)
        tc = dataclasses.replace(
            tc, **({"tp_size": 2} if value == "pp" else {"pp_size": 2}))
    with pytest.raises(NotImplementedError, match="slice|XLA"):
        check_slice(mc, tc)


def test_sigterm_saves_and_resume_finishes_the_stream(tmp_path,
                                                      monkeypatch):
    """SIGTERM sent to the process from the `log` callback after iteration
    2 (log_interval 1): the loop stops at the top of iteration 3 with a
    verified `step_3` and `stopped_early`, without the final save; then
    `--resume` runs 3..5. The losses of both runs together equal an
    uninterrupted run's, and so do the final weights, bit for bit (fp32,
    CPU)."""
    import signal
    straight = _tiny_run(tmp_path / "a", monkeypatch, max_iters=5,
                         log_interval=1)
    sent = []

    def log(line):
        if line.startswith("iter     2 |") and not sent:
            sent.append(line)
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.chdir(tmp_path)
    base = dict(dataset="synthetic", data_dir=str(tmp_path / "b" / "data"),
                batch_size=2, total_batch_size=2 * 2 * 32, warmup_steps=2,
                platform="cpu", compute_dtype="float32", log_interval=1,
                save_stats=False, max_iters=5, save_model=True)
    (tmp_path / "b").mkdir()
    monkeypatch.chdir(tmp_path / "b")
    first = train(LLMConfig(**TINY), TrainConfig(**base), log=log)
    assert sent and first["stopped_early"]
    assert first["state"].step == 3 and len(first["train_losses"]) == 3
    root = os.path.join("checkpoints", "llm_model")
    assert [os.path.basename(p) for _, p in ckpt._step_dirs(root)] == \
        ["step_3"]
    assert ckpt.verify_manifest(os.path.join(root, "step_3")) == []
    resumed = train(LLMConfig(**TINY), TrainConfig(**base, resume=True),
                    log=lambda s: None)
    assert not resumed["stopped_early"] and resumed["state"].step == 6
    assert first["train_losses"] + resumed["train_losses"] == \
        straight["train_losses"]
    want, got = _weights(straight["state"]), _weights(resumed["state"])
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_eval_through_the_pallas_loss(tmp_path, monkeypatch):
    """`--loss_impl pallas --eval` on the CPU: training and eval losses go
    through the fused CE functions (their plain versions: forward,
    dx and dW once per micro-step, the forward alone per eval batch), never
    the chunked path, and equal a 'fused' run's to 1e-5 (fp32)."""
    from distributed_pytorch_tpu_torch.ops import fused_ce
    runs = {}
    for impl in ("pallas", "fused"):
        fused_ce.reset_counts()
        tmp = tmp_path / impl
        tmp.mkdir()
        monkeypatch.chdir(tmp)
        runs[impl] = train(
            LLMConfig(**WIDE, loss_impl=impl),
            TrainConfig(dataset="synthetic", data_dir=str(tmp / "data"),
                        batch_size=2, total_batch_size=2 * 2 * 32,
                        warmup_steps=2, platform="cpu",
                        compute_dtype="float32", log_interval=100,
                        save_stats=False, max_iters=3, eval=True,
                        eval_interval=2, eval_iters=2),
            log=lambda s: None)
        if impl == "pallas":
            # 4 iterations x 2 micro-steps; evals at 0 and 2, 2 splits x 2
            assert fused_ce.PLAIN_CALLS == {
                "fused_ce_fwd": 8 + 2 * 2 * 2, "fused_ce_bwd_dx": 8,
                "fused_ce_bwd_dw": 8}
            assert fused_ce.DEGRADED["chunked"] == 0
    p, f = runs["pallas"], runs["fused"]
    assert [i for i, _ in p["val_losses"]] == [0, 2]
    np.testing.assert_allclose(p["train_losses"], f["train_losses"],
                               rtol=1e-5)
    np.testing.assert_allclose([v for _, v in p["val_losses"]],
                               [v for _, v in f["val_losses"]], rtol=1e-5)


# ---------------------------------------------------------------------------
# MoE: the CLI on the CPU, the FLOP count, Adafactor on stacked experts
# ---------------------------------------------------------------------------

def test_cli_trains_a_grouped_moe_model_on_the_cpu(tmp_path, monkeypatch,
                                                   capsys):
    """`python -m distributed_pytorch_tpu_torch --platform cpu --moe ...
    --moe_impl grouped`: the loss is finite, each log line carries
    `moe_drop` (0.00% for the dropless grouped dispatch), and the grouped
    functions ran their plain versions 3 (forward: fc, proj, and proj's
    recompute for the gate cotangent) and 2 (dx, dW) times per layer per
    micro-step, with no degraded layer."""
    from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
    monkeypatch.chdir(tmp_path)
    argv = ["--platform", "cpu", "--compute_dtype", "float32",
            "--dataset", "synthetic", "--data_dir", str(tmp_path / "d"),
            "--vocab_size", "97", "--block_size", "32", "--n_embd", "32",
            "--n_head", "4", "--n_kv_heads", "2", "--n_layer", "2",
            "--up_dim", "48", "--moe", "--n_exp", "6", "--n_shared", "1",
            "--n_act", "3", "--moe_impl", "grouped", "--batch_size", "2",
            "--total_batch_size_str", "2*2*32", "--max_iters", "2",
            "--warmup_steps", "1", "--log_interval", "1", "--no-save_stats"]
    gm.reset_counts()
    tmain.main(argv)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("iter ")]
    assert len(lines) == 3 and all(ln.endswith("| moe_drop  0.00%") for ln in lines)
    micro = 2 * 3 * 2                       # layers x iterations x accum
    assert gm.PLAIN_CALLS == {"grouped_mm_fwd": 3 * micro,
                              "grouped_mm_bwd_dx": 2 * micro,
                              "grouped_mm_bwd_dw": 2 * micro}
    assert gm.DEGRADED["dense"] == 0
    assert "params:" in out and "active" in out


@pytest.mark.parametrize("up_dim", [96, 100])
def test_train_stats_count_dense_degrades(tmp_path, monkeypatch, up_dim):
    """`stats["moe_degraded_dense"]` counts the MoE layer forwards of the
    run that asked for 'grouped' and took 'dense': 0 where the gate takes
    the widths, every layer forward (2 layers x 2 iterations x 2
    micro-steps) where it refuses them (up_dim 100 is not a multiple of
    8), with one warning per layer."""
    monkeypatch.chdir(tmp_path)
    model_cfg = LLMConfig(**dict(TINY, up_dim=up_dim), moe=True, n_exp=4,
                          n_shared=1, n_act=2, moe_impl="grouped")
    train_cfg = TrainConfig(
        dataset="synthetic", data_dir=str(tmp_path / "data"), batch_size=2,
        total_batch_size=2 * 2 * 32, max_iters=1, warmup_steps=1,
        platform="cpu", compute_dtype="float32", log_interval=100,
        save_stats=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stats = train(model_cfg, train_cfg, log=lambda s: None)
    refused = up_dim % 8 != 0
    assert stats["moe_degraded_dense"] == (2 * 2 * 2 if refused else 0)
    assert sum("'dense' dispatch" in str(w.message)
               for w in caught) == (2 if refused else 0)


@pytest.mark.parametrize("impl", ["dense", "scatter", "grouped"])
@pytest.mark.parametrize("recomp", [None, "block", "attn"])
def test_moe_flop_count_matches_reference(impl, recomp):
    """The MFU numerator of the flagship MoE (8 experts, 1 shared, top 2
    routed, up_dim 1024) equals the reference's `step_flops`, and the
    over-compute factor its `moe_overcompute_factor`, exactly."""
    from distributed_pytorch_tpu.config import flagship_gpt124m as jflag
    from distributed_pytorch_tpu.train import metrics as jmetrics

    from distributed_pytorch_tpu_torch.config import flagship_gpt124m
    from distributed_pytorch_tpu_torch.train import metrics
    kw = dict(moe=True, n_exp=8, n_shared=1, n_act=3, up_dim=1024,
              moe_impl=impl, act_recomp=recomp is not None,
              act_recomp_policy=recomp or "block")
    jc, tc = jflag(**kw), flagship_gpt124m(**kw)
    assert metrics.step_flops(tc, 2 ** 14, 1024) == \
        jmetrics.step_flops(jc, 2 ** 14, 1024)
    assert metrics.moe_overcompute_factor(tc) == \
        jmetrics.moe_overcompute_factor(jc)
    assert metrics.matmul_params_per_token(tc) > \
        metrics.matmul_params_per_token(flagship_gpt124m())


def test_adafactor_on_stacked_expert_weights_matches_optax():
    """3 Adafactor steps (lr 1e-2, weight decay rate 1e-3) on the
    flagship MoE's two expert stacks, (8, 768, 2048) and (8, 1024, 768),
    against optax.adafactor on the same gradients: the second moment
    factors over the two largest axes, and the row statistic is normalised
    over its own axis for each expert (optax's row_col_mean), not over the
    whole stack. fp32, atol 1e-5 on every weight after every step."""
    import optax

    from distributed_pytorch_tpu_torch.train.state import Adafactor
    rng = np.random.default_rng(0)
    shapes = [(8, 768, 2048), (8, 1024, 768)]
    # experts of different gradient scales, so a stack-wide normalisation
    # would show
    scale = [np.geomspace(0.1, 10, s[0]).astype(np.float32)[:, None, None]
             for s in shapes]
    p0 = [(0.02 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s).astype(np.float32) * c)
              for s, c in zip(shapes, scale)] for _ in range(3)]
    tx = optax.adafactor(learning_rate=1e-2, weight_decay_rate=1e-3)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt = Adafactor([{"params": tp, "weight_decay": 1e-3}], lr=1e-2)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        for p, r in zip(tp, jp):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5,
                                       rtol=0)
