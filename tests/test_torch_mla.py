"""The port's MLA (models/attention.py `NaiveMLA`, `FullMLA`) against the
reference package's on the CPU, from the same numpy-seeded inputs and the
reference's weights through `params_from_jax`: the layer uncached and over
contiguous and paged latent caches, the materialized (training) forward
against the absorbed (cached) one, a tiny model's logits, loss and
gradients with the flash route ('pallas': the kernels' plain versions on
the CPU) and the naive one, with and without MoE, a 5-step AdamW
trajectory (and 'attn' recomputation leaving it as it is), greedy
`generate` and engine tokens (wave, chunked, prefix reuse, forced
preemption), weight-only int8 teacher-forced logits against the
reference's store, and the parameter and FLOP counts. NaiveMLA runs with
learned positions, FullMLA with RoPE (head size 16, rope head 16, so the
flash route sees q_c | q_r at head size 32). fp32; each test states its
tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.config import TrainConfig as JTrainConfig
from distributed_pytorch_tpu.engine import DecodeEngine as JEngine
from distributed_pytorch_tpu.models import attention as jattn
from distributed_pytorch_tpu.models.generate import generate as jgenerate
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.models.gpt import init_cache as jinit_cache
from distributed_pytorch_tpu.ops import quant as jq
from distributed_pytorch_tpu.ops.block_pool import NULL_BLOCK
from distributed_pytorch_tpu.ops.rope import \
    precompute_rope_freqs as jfreqs
from distributed_pytorch_tpu.train.state import create_train_state as jstate
from distributed_pytorch_tpu.train.step import make_train_step as jstep
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.engine import DecodeEngine
from distributed_pytorch_tpu_torch.models import attention as tattn
from distributed_pytorch_tpu_torch.models.generate import generate
from distributed_pytorch_tpu_torch.models.gpt import (LLM, count_params,
                                                      init_cache)
from distributed_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_pytorch_tpu_torch.ops import flash_decode as tfd
from distributed_pytorch_tpu_torch.ops import quant as tq
from distributed_pytorch_tpu_torch.ops.rope import precompute_rope_freqs
from distributed_pytorch_tpu_torch.train.state import (TrainState,
                                                       build_model,
                                                       make_optimizer)
from distributed_pytorch_tpu_torch.train.step import make_train_step
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-4
BASE = dict(vocab_size=97, block_size=64, n_embd=64, n_head=4, attn="mla",
            n_layer=2, up_dim=96, non_linearity="swiglu", q_latent_dim=16,
            kv_latent_dim=16, rope_head_dim=16)
FLAVORS = {"full": dict(BASE, pos_emb="rope"),
           "naive": dict(BASE, pos_emb="learn")}
MOE = dict(moe=True, n_exp=6, n_shared=1, n_act=3, moe_impl="dense")
# the flagship's head split under `--attn mla` (64 content + 16 rotary
# features a head, the CLI's latents): the flash route sees q_c | q_r at
# head size 80, which the kernels run at their width 128
SPLITS = dict(FLAVORS, flagship=dict(BASE, pos_emb="rope", n_embd=256,
                                     q_latent_dim=32, kv_latent_dim=32))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _pair(kw, seed=0):
    jm = JLLM(JConfig(**kw), attn_impl="naive")
    x = jnp.zeros((1, kw["block_size"]), jnp.int32)
    key = jax.random.PRNGKey(seed)
    var = jax.tree_util.tree_map(np.array, jax.device_get(dict(
        jm.init({"params": key, "dropout": key}, x, x))))
    cfg = LLMConfig(**kw)
    tm = LLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(var["params"], cfg,
                                       var.get("moe_state")))
    tm.eval()
    return jm, var, tm


@pytest.fixture(scope="module", params=list(FLAVORS))
def pair(request):
    return (request.param,) + _pair(FLAVORS[request.param])


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_pair(flavor):
    """The reference's layer and the port's from the same weights, with
    each side's RoPE table at rope_head_dim."""
    kw = FLAVORS[flavor]
    jcfg, cfg = JConfig(**kw), LLMConfig(**kw)
    jl = jattn.Attention(jcfg, "naive")
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jf = jfreqs(16, 64) if flavor == "full" else None
    var = jax.tree_util.tree_map(np.array, jax.device_get(dict(
        jl.init(jax.random.PRNGKey(2), jnp.asarray(x0), jf))))
    tl = tattn.Attention(cfg, device="cpu", attn_impl="naive")
    assert type(tl).__name__ == type(jl).__name__
    with torch.no_grad():
        for name, w in var["params"].items():
            getattr(tl, name).copy_(_t(w))
    tf = precompute_rope_freqs(16, 64) if flavor == "full" else None
    return jcfg, cfg, jl, var, tl, jf, tf


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_layer_uncached_and_contiguous_cache_match_reference(flavor):
    """The layer's training forward (T 12; both sdpa routes), then a
    6-token prefill and 4 single-token steps at per-sequence positions
    over a contiguous latent cache: every output against the reference's
    layer, and the cache leaves after the last step, fp32 atol 1e-5."""
    jcfg, cfg, jl, var, tl, jf, tf = _layer_pair(flavor)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    ref, _ = jl.apply(var, jnp.asarray(x), jf)
    for impl in ("naive", "pallas"):
        tl.attn_impl = impl
        with torch.no_grad():
            out = tl(_t(x), tf)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0, err_msg=impl)
    jc = jattn.init_attn_cache(jcfg, 2, 16)
    tc = tattn.init_attn_cache(cfg, 2, 16, device="cpu")
    assert set(tc) == set(jc) == ({"c_kv", "k_r"} if flavor == "full"
                                  else {"c_kv"})
    steps = [(x[:, :6], 0)] + [(x[:, t:t + 1], np.array([t, t - 2]))
                               for t in range(6, 10)]
    for xs, pos in steps:
        ref, jc = jl.apply(var, jnp.asarray(xs), jf, jc,
                           pos if isinstance(pos, int) else jnp.asarray(pos))
        with torch.no_grad():
            out = tl(_t(xs), tf, tc,
                     pos if isinstance(pos, int) else torch.from_numpy(pos))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
    for name in jc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_layer_paged_cache_matches_reference(flavor):
    """Each of two sequences prefills 8 tokens (two blocks of 4) into a
    shared 3-D latent pool through its own block table, then both take 3
    steps at their own positions: outputs and the pool (the null block
    aside) against the reference's `paged_update` / `paged_gather` path,
    fp32 atol 1e-5."""
    jcfg, cfg, jl, var, tl, jf, tf = _layer_pair(flavor)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    bt = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    jc = jattn.init_paged_attn_cache(jcfg, 7, 4)
    tc = tattn.init_paged_attn_cache(cfg, 7, 4, device="cpu")
    assert tc["c_kv"].shape == (7, 4, 16)
    for b in range(2):
        ref, jc = jl.apply(var, jnp.asarray(x[b:b + 1, :8]), jf, jc, 0,
                           block_tables=jnp.asarray(bt[b:b + 1]))
        with torch.no_grad():
            out = tl(_t(x[b:b + 1, :8]), tf, tc, 0,
                     block_tables=torch.from_numpy(bt[b:b + 1]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
    for t in range(8, 11):
        pos = np.array([t, t], np.int32)
        ref, jc = jl.apply(var, jnp.asarray(x[:, t:t + 1]), jf, jc,
                           jnp.asarray(pos), block_tables=jnp.asarray(bt))
        with torch.no_grad():
            out = tl(_t(x[:, t:t + 1]), tf, tc, torch.from_numpy(pos).long(),
                     block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
    for name in jc:
        np.testing.assert_allclose(tc[name][NULL_BLOCK + 1:].numpy(),
                                   np.asarray(jc[name])[NULL_BLOCK + 1:],
                                   atol=1e-5, rtol=0, err_msg=name)


def test_absorbed_decode_matches_materialized(pair):
    """The port's own equivalence (the reference's tests/test_mla.py):
    every position's logits of one uncached forward (materialized K/V
    through sdpa) against a 6-token prefill and then one token at a time
    through the absorbed decode over the contiguous cache, fp32 atol
    2e-5; no attention kernel's plain version runs on the cached calls."""
    _, _, _, tm = pair
    idx = torch.from_numpy(np.random.default_rng(5).integers(0, 97, (2, 14)))
    with torch.no_grad():
        full = tm(idx, all_logits=True)
        caches = init_cache(tm.config, 2, 32, device="cpu")
        tfd.reset_counts()
        out = [tm(idx[:, :6], caches=caches, pos=0, all_logits=True)]
        out += [tm(idx[:, t:t + 1], caches=caches, pos=torch.tensor(t))
                for t in range(6, 14)]
    assert sum(tfd.PLAIN_CALLS.values()) == 0
    np.testing.assert_allclose(torch.cat(out, 1).numpy(), full.numpy(),
                               atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# the model: logits, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "naive"])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("flavor", list(SPLITS))
def test_logits_loss_and_grads_match_reference(flavor, moe, impl):
    """A 2-layer MLA model (with a 6-expert MoE where asked) from the
    reference's weights: every position's logits, the loss and every
    parameter's gradient against `jax.grad` of the reference's loss, in
    eval mode, fp32 atol 1e-4. 'pallas' sends FullMLA's q_c | q_r
    (head size 32; 80 in the flagship's split, 4 heads of 64 + 16) and
    NaiveMLA's q (16) through the flash wrappers: one forward and one dq,
    dkv per layer."""
    kw = dict(SPLITS[flavor], **(MOE if moe else {}))
    jm, var, _ = _pair(kw, seed=1)
    cfg = LLMConfig(**kw)
    tm = LLM(cfg, device="cpu", attn_impl=impl)
    tm.load_state_dict(params_from_jax(var["params"], cfg,
                                       var.get("moe_state")))
    tm.eval()
    rng = np.random.default_rng(6)
    x = rng.integers(0, 97, (2, 24))
    y = rng.integers(0, 97, (2, 24))
    rest = {k: v for k, v in var.items() if k != "params"}

    def loss_fn(params):
        logits, loss, _ = jm.apply(dict(rest, params=params), jnp.asarray(x),
                                   jnp.asarray(y), all_logits=True)
        return loss, logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        var["params"])
    fa.reset_counts()
    logits, loss = tm(torch.from_numpy(x), torch.from_numpy(y),
                      all_logits=True)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    ref = params_from_jax(jax.device_get(jgrads), cfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)
    n = 2 if impl == "pallas" else 0
    assert fa.PLAIN_CALLS == {"flash_attn_fwd": n, "flash_attn_bwd_dq": n,
                              "flash_attn_bwd_dkv": n}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_KW = dict(batch_size=2, total_batch_size=2 * 2 * 32, max_iters=10,
                warmup_steps=2, learning_rate=1e-3, grad_clip=1.0,
                compute_dtype="float32", seed=5)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 97, (2, 2, 32)), rng.integers(0, 97, (2, 2, 32)))
            for _ in range(n)]


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_five_step_trajectory_matches_reference(flavor):
    """5 AdamW steps at accum 2 from the reference's init on the same
    batches, through the flash route ('pallas'): the loss (rtol 1e-5) and
    every parameter (atol 1e-4, as the dense trajectory test) after every
    step."""
    kw = dict(FLAVORS[flavor], block_size=32)
    mc = JConfig(**kw)
    jtc = JTrainConfig(**TRAIN_KW)
    jmodel, tx, js, _ = jstate(mc, jtc, None)
    jtrain = jstep(jmodel, tx, mc, jtc, None, None)
    cfg = LLMConfig(**kw)
    tc = TrainConfig(**TRAIN_KW, platform="cpu", attn_impl="pallas")
    model = build_model(cfg, tc, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(js.params), cfg))
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model, tc))
    step = make_train_step(tc)
    for x, y in _batches(5):
        js, jm = jtrain(js, jnp.asarray(x, jnp.int32),
                        jnp.asarray(y, jnp.int32))
        m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        ref = params_from_jax(jax.device_get(js.params), cfg)
        sd = model.state_dict()
        for name, r in ref.items():
            np.testing.assert_allclose(sd[name].numpy(), r.numpy(),
                                       atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_attn_recompute_keeps_the_trajectory(flavor, moe):
    """act_recomp with policy 'attn' re-runs each MLA sublayer (and its
    flash forward) in the backward: 3 steps at accum 2 leave every
    parameter and buffer exactly equal to the run without it (fp32,
    bitwise), with one more flash forward per layer per micro-step."""
    cfg = LLMConfig(**dict(FLAVORS[flavor], block_size=32,
                           **(MOE if moe else {})))
    tc = TrainConfig(**TRAIN_KW, platform="cpu", attn_impl="pallas")
    runs, fwd = [], []
    for recomp in (False, True):
        c = dataclasses.replace(cfg, act_recomp=recomp,
                                act_recomp_policy="attn")
        model = build_model(c, tc, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(model, tc))
        step = make_train_step(tc)
        fa.reset_counts()
        for x, y in _batches(3, seed=7):
            step(state, torch.from_numpy(x), torch.from_numpy(y))
        fwd.append(fa.PLAIN_CALLS["flash_attn_fwd"])
        runs.append(state.model.state_dict())
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    micro = 2 * 3 * 2                    # layers x steps x accum
    assert fwd == [micro, 2 * micro]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _margins(jm, var, seqs, prompt_lens):
    """The reference's top-2 logit margin at each generated position of
    each sequence, from one causal forward over the sequences padded on
    the right (a position's logits do not see the positions after it)."""
    L = max(len(s) for s in seqs) - 1
    x = np.zeros((len(seqs), L), np.int32)
    for i, s in enumerate(seqs):
        x[i, :len(s) - 1] = s[:-1]
    logits, _, _ = jm.apply(var, jnp.asarray(x), all_logits=True)
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return [top2[i, p - 1:len(s) - 1, 1] - top2[i, p - 1:len(s) - 1, 0]
            for i, (s, p) in enumerate(zip(seqs, prompt_lens))]


def _assert_greedy_agree(ref, out, prompt_len, margins, tol=ATOL):
    """Tokens equal up to the first position whose reference top-2 margin
    is within `tol` (a legitimate tie flip may diverge the rest)."""
    assert out[:prompt_len] == ref[:prompt_len]
    for i, m in enumerate(margins):
        if m <= tol:
            return
        assert out[prompt_len + i] == ref[prompt_len + i], (i, m)
    assert out == ref


def test_generate_greedy_matches_reference(pair):
    """`generate` over the contiguous latent cache (the prompt pass and
    every step through the absorbed attention: no kernel's plain version
    runs, as the reference runs no Pallas kernel there) gives the
    reference's greedy tokens, compared where its top-2 margins clear
    1e-4."""
    _, jm, var, tm = pair
    prompt = np.random.default_rng(7).integers(0, 97, (2, 7)).astype(
        np.int32)
    ref = np.asarray(jgenerate(jm, var, jnp.asarray(prompt), 12,
                               temperature=0.0))
    fa.reset_counts()
    tfd.reset_counts()
    out = generate(tm, torch.from_numpy(prompt), 12, temperature=0.0)
    assert sum(fa.PLAIN_CALLS.values()) + sum(tfd.PLAIN_CALLS.values()) == 0
    margins = _margins(jm, var, ref.tolist(), [7, 7])
    for b in range(2):
        _assert_greedy_agree(ref[b].tolist(), out[b].tolist(), 7,
                             margins[b])


def _prompts():
    rng = np.random.default_rng(1)
    prefix = [int(t) for t in rng.integers(1, 97, 20)]
    shared = [prefix + [int(t) for t in rng.integers(1, 97, n)]
              for n in (3, 9, 1)]
    return shared + [[int(t) for t in rng.integers(1, 97, n)]
                     for n in (5, 17, 2)]


# (n_blocks, n_slots, max_new) of each pool
POOLS = {
    "prefix": (None, 2, 8),       # roomy pool: shared-prefix reuse, 2 slots
    "preemption": (9, 3, 20),     # 8 usable blocks for 3 slots: preemption
}


def _engine_kw(n_blocks, n_slots):
    return dict(n_slots=n_slots, temperature=0.0, min_bucket=8, block_size=8,
                n_blocks=n_blocks)


@pytest.fixture(scope="module")
def engine_refs(pair):
    """{pool: (the reference engine's tokens, its top-2 margins)} of this
    flavor, computed once for the wave and chunked cases."""
    _, jm, var, _ = pair
    prompts, out = _prompts(), {}
    for name, (n_blocks, n_slots, max_new) in POOLS.items():
        ref = JEngine(jm, var, **_engine_kw(n_blocks, n_slots)).run(
            prompts, max_new)
        out[name] = ref, _margins(jm, var, ref, [len(p) for p in prompts])
    return out


@pytest.mark.parametrize("chunk", [0, 16], ids=["wave", "chunked"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_engine_matches_reference_engine(pair, engine_refs, pool, chunk):
    """The port's engine over paged latent pools (absorbed decode, no
    paged attention kernel: their plain versions never run) against the
    reference's engine, wave or chunked (16-token chunks), with radix
    prefix reuse or a pool small enough to preempt: the same retirements
    and greedy tokens where the reference's top-2 margins clear 1e-4;
    the chunked port equals the port's wave engine exactly."""
    _, jm, var, tm = pair
    prompts = _prompts()
    n_blocks, n_slots, max_new = POOLS[pool]
    kw = _engine_kw(n_blocks, n_slots)
    ref, margins = engine_refs[pool]
    tfd.reset_counts()
    eng = DecodeEngine(tm, prefill_chunk=chunk, **kw)
    out = eng.run(prompts, max_new)
    assert sum(tfd.PLAIN_CALLS.values()) == 0
    assert eng.prefix_hit_rate > 0
    if n_blocks is not None:
        assert eng.retire_counts["preempted"] > 0
    for p, r, o, m in zip(prompts, ref, out, margins):
        _assert_greedy_agree(r, o, len(p), m)
    if chunk:
        assert out == DecodeEngine(tm, **kw).run(prompts, max_new)


def test_int8_request_keeps_the_models_dtype(pair):
    """An int8 request on an MLA model keeps the latent pools in the
    model's dtype (`quant_kv_usable`), and weight-only int8 quantizes the
    eight MLA projections."""
    name, _, _, tm = pair
    eng = DecodeEngine(tm, cache_dtype="int8", quantize_weights=True,
                       n_slots=1, temperature=0.0, min_bucket=8,
                       block_size=8)
    assert eng.cache_dtype == torch.float32 and not eng.kv_quantized
    assert eng.caches[0]["c_kv"].dtype == torch.float32
    mla = {k.rsplit(".", 1)[-1] for k in eng._qparams if ".attn." in k}
    assert mla == set(tq.MLA_WEIGHTS if name == "full"
                      else tq.MLA_WEIGHTS - {"W_qr", "W_kr"})


TOKENS = [5, 17, 3, 44, 9, 61, 2, 30, 88, 12, 7, 50]


def test_int8_weights_teacher_forced_logits_match_reference(pair):
    """A 4-token prefill then 8 teacher-forced decode steps through the
    contiguous latent cache with int8 weights in every forward (the
    absorbed W_uk / W_uv dequantized): port against the reference's
    store at 1e-4; both stay within 5e-2 of the fp32 logits."""
    _, jm, var, tm = pair
    jstore = jq.quantize_params(var["params"])
    tstore = tq.quantize_params(dict(tm.named_parameters()))
    jc = jinit_cache(jm.config, 1, 64, dtype=jnp.float32)
    tc = init_cache(tm.config, 1, 64, device="cpu")
    ref, out, exact, pos = [], [], [], 0
    tc2 = init_cache(tm.config, 1, 64, device="cpu")
    for chunk in [TOKENS[:4]] + [[t] for t in TOKENS[4:]]:
        with jq.use_quantized_params(jstore):
            lg, _, jc = jm.apply(var, jnp.asarray([chunk], jnp.int32), None,
                                 jc, pos, deterministic=True)
        ref.append(np.asarray(lg)[0, -1])
        p = pos if pos == 0 else torch.tensor(pos)
        with torch.no_grad():
            with tq.use_quantized_params(tstore):
                out.append(tm(torch.tensor([chunk]), caches=tc, pos=p)[0, -1]
                           .numpy())
            exact.append(tm(torch.tensor([chunk]), caches=tc2, pos=p)[0, -1]
                         .numpy())
        pos += len(chunk)
    out, ref, exact = np.stack(out), np.stack(ref), np.stack(exact)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert 0 < np.abs(out - exact).max() <= 5e-2


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_count_params_and_flops_match_reference(flavor, moe):
    """count_params (total, active) of a tiny MLA model equals the
    reference's; the MFU numerator (`step_flops` with and without 'attn'
    recomputation) and the attention recompute count equal the
    reference's, exactly."""
    from distributed_pytorch_tpu.models.gpt import count_params as jcount
    from distributed_pytorch_tpu.train import metrics as jmetrics

    from distributed_pytorch_tpu_torch.train import metrics
    kw = dict(FLAVORS[flavor], **(MOE if moe else {}))
    _, var, tm = _pair(kw)
    assert count_params(tm, tm.config) == jcount(var["params"], JConfig(**kw))
    for recomp in (False, True):
        k = dict(kw, act_recomp=recomp, act_recomp_policy="attn")
        jc, tc = JConfig(**k), LLMConfig(**k)
        assert metrics.step_flops(tc, 2 ** 14, 1024) == \
            jmetrics.step_flops(jc, 2 ** 14, 1024)
        assert metrics.attn_matmul_params_per_token(tc) == \
            jmetrics.attn_matmul_params_per_token(jc)


#: the launcher's MLA model (scripts/train.sh, Model configuration)
LAUNCHER = dict(n_layer=12, n_embd=1024, vocab_size=50304, block_size=1024,
                pos_emb="rope", up_dim=768, non_linearity="swiglu",
                attn="mla", n_head=8, q_latent_dim=256, kv_latent_dim=256,
                rope_head_dim=128, moe=True, n_exp=16, n_shared=1, n_act=4,
                moe_impl="scatter", aux_free=True)


def test_launcher_model_counts():
    """The launcher's model built on the meta device (no memory): 537.76M
    parameters, 33.03M of them in attention, its flash head size 256,
    and a FLOP count equal to the reference's under 'attn'
    recomputation."""
    from distributed_pytorch_tpu.train import metrics as jmetrics

    from distributed_pytorch_tpu_torch.train import metrics
    cfg = LLMConfig(**LAUNCHER, act_recomp=True, act_recomp_policy="attn")
    tm = LLM(cfg, device="meta")
    total, active = count_params(tm, cfg)
    attn = sum(p.numel() for n, p in tm.named_parameters() if ".attn." in n)
    assert round(total / 1e6, 2) == 537.76 and active < total
    assert round(attn / 1e6, 2) == 33.03
    assert cfg.head_size + cfg.rope_head_dim == 256 == fa.padded_width(
        256, "flash_attn_fwd", torch.bfloat16)
    assert metrics.step_flops(cfg, 2 ** 14, 1024) == jmetrics.step_flops(
        JConfig(**LAUNCHER, act_recomp=True, act_recomp_policy="attn"),
        2 ** 14, 1024)
