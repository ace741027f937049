"""The port's DecodeEngine against the reference package's DecodeEngine and
against the port's own one-shot `generate`: greedy outputs through
continuous batching, with a shared prompt prefix (radix reuse) and with a
pool small enough to force preemption and requeue; with an int8 KV cache,
with int8 weights and with chunked prefill (the reference run with
FLASH_DECODE=on, so its int8 legs go through its `_q8` kernels in
interpret mode). Greedy tokens are compared where the reference's top-2
logit margin exceeds the tolerance (for the int8 legs the tolerance plus
twice the int8-vs-fp32 logit limit of tests/test_torch_quant.py, since
the margins come from the fp32 model); past a position where it does not,
a legitimate tie flip may diverge the rest of the sequence, so the
comparison stops there. Inside the port: chunked prefill gives the wave
engine's tokens exactly (fp32 and int8 caches), composes with prefix
reuse and with mid-prefill preemption, and prefill forwards keep the
model's own weights under `quantize_weights`. A float cache in another
dtype than the model's is refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.engine import DecodeEngine as JEngine
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.engine import DecodeEngine
from distributed_pytorch_tpu_torch.models.generate import generate
from distributed_pytorch_tpu_torch.models.gpt import LLM
from distributed_pytorch_tpu_torch.ops import flash_decode as tfd
from torch_threads import one_thread  # noqa: F401

TOL = 1e-4
KW = dict(vocab_size=97, block_size=64, n_embd=64, n_head=4, n_kv_heads=2,
          attn="gqa", n_layer=2, up_dim=96, non_linearity="swiglu",
          pos_emb="rope")


@pytest.fixture(scope="module")
def models():
    jm = JLLM(JConfig(**KW), attn_impl="naive")
    x = jnp.zeros((1, KW["block_size"]), jnp.int32)
    key = jax.random.PRNGKey(0)
    var = dict(jm.init({"params": key, "dropout": key}, x, x))
    cfg = LLMConfig(**KW)
    tm = LLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(var["params"]), cfg))
    return jm, var, tm, jax.jit(jm.apply, static_argnames="all_logits")


def _prompts():
    rng = np.random.default_rng(1)
    prefix = [int(t) for t in rng.integers(1, 97, 20)]
    shared = [prefix + [int(t) for t in rng.integers(1, 97, n)]
              for n in (3, 9, 1)]
    return shared + [[int(t) for t in rng.integers(1, 97, n)]
                     for n in (5, 17, 2)]


def _assert_greedy_agree(ref, out, prompt_len, margins, tol=TOL):
    """ref/out token lists; margins[i] is the reference's top-2 gap for the
    token at prompt_len + i."""
    assert out[:prompt_len] == ref[:prompt_len]
    for i, m in enumerate(margins):
        if m <= tol:
            return
        assert out[prompt_len + i] == ref[prompt_len + i], (
            f"token {i} differs with margin {m}")
    assert out == ref


def _margins_jax(japply, var, seq, prompt_len):
    # right-pad to one shape (one compile); causal rows ignore the pad
    buf = np.zeros((1, KW["block_size"]), np.int32)
    buf[0, :len(seq) - 1] = seq[:-1]
    logits, _, _ = japply(var, jnp.asarray(buf), all_logits=True)
    logits = np.asarray(logits)[:, :len(seq) - 1]
    top2 = np.sort(logits[0, prompt_len - 1:], axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _margins_torch(tm, seq, prompt_len):
    with torch.no_grad():
        logits = tm(torch.tensor([seq[:-1]]), all_logits=True)
    top2 = torch.sort(logits[0, prompt_len - 1:], dim=-1).values[:, -2:]
    return (top2[:, 1] - top2[:, 0]).numpy()


@pytest.mark.parametrize("n_blocks,n_slots,max_new", [
    (None, 2, 8),      # roomy pool: shared-prefix reuse through 2 slots
    (9, 3, 20),        # 8 usable blocks for 3 slots: forced preemption
], ids=["prefix", "preemption"])
def test_engine_matches_reference_engine_and_generate(models, n_blocks,
                                                      n_slots, max_new):
    jm, var, tm, japply = models
    prompts = _prompts()
    kw = dict(n_slots=n_slots, temperature=0.0, min_bucket=8, block_size=8,
              n_blocks=n_blocks)
    jeng = JEngine(jm, var, **kw)
    ref = jeng.run(prompts, max_new)
    tfd.reset_counts()
    eng = DecodeEngine(tm, **kw)
    out = eng.run(prompts, max_new)
    assert eng.prefix_hit_rate > 0
    assert eng.retire_counts == jeng.retire_counts
    if n_blocks is not None:
        assert eng.retire_counts["preempted"] > 0
    # the CPU engine walked the kernel routes through their plain versions
    assert tfd.PLAIN_CALLS["paged_decode_attn"] == \
        KW["n_layer"] * eng.n_steps
    assert tfd.PLAIN_CALLS["paged_prefill_attn"] > 0
    assert sum(tfd.LAUNCHES.values()) == 0
    for p, r, o in zip(prompts, ref, out):
        _assert_greedy_agree(r, o, len(p),
                             _margins_jax(japply, var, r, len(p)))
        g = generate(tm, p, max_new, temperature=0.0)[0].tolist()
        _assert_greedy_agree(g, o, len(p), _margins_torch(tm, g, len(p)))


def test_cancel_eos_and_accounting(models):
    tm = models[2]
    prompts = _prompts()
    eng = DecodeEngine(tm, n_slots=2, temperature=0.0, min_bucket=8,
                       block_size=8)
    a = eng.admit(prompts[0], 10)
    b = eng.admit(prompts[1], 10)
    assert b.prefix_len == 16 and b.prefilled == len(prompts[1]) - 16
    res = eng.step()
    assert set(res.emitted) == {a.seq_id, b.seq_id}
    ret = eng.cancel(a.seq_id)
    assert ret.reason == "cancelled" and eng.n_free == 1
    assert eng.cancel(a.seq_id) is None
    # eos: retire on the next token the engine would emit
    nxt = generate(tm, ret.tokens, 1, temperature=0.0)[0, -1].item()
    eng.eos_id = nxt
    c = eng.admit(ret.tokens, 10)
    assert c.retired is not None and c.retired.reason == "eos"
    assert eng.block_utilization > 0 and 0 <= eng.block_fragmentation < 1
    assert eng.trace_guards == {} and eng.aot_store is None
    assert eng.flight.total == eng.n_steps


# ----------------------------------------------------------------------
# int8 serving and chunked prefill
# ----------------------------------------------------------------------

# a trivial prompt, a multi-chunk one and a mid-size one (the reference's
# tests/test_engine.py CHUNK_PROMPTS); prompt + budget stays under max_len
CHUNK_PROMPTS = [[1, 2, 3], list(range(1, 40)), [7] * 10]
#: int8-vs-fp32 logit limits (cache, weights) the margins must clear
INT8_LIMIT = {"cache_dtype": 2e-2, "quantize_weights": 5e-2}


@pytest.mark.parametrize("leg", [dict(cache_dtype="int8"),
                                 dict(quantize_weights=True),
                                 dict(prefill_chunk=16)],
                         ids=["int8-cache", "int8-weights", "chunked"])
def test_int8_and_chunked_engines_match_reference_engine(models, leg,
                                                         monkeypatch):
    jm, var, tm, japply = models
    kw = dict(n_slots=2, temperature=0.0, min_bucket=8, block_size=8, **leg)
    monkeypatch.setenv("FLASH_DECODE", "on")
    jeng = JEngine(JLLM(JConfig(**KW), attn_impl="auto"), var, **kw)
    ref = jeng.run([list(p) for p in CHUNK_PROMPTS], 12)
    tfd.reset_counts()
    eng = DecodeEngine(tm, **kw)
    out = eng.run([list(p) for p in CHUNK_PROMPTS], 12)
    assert eng.kv_quantized == jeng.kv_quantized
    assert eng.weights_quantized == jeng.weights_quantized
    assert eng.retire_counts == jeng.retire_counts
    q8 = "_q8" if "cache_dtype" in leg else ""
    assert tfd.PLAIN_CALLS[f"paged_decode_attn{q8}"] > 0
    assert tfd.PLAIN_CALLS[f"paged_prefill_attn{q8}"] > 0
    assert sum(tfd.LAUNCHES.values()) == 0
    tol = TOL + 2 * sum(INT8_LIMIT.get(k, 0.0) for k in leg)
    for p, r, o in zip(CHUNK_PROMPTS, ref, out):
        _assert_greedy_agree(r, o, len(p),
                             _margins_jax(japply, var, r, len(p)), tol)


@pytest.mark.parametrize("cache_dtype", [None, "int8"],
                         ids=["native", "int8"])
def test_chunked_matches_wave(models, cache_dtype):
    """Splitting prompts into 16-token chunks fused into the steps is
    invisible in the tokens (per-row scales make int8 quantization
    independent of the chunking); native legs equal `generate` too. A
    chunked admission runs no forward and returns no first token; every
    chunk step reports its prompt tokens."""
    tm = models[2]
    kw = dict(n_slots=2, temperature=0.0, min_bucket=8, block_size=8,
              cache_dtype=cache_dtype)
    refs = DecodeEngine(tm, **kw).run([list(p) for p in CHUNK_PROMPTS], 12)
    if cache_dtype is None:
        for p, r in zip(CHUNK_PROMPTS, refs):
            assert r == generate(tm, p, 12, temperature=0.0)[0].tolist()
    eng = DecodeEngine(tm, prefill_chunk=16, **kw)
    assert eng.table_width == eng.max_blocks + 2
    adm = eng.admit(CHUNK_PROMPTS[1], 12)
    assert adm.first_token is None and adm.prefilled == 39
    assert eng.block_pool.n_referenced == 2    # the first chunk's blocks
    steps = [eng.step() for _ in range(3)]
    assert [r.prefill_tokens for r in steps] == [16, 16, 7]
    assert [list(r.emitted.values()) for r in steps[:2]] == [[], []]
    assert list(steps[2].emitted.values()) == [[refs[1][39]]]
    eng.cancel(adm.seq_id)
    assert eng.run([list(p) for p in CHUNK_PROMPTS], 12) == refs
    assert eng.admit_traces == {} and eng.fused_step_traces == 0
    assert eng.flight.total == eng.n_steps


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix-on", "prefix-off"])
def test_chunked_prefix_reuse(models, prefix_cache):
    """A re-admitted prompt hits the blocks its own chunks published as
    they filled and chunks in only the tail, with the same tokens; with
    the cache off everything is chunked again."""
    tm = models[2]
    eng = DecodeEngine(tm, n_slots=1, temperature=0.0, min_bucket=8,
                       prefill_chunk=16, block_size=8,
                       prefix_cache=prefix_cache)
    p = list(range(1, 40))
    ref = generate(tm, p, 12, temperature=0.0)[0].tolist()
    assert eng.run([list(p)], 12)[0] == ref
    assert eng.run([list(p)], 12)[0] == ref
    if prefix_cache:
        assert 0 < eng.prefix_hit_tokens < 2 * len(p)
    else:
        assert eng.prefix_hit_tokens == 0
        assert eng.prefilled_tokens == 2 * len(p)


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix-on", "prefix-off"])
def test_chunked_mid_prefill_preemption(models, prefix_cache):
    """A pool too small for a decode stream and a multi-chunk prompt
    preempts the partial MID-PREFILL; `run` requeues it and the resume
    (a prefix hit on its written blocks when the cache is on) gives the
    one-shot tokens. Nothing leaks."""
    tm = models[2]
    eng = DecodeEngine(tm, n_slots=2, temperature=0.0, min_bucket=8,
                       prefill_chunk=16, block_size=8, n_blocks=9,
                       prefix_cache=prefix_cache)
    prompts = [[1, 2, 3], list(range(1, 40))]
    outs = eng.run([list(p) for p in prompts], 20)
    assert eng.retire_counts["preempted"] >= 1
    for p, o in zip(prompts, outs):
        assert o == generate(tm, p, 20, temperature=0.0)[0].tolist()
    assert (eng.prefix_hit_tokens > 0) == prefix_cache
    assert eng.block_pool.n_referenced == 0


@pytest.mark.parametrize("n_blocks,prompts", [
    (10, [range(1, 20), range(3, 45)]),
    (9, [range(1, 30), range(3, 48)]),
    (11, [range(1, 40), range(2, 50), range(5, 20)]),
], ids=["decode-victim", "long-partial", "three-streams"])
def test_chunked_preemption_while_growing_a_chunk(models, n_blocks,
                                                  prompts):
    """A dry pool when the next chunk's blocks are allocated preempts the
    youngest sequence from inside the chunk scheduler; its retirement is
    reported (the slot is read before `_retire` drops it), `run` resumes
    it, and every stream gives the one-shot tokens. Nothing leaks."""
    tm = models[2]
    eng = DecodeEngine(tm, n_slots=2, temperature=0.0, min_bucket=8,
                       prefill_chunk=16, block_size=8, n_blocks=n_blocks)
    chunk_victims = []
    next_chunk = eng._next_chunk

    def counted(preempted):
        out = next_chunk(preempted)
        chunk_victims.extend(preempted)
        return out

    eng._next_chunk = counted
    prompts = [list(p) for p in prompts]
    outs = eng.run([list(p) for p in prompts], 16)
    assert chunk_victims
    for p, o in zip(prompts, outs):
        assert o == generate(tm, p, 16, temperature=0.0)[0].tolist()
    assert eng.block_pool.n_referenced == 0


@pytest.mark.parametrize("cache_dtype", ["bfloat16", torch.float16, "float32",
                                         torch.float32],
                         ids=["bf16", "torch_fp16", "fp32", "torch_fp32"])
def test_engine_refuses_a_float_cache_dtype_other_than_the_models(
        models, cache_dtype):
    """A float KV cache in another dtype than the model's is refused with
    ValueError (the reference engine takes it: a divergence by design,
    ROADMAP Queue 3); the model's own dtype, by name or as a torch dtype,
    is taken."""
    _, _, tm, _ = models
    if getattr(torch, str(cache_dtype).removeprefix("torch.")) != tm.dtype:
        with pytest.raises(ValueError, match="differs from the model"):
            DecodeEngine(tm, n_slots=2, cache_dtype=cache_dtype)
        return
    eng = DecodeEngine(tm, n_slots=2, cache_dtype=cache_dtype)
    assert eng.cache_dtype == tm.dtype and not eng.kv_quantized


@pytest.mark.parametrize("prefill_chunk", [0, 16], ids=["wave", "chunked"])
def test_prefill_keeps_the_models_weights(models, prefill_chunk):
    """Under `quantize_weights` only decode forwards read int8 weights: a
    prompt's prefill writes the same cache as an unquantized engine's, to
    the bit; the first decode step's write differs."""
    tm = models[2]
    kw = dict(n_slots=1, temperature=0.0, min_bucket=8, block_size=8,
              prefill_chunk=prefill_chunk)
    engs = [DecodeEngine(tm, quantize_weights=q, **kw) for q in (False, True)]
    assert engs[1]._qparams and engs[0]._qparams is None
    p = list(range(3, 30))
    for e in engs:
        e.admit(p, 8)
        while prefill_chunk and e._is_partial(e._slots[0]):
            e.step()
    rows = len(p)
    bt = engs[0].block_tables[:1]
    assert torch.equal(engs[0].block_tables, engs[1].block_tables)

    def written(e, n):
        from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather
        return paged_gather(e.caches[0]["k"], bt)[0, :n]

    assert torch.equal(written(engs[0], rows), written(engs[1], rows))
    for e in engs:
        e.step()
    assert not torch.equal(written(engs[0], rows + 1)[rows],
                           written(engs[1], rows + 1)[rows])


@pytest.mark.parametrize("cache_dtype,quant", [(None, False), ("int8", True)],
                         ids=["native", "int8_cache_and_weights"])
def test_moe_engine_chunked_matches_wave(cache_dtype, quant):
    """An MoE model (1 shared + 5 routed experts, top 2, the grouped
    dispatch) in the engine: chunked prefill gives the wave engine's
    tokens exactly, and the native wave `generate`'s; the grouped forward
    runs twice per layer per model forward, and never moves the bias;
    under `quantize_weights` the store holds the attention weights and
    the tied head but no expert stack or router, which stay in the
    model's dtype (the reference's quantize_params leaves them too)."""
    from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
    cfg = LLMConfig(**dict(KW, moe=True, n_exp=6, n_shared=1, n_act=3,
                           moe_impl="grouped"))
    tm = LLM(cfg, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in tm.moe_layers():
            m.expert_bias.normal_(0.0, 0.3,
                                  generator=torch.Generator().manual_seed(1))
    tm.eval()
    bias = [m.expert_bias.clone() for m in tm.moe_layers()]
    kw = dict(n_slots=2, temperature=0.0, min_bucket=8, block_size=8,
              cache_dtype=cache_dtype, quantize_weights=quant)
    prompts = [list(p) for p in CHUNK_PROMPTS]
    refs = DecodeEngine(tm, **kw).run(prompts, 10)
    if cache_dtype is None:
        for p, r in zip(prompts, refs):
            assert r == generate(tm, p, 10, temperature=0.0)[0].tolist()
    calls = []
    hook = tm.moe_layers()[1].register_forward_hook(
        lambda *a: calls.append(1))
    gm.reset_counts()
    try:
        eng = DecodeEngine(tm, prefill_chunk=16, **kw)
        assert eng.run(prompts, 10) == refs
    finally:
        hook.remove()
    assert gm.PLAIN_CALLS["grouped_mm_fwd"] == 2 * cfg.n_layer * len(calls)
    assert gm.DEGRADED["dense"] == 0
    assert all(torch.equal(b, m.expert_bias)
               for b, m in zip(bias, tm.moe_layers()))
    if quant:
        assert "blocks.0.attn.c_attn.weight" in eng._qparams
        assert not any(".moe." in k for k in eng._qparams)
