"""Self-speculative decoding in the port's DecodeEngine against the reference
package's (its tests/test_spec_decode.py, case for case): the n-gram
drafter against the reference's `ngram_propose`, `paged_update`'s
multi-row branch against the reference's, and greedy tokens with
SPEC_DECODE on against the reference's spec-on engine and the port's
spec-off engine — attention flavors (MLA included), an MoE model, int8 KV,
prefix reuse, forced preemption, the budget and `max_len` boundaries, zero
and all-K acceptance and an EOS inside the accepted span (drafter
monkeypatched), knob gating, chunked prefill, and the scheduler streaming
multi-token steps in order. The models' weights are the init's times
SCALE, so that a token depends on its position; the n-gram drafter seldom
hits such streams, so most cases draft from the reference's own output
with every third proposal wrong (`oracle_drafter`), and the n-gram drafter
runs on init-scale models, as in the reference's tests. Tokens are
compared position by position where the reference's top-2 logit margin
exceeds TOL (for int8 KV, TOL plus twice the int8-vs-fp32 logit limit of
tests/test_torch_quant.py); past a near-tie a legitimate flip may diverge
the rest, so the comparison stops there. The reference's trace-count tests
have no eager counterpart."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.engine import DecodeEngine as JEngine
from distributed_pytorch_tpu.engine.decode import \
    ngram_propose as jngram_propose
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.ops import block_pool as jbp
from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.engine import DecodeEngine
from distributed_pytorch_tpu_torch.engine import decode as decode_mod
from distributed_pytorch_tpu_torch.engine.decode import ngram_propose
from distributed_pytorch_tpu_torch.models.gpt import LLM
from distributed_pytorch_tpu_torch.ops import block_pool as bp
from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
from distributed_pytorch_tpu_torch.serve.scheduler import Scheduler
from torch_threads import one_thread  # noqa: F401

TOL = 1e-4
INT8_LIMIT = 2e-2
#: the init's weights times this ('sharp' models): at the init's scale a
#: tiny model echoes its last token whatever its position, which would
#: hide a verify that writes or reads the wrong rows
SCALE = 4.0


def tiny(**kw):
    base = dict(vocab_size=97, block_size=64, n_embd=48, n_head=4,
                n_kv_heads=2, attn="gqa", n_layer=2, up_dim=64,
                non_linearity="swiglu", pos_emb="rope", dropout=0.0,
                q_latent_dim=16, kv_latent_dim=16, rope_head_dim=8)
    base.update(kw)
    return base


#: (model, reference variables, port model, jitted reference apply) per
#: configuration, built once
_BUILT = {}


def build(scale=SCALE, **kw):
    """The reference model at seed 0, its weights times `scale`, and the
    port's from those weights (an MoE model's expert bias nonzero, so that
    it changes the selection; the port routes MoE through 'grouped', the
    reference through 'dense': the same dropless semantics)."""
    key = (scale,) + tuple(sorted(kw.items()))
    if key in _BUILT:
        return _BUILT[key]
    cfg = tiny(**kw)
    jm = JLLM(JConfig(**cfg), attn_impl="naive")
    x = jnp.zeros((1, cfg["block_size"]), jnp.int32)
    rng = jax.random.PRNGKey(0)
    var = dict(jm.init({"params": rng, "dropout": rng}, x, x))
    var = jax.tree_util.tree_map(np.array, jax.device_get(var))
    var["params"] = jax.tree_util.tree_map(lambda a: a * scale,
                                           var["params"])
    moe_state = None
    if cfg.get("moe"):
        r = np.random.default_rng(3)
        for i in range(cfg["n_layer"]):
            var["moe_state"][f"block_{i}"]["moe"]["expert_bias"] = (
                0.3 * r.standard_normal(cfg["n_exp"] - cfg["n_shared"])
            ).astype(np.float32)
        moe_state = var["moe_state"]
        cfg = dict(cfg, moe_impl="grouped")
    tcfg = LLMConfig(**cfg)
    tm = LLM(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(var["params"], tcfg, moe_state))
    tm.eval()
    _BUILT[key] = (jm, var, tm,
                   jax.jit(jm.apply, static_argnames="all_logits"))
    return _BUILT[key]


def jengine(jm, var, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("min_bucket", 8)
    return JEngine(jm, var, temperature=0.0, **kw)


def spec_engine(tm, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("min_bucket", 8)
    kw.setdefault("spec_k", 4)
    return DecodeEngine(tm, temperature=0.0, spec_decode=True, **kw)


def plain_engine(tm, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("min_bucket", 8)
    return DecodeEngine(tm, temperature=0.0, spec_decode=False, **kw)


def oracle_drafter(refs, wrong_every=3):
    """A drafter for the sharp models, whose streams the n-gram drafter
    seldom hits: it proposes the continuation of the reference output
    that `tokens` begins, with the proposal for every `wrong_every`-th
    position off by one, so that drafts are accepted in part, in full and
    not at all."""
    def propose(tokens, k, **_kw):
        n = len(tokens)
        for r in refs:
            if list(r[:n]) == list(tokens):
                return [(t + 1) % 97 if (n + i) % wrong_every == 0 else t
                        for i, t in enumerate(r[n:n + k])]
        return []
    return propose


def _margins(japply, var, seq, prompt_len, block_size):
    """The reference's top-2 logit margin at every generated position of
    `seq`, from one uncached forward (right-padded to one shape)."""
    buf = np.zeros((1, block_size), np.int32)
    buf[0, :len(seq) - 1] = seq[:-1]
    logits, _, _ = japply(var, jnp.asarray(buf), all_logits=True)
    top2 = np.sort(np.asarray(logits)[0, prompt_len - 1:len(seq) - 1],
                   axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def assert_same(built, prompts, ref, out, tol=TOL):
    """`out` equals `ref` token for token up to the first position whose
    reference margin is within `tol` (all of it when none is)."""
    jm, var, _, japply = built
    assert len(ref) == len(out)
    for p, r, o in zip(prompts, ref, out):
        r, o = list(r), list(o)
        n = len(p)
        assert o[:n] == r[:n]
        margins = _margins(japply, var, r, n, jm.config.block_size) \
            if len(r) > n else []
        for i, m in enumerate(margins):
            if m <= tol:
                break
            assert o[n + i] == r[n + i], f"token {i} differs, margin {m}"
        else:
            assert o == r


# repetitive suffixes (n-gram hits) mixed with structureless prompts
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 7, 8, 9, 10, 11],
           [20] * 17, [4, 9, 4, 9, 4], [9]]


# ----------------------------------------------------------------------
# drafter and the multi-row write
# ----------------------------------------------------------------------

NGRAM_CASES = [
    ([1, 2, 3, 4, 5, 1, 2], 3),              # hit: continuation 3, 4, 5
    ([7, 1, 2, 9, 5, 1, 2, 8, 7, 1, 2], 2),  # the longest match wins
    ([1, 2, 5, 1, 2, 6, 1, 2], 1),           # the most recent occurrence
    ([1, 2, 3, 4, 5], 4),                    # no repeat
    ([1, 2], 4),                             # too short
    ([1, 2, 3, 1, 2], 0),                    # k 0
    ([], 4),
    ([1, 2, 3, 4, 5, 6, 7, 1, 2], 2),        # clamped to k
    ([1, 2, 3, 4, 5, 6, 7, 1, 2], 100),
    ([3, 3, 3, 3], 4),                       # suffix-adjacent match
]


@pytest.mark.parametrize("tokens,k", NGRAM_CASES)
def test_ngram_propose_matches_reference(tokens, k):
    got = ngram_propose(list(tokens), k)
    assert got == jngram_propose(list(tokens), k)
    assert len(got) <= max(k, 0)


def test_ngram_expected_drafts():
    assert ngram_propose([1, 2, 3, 4, 5, 1, 2], 3) == [3, 4, 5]
    assert ngram_propose([7, 1, 2, 9, 5, 1, 2, 8, 7, 1, 2], 2) == [9, 5]
    assert ngram_propose([1, 2, 5, 1, 2, 6, 1, 2], 1) == [6]
    assert ngram_propose([1, 2, 3, 4, 5, 6, 7, 1, 2], 100) == \
        [3, 4, 5, 6, 7, 1, 2]


@pytest.mark.parametrize("T", [1, 3, 5])
def test_paged_update_multi_row_matches_reference(T):
    """Per-slot (B,) offsets with T rows: rows cross block boundaries, a
    dead slot's zeroed table row sends its writes to the null block, and
    rows past the table land there too (the pools compared exactly)."""
    rng = np.random.default_rng(T)
    n_blocks, bs, W, B = 12, 4, 3, 4
    pool = rng.standard_normal((n_blocks, bs, 2, 8)).astype(np.float32)
    new = rng.standard_normal((B, T, 2, 8)).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 9]],
                      np.int32)
    pos = np.array([2, 7, 5, 10], np.int32)   # slot 3 runs off the table
    ref = jbp.paged_update(jnp.asarray(pool), jnp.asarray(new),
                           jnp.asarray(pos), jnp.asarray(tables))
    got = bp.paged_update(torch.from_numpy(pool.copy()),
                          torch.from_numpy(new), torch.from_numpy(pos),
                          torch.from_numpy(tables))
    # the null block holds whatever landed last: compare the rest
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(ref)[1:])


# ----------------------------------------------------------------------
# greedy tokens, spec on
# ----------------------------------------------------------------------

FLAVORS = {"gqa-rope": dict(attn="gqa", pos_emb="rope"),
           "mla-rope": dict(attn="mla", pos_emb="rope"),
           "mha-learn": dict(attn="mha", n_kv_heads=4, pos_emb="learn"),
           "moe": dict(moe=True, n_exp=6, n_shared=1, n_act=3,
                       aux_free=True)}


@pytest.mark.parametrize("kw", FLAVORS.values(), ids=FLAVORS.keys())
def test_spec_matches_reference_engine_and_spec_off(kw, monkeypatch):
    """Ragged continuous batching with speculation on, sharp models, the
    oracle drafter: the reference's spec-on engine's tokens, and the
    port's spec-off engine's; drafts were accepted in part, and the
    accounting adds up."""
    built = build(**kw)
    jm, var, tm, _ = built
    ref = jengine(jm, var, spec_decode=True, spec_k=4).run(PROMPTS, 8)
    monkeypatch.setattr(decode_mod, "ngram_propose", oracle_drafter(ref))
    gm.reset_counts()
    eng = spec_engine(tm)
    out = eng.run(PROMPTS, 8)
    assert_same(built, PROMPTS, ref, out)
    assert_same(built, PROMPTS, out, plain_engine(tm).run(PROMPTS, 8))
    assert 0 < eng.spec_accepted_tokens < eng.spec_drafted_tokens
    assert eng.emitted_tokens == sum(len(o) - len(p) - 1
                                     for p, o in zip(PROMPTS, out))
    assert eng.flight.total == eng.n_steps
    if kw.get("moe"):
        assert gm.DEGRADED["dense"] == 0 and gm.PLAIN_CALLS["grouped_mm_fwd"]


@pytest.mark.parametrize("kw", [FLAVORS["gqa-rope"], FLAVORS["mla-rope"]],
                         ids=["gqa-rope", "mla-rope"])
def test_ngram_drafter_engine_matches_reference(kw):
    """The n-gram drafter itself on the init-scale model (the reference's
    own test setting, where the streams repeat and drafts hit): the
    reference's spec-on tokens and the port's spec-off tokens."""
    built = build(scale=1.0, **kw)
    jm, var, tm, _ = built
    ref = jengine(jm, var, spec_decode=True, spec_k=4).run(PROMPTS, 8)
    eng = spec_engine(tm)
    out = eng.run(PROMPTS, 8)
    assert_same(built, PROMPTS, ref, out)
    assert_same(built, PROMPTS, out, plain_engine(tm).run(PROMPTS, 8))
    assert 0 < eng.spec_accepted_tokens <= eng.spec_drafted_tokens


def test_spec_int8_kv_matches_spec_off_and_reference(monkeypatch):
    """int8 KV: the K+1-row verify writes quantize row by row as the
    decode writes do — spec on equals spec off at the same dtype, and the
    reference's int8 spec-on engine within the int8 limit."""
    built = build()
    jm, var, tm, _ = built
    monkeypatch.setenv("FLASH_DECODE", "on")
    ref = JEngine(JLLM(jm.config, attn_impl="auto"), var, n_slots=2,
                  min_bucket=8, temperature=0.0, cache_dtype="int8",
                  spec_decode=True, spec_k=4).run(PROMPTS, 8)
    monkeypatch.setattr(decode_mod, "ngram_propose", oracle_drafter(ref))
    on = spec_engine(tm, cache_dtype="int8")
    out = on.run(PROMPTS, 8)
    assert on.kv_quantized and on.spec_drafted_tokens > 0
    assert_same(built, PROMPTS, ref, out, TOL + 2 * INT8_LIMIT)
    off = plain_engine(tm, cache_dtype="int8").run(PROMPTS, 8)
    assert_same(built, PROMPTS, out, off, TOL + 2 * INT8_LIMIT)


def test_spec_with_prefix_reuse(monkeypatch):
    """Prompts resolving to cached prefix blocks verify from mid-sequence
    over shared blocks; a second pass hits the cache and repeats."""
    built = build()
    jm, var, tm, _ = built
    shared = [3, 1, 4, 1, 5, 9, 2, 6] * 3            # 3 full 8-blocks
    prompts = [shared + [30], shared + [40, 41]]
    ref = jengine(jm, var, block_size=8, spec_decode=True,
                  spec_k=4).run(prompts, 8)
    monkeypatch.setattr(decode_mod, "ngram_propose", oracle_drafter(ref))
    eng = spec_engine(tm, block_size=8)
    outs = eng.run(prompts, 8)
    assert eng.run(prompts, 8) == outs
    assert eng.prefix_hit_tokens > 0 and eng.spec_drafted_tokens > 0
    assert_same(built, prompts, ref, outs)


def test_spec_under_preemption(monkeypatch):
    """A tight pool preempts mid-decode; the requeued sequence resumes
    with speculation on both sides, and no block leaks."""
    built = build()
    jm, var, tm, _ = built
    prompts = [[1, 2, 3, 1, 2, 3, 1], [5] * 9]
    kw = dict(n_slots=2, block_size=8, n_blocks=9)
    ref = jengine(jm, var, spec_decode=True, spec_k=4, **kw).run(prompts, 40)
    monkeypatch.setattr(decode_mod, "ngram_propose", oracle_drafter(ref))
    eng = spec_engine(tm, **kw)
    outs = eng.run(prompts, 40)
    assert eng.retire_counts["preempted"] > 0, "the pool never got tight"
    assert eng.spec_accepted_tokens > 0
    assert eng.block_pool.n_referenced == 0
    assert_same(built, prompts, ref, outs)
    assert_same(built, prompts, outs, plain_engine(tm, **kw).run(prompts, 40))


@pytest.mark.parametrize("budget", [1, 2, 5])
def test_spec_budget_boundary_exact(budget, monkeypatch):
    """The draft clamp keeps every output at exactly prompt + budget even
    when the drafts would all be accepted."""
    built = build()
    jm, var, tm, _ = built
    (ref,) = jengine(jm, var, spec_decode=True, spec_k=6).run([[7] * 12],
                                                             100)
    monkeypatch.setattr(decode_mod, "ngram_propose",
                        oracle_drafter([ref], wrong_every=10 ** 6))
    eng = spec_engine(tm, spec_k=6)
    (out,) = eng.run([[7] * 12], budget)
    assert len(out) == 12 + budget
    # the first token comes from the prefill; the last step's correction
    assert eng.spec_accepted_tokens == max(budget - 2, 0)
    assert_same(built, [[7] * 12], [ref[:12 + budget]], [out])


def test_spec_max_len_boundary(monkeypatch):
    """Near the cache end speculation falls back to the plain step and the
    engine retires at exactly max_len + 1 tokens ('cache_full')."""
    built = build(block_size=16)
    jm, var, tm, _ = built
    (ref,) = jengine(jm, var, n_slots=1, spec_decode=True,
                     spec_k=4).run([[1, 2, 1, 2, 1]], 1000)
    monkeypatch.setattr(decode_mod, "ngram_propose",
                        oracle_drafter([ref], wrong_every=10 ** 6))
    eng = spec_engine(tm, n_slots=1)
    (out,) = eng.run([[1, 2, 1, 2, 1]], 1000)
    assert len(out) == 16 + 1
    assert eng.spec_accepted_tokens > 0
    # speculation stops where pos + K + 1 would pass max_len
    assert eng.flight.entries()[-1]["drafted"] == 0
    assert eng.retire_counts["cache_full"] == 1
    assert_same(built, [[1, 2, 1, 2, 1]], [ref], [out])
    (off,) = plain_engine(tm, n_slots=1).run([[1, 2, 1, 2, 1]], 1000)
    assert_same(built, [[1, 2, 1, 2, 1]], [out], [off])


# ----------------------------------------------------------------------
# acceptance-length edges (a controlled drafter)
# ----------------------------------------------------------------------

def _drafted_run(tm, prompt, n, drafter, monkeypatch, **kw):
    monkeypatch.setattr(decode_mod, "ngram_propose", drafter)
    eng = spec_engine(tm, **kw)
    (out,) = eng.run([prompt], n)
    return eng, out


def _greedy(built, prompt, n):
    jm, var = built[:2]
    (ref,) = jengine(jm, var, spec_decode=False).run([prompt], n)
    return ref


def test_zero_accepted_still_exact(monkeypatch):
    """A drafter that is always wrong accepts nothing: each spec step
    emits the plain step's one correction token."""
    built = build()
    tm = built[2]
    prompt, n = [1, 2, 3, 1, 2, 3], 8
    ref = _greedy(built, prompt, n)

    def wrong(tokens, k, **_kw):
        i = len(tokens)
        return [(ref[i + j] + 1) % 97 for j in range(min(k, len(ref) - i))]

    eng, out = _drafted_run(tm, prompt, n, wrong, monkeypatch)
    assert_same(built, [prompt], [ref], [out])
    assert eng.spec_drafted_tokens > 0 and eng.spec_accepted_tokens == 0


def test_all_k_accepted(monkeypatch):
    """A drafter that proposes the greedy continuation gets every draft
    accepted, and a step advances several tokens."""
    built = build()
    tm = built[2]
    prompt, n = [1, 2, 3, 1, 2, 3], 9
    ref = _greedy(built, prompt, n)

    def perfect(tokens, k, **_kw):
        return ref[len(tokens):len(tokens) + k]

    eng, out = _drafted_run(tm, prompt, n, perfect, monkeypatch, spec_k=3)
    assert_same(built, [prompt], [ref], [out])
    assert out == ref
    assert 0 < eng.spec_accepted_tokens == eng.spec_drafted_tokens
    assert eng.accepted_token_rate == 1.0
    # 8 tokens after the first in 2 steps of 3 accepted + 1 correction
    assert eng.n_steps == 2 and eng.tokens_per_step == 4.0


def test_eos_inside_accepted_span(monkeypatch):
    """An EOS inside an accepted draft prefix cuts the emission at it and
    retires the slot with reason 'eos'."""
    built = build()
    tm = built[2]
    prompt = [1, 2, 3, 1, 2, 3]
    ref = _greedy(built, prompt, 10)
    eos = ref[len(prompt) + 2]          # the third generated token

    def perfect(tokens, k, **_kw):
        return ref[len(tokens):len(tokens) + k]

    eng, out = _drafted_run(tm, prompt, 10, perfect, monkeypatch,
                            eos_id=eos, spec_k=6)
    stop = ref.index(eos, len(prompt))
    assert out == ref[:stop + 1] and out[-1] == eos
    assert eng.retire_counts["eos"] == 1


# ----------------------------------------------------------------------
# gating, chunked prefill, the scheduler
# ----------------------------------------------------------------------

def test_spec_knob_gating(monkeypatch):
    """SPEC_DECODE 'auto' follows the request, 'on' / 'off' force it;
    temperature > 0 and spec_k 0 keep it off; SPEC_K sets the default
    draft length; and the gated engines give the same tokens."""
    tm = build(scale=1.0)[2]
    kw = dict(n_slots=2, min_bucket=8)
    assert not DecodeEngine(tm, temperature=0.7, spec_decode=True,
                            spec_k=4, **kw).spec_decode
    assert not DecodeEngine(tm, temperature=0.0, spec_decode=True,
                            spec_k=0, **kw).spec_decode
    assert not DecodeEngine(tm, temperature=0.0, **kw).spec_decode
    monkeypatch.setenv("SPEC_DECODE", "on")
    monkeypatch.setenv("SPEC_K", "3")
    forced = DecodeEngine(tm, temperature=0.0, **kw)
    assert forced.spec_decode and forced.spec_k == 3
    monkeypatch.setenv("SPEC_DECODE", "off")
    assert not DecodeEngine(tm, temperature=0.0, spec_decode=True,
                            **kw).spec_decode
    monkeypatch.setenv("SPEC_DECODE", "sometimes")
    with pytest.raises(ValueError):
        DecodeEngine(tm, temperature=0.0, **kw)
    monkeypatch.delenv("SPEC_DECODE")
    assert forced.run(PROMPTS[:2], 6) == \
        plain_engine(tm).run(PROMPTS[:2], 6)
    assert forced.spec_drafted_tokens > 0


def test_chunked_prefill_with_spec(monkeypatch):
    """A chunked engine speculates on chunk-free steps only, with the
    reference's spec-on chunked tokens."""
    built = build()
    jm, var, tm, _ = built
    prompts = [[1, 2, 3, 1, 2, 3], list(range(1, 40)), [7] * 10]
    ref = jengine(jm, var, prefill_chunk=16, spec_decode=True,
                  spec_k=4).run(prompts, 8)
    monkeypatch.setattr(decode_mod, "ngram_propose", oracle_drafter(ref))
    eng = spec_engine(tm, prefill_chunk=16)
    seen = []
    step = eng.step

    def watched():
        res = step()
        seen.append((res.prefill_tokens, res.drafted))
        return res

    eng.step = watched
    outs = eng.run(prompts, 8)
    assert_same(built, prompts, ref, outs)
    assert any(d for _, d in seen)
    assert not any(p and d for p, d in seen)


def test_scheduler_streams_spec_tokens_in_order(monkeypatch):
    """Multi-token steps fan into the request streams in generation order,
    and the spec counters and gauges reach the scheduler's metrics."""
    built = build()
    jm, var, tm, _ = built
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 9, 4, 9, 4, 9], [20] * 10]
    budget = 8
    ref = jengine(jm, var, spec_decode=True, spec_k=4).run(prompts, budget)
    monkeypatch.setattr(decode_mod, "ngram_propose", oracle_drafter(ref))

    async def main():
        eng = spec_engine(tm)
        sched = Scheduler(eng, max_queue=8)
        await sched.start()
        handles = [sched.submit(p, budget) for p in prompts]
        await asyncio.gather(*(h.result() for h in handles))
        await sched.stop()
        return eng, sched, handles

    eng, sched, handles = asyncio.run(asyncio.wait_for(main(), 300))
    assert_same(built, prompts, ref, [p + h.tokens for p, h in
                                      zip(prompts, handles)])
    assert all(h.retired.reason == "budget" for h in handles)
    m = sched.metrics.counters
    assert m["spec_drafted_tokens"] == eng.spec_drafted_tokens > 0
    assert eng.spec_accepted_tokens > 0
    assert m["spec_accepted_tokens"] == eng.spec_accepted_tokens
    assert m["tokens_out"] == len(prompts) * budget
    snap = sched.metrics.snapshot()["gauges"]
    assert snap["serve_spec_accepted_token_rate"] == pytest.approx(
        eng.accepted_token_rate, abs=1e-6)
    assert snap["serve_engine_tokens_per_step"] == pytest.approx(
        eng.tokens_per_step, abs=1e-6)
