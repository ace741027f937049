"""The port's DecodeEngine against the reference package's DecodeEngine and
against the port's own one-shot `generate`: greedy outputs through
continuous batching, with a shared prompt prefix (radix reuse) and with a
pool small enough to force preemption and requeue. Greedy tokens are
compared where the reference's top-2 logit margin exceeds the tolerance;
past a position where it does not, a legitimate tie flip may diverge the
rest of the sequence, so the comparison stops there."""

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


def _assert_greedy_agree(ref, out, prompt_len, margins):
    """ref/out token lists; margins[i] is the reference's top-2 gap for the
    token at prompt_len + i."""
    assert out[:prompt_len] == ref[:prompt_len]
    for i, m in enumerate(margins):
        if m <= TOL:
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
