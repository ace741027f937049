"""The port's LLM against the reference package's on converted weights
(distributed_pytorch_tpu_torch/convert.py): uncached logits, a paged
prefill at offset 0 and at a block-aligned offset sharing a prefix block,
then batched paged decode steps at per-sequence positions, and the
contiguous-cache generate. fp32, atol 1e-4 on logits (the two frameworks
order their float sums differently across 2 layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.models.generate import generate as jgenerate
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.models.gpt import init_paged_cache as j_paged
from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.models.generate import generate
from distributed_pytorch_tpu_torch.models.gpt import LLM, count_params
from distributed_pytorch_tpu_torch.models.gpt import init_paged_cache

ATOL = 1e-4
KW = {
    "gqa-rope": dict(vocab_size=97, block_size=64, n_embd=64, n_head=4,
                     n_kv_heads=2, attn="gqa", n_layer=2, up_dim=96,
                     non_linearity="swiglu", pos_emb="rope"),
    "mha-learn": dict(vocab_size=97, block_size=64, n_embd=64, n_head=4,
                      n_kv_heads=4, attn="mha", n_layer=2, up_dim=96,
                      non_linearity="gelu", pos_emb="learn"),
    "mqa-sin": dict(vocab_size=97, block_size=64, n_embd=64, n_head=4,
                    n_kv_heads=1, attn="mqa", n_layer=2, up_dim=96,
                    non_linearity="glu", pos_emb="sin"),
}


def _pair(kw, seed=0):
    jm = JLLM(JConfig(**kw), attn_impl="naive")
    x = jnp.zeros((1, kw["block_size"]), jnp.int32)
    key = jax.random.PRNGKey(seed)
    var = dict(jm.init({"params": key, "dropout": key}, x, x))
    cfg = LLMConfig(**kw)
    tm = LLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(var["params"]), cfg))
    return jm, var, tm


@pytest.fixture(scope="module", params=list(KW))
def pair(request):
    return (request.param,) + _pair(KW[request.param])


def test_uncached_logits(pair):
    _, jm, var, tm = pair
    idx = np.random.default_rng(0).integers(0, 97, (2, 24)).astype(np.int32)
    ref, _, _ = jm.apply(var, jnp.asarray(idx), all_logits=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(idx).long(), all_logits=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_paged_prefill_then_decode(pair):
    """Sequence 0 prefills a 13-token prompt in a 16-row bucket at offset
    0; sequence 1 shares its first block and prefills 8 rows at the
    block-aligned offset 8; then both decode 3 steps together at their own
    positions. Every logit matches the reference's same calls."""
    _, jm, var, tm = pair
    cfg = tm.config
    rng = np.random.default_rng(1)
    n_blocks, bs = 12, 8
    bt = np.array([[3, 7, 1, 9, 0, 0], [3, 5, 2, 0, 0, 0]], np.int32)
    jc = j_paged(jm.config, n_blocks, bs)
    tc = init_paged_cache(cfg, n_blocks, bs)
    p0 = rng.integers(0, 97, 13)
    p1 = rng.integers(0, 97, 6)
    steps = [
        # (tokens (B, T), pos, row of the table, logits_idx)
        (np.pad(p0, (0, 3))[None], 0, 0, [12]),
        (np.pad(p1, (0, 2))[None], 8, 1, [5]),
    ]
    japply = jax.jit(jm.apply)                  # positions traced
    for toks, pos, row, li in steps:
        ref, _, jc = japply(var, jnp.asarray(toks, jnp.int32), None, jc,
                            jnp.int32(pos),
                            logits_idx=jnp.asarray(li, jnp.int32),
                            block_tables=jnp.asarray(bt[row:row + 1]))
        with torch.no_grad():
            out = tm(torch.from_numpy(toks).long(), tc, pos, logits_idx=li,
                     block_tables=torch.from_numpy(bt[row:row + 1]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
    pos = np.array([13, 14], np.int32)
    for _ in range(3):
        tok = rng.integers(0, 97, (2, 1)).astype(np.int32)
        ref, _, jc = japply(var, jnp.asarray(tok), None, jc,
                            jnp.asarray(pos), block_tables=jnp.asarray(bt))
        with torch.no_grad():
            out = tm(torch.from_numpy(tok).long(), tc,
                     torch.from_numpy(pos).long(),
                     block_tables=torch.from_numpy(bt))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
        pos = pos + 1


def test_generate_greedy_matches(pair):
    """Contiguous-cache greedy decoding gives the reference's tokens: no
    top-2 logit margin along the reference's path is within the tolerance
    here, so every token must match."""
    name, jm, var, tm = pair
    prompt = np.random.default_rng(2).integers(0, 97, (2, 7)).astype(
        np.int32)
    ref = np.asarray(jgenerate(jm, var, jnp.asarray(prompt), 10,
                               temperature=0.0))
    logits, _, _ = jm.apply(var, jnp.asarray(ref[:, :-1]), all_logits=True)
    top2 = np.sort(np.asarray(logits)[:, 6:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > ATOL, name
    out = generate(tm, torch.from_numpy(prompt), 10, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_count_params_matches_reference(pair):
    _, jm, var, tm = pair
    total = sum(int(np.prod(a.shape)) for a in
                jax.tree_util.tree_leaves(var["params"]))
    assert count_params(tm, tm.config) == (total, total)
