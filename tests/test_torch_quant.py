"""The port's int8 quantization (distributed_pytorch_tpu_torch/ops/quant.py)
against the reference package's `ops/quant.py`, on the CPU, with the same
numpy inputs: `quantize_int8`/`quantize_kv` codes bit for bit and scales
within 1 ulp (zero groups stay zero); `quantize_params` of converted
weights against the reference's tree, transposed to the `nn.Linear`
layout; `maybe_quantized_matmul` (fp32, 1e-5); the engine's int8 choices
and MLA's refusal; and teacher-forced logits of a tiny model with an int8
KV cache and with int8 weights, port against reference in fp32 at 1e-4
(both run the same arithmetic; the reference's own int8-vs-fp32 limits
are 2e-2 and 5e-2)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.models.gpt import init_cache as jinit_cache
from distributed_pytorch_tpu.ops import quant as jq
from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.engine import DecodeEngine
from distributed_pytorch_tpu_torch.models.attention import init_attn_cache
from distributed_pytorch_tpu_torch.models.gpt import LLM, init_cache
from distributed_pytorch_tpu_torch.ops import quant as tq

TOL = 1e-4
KW = dict(vocab_size=97, block_size=64, n_embd=64, n_head=4, n_kv_heads=2,
          attn="gqa", n_layer=2, up_dim=96, non_linearity="swiglu",
          pos_emb="rope")
TOKENS = [5, 6, 7, 8, 9, 10, 11, 3, 90, 41, 17, 2]


@pytest.fixture(scope="module")
def pair():
    jm = JLLM(JConfig(**KW), attn_impl="naive")
    x = jnp.zeros((1, KW["block_size"]), jnp.int32)
    key = jax.random.PRNGKey(0)
    var = dict(jm.init({"params": key, "dropout": key}, x, x))
    cfg = LLMConfig(**KW)
    tm = LLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(var["params"]), cfg))
    tm.eval()
    return jm, var, tm


@pytest.mark.parametrize("shape,dim", [((6, 9, 4, 16), -1), ((64, 192), 0),
                                       ((97, 64), 1)],
                         ids=["kv-rows", "in-out", "vocab-rows"])
def test_quantize_int8_matches_reference(shape, dim):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 5.0)) \
        .astype(np.float32)
    zero = (slice(None), 0) if dim == 0 else (0,)   # one all-zero group
    x[zero] = 0.0
    jc, js = jq.quantize_int8(jnp.asarray(x), axis=dim)
    tc, ts = tq.quantize_int8(torch.from_numpy(x), dim=dim)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    assert not tc.numpy()[zero].any() and not ts.numpy()[zero].any()
    deq = tq.dequantize_int8(tc, ts).numpy()
    assert not deq[zero].any()
    # round-trip error at most half a step of each group's scale
    assert (np.abs(deq - x) <= ts.numpy() / 2 + 1e-7).all()


def test_quantize_kv_rows_and_zero_rows():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    x[1, 2] = 0.0
    tc, ts = tq.quantize_kv(torch.from_numpy(x))
    jc, js = jq.quantize_kv(jnp.asarray(x))
    assert tuple(ts.shape) == (2, 5, 2, 1) == js.shape
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    assert not tc[1, 2].any() and not ts[1, 2].any()


def test_quantize_params_matches_reference_tree(pair):
    """The port's store of the converted weights equals the reference's
    tree transposed to `nn.Linear` layout: codes bit for bit, scales to 1
    ulp; biases, norms and nothing else are left out."""
    _, var, tm = pair
    ref = jq.quantize_params(var["params"])
    store = tq.quantize_params(dict(tm.named_parameters()))
    want = {"tkn_emb.weight"}
    for i in range(KW["n_layer"]):
        want |= {f"blocks.{i}.attn.c_attn.weight",
                 f"blocks.{i}.attn.c_proj.weight",
                 f"blocks.{i}.mlp.c_fc", f"blocks.{i}.mlp.c_proj"}
    assert set(store) == want

    def same(name, node, transpose):
        codes, scale = np.asarray(node["q8"]), np.asarray(node["scale"])
        if transpose:
            codes, scale = codes.T, scale.T
        np.testing.assert_array_equal(store[name]["q8"].numpy(), codes)
        np.testing.assert_array_max_ulp(store[name]["scale"].numpy(), scale,
                                        maxulp=1)

    same("tkn_emb.weight", ref["tkn_emb"]["embedding"], False)
    for i in range(KW["n_layer"]):
        b = ref[f"block_{i}"]
        for lin in ("c_attn", "c_proj"):
            same(f"blocks.{i}.attn.{lin}.weight", b["attn"][lin]["kernel"],
                 True)
        for w in ("c_fc", "c_proj"):
            same(f"blocks.{i}.mlp.{w}", b["mlp"][w], False)
    # the inverse: dequantized weights within half a step of the originals
    params = dict(tm.named_parameters())
    for name, e in store.items():
        w = tq.dequantize_int8(e["q8"], e["scale"])
        assert ((w - params[name].detach()).abs()
                <= e["scale"] / 2 + 1e-7).all()


@pytest.mark.parametrize("transpose_b", [False, True],
                         ids=["in-out", "tied-head"])
def test_maybe_quantized_matmul_matches_reference(transpose_b):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    w = rng.standard_normal((48, 32) if transpose_b else (32, 48)) \
        .astype(np.float32)
    jnames = ("tkn_emb", "embedding") if transpose_b else ("w", "kernel")
    jc, js = jq.quantize_int8(jnp.asarray(w), axis=1 if transpose_b else 0)
    with jq.use_quantized_params({jnames[0]: {jnames[1]: {"q8": jc,
                                                          "scale": js}}}):
        ref = jq.maybe_quantized_matmul(jnp.asarray(x), jnames,
                                        transpose_b=transpose_b)
    tc, ts = tq.quantize_int8(torch.from_numpy(w),
                              dim=1 if transpose_b else 0)
    tx = torch.from_numpy(x)
    assert tq.maybe_quantized_matmul(tx, "w") is None     # no store active
    with tq.use_quantized_params({"w": {"q8": tc, "scale": ts}}):
        out = tq.maybe_quantized_matmul(tx, "w", transpose_b=transpose_b)
        assert tq.maybe_quantized_matmul(tx, "other") is None
        assert tq.maybe_quantized_matmul(tx, None) is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("cache_dtype,quantize_weights", [
    ("int8", True), ("int8", False), (None, True), (None, False)],
    ids=["cache-weights", "cache", "weights", "neither"])
def test_engine_follows_the_request(pair, cache_dtype, quantize_weights):
    """The engine quantizes the cache and the decode weights exactly as
    its arguments ask; an int8 cache keeps fp32 (n_blocks, bs, nkv, 1)
    scale pools beside its codes."""
    eng = DecodeEngine(pair[2], cache_dtype=cache_dtype,
                       quantize_weights=quantize_weights, n_slots=1,
                       temperature=0.0, min_bucket=8, block_size=8)
    q8 = cache_dtype == "int8"
    assert eng.kv_quantized == q8
    assert eng.weights_quantized == quantize_weights
    assert (eng._qparams is not None) == quantize_weights
    c = eng.caches[0]
    assert c["k"].dtype == (torch.int8 if q8 else torch.float32)
    assert ("k_scale" in c) == q8
    if q8:
        assert c["k_scale"].dtype == torch.float32
        assert tuple(c["k_scale"].shape) == (eng.n_blocks, 8, 2, 1)


def test_int8_declines_mla(pair):
    """MLA's latent cache declines int8 (`quant_kv_usable`), as in the
    reference; an int8 MLA cache is refused with the reference's
    ValueError, and a cache dtype other than int8 must be the model's
    own."""
    for cfg in (JConfig(**{**KW, "attn": "mla"}),
                LLMConfig(**{**KW, "attn": "mla"})):
        assert not tq.quant_kv_usable(cfg) and not jq.quant_kv_usable(cfg)
    assert tq.quant_kv_usable(LLMConfig(**KW))
    with pytest.raises(ValueError, match="GQA family only"):
        init_attn_cache(LLMConfig(**{**KW, "attn": "mla"}), 1, 16,
                        dtype=torch.int8)
    with pytest.raises(ValueError):          # the model is fp32
        DecodeEngine(pair[2], cache_dtype="bfloat16", n_slots=1,
                     temperature=0.0, min_bucket=8, block_size=8)


def _logits_jax(jm, var, tokens, cache_dtype, qparams):
    c = jinit_cache(jm.config, 1, KW["block_size"], dtype=cache_dtype)
    out, pos = [], 0
    for chunk in [tokens[:4]] + [[t] for t in tokens[4:]]:
        ctx = (jq.use_quantized_params(qparams) if qparams is not None
               else contextlib.nullcontext())
        with ctx:
            lg, _, c = jm.apply(var, jnp.asarray([chunk], jnp.int32), None,
                                c, pos, deterministic=True)
        out.append(np.asarray(lg)[0, -1])
        pos += len(chunk)
    return np.stack(out)


def _logits_torch(tm, tokens, cache_dtype, store):
    c = init_cache(tm.config, 1, KW["block_size"], dtype=cache_dtype,
                   device="cpu")
    out, pos = [], 0
    with torch.no_grad():
        for chunk in [tokens[:4]] + [[t] for t in tokens[4:]]:
            p = pos if pos == 0 else torch.tensor(pos)
            with tq.use_quantized_params(store):
                lg = tm(torch.tensor([chunk]), caches=c, pos=p)
            out.append(lg[0, -1].numpy())
            pos += len(chunk)
    return np.stack(out)


@pytest.mark.parametrize("leg", ["int8-cache", "int8-weights"])
def test_teacher_forced_logits_match_reference(pair, leg):
    """A 4-token prefill then 8 teacher-forced decode steps through the
    contiguous cache: int8 codes in the cache (the port's decode steps go
    through the `_q8` plain version, the reference's through its
    dequantizing path) or int8 weights in every forward. Port against
    reference at 1e-4; each stays within the reference's own int8-vs-fp32
    limit."""
    jm, var, tm = pair
    if leg == "int8-cache":
        jdt, tdt, jstore, tstore, limit = jnp.int8, torch.int8, None, None, \
            2e-2
    else:
        jdt, tdt, limit = jnp.float32, torch.float32, 5e-2
        jstore = jq.quantize_params(var["params"])
        tstore = tq.quantize_params(dict(tm.named_parameters()))
    ref = _logits_jax(jm, var, TOKENS, jdt, jstore)
    out = _logits_torch(tm, TOKENS, tdt, tstore)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    exact = _logits_torch(tm, TOKENS, torch.float32, None)
    assert 0 < np.abs(out - exact).max() <= limit


def test_generate_with_int8_cache_matches_reference(pair):
    """`generate(cache_dtype=int8)` (decode steps through the contiguous
    `_q8` route) gives the reference's int8-cache greedy tokens wherever
    the fp32 model's top-2 margin clears twice the int8 limit."""
    from distributed_pytorch_tpu.models.generate import make_generate_fn
    from distributed_pytorch_tpu_torch.models.generate import generate
    from distributed_pytorch_tpu_torch.ops import flash_decode as tfd

    jm, var, tm = pair
    prompt = TOKENS[:7]
    ref = np.asarray(make_generate_fn(jm, 10, temperature=0.0,
                                      cache_dtype=jnp.int8)(
        var, jnp.asarray([prompt], jnp.int32), jax.random.PRNGKey(0)))[0]
    tfd.reset_counts()
    out = generate(tm, prompt, 10, temperature=0.0,
                   cache_dtype=torch.int8)[0].tolist()
    assert tfd.PLAIN_CALLS["paged_decode_attn_q8"] == 9 * KW["n_layer"]
    with torch.no_grad():
        lg = tm(torch.tensor([ref[:-1].tolist()]), all_logits=True)[0]
    top2 = torch.sort(lg[len(prompt) - 1:], dim=-1).values[:, -2:]
    margins = (top2[:, 1] - top2[:, 0]).tolist()
    assert out[:len(prompt)] == prompt
    for i, m in enumerate(margins):
        if m <= TOL + 2 * 2e-2:
            break
        assert out[len(prompt) + i] == int(ref[len(prompt) + i]), i
