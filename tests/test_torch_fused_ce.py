"""The port's fused cross-entropy (ops/fused_ce.py) against the reference
package's Pallas kernels run in interpret mode on the CPU: the three
kernels' plain versions against `_fwd` / `_bwd` (vocab 64, 96 and the
ragged 100, and the GPT-2 vocab 50304, with ignored rows), the
`pallas_cross_entropy` loss and its gradients in fp32 and bf16, the
usability gate, and the model's `loss_impl='pallas'` route against the
reference model on converted weights. Then the wrappers' refusals. Each
test states its tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu.ops import fused_ce as jce
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.ops import fused_ce as tce
from distributed_pytorch_tpu_torch.train.state import build_model


def _data(n, C, V, seed=0, n_ignored=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, C)).astype(np.float32)
    w = (0.1 * rng.standard_normal((V, C))).astype(np.float32)
    t = rng.integers(0, V, n).astype(np.int32)
    t[:n_ignored] = -2                      # ignored rows: match no column
    coef = rng.standard_normal(n).astype(np.float32)
    coef[:n_ignored] = 0.0
    return x, w, t, coef


def _reference(x, w, t, coef):
    """The reference kernels in interpret mode, tiled as its wrapper tiles
    them: (nll, lse, dx, dW) as numpy."""
    n, V = x.shape[0], w.shape[0]
    bn = jce._pick(n, jce.DEFAULT_BLOCK_N)
    bv = min(jce.DEFAULT_BLOCK_V, -(-V // 8) * 8)
    w_pad = jce._pad_vocab(jnp.asarray(w), bv)
    tt = jnp.asarray(t)[:, None]
    nll, lse = jce._fwd(jnp.asarray(x), w_pad, tt, bn, bv, V, True)
    dx, dw = jce._bwd(jnp.asarray(x), w_pad, tt, lse,
                      jnp.asarray(coef)[:, None], bn, bv, V, True)
    return (np.asarray(nll)[:, 0], np.asarray(lse)[:, 0], np.asarray(dx),
            np.asarray(dw)[:V])


@pytest.mark.parametrize("n,C,V", [(64, 128, 64), (64, 128, 96),
                                   (64, 128, 100), (16, 128, 50304)])
def test_plain_versions_match_reference_kernels(n, C, V):
    """fp32, atol 1e-5 element by element on nll, lse, dx and dW
    (summation order; |lse| ~ ln V): the ragged vocab 100 and the 50304
    vocab take the reference's host padding and the port's masking."""
    x, w, t, coef = _data(n, C, V)
    r_nll, r_lse, r_dx, r_dw = _reference(x, w, t, coef)
    tx, tw, tt, tc = map(torch.from_numpy, (x, w, t, coef))
    tce.reset_counts()
    nll, lse = tce.fused_ce_fwd(tx, tw, tt)
    dx = tce.fused_ce_bwd_dx(tx, tw, tt, lse, tc)
    dw = tce.fused_ce_bwd_dw(tx, tw, tt, lse, tc)
    assert tce.PLAIN_CALLS == {k: 1 for k in tce.PLAIN_CALLS}
    assert tce.LAUNCHES == {k: 0 for k in tce.LAUNCHES}
    for got, ref in ((nll, r_nll), (lse, r_lse), (dx, r_dx), (dw, r_dw)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    # an ignored row (target -2): nll = lse, and coef 0 gives dx exactly 0
    np.testing.assert_array_equal(nll[:5].numpy(), lse[:5].numpy())
    assert torch.count_nonzero(dx[:5]) == 0


def _loss_data(dtype, B=2, T=32, C=128, V=100, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    emb = (0.1 * rng.standard_normal((V, C))).astype(np.float32)
    tgt = rng.integers(0, V, (B, T))
    tgt[:, -5:] = -1
    if dtype == "bfloat16":   # the same bf16 values on both sides
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        emb = np.array(jnp.asarray(emb, jnp.bfloat16).astype(jnp.float32))
    return x, emb, tgt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_cross_entropy_matches_reference(dtype):
    """Loss and gradients (x and the embedding) against the reference's
    `pallas_cross_entropy(interpret=True)`, with ignored targets. fp32:
    rtol 1e-6 on the loss, atol 2e-6 on the gradients (the reference's own
    limits against its oracle). bf16: loss rtol 1e-5 (fp32 scores from the
    same bf16 values, summation order); gradients within one bf16 ulp
    (2^-8 relative) plus atol 1e-6, since dlogits round to bf16 on both
    sides and a sum-order difference can tip a rounding. Ignored rows
    get exactly zero dx."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, emb, tgt = _loss_data(dtype)
    ref, (g_x, g_e) = jax.value_and_grad(
        lambda a, e: jce.pallas_cross_entropy(a, e, jnp.asarray(tgt),
                                              interpret=True),
        argnums=(0, 1))(jnp.asarray(x, jdt), jnp.asarray(emb, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    te = torch.from_numpy(emb).to(tdt).requires_grad_()
    loss = tce.pallas_cross_entropy(tx, te, torch.from_numpy(tgt))
    loss.backward()
    assert tx.grad.dtype == tdt and te.grad.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
        tol = dict(atol=2e-6, rtol=0)
    else:
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
        tol = dict(atol=1e-6, rtol=2 ** -8)
    for got, r in ((tx.grad, g_x), (te.grad, g_e)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)), **tol)
    assert torch.count_nonzero(tx.grad[:, -5:]) == 0


def test_pallas_ce_usable_gate():
    """The reference's gate cases, plus what it refuses besides; the
    kernels take every width it accepts (1280: GPT-2 large)."""
    for usable, args in ((True, (16384, 768, torch.bfloat16)),
                         (True, (16384, 1280, torch.bfloat16)),
                         (False, (16384, 120, torch.bfloat16)),
                         (False, (16384, 768, torch.float16)),
                         (True, (64, 128, torch.float32)),
                         (False, (4, 128, torch.float32)),
                         (False, (0, 128, torch.float32))):
        assert tce.pallas_ce_usable(*args) is usable, args
        jdt = getattr(jnp, str(args[2]).removeprefix("torch."))
        assert jce.pallas_ce_usable(args[0], args[1], jdt) is usable, args


TINY = dict(vocab_size=97, block_size=32, n_embd=128, n_head=4, n_kv_heads=2,
            attn="gqa", n_layer=2, up_dim=96, non_linearity="swiglu",
            pos_emb="rope")


def _tree_close(got: dict, ref: dict, atol, what):
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), atol=atol,
                                   rtol=0, err_msg=f"{what} {name}")


def test_model_pallas_loss_matches_reference_model():
    """`LLM(loss_impl='pallas')` from converted weights against the
    reference LLM (whose CPU run takes its oracle route): loss and every
    parameter's gradient, fp32, atol 1e-4. The port's loss runs through the
    fused CE functions (their plain versions here), not the chunked path."""
    mc = JConfig(**TINY, loss_impl="pallas")
    jm = JLLM(mc, attn_impl="naive")
    rng = np.random.default_rng(2)
    x = rng.integers(0, 97, (2, 32))
    y = rng.integers(0, 97, (2, 32))
    y[0, :3] = -1
    key = jax.random.PRNGKey(4)
    var = jm.init({"params": key, "dropout": key}, jnp.asarray(x),
                  jnp.asarray(y))

    def f(params):
        return jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))[1]

    ref, g = jax.value_and_grad(f)(var["params"])
    cfg = LLMConfig(**TINY, loss_impl="pallas")
    model = build_model(cfg, TrainConfig(compute_dtype="float32"), "cpu")
    model.load_state_dict(params_from_jax(jax.device_get(var["params"]), cfg))
    tce.reset_counts()
    _, loss = model(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert tce.PLAIN_CALLS == {k: 1 for k in tce.PLAIN_CALLS}
    assert tce.DEGRADED["chunked"] == 0
    np.testing.assert_allclose(loss.item(), float(ref), atol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()}
    _tree_close(grads, params_from_jax(jax.device_get(g), cfg), 1e-4, "grad")


def test_model_degrades_to_chunked_where_the_gate_refuses():
    """n_embd 64 fails the gate's lane multiple: the model takes the
    chunked loss, counts it in DEGRADED, and equals loss_impl='fused'
    exactly (fp32)."""
    cfg = LLMConfig(**{**TINY, "n_embd": 64}, loss_impl="pallas")
    model = build_model(cfg, TrainConfig(compute_dtype="float32"), "cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 97, (2, 32)))
    tce.reset_counts()
    _, loss = model(x, x.roll(-1, 1))
    assert tce.DEGRADED["chunked"] == 1
    assert tce.PLAIN_CALLS == {k: 0 for k in tce.PLAIN_CALLS}
    model.config = dataclasses.replace(cfg, loss_impl="fused")
    _, ref = model(x, x.roll(-1, 1))
    assert torch.equal(loss, ref)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,match", [
    ("fp16", "fp32 or bf16"), ("mixed", "fp32 or bf16"),
    ("strided", "contiguous"), ("width", "multiple of 128"),
    ("targets", "int32"), ("meta", "CUDA tensors")])
def test_wrappers_refuse_what_the_kernels_do_not_take(case, match):
    """A wrapper runs the plain version only for CPU tensors; anything
    else must be operands the kernel takes on a CUDA card, or it raises —
    shown here on meta tensors, which no card is needed to build."""
    n, C, V = 32, 128, 100
    x, w = _meta((n, C)), _meta((V, C))
    t = _meta((n,), torch.int32)
    rows = (_meta((n,)), _meta((n,)))
    if case == "fp16":
        x, w = x.half(), w.half()
    elif case == "mixed":
        w = w.to(torch.bfloat16)
    elif case == "strided":
        x = _meta((C, n)).t()
    elif case == "width":
        x, w = _meta((n, 96)), _meta((V, 96))
    elif case == "targets":
        t = _meta((n,), torch.int64)
    for fn, extra in ((tce.fused_ce_fwd, ()), (tce.fused_ce_bwd_dx, rows),
                      (tce.fused_ce_bwd_dw, rows)):
        with pytest.raises(ValueError, match=match):
            fn(x, w, t, *extra)
    assert tce.LAUNCHES == {k: 0 for k in tce.LAUNCHES}
