"""The port's grouped matmul (ops/grouped_matmul.py) against the reference
package's on the CPU: the packing metadata exactly, the plain versions of
the three kernels against the reference's Pallas calls in interpret mode,
the autograd Function against `jax.vjp` of `gmm`, and the whole dispatch
against the reference's and against the port's dense combine. bm is 8, as
the reference's interpret mode uses; the group sizes are those of the
reference's own tests plus one whose last group is empty (trailing tiles
then resolve to an empty group). Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops import grouped_matmul as jgm
from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.models.mlp import activate, mlp_apply
from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm

BM, E, K, N = 8, 4, 32, 48
SIZES = {"ragged": [10, 0, 5, 7], "one_expert": [0, 0, 22, 0],
         "singletons": [1, 1, 1, 1], "empty_last": [6, 3, 11, 0]}


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat_e(sizes, seed=0):
    """Expert ids of the assignments, in a seeded order."""
    ids = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    return np.random.default_rng(seed).permutation(ids)


def _buffer(sizes, seed=1):
    """Metadata from both packages and random packed operands: rows, a
    weight stack, gates (0 on unfilled rows, as the dispatch leaves them)
    and a cotangent whose rows in trailing tiles — past the last group's
    rows — are 0, as the dispatch's are (module docstring)."""
    A = sum(sizes)
    n_tiles = -(-A // BM) + E
    P = n_tiles * BM
    flat_e = _flat_e(sizes)
    ref = jgm._gmm_metadata(jnp.asarray(flat_e), E, n_tiles, BM)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, K)).astype(np.float32)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    s = rng.standard_normal((P, 1)).astype(np.float32)
    dy = rng.standard_normal((P, N)).astype(np.float32)
    pstart = np.asarray(ref[1])
    filled = np.zeros(P, bool)
    for e, c in enumerate(sizes):
        filled[pstart[e]:pstart[e] + c] = True
    s[~filled] = 0.0
    used = sum(-(-c // BM) for c in sizes)
    dy[used * BM:] = 0.0
    return dict(P=P, n_tiles=n_tiles, flat_e=flat_e, ref=ref, x=x, w=w, s=s,
                dy=dy, filled=filled)


@pytest.mark.parametrize("sizes", SIZES.values(), ids=SIZES.keys())
def test_metadata_and_packing_match_reference(sizes):
    """`_gmm_metadata` and `_pack_rows` equal the reference's exactly (but
    for `tile_first`, which the port does not keep); the packed rows and
    gates that `gather_rows` reads through the packing are the
    reference's on the filled rows and zero on the others (the reference
    leaves token 0's row there, times gate 0)."""
    b = _buffer(sizes)
    got = gm._gmm_metadata(_t(b["flat_e"]).long(), E, b["n_tiles"], BM)
    for name, g, r in zip(("counts", "pstart", "starts", "tile_group"),
                          got, b["ref"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert got[3].dtype == torch.int32 and got[0].dtype == torch.int32

    A = sum(sizes)
    rng = np.random.default_rng(2)
    x_flat = rng.standard_normal((9, K)).astype(np.float32)
    flat_t = rng.integers(0, 9, A).astype(np.int32)
    flat_g = rng.standard_normal(A).astype(np.float32)
    ref = jgm._pack_rows(jnp.asarray(x_flat), jnp.asarray(b["flat_e"]),
                         jnp.asarray(flat_t), jnp.asarray(flat_g), E, BM)
    pk, counts, pstart, tile_group = gm._pack_rows(
        _t(b["flat_e"]).long(), _t(flat_t).long(), E, BM)
    np.testing.assert_array_equal(pk.filled.numpy(), b["filled"])
    # each assignment's slot holds it
    np.testing.assert_array_equal(pk.row_asg[pk.slot].numpy(), np.arange(A))
    fill = b["filled"][:, None]
    x_pad = gm.gather_rows(_t(x_flat), pk.row_tok, pk.filled,
                           pk.slot[:, None])
    row_gate = gm.gather_rows(_t(flat_g)[:, None], pk.row_asg, pk.filled,
                              pk.slot[:, None])
    for name, g, r in (("x_pad", x_pad, np.where(fill, ref[0], 0)),
                       ("row_tok", pk.row_tok, ref[1]),
                       ("row_gate", row_gate, ref[2]),
                       ("counts", counts, ref[3]),
                       ("tile_group", tile_group, ref[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    np.testing.assert_array_equal(pstart.numpy(), np.asarray(b["ref"][1]))


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("sizes", SIZES.values(), ids=SIZES.keys())
def test_plain_versions_match_reference_calls(sizes, scaled):
    """The plain forward, dx and dW against `_fwd_call`, `_dx_call` and
    `_dw_call_impl` (interpret mode; dW masked to 0 for empty experts, as
    `_gmm_bwd` does), fp32, atol 1e-5 relative to each output's largest
    entry (summation order). The port's dW ignores trailing tiles whatever
    they hold: it gets a cotangent whose trailing rows are not 0, the
    reference the same one with those rows zeroed."""
    b = _buffer(sizes)
    counts, pstart, _, tile_group, tile_first = b["ref"]
    s = b["s"] if scaled else None
    js = jnp.asarray(b["s"]) if scaled else None
    tg = _t(tile_group)
    ref_y = jgm._fwd_call(jnp.asarray(b["x"]), jnp.asarray(b["w"]), js,
                          tile_group, BM, True)
    ref_dx = jgm._dx_call(jnp.asarray(b["dy"]), jnp.asarray(b["w"]), js,
                          tile_group, BM, True)
    ref_dw = jgm._dw_call_impl(jnp.asarray(b["x"]), jnp.asarray(b["dy"]), js,
                               tile_group, tile_first, E, BM, True)
    ref_dw = np.where(np.asarray(counts)[:, None, None] > 0,
                      np.asarray(ref_dw), 0.0)
    dy_port = b["dy"].copy()
    used = sum(-(-c // BM) for c in sizes)
    dy_port[used * BM:] = 1.0
    sc = None if s is None else _t(s)
    gm.reset_counts()
    y = gm.gmm_fwd(_t(b["x"]), _t(b["w"]), tg, sc, bm=BM)
    dx = gm.gmm_bwd_dx(_t(b["dy"]), _t(b["w"]), tg, sc, bm=BM)
    dw = gm.gmm_bwd_dw(_t(b["x"]), _t(dy_port), _t(counts), _t(pstart), sc,
                       bm=BM)
    assert gm.PLAIN_CALLS == {k: 1 for k in gm.PLAIN_CALLS}
    assert gm.LAUNCHES == {k: 0 for k in gm.LAUNCHES}
    for got, ref in ((y, ref_y), (dx, ref_dx), (dw, ref_dw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
    for e, c in enumerate(sizes):
        if c == 0:
            assert not dw[e].any()


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
def test_plain_versions_round_as_the_reference_in_bf16(scaled):
    """bf16 operands: forward and dx equal the reference's interpret-mode
    calls to one bf16 ulp (rtol 2^-7: fp32 sums of the same products in
    another order can round to neighbouring bf16 values); the scaled dx
    rounds dy * gate to bf16 before the product on both sides."""
    b = _buffer(SIZES["ragged"])
    tile_group = b["ref"][3]
    bf = jnp.bfloat16
    x, w, dy = (jnp.asarray(b[k]).astype(bf) for k in ("x", "w", "dy"))
    js = jnp.asarray(b["s"]) if scaled else None
    ref_y = jgm._fwd_call(x, w, js, tile_group, BM, True)
    ref_dx = jgm._dx_call(dy, w, js, tile_group, BM, True)
    tx, tw, tdy = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                   .to(torch.bfloat16) for a in (x, w, dy))
    sc = _t(b["s"]) if scaled else None
    tg = _t(tile_group)
    for got, ref in ((gm.gmm_fwd(tx, tw, tg, sc, bm=BM), ref_y),
                     (gm.gmm_bwd_dx(tdy, tw, tg, sc, bm=BM), ref_dx)):
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("sizes", SIZES.values(), ids=SIZES.keys())
def test_autograd_matches_reference_vjp(sizes, scaled):
    """`gmm` forward and its gradients for x, W and the gates against
    `jax.vjp` of the reference's `gmm` (interpret mode), fp32, atol 1e-5
    relative to each output's largest entry; dW of an empty expert is
    exactly 0."""
    b = _buffer(sizes)
    counts, pstart, _, tile_group, tile_first = b["ref"]

    def f(x, w, s):
        return jgm.gmm(x, w, tile_group, tile_first, counts,
                       scales=s if scaled else None, bm=BM, interpret=True)

    y_ref, vjp = jax.vjp(f, jnp.asarray(b["x"]), jnp.asarray(b["w"]),
                         jnp.asarray(b["s"]))
    gx_ref, gw_ref, gs_ref = vjp(jnp.asarray(b["dy"]))

    x = _t(b["x"]).requires_grad_()
    w = _t(b["w"]).requires_grad_()
    s = _t(b["s"]).requires_grad_()
    y = gm.gmm(x, w, _t(tile_group), _t(counts), _t(pstart),
               scales=s if scaled else None, bm=BM)
    y.backward(_t(b["dy"]))
    pairs = [(y.detach(), y_ref), (x.grad, gx_ref), (w.grad, gw_ref)]
    if scaled:
        pairs.append((s.grad, gs_ref))
    else:
        assert s.grad is None
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
    for e, c in enumerate(sizes):
        if c == 0:
            assert not w.grad[e].any()


def _routing(Nt, n_routed, k, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((Nt, n_routed)).astype(np.float32)
    idx = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
    vals = np.take_along_axis(logits, idx, axis=1)
    gates = np.exp(vals) / np.exp(vals).sum(1, keepdims=True)
    return idx, gates.astype(np.float32)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_grouped_dispatch_matches_reference_and_dense(n_shared):
    """The whole dispatch (shared experts as always-on groups, swiglu,
    gate-scaled combine) against the reference's `grouped_dispatch`
    (interpret mode) — output and the gradients of x, the gates and both
    stacks through `jax.vjp` — and against the port's own dense combine
    (every expert on every token, weighted by a gate matrix): fp32, atol
    1e-5."""
    Nt, C, up, n_exp, k = 24, 32, 16, 6, 2
    n_routed = n_exp - n_shared
    rng = np.random.default_rng(4)
    x = rng.standard_normal((Nt, C)).astype(np.float32)
    fc = (0.2 * rng.standard_normal((n_exp, C, 2 * up))).astype(np.float32)
    proj = (0.2 * rng.standard_normal((n_exp, up, C))).astype(np.float32)
    idx, gates = _routing(Nt, n_routed, k, 5)
    dy = rng.standard_normal((Nt, C)).astype(np.float32)

    def f(x, g, a, b):
        return jgm.grouped_dispatch(x, jnp.asarray(idx), g, a, b,
                                    non_linearity="swiglu",
                                    n_shared=n_shared, interpret=True)

    y_ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, gates, fc, proj)))
    g_ref = vjp(jnp.asarray(dy))

    leaves = [_t(a).requires_grad_() for a in (x, gates, fc, proj)]
    gm.reset_counts()
    y = gm.grouped_dispatch(leaves[0], _t(idx).long(), leaves[1], leaves[2],
                            leaves[3], act=lambda h: activate(h, "swiglu"),
                            n_shared=n_shared)
    y.backward(_t(dy))
    assert gm.PLAIN_CALLS == {"grouped_mm_fwd": 3, "grouped_mm_bwd_dx": 2,
                              "grouped_mm_bwd_dw": 2}
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=1e-5, rtol=0)
    for got, ref in zip(leaves, g_ref):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=0)

    # the dense combine of the same routing
    xs = _t(x)
    combine = torch.zeros(Nt, n_routed).scatter_(1, _t(idx).long(),
                                                 _t(gates))
    dense = torch.einsum("enc,ne->nc", mlp_apply(
        xs, _t(fc[n_shared:]), _t(proj[n_shared:]), "swiglu"), combine)
    if n_shared:
        dense = dense + mlp_apply(xs, _t(fc[:n_shared]), _t(proj[:n_shared]),
                                  "swiglu").sum(0)
    np.testing.assert_allclose(y.detach().numpy(), dense.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("widths,device,dtype,usable", [
    ((32, 48), "cpu", torch.float32, True),
    ((36, 48), "cpu", torch.float32, False),     # n_embd % 8
    ((32, 44), "cpu", torch.float32, False),     # up_dim % 8
    ((32, 48), "meta", torch.bfloat16, True),    # a non-CPU device
    ((32, 48), "meta", torch.float16, False),    # the kernels take fp32/bf16
])
def test_grouped_usable(widths, device, dtype, usable):
    C, up = widths
    cfg = LLMConfig(n_embd=C, n_head=4, n_kv_heads=2, up_dim=up, moe=True,
                    n_exp=4, n_shared=1, n_act=2, moe_impl="grouped")
    assert gm.grouped_usable(cfg, dtype, device) is usable
    assert gm.block_m("cpu") == 8 and gm.block_m("meta") == 128


@pytest.mark.parametrize("name", ["fwd", "dx", "dw"])
def test_wrappers_refuse_non_cpu_tensors_they_cannot_launch(name):
    """Off the CPU a wrapper launches its kernel or raises — never the
    plain version: here meta tensors (no card to launch on) raise."""
    x = torch.zeros(16, 8, device="meta")
    w = torch.zeros(2, 8, 8, device="meta")
    i32 = torch.zeros(2, dtype=torch.int32, device="meta")
    call = {"fwd": lambda: gm.gmm_fwd(x, w, i32, bm=8),
            "dx": lambda: gm.gmm_bwd_dx(x, w, i32, bm=8),
            "dw": lambda: gm.gmm_bwd_dw(x, x, i32, i32, bm=8)}[name]
    gm.reset_counts()
    with pytest.raises(ValueError):
        call()
    assert gm.PLAIN_CALLS == {k: 0 for k in gm.PLAIN_CALLS}
