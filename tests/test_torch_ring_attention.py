"""Sequence-parallel attention in the port (ops/ring_attention.py) against
the reference package's (ops/ring_attention.py) on the CPU.

* The flash kernels' plain versions with query and key position offsets
  draw the reference's per-hop mask (`_hop_dropout_mask`) exactly.
* The hop schedule and merge, run in one process over every rank's chunk
  (`LocalRing`), equal one whole flash call, forward and backward.
* `sp_sdpa` on gloo ranks spawned from tests/torch_parallel_ranks.py
  (ring, zig-zag and Ulysses, sp 2 and 4, MHA and GQA at head size 64 and
  GQA at 32 or 48, dropout 0 and 0.2) against the reference's `sp_sdpa`
  on a 'seq' axis of as many virtual CPU devices, which runs its einsum
  hops there: out and the gradients of q, k and v within 1e-5.
* The lse output of `flash_attention_lse` carries its gradient (the
  dlse term of delta) as the reference's does.

Each test states its tolerance."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops import flash_attention as jfa
from distributed_pytorch_tpu.ops import ring_attention as jra
from distributed_pytorch_tpu.parallel import context as jcontext
from distributed_pytorch_tpu.parallel.mesh import build_mesh
from distributed_pytorch_tpu.parallel.mesh import resolve_plan as jplan
from distributed_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_pytorch_tpu_torch.ops import ring_attention as ra

import torch_parallel_ranks as ranks

TOL = 1e-5
B, T = 2, 32


@pytest.mark.parametrize("qo,ko,nh", [(0, 0, 4), (24, 8, 4), (40, 56, 2)])
def test_keep_mask_with_offsets_is_the_hop_mask(qo, ko, nh):
    """`keep_mask` at query / key position offsets equals the reference's
    `_hop_dropout_mask` at the same offsets (exact)."""
    seed = np.array([123, -456], np.int32)
    want = jra._hop_dropout_mask((B, nh, 8, 16), qo, ko, nh, 0.2,
                                 jnp.asarray(seed))
    got = fa.keep_mask(torch.from_numpy(seed), 0.2, B, nh, 8, 16, None, 0,
                       None, qo, ko)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _qkv(nh, nkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, T, nh, d), (B, T, nkv, d), (B, T, nkv, d),
                  (B, T, nh, d)))


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("sp,rate", [(2, 0.0), (4, 0.2)])
def test_hops_equal_one_flash_call(layout, sp, rate):
    """`ring_fwd` / `ring_bwd` over a `LocalRing` of sp chunks (a list
    rotation in place of the permute) against one causal flash call over
    the whole sequence: out, dq, dk and dv within 1e-5."""
    q, k, v, g = (torch.from_numpy(a) for a in _qkv(4, 2, 16))
    seed = torch.tensor([9, -2], dtype=torch.int32)
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    out = fa.flash_attention(q, k, v, scale=0.25, dropout_rate=rate,
                             seed=seed)
    out.backward(g)
    cols = [ra.local_positions(T, sp, r, layout) for r in range(sp)]
    kvs = [torch.stack([k.detach()[:, c], v.detach()[:, c]]) for c in cols]
    accs = {}
    kw = dict(scale=0.25, layout=layout, rate=rate, seed=seed)
    for r, c in enumerate(cols):
        o, lse = ra.ring_fwd(q.detach()[:, c], kvs[r],
                             ra.LocalRing(kvs, r, accs), **kw)
        torch.testing.assert_close(o, out.detach()[:, c], rtol=0, atol=TOL)
        dq = ra.ring_bwd(q.detach()[:, c], kvs[r], o, lse, g[:, c],
                         ra.LocalRing(kvs, r, accs), **kw)
        torch.testing.assert_close(dq, q.grad[:, c], rtol=0, atol=TOL)
    for r, c in enumerate(cols):
        torch.testing.assert_close(accs[r][0], k.grad[:, c], rtol=0,
                                   atol=TOL)
        torch.testing.assert_close(accs[r][1], v.grad[:, c], rtol=0,
                                   atol=TOL)


# (impl, rate, nh, nkv, head size): ring, zig-zag and Ulysses; MHA and GQA
# at 64, GQA at 32 and 48; Ulysses at 0.2 reroutes
CASES = [("ring", 0.0, 4, 4, 64), ("zigzag", 0.0, 4, 2, 64),
         ("ulysses", 0.0, 4, 4, 64), ("zigzag", 0.2, 4, 2, 32),
         ("ring", 0.2, 4, 2, 64), ("ulysses", 0.2, 4, 4, 48)]


def _reference(sp, impl, rate, q, k, v, dout, key):
    """The reference's sp_sdpa on a 'seq' axis of sp virtual devices:
    (out, dq, dk, dv)."""
    mesh = build_mesh(jplan("sp", sp, sp_size=sp))
    scale = q.shape[-1] ** -0.5

    def f(q, k, v):
        return jra.sp_sdpa(q, k, v, scale=scale, impl=impl,
                           dropout_rate=rate, dropout_rng=key)

    with jcontext.use_mesh(mesh):
        out, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, (q, k, v)))
        grads = vjp(jnp.asarray(dout))
    return [np.asarray(a) for a in (out, *grads)]


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """{sp: [(case, reference (out, dq, dk, dv), the ranks' records)]}:
    every case of one sp in one spawn of sp ranks; the two spawns run
    while the reference computes."""
    inputs, spawns = [], {}
    for n, (impl, rate, nh, nkv, d) in enumerate(CASES):
        key = jax.random.PRNGKey(100 + n)
        # the seed the reference's sp_sdpa draws from its key
        seed = np.asarray(jax.random.randint(key, (2,), -2 ** 31,
                                             2 ** 31 - 1, jnp.int32))
        inputs.append((_qkv(nh, nkv, d, seed=n), key, seed))
    with ThreadPoolExecutor(2) as pool:
        for sp in (2, 4):
            cases = [dict(kind="sp_attn", q=q, k=k, v=v, dout=dout,
                          impl=ra.resolve_impl(impl, T, sp, nh, nkv, rate),
                          rate=rate, seed=seed, scale=d ** -0.5)
                     for (impl, rate, nh, nkv, d), ((q, k, v, dout), _,
                                                    seed)
                     in zip(CASES, inputs)]
            spawns[sp] = pool.submit(
                ranks.spawn, tmp_path_factory.mktemp(f"sp{sp}"), sp, cases)
        out = {}
        for sp in (2, 4):
            refs = [_reference(sp, c[0], c[1], *qkv, key)
                    for c, (qkv, key, _) in zip(CASES, inputs)]
            got = spawns[sp].result()
            out[sp] = [(CASES[n], refs[n], [g[n] for g in got])
                       for n in range(len(CASES))]
    return out


@pytest.mark.parametrize("n", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
@pytest.mark.parametrize("sp", [2, 4])
def test_sp_attention_matches_reference(sp_runs, sp, n):
    """Each rank's rows of out, dq, dk and dv equal the reference's
    sp_sdpa at those positions within 1e-5 (the reference's dropout seed
    handed to the port; the same mask from the same global coordinates)."""
    case, ref, got = sp_runs[sp][n]
    for r, rec in enumerate(got):
        c = rec["cols"]
        for name, want in zip(("out", "dq", "dk", "dv"), ref):
            np.testing.assert_allclose(
                rec[name].numpy(), want[:, c], rtol=0, atol=TOL,
                err_msg=f"{case} sp {sp} rank {r} {name}")


def test_lse_gradient_matches_reference():
    """A loss on both outputs of `flash_attention_lse` (the ring merge's
    use of it) gives the reference's gradients within 1e-5: lse's
    gradient folds into delta."""
    q, k, v, g = _qkv(4, 2, 16, seed=7)
    w = np.random.default_rng(8).standard_normal((B, T, 4)).astype(
        np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, scale=0.25, causal=False,
                                         interpret=True)
        return (o * g).sum() + (lse * w).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = fa.flash_attention_lse(tq, tk, tv, scale=0.25, causal=False)
    ((o * torch.from_numpy(g)).sum()
     + (lse * torch.from_numpy(w)).sum()).backward()
    for t, ref in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)
