"""The port's attention kernels' plain versions (distributed_pytorch_tpu_torch
/ops/flash_decode.py) against the reference package's Pallas kernels run
in interpret mode on the CPU: paged decode across GQA ratios and ragged
lengths, the contiguous decode, and the paged chunk prefill at offset 0
and at a block-aligned offset. Same numpy inputs to both; fp32, atol 1e-5
(the two sum in different orders: one-pass softmax vs an online one over
8-row blocks). Also the dispatcher's kernel routes against its naive path,
and the launch/plain counters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops import flash_decode as jfd
from distributed_pytorch_tpu_torch.ops import flash_decode as tfd
from distributed_pytorch_tpu_torch.ops.attention_core import _naive_sdpa, sdpa
from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather

ATOL = 1e-5


def _paged(B, n_max, bs, nh, nkv, hs, seed):
    """Random pools + shuffled non-contiguous block tables (block 0 is the
    null block and belongs to nobody)."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * n_max + 3
    q = rng.standard_normal((B, nh, hs)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, nkv, hs)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, nkv, hs)).astype(np.float32)
    bt = rng.permutation(np.arange(1, 1 + B * n_max)) \
        .reshape(B, n_max).astype(np.int32)
    return q, kp, vp, bt


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("nkv", [4, 2, 1], ids=lambda n: f"nkv{n}")
def test_paged_decode_matches_jax_kernel(nkv):
    """Ragged lengths including 1 and the full table, GQA 1:1 to 4:1."""
    B, n_max, bs, nh, hs = 4, 4, 8, 4, 16
    q, kp, vp, bt = _paged(B, n_max, bs, nh, nkv, hs, seed=nkv)
    cl = np.array([1, 7, 17, 32], np.int32)
    ref = jfd.paged_flash_decode(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(cl), scale=hs ** -0.5,
                                 interpret=True)
    tq, tk, tv, tbt, tcl = _t(q, kp, vp, bt, cl)
    out = tfd.paged_flash_decode(tq, tk, tv, tbt, tcl, scale=hs ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("nkv", [4, 1], ids=lambda n: f"nkv{n}")
def test_contiguous_decode_matches_jax_kernel(nkv):
    B, S, nh, hs = 3, 32, 4, 16
    rng = np.random.default_rng(10 + nkv)
    q = rng.standard_normal((B, nh, hs)).astype(np.float32)
    k = rng.standard_normal((B, S, nkv, hs)).astype(np.float32)
    v = rng.standard_normal((B, S, nkv, hs)).astype(np.float32)
    cl = np.array([1, 13, 32], np.int32)
    ref = jfd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(cl), scale=hs ** -0.5, block_s=8,
                           interpret=True)
    out = tfd.flash_decode(*_t(q, k, v, cl), scale=hs ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("nkv,off", [(4, 0), (2, 16), (1, 8)],
                         ids=["nkv4-off0", "nkv2-off16", "nkv1-off8"])
def test_paged_prefill_matches_jax_kernel(nkv, off):
    """A 16-row chunk at offset 0 and at block-aligned offsets attends the
    sequence's own prior blocks plus its causal in-chunk prefix."""
    T, n_max, bs, nh, hs = 16, 6, 8, 4, 16
    q, kp, vp, bt = _paged(1, n_max, bs, nh, nkv, hs, seed=20 + off)
    rng = np.random.default_rng(off)
    q = rng.standard_normal((1, T, nh, hs)).astype(np.float32)
    ref = jfd.paged_flash_prefill(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(bt),
                                  jnp.int32(off), scale=hs ** -0.5,
                                  interpret=True)
    tq, tk, tv, tbt = _t(q, kp, vp, bt)
    out = tfd.paged_flash_prefill(tq, tk, tv, tbt, off, scale=hs ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_dead_blocks_never_reach_the_output():
    """NaN/inf in every block a 1-token sequence does not own: the plain
    version, like the kernel, never lets rows past cache_len touch the
    output (softmax weight 1.0 on the one live row)."""
    B, n_max, bs, nh, nkv, hs = 1, 4, 8, 4, 4, 8
    q, kp, vp, bt = _paged(B, n_max, bs, nh, nkv, hs, seed=5)
    own = int(bt[0, 0])
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[np.arange(kp.shape[0]) != own] = np.nan
    vp2[np.arange(vp.shape[0]) != own] = np.inf
    vp2[own, 1:] = np.inf                      # rows past the live one
    out = tfd.paged_flash_decode(*_t(q, kp2, vp2, bt,
                                     np.array([1], np.int32)),
                                 scale=hs ** -0.5)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0].numpy(), vp[own, 0], atol=ATOL)


@pytest.mark.parametrize("T,tensor_off", [(1, False), (16, False),
                                          (16, True)],
                         ids=["decode", "prefill", "prefill-0d-offset"])
def test_sdpa_kernel_route_matches_naive_path(T, tensor_off):
    """A cached paged call takes the kernel route (its plain version on
    the CPU, counted, no launch) and agrees with the naive einsum path on
    the gathered logical view. A chunk's offset may be an int or a 0-d
    tensor, as the reference accepts."""
    B = 3 if T == 1 else 1
    n_max, bs, nh, nkv, hs = 4, 8, 4, 2, 16
    _, kp, vp, bt = _paged(B, n_max, bs, nh, nkv, hs, seed=7)
    rng = np.random.default_rng(T)
    q = torch.from_numpy(rng.standard_normal((B, T, nh, hs))
                         .astype(np.float32))
    pos = torch.tensor([0, 9, 31]) if T == 1 else 8
    if tensor_off:
        pos = torch.tensor(pos)
    tk, tv, tbt = torch.from_numpy(kp), torch.from_numpy(vp), \
        torch.from_numpy(bt)
    ref = _naive_sdpa(q, paged_gather(tk, tbt), paged_gather(tv, tbt),
                      scale=hs ** -0.5, q_offset=pos)
    tfd.reset_counts()
    out = sdpa(q, tk, tv, q_offset=pos, decode=True, block_tables=tbt)
    name = "paged_decode_attn" if T == 1 else "paged_prefill_attn"
    assert tfd.PLAIN_CALLS[name] == 1
    assert sum(tfd.LAUNCHES.values()) == 0     # no kernel on the CPU
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_usable_gates():
    q1 = torch.zeros(2, 1, 8, 64)
    pool = torch.zeros(5, 16, 2, 64)
    assert tfd.paged_flash_decode_usable(q1, pool, pool)
    # fp16 / mixed dtypes: the kernels build fp32 and bf16 only
    assert not tfd.paged_flash_decode_usable(q1.half(), pool.half(),
                                             pool.half())
    assert not tfd.paged_flash_decode_usable(q1.bfloat16(), pool, pool)
    # head sizes the 16-byte row vectors cannot tile
    odd = torch.zeros(5, 16, 2, 12)
    assert not tfd.paged_flash_decode_usable(torch.zeros(2, 1, 8, 12), odd,
                                             odd)
    # a multi-token query is not a decode call; a batch is not a chunk
    assert not tfd.paged_flash_decode_usable(torch.zeros(2, 4, 8, 64),
                                             pool, pool)
    assert tfd.paged_flash_prefill_usable(torch.zeros(1, 32, 8, 64), pool,
                                          pool)
    assert not tfd.paged_flash_prefill_usable(torch.zeros(2, 32, 8, 64),
                                              pool, pool)
    # tiles past the card's shared memory decline
    big = torch.zeros(5, 16, 1, 512)
    assert not tfd.paged_flash_prefill_usable(torch.zeros(1, 32, 8, 512),
                                              big, big)
