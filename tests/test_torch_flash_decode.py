"""The port's attention kernels' plain versions (distributed_pytorch_tpu_torch
/ops/flash_decode.py) against the reference package's Pallas kernels run
in interpret mode on the CPU: paged decode across GQA ratios and ragged
lengths, the contiguous decode, and the paged chunk prefill at offset 0
and at a block-aligned offset. Same numpy inputs to both; fp32, atol 1e-5
(the two sum in different orders: one-pass softmax vs an online one over
8-row blocks). The int8-cache (`_q8`) plain versions against the
reference's `_q8` bodies the same way, for nkv 1/2/4 and chunk offsets 0
and 8, with poisoned scales in blocks no sequence owns; the int8 prefill
also with bf16 queries at the card kernel's head size 64 (GQA and MQA,
chunks off its 64-row tiles, offsets past one tile) at a stated bf16
limit (`Q8_BF16_TOL`). Also the
dispatcher's kernel routes against its naive path (int8: against the naive
path on the dequantized cache), the gates, and the launch/plain counters.
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


def _q8(pool_shape, seed):
    """int8 code pools and fp32 (..., nkv, 1) scale pools."""
    rng = np.random.default_rng(seed)
    sc = pool_shape[:-1] + (1,)
    return (rng.integers(-127, 128, pool_shape).astype(np.int8),
            rng.uniform(1e-3, 4e-2, sc).astype(np.float32),
            rng.integers(-127, 128, pool_shape).astype(np.int8),
            rng.uniform(1e-3, 4e-2, sc).astype(np.float32))


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


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


@pytest.mark.parametrize("nkv,off,nh,hs,T", [
    pytest.param(4, 0, 4, 16, 16, id="nkv4-off0"),
    pytest.param(2, 16, 4, 16, 16, id="nkv2-off16"),
    pytest.param(1, 8, 4, 16, 16, id="nkv1-off8"),
    pytest.param(4, 0, 8, 32, 16, id="hs32-gqa-off0"),
    pytest.param(4, 16, 8, 32, 16, id="hs32-gqa-off16"),
    pytest.param(4, 13, 8, 32, 5, id="hs32-gqa-verify-T5-off13")])
def test_paged_prefill_matches_jax_kernel(nkv, off, nh, hs, T):
    """A 16-row chunk at offset 0 and at block-aligned offsets attends the
    sequence's own prior blocks plus its causal in-chunk prefix; also at
    the default config's head size 32 with 8 / 4 heads (the card runs it
    on the wgmma kernel), and a one-slot speculative verify's 5 rows at an
    offset inside a block."""
    n_max, bs = 6, 8
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


@pytest.mark.parametrize("nkv", [4, 2, 1], ids=lambda n: f"nkv{n}")
def test_q8_paged_decode_matches_jax_kernel(nkv):
    B, n_max, bs, nh, hs = 4, 4, 8, 4, 16
    q, kp, _, bt = _paged(B, n_max, bs, nh, nkv, hs, seed=30 + nkv)
    kc, ks, vc, vs = _q8(kp.shape, seed=nkv)
    cl = np.array([1, 7, 17, 32], np.int32)
    ref = jfd.paged_flash_decode(*_j(q, kc, vc, bt, cl), scale=hs ** -0.5,
                                 k_scale=jnp.asarray(ks),
                                 v_scale=jnp.asarray(vs), interpret=True)
    tq, tkc, tvc, tbt, tcl, tks, tvs = _t(q, kc, vc, bt, cl, ks, vs)
    tfd.reset_counts()
    out = tfd.paged_flash_decode(tq, tkc, tvc, tbt, tcl, scale=hs ** -0.5,
                                 k_scale=tks, v_scale=tvs)
    assert tfd.PLAIN_CALLS["paged_decode_attn_q8"] == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("nkv", [4, 1], ids=lambda n: f"nkv{n}")
def test_q8_contiguous_decode_matches_jax_kernel(nkv):
    B, S, nh, hs = 3, 32, 4, 16
    q = np.random.default_rng(40 + nkv).standard_normal((B, nh, hs)) \
        .astype(np.float32)
    kc, ks, vc, vs = _q8((B, S, nkv, hs), seed=41 + nkv)
    cl = np.array([1, 13, 32], np.int32)
    ref = jfd.flash_decode(*_j(q, kc, vc, cl), scale=hs ** -0.5,
                           k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                           block_s=8, interpret=True)
    tq, tkc, tvc, tcl, tks, tvs = _t(q, kc, vc, cl, ks, vs)
    out = tfd.flash_decode(tq, tkc, tvc, tcl, scale=hs ** -0.5, k_scale=tks,
                           v_scale=tvs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


# bf16 limit of the int8-cache prefill against the reference: both round
# the output to bf16 (half an ulp each: 2^-8 relative, rtol), and the P V
# operand (p * v_scale) rounds to bf16 (2^-9 relative a term) against the
# running max of 16-key blocks in the reference but the global max in
# the plain version, an error relative to sum(p |v|), not to |out|: atol
# 1e-2 against values |v| <= 127 * 0.04 = 5.1 (`_q8`'s scales)
Q8_BF16_TOL = dict(atol=1e-2, rtol=2 ** -7)


@pytest.mark.parametrize("dtype,T,off,nh,nkv,hs,bs", [
    pytest.param("float32", 16, 0, 4, 4, 16, 8, id="nkv4-off0"),
    pytest.param("float32", 16, 8, 4, 2, 16, 8, id="nkv2-off8"),
    pytest.param("float32", 16, 8, 4, 1, 16, 8, id="nkv1-off8"),
    pytest.param("float32", 16, 0, 4, 1, 16, 8, id="nkv1-off0"),
    pytest.param("bfloat16", 64, 0, 8, 2, 64, 16, id="bf16-hs64-gqa-T64-off0"),
    pytest.param("bfloat16", 100, 80, 8, 2, 64, 16,
                 id="bf16-hs64-gqa-T100-off80"),
    pytest.param("bfloat16", 40, 144, 8, 1, 64, 16,
                 id="bf16-hs64-mqa-T40-off144")])
def test_q8_paged_prefill_matches_jax_kernel(dtype, T, off, nh, nkv, hs, bs):
    """The int8-cache prefill's plain version against the reference's
    `_prefill_kernel_q8` in interpret mode: fp32 at head size 16 (atol
    1e-5: summation order), and bf16 queries at the card kernel's head
    size 64, block size 16, GQA and MQA, chunks that are not whole 64-row
    tiles at offsets past one tile (Q8_BF16_TOL)."""
    n_max = max(6, (off + T + bs - 1) // bs + 2)
    _, kp, _, bt = _paged(1, n_max, bs, nh, nkv, hs, seed=50 + off)
    kc, ks, vc, vs = _q8(kp.shape, seed=51 + nkv)
    q = np.random.default_rng(off).standard_normal((1, T, nh, hs)) \
        .astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfd.paged_flash_prefill(jnp.asarray(q).astype(jdt),
                                  *_j(kc, vc, bt), jnp.int32(off),
                                  scale=hs ** -0.5, k_scale=jnp.asarray(ks),
                                  v_scale=jnp.asarray(vs), interpret=True)
    tq, tkc, tvc, tbt, tks, tvs = _t(q, kc, vc, bt, ks, vs)
    tfd.reset_counts()
    out = tfd.paged_flash_prefill(tq.to(tdt), tkc, tvc, tbt, off,
                                  scale=hs ** -0.5, k_scale=tks, v_scale=tvs)
    assert tfd.PLAIN_CALLS["paged_prefill_attn_q8"] == 1
    assert out.dtype == tdt
    tol = dict(atol=ATOL, rtol=0) if dtype == "float32" else Q8_BF16_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


# the C entries of csrc/paged_prefill_attn.cu and the head sizes whose
# bf16 calls each sends to its wgmma body (`prefill_sm90::launch<HS, C>`)
PREFILL_WGMMA = {"paged_prefill_attn": ("__nv_bfloat16", (32, 64, 128)),
                 "paged_prefill_attn_q8": ("int8_t", (64, 128))}


@pytest.mark.parametrize("entry", sorted(PREFILL_WGMMA))
def test_prefill_c_entry_routes(entry):
    """Read from the source: the C entry sends fp32 to the FMA kernel,
    bf16 at exactly the head sizes of PREFILL_WGMMA to the wgmma body
    built at that head size over its cache type (hs 32 over a bf16 cache
    only), and bf16 at every other head size to the FMA kernel; the bf16
    entry refuses a split count other than 1 except 2 at hs 32, and hands
    its workspace to the hs-32 body only."""
    import re
    from pathlib import Path
    src = (Path(tfd.__file__).resolve().parent.parent / "csrc"
           / "paged_prefill_attn.cu").read_text()
    start = src.index(f'extern "C" int {entry}(')
    body = src[start:src.index("\n}\n", start)]
    cases = re.findall(r"if \((.*?)\)\s*return (.*?);", body, re.S)
    if entry == "paged_prefill_attn":
        guard, *cases = cases
        assert re.sub(r"\s+", " ", guard[0]) == (
            "n_split != 1 && !(n_split == 2 && ws != nullptr && dtype == 1 "
            "&& hs == 32)"), guard
        for cond, call in cases[1:-1]:
            want = "n_split == 2 ? ws : nullptr" if cond.endswith(
                "hs == 32") else "nullptr, stream"
            assert want in re.sub(r"\s+", " ", call), (cond, call)
    cache, sizes = PREFILL_WGMMA[entry]
    fma = "float" if cache == "__nv_bfloat16" else "int8_t"
    assert cases[0][0] == "dtype == 0" and re.match(
        rf"launch<float, {fma}>\(", cases[0][1]), cases[0]
    wgmma = [(cond, call) for cond, call in cases[1:-1]]
    assert [c for c, _ in wgmma] == [f"dtype == 1 && hs == {hs}"
                                     for hs in sizes], wgmma
    for hs, (_, call) in zip(sizes, wgmma):
        assert re.match(rf"prefill_sm90::launch<{hs}, {cache}>\(", call), call
    cond, call = cases[-1]
    assert cond == "dtype == 1" and re.match(
        rf"launch<__nv_bfloat16, {'__nv_bfloat16' if fma == 'float' else fma}>\(",
        call), (cond, call)
    assert body.rstrip().endswith("return (int)cudaErrorInvalidValue;")
    assert body.count("return") == len(cases) + 1 + (
        entry == "paged_prefill_attn")


@pytest.mark.parametrize("n_tok,nh,nkv,hs,dtype,n_sm,want", [
    (512, 8, 4, 32, torch.bfloat16, 132, 2),    # 64 CTAs: 128 fit
    (520, 8, 4, 32, torch.bfloat16, 132, 1),    # 68 CTAs: 136 do not
    (512, 12, 12, 32, torch.bfloat16, 132, 1),  # 96
    (5, 8, 4, 32, torch.bfloat16, 132, 2),      # a verify's 4 CTAs
    (512, 8, 4, 32, torch.float32, 132, 1),     # the FMA kernel
    (512, 8, 4, 64, torch.bfloat16, 132, 1),    # hs 64 never splits
    (256, 8, 4, 32, torch.bfloat16, 64, 2),
    (256, 8, 4, 32, torch.bfloat16, 63, 1)])
def test_prefill_splits(n_tok, nh, nkv, hs, dtype, n_sm, want):
    """The bf16 hs-32 prefill splits its key tiles over two CTAs a (row
    tile, kv head) exactly where both CTAs of every pair fit on the SMs at
    once; the workspace holds each half's (64, hs + 2) partial a tile."""
    assert tfd.prefill_splits(n_tok, nh, nkv, hs, dtype, n_sm) == want
    ws = tfd.prefill_workspace(n_tok, nh, nkv, hs, "cpu")
    assert ws.shape == (nkv, -(-n_tok * (nh // nkv) // 64), 2, 64, hs + 2)
    assert ws.dtype == torch.float32


def test_q8_dead_blocks_never_reach_the_output():
    """NaN scales in every block a 1-token sequence does not own, and in
    its own rows past the live one: the output is the one live value row,
    dequantized (softmax weight 1.0)."""
    n_max, bs, nh, nkv, hs = 4, 8, 4, 4, 8
    q, kp, _, bt = _paged(1, n_max, bs, nh, nkv, hs, seed=6)
    kc, ks, vc, vs = _q8(kp.shape, seed=6)
    own = int(bt[0, 0])
    want = vc[own, 0].astype(np.float32) * vs[own, 0]
    for s in (ks, vs):
        s[np.arange(s.shape[0]) != own] = np.nan
        s[own, 1:] = np.nan
    out = tfd.paged_flash_decode(*_t(q, kc, vc, bt, np.array([1], np.int32)),
                                 scale=hs ** -0.5,
                                 k_scale=torch.from_numpy(ks),
                                 v_scale=torch.from_numpy(vs))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0].numpy(), want, atol=ATOL)


@pytest.mark.parametrize("T", [1, 16], ids=["decode", "prefill"])
def test_sdpa_q8_route_matches_naive_on_dequantized_cache(T):
    """An int8 paged call takes the `_q8` route (its plain version on the
    CPU) and agrees with the naive path on the dequantized logical view;
    a paged multi-sequence chunk dequantizes up front."""
    B = 3 if T == 1 else 1
    n_max, bs, nh, nkv, hs = 4, 8, 4, 2, 16
    _, kp, _, bt = _paged(B, n_max, bs, nh, nkv, hs, seed=8)
    kc, ks, vc, vs = (torch.from_numpy(a) for a in _q8(kp.shape, seed=9))
    q = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (B, T, nh, hs)).astype(np.float32))
    pos = torch.tensor([0, 9, 31]) if T == 1 else 8
    tbt = torch.from_numpy(bt)
    kd = paged_gather(kc.float() * ks, tbt)
    vd = paged_gather(vc.float() * vs, tbt)
    ref = _naive_sdpa(q, kd, vd, scale=hs ** -0.5, q_offset=pos)
    tfd.reset_counts()
    out = sdpa(q, kc, vc, q_offset=pos, decode=True, block_tables=tbt,
               k_scale=ks, v_scale=vs)
    name = "paged_decode_attn_q8" if T == 1 else "paged_prefill_attn_q8"
    assert tfd.PLAIN_CALLS[name] == 1 and sum(tfd.LAUNCHES.values()) == 0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    # two sequences' 16-row chunks: the naive path on the dequantized view
    q2 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, nh, hs)).astype(np.float32))
    bt2 = torch.from_numpy(np.stack([bt[0], bt[0]]))
    tfd.reset_counts()
    out2 = sdpa(q2, kc, vc, q_offset=8, decode=True, block_tables=bt2,
                k_scale=ks, v_scale=vs)
    ref2 = _naive_sdpa(q2, paged_gather(kc.float() * ks, bt2),
                       paged_gather(vc.float() * vs, bt2), scale=hs ** -0.5,
                       q_offset=8)
    assert sum(tfd.PLAIN_CALLS.values()) == 0
    np.testing.assert_allclose(out2.numpy(), ref2.numpy(), atol=ATOL, rtol=0)


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


def test_q8_usable_gates():
    """An int8 pool with fp32 scale rows passes at every head size the
    reference's gate takes (a multiple of 8, 8 mod 16 included); codes
    without scales, scales of the wrong shape or dtype, or bf16 codes
    labelled int8 do not."""
    for hs in (8, 24, 40, 64, 128):
        q1 = torch.zeros(2, 1, 8, hs)
        codes = torch.zeros(5, 16, 2, hs, dtype=torch.int8)
        sc = torch.zeros(5, 16, 2, 1)
        assert tfd.paged_flash_decode_usable(q1, codes, codes, sc, sc)
        assert tfd.paged_flash_decode_usable(q1.bfloat16(), codes, codes,
                                             sc, sc)
        assert tfd.paged_flash_prefill_usable(torch.zeros(1, 32, 8, hs),
                                              codes, codes, sc, sc)
    assert not tfd.paged_flash_decode_usable(q1, codes, codes)
    assert not tfd.paged_flash_decode_usable(q1, codes, codes, sc.double(),
                                             sc.double())
    assert not tfd.paged_flash_decode_usable(q1, codes, codes, sc[..., 0],
                                             sc[..., 0])
    assert not tfd.paged_flash_decode_usable(q1, codes.float(),
                                             codes.float(), sc, sc)
    odd = torch.zeros(5, 16, 2, 12, dtype=torch.int8)
    assert not tfd.paged_flash_decode_usable(torch.zeros(2, 1, 8, 12), odd,
                                             odd, sc, sc)
    # the scale tiles count against the shared-memory limit
    assert tfd._smem_bytes(64, 64, True) == tfd._smem_bytes(64, 64) + 512


@pytest.mark.parametrize("hs,dtype,split", [
    (64, torch.bfloat16, True), (256, torch.bfloat16, True),
    (264, torch.bfloat16, False), (128, torch.float32, True),
    (136, torch.float32, False), (256, torch.float32, False),
    (8, torch.int8, True), (256, torch.int8, True),
    (264, torch.int8, False)])
def test_takes_split(hs, dtype, split):
    """K/V rows of at most 32 vectors (512 bytes of fp32 or bf16, 256 int8
    codes) take the split-KV decode (and its workspace); wider rows the
    tile kernel, which needs none."""
    assert tfd.takes_split(hs, dtype) is split


@pytest.mark.parametrize("hs,dtype,splits", [
    (64, torch.int8, 8), (8, torch.int8, 8), (256, torch.int8, 8),
    (264, torch.int8, None), (64, torch.bfloat16, 8),
    (264, torch.bfloat16, None)])
def test_decode_workspace_follows_the_cache_rows(hs, dtype, splits):
    """The workspace a decode launch hands its C entry: for int8 codes as
    for bf16 rows, (B, nh, n_split, hs + 2) fp32 with n_split from the
    table's capacity (1024 keys: 8 splits) where the rows take the split
    kernel, none where they take the tile kernel."""
    q = torch.zeros(3, 12, hs)
    pool = torch.zeros(65, 16, 4, hs, dtype=dtype)
    ws = tfd.workspace_for(q, pool, 64 * 16)
    if splits is None:
        assert ws is None
    else:
        assert ws.shape == (3, 12, splits, hs + 2)
        assert ws.dtype == torch.float32


def test_split_decode_gate():
    """The fp32/bf16 split-KV decode holds a K/V row of at most 512 bytes
    in one warp's registers (head size <= 256 in bf16, <= 128 in fp32) and
    any number of query rows a kv head (MQA rep 12 included); a wider row
    takes the FMA tile kernel, gated by its shared-memory tiles (as the
    reference's decode takes every head whose tiles fit), so fp32 136 and
    bf16 264 are taken and a 1024-wide fp32 head at rep 12 is not; the
    int8 cache's kernel keeps its own shared-memory gate."""
    for hs, dtype, ok in ((256, torch.bfloat16, True),
                          (264, torch.bfloat16, True),
                          (128, torch.float32, True),
                          (136, torch.float32, True),
                          (256, torch.float32, True),
                          (1024, torch.float32, False)):
        pool = torch.zeros(5, 16, 1, hs, dtype=dtype)
        q1 = torch.zeros(2, 1, 12, hs, dtype=dtype)
        assert tfd.paged_flash_decode_usable(q1, pool, pool) == ok, hs
    assert tfd._smem_bytes(12, 1024) > tfd._SMEM_LIMIT >= tfd._smem_bytes(
        12, 264)
    codes = torch.zeros(5, 16, 1, 256, dtype=torch.int8)
    sc = torch.zeros(5, 16, 1, 1)
    assert tfd.paged_flash_decode_usable(torch.zeros(2, 1, 12, 256), codes,
                                         codes, sc, sc)
    assert tfd._split_smem_bytes(12, 64) == 4 * 4 * 8 * 66
    assert tfd._split_smem_bytes(1, 64) == 4 * 4 * 1 * 66
