"""The port's CUDA kernels against their plain PyTorch versions on the card:
paged decode (GQA ratios, ragged lengths including 1 and the full table,
dead blocks poisoned), contiguous decode, and paged prefill at offset 0
and at block-aligned offsets, in fp32 (atol 1e-4: summation order) and
bf16 (atol 2e-2: outputs round to bf16, and p rounds to bf16 against a
running max in the kernel but the global max in the plain version).

These carry the `cuda` marker and skip without a card. This file imports
no JAX, so on a machine without it run it alone, without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch.ops import flash_decode as fd
from distributed_pytorch_tpu_torch.ops.attention_core import sdpa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pools(dev, dtype, n_blocks, bs, nkv, hs, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    kp = torch.randn(n_blocks, bs, nkv, hs, generator=g, device=dev)
    vp = torch.randn(n_blocks, bs, nkv, hs, generator=g, device=dev)
    return kp.to(dtype), vp.to(dtype), g


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nh,nkv,hs", [(12, 12, 64), (8, 2, 64),
                                       (8, 1, 128), (6, 3, 32)])
def test_paged_decode(dev, dtype, nh, nkv, hs):
    B, bs, n_max = 5, 16, 8
    kp, vp, g = _pools(dev, dtype, 1 + B * n_max, bs, nkv, hs, seed=nh)
    tables = torch.from_numpy(np.random.default_rng(0).permutation(
        np.arange(1, 1 + B * n_max)).reshape(B, n_max).astype(np.int32)) \
        .to(dev)
    cl = torch.tensor([1, 16, 17, 100, 128], dtype=torch.int32, device=dev)
    q = torch.randn(B, nh, hs, generator=g, device=dev).to(dtype)
    fd.reset_counts()
    out = fd.paged_flash_decode(q, kp, vp, tables, cl, scale=hs ** -0.5)
    assert fd.LAUNCHES["paged_decode_attn"] == 1
    _close(out, fd.paged_flash_decode_plain(q, kp, vp, tables, cl,
                                            scale=hs ** -0.5), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_paged_decode_never_reads_dead_blocks(dev, dtype):
    B, bs, n_max, nh, hs = 2, 16, 4, 4, 64
    kp, vp, g = _pools(dev, dtype, 9, bs, nh, hs, seed=1)
    tables = torch.tensor([[3, 5, 7, 1], [2, 4, 6, 8]], dtype=torch.int32,
                          device=dev)
    cl = torch.tensor([1, 20], dtype=torch.int32, device=dev)
    q = torch.randn(B, nh, hs, generator=g, device=dev).to(dtype)
    ref = fd.paged_flash_decode_plain(q, kp, vp, tables, cl,
                                      scale=hs ** -0.5)
    for blk in (5, 7, 1, 6, 8):             # blocks past each cache_len
        kp[blk] = float("nan")
        vp[blk] = float("inf")
    kp[3, 1:] = float("nan")                # rows past cache_len = 1
    vp[3, 1:] = float("inf")
    out = fd.paged_flash_decode(q, kp, vp, tables, cl, scale=hs ** -0.5)
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_contiguous_decode(dev, dtype):
    B, S, nh, nkv, hs = 4, 256, 8, 4, 64
    kc, vc, g = _pools(dev, dtype, B, S, nkv, hs, seed=2)
    q = torch.randn(B, nh, hs, generator=g, device=dev).to(dtype)
    cl = torch.tensor([1, 77, 255, 256], dtype=torch.int32, device=dev)
    out = fd.flash_decode(q, kc, vc, cl, scale=hs ** -0.5)
    _close(out, fd.flash_decode_plain(q, kc, vc, cl, scale=hs ** -0.5),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("T,off,nh,nkv", [(64, 0, 12, 12), (100, 32, 8, 2),
                                          (512, 256, 12, 12),
                                          (16, 48, 4, 1)])
def test_paged_prefill(dev, dtype, T, off, nh, nkv):
    bs, n_max, hs = 16, 64, 64
    kp, vp, g = _pools(dev, dtype, 1 + n_max, bs, nkv, hs, seed=T)
    table = torch.from_numpy(np.random.default_rng(T).permutation(
        np.arange(1, 1 + n_max)).astype(np.int32)).to(dev)[None]
    q = torch.randn(1, T, nh, hs, generator=g, device=dev).to(dtype)
    fd.reset_counts()
    out = fd.paged_flash_prefill(q, kp, vp, table, off, scale=hs ** -0.5)
    assert fd.LAUNCHES["paged_prefill_attn"] == 1
    _close(out, fd.paged_flash_prefill_plain(q, kp, vp, table, off,
                                             scale=hs ** -0.5), dtype)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = torch.zeros(2, 4, 64, device=dev, dtype=torch.float16)
    pool = torch.zeros(3, 16, 4, 64, device=dev, dtype=torch.float16)
    bt = torch.ones(2, 2, dtype=torch.int32, device=dev)
    cl = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fd.paged_flash_decode(q, pool, pool, bt, cl, scale=0.125)


@pytest.mark.parametrize("T,B,paged", [(1, 2, True), (16, 1, True),
                                       (1, 2, False)],
                         ids=["paged-decode", "paged-prefill", "contiguous"])
def test_sdpa_cached_call_raises_rather_than_falls_back(dev, T, B, paged):
    """A cached call the kernel does not take (fp16 here) raises on the
    card; it never drops quietly to the naive path."""
    q = torch.zeros(B, T, 4, 64, device=dev, dtype=torch.float16)
    pool = torch.zeros(3 if paged else B, 16, 4, 64, device=dev,
                       dtype=torch.float16)
    bt = torch.ones(B, 2, dtype=torch.int32, device=dev) if paged else None
    fd.reset_counts()
    with pytest.raises(ValueError):
        sdpa(q, pool, pool, q_offset=torch.tensor(0), decode=True,
             block_tables=bt)
    assert fd.PLAIN_CALLS == {k: 0 for k in fd.PLAIN_CALLS}
