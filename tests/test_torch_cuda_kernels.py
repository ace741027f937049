"""The port's CUDA kernels against their plain PyTorch versions on the card:
paged decode (GQA ratios, MQA at rep 12, ragged lengths including 1 and
the full table, dead blocks poisoned; lengths at the split-KV kernel's
128-key split boundaries and 0; two launches bit-equal), contiguous
decode, and paged prefill at offset 0
and at block-aligned offsets, in fp32 (atol 1e-4: summation order) and
bf16 (atol 2e-2: outputs round to bf16, and p rounds to bf16 against a
running max in the kernel but the global max in the plain version); the
bf16 prefill's wgmma kernel at block sizes 8, 16 and 32, head sizes 32,
64 and 128, MHA, GQA and MQA, chunks off its 64-row tiles and offsets past
256, other bf16 head sizes through the FMA kernel, two wgmma launches
bit-equal, and the kernel the profiler sees on each route; the
same three routes over an int8 cache with fp32 scale rows (the `_q8`
kernels, head sizes 8 mod 16 included), at the same limits: the int8
decode's split pair at head sizes 8-256, rep 1, 6 and 12 (two row
chunks), lengths at its 128-key split boundaries, NaN scales in every
dead row, two launches bit-equal, the kernels the profiler sees, and
int8 rows past 256 codes on the tile kernel; the int8 prefill's wgmma
kernel (bf16 at head sizes 64 and 128) at block sizes 8, 16 and 32, MHA,
GQA and MQA, chunks off its 64-row tiles and offsets past 256, with NaN
scales in a spare block and every row past the chunk, codes at +-127
with scales over several orders of magnitude, two launches bit-equal,
and the kernel the profiler sees on each route (the FMA kernel for fp32
and head size 40).
The flash-attention kernels (forward, dq, dkv) over causal and full
attention, MHA and GQA (rep 4 at head size 128), dropout 0 and 0.2, T and
S off the bf16 kernels' tiles (T 1, 70, 130, 200) and S > T, at their
built widths 32, 64, 80, 128 and 256 and at head sizes under them (8, 32, 40,
48, 72, 96, 136, 192, 200, 248), the warp-specialized dq's last 128-row
tile with no, some or all rows for its second consumer (T 900, 1000,
1088), the bf16 forward, dq and dkv at width 80 (head sizes 72 and 80; T
65, 900 and 1088, MHA 12 / 12 and GQA 12 / 4, causal and full, dropout 0
and 0.2) and the kernels the profiler sees there (each built at 80),
with no output column stored past the head size
(outputs allocated in front of NaN sentinels), and bf16 at the training
shapes (B 8, T 1024, 12 x 64 and 8 x 256), each
output element by element within atol + rtol x |plain|:
fp32 (1e-5, 1e-5: summation order); bf16 (4e-3, 2^-7: outputs round to
bf16 on both sides, and p rounds against a running max in the forward
kernel); lse, fp32 whatever the inputs, at the fp32 limits. Strided q/k/v
views of a fused qkv (the bf16 TMA maps' time stride; head sizes 64, 80
and 256) reach the kernels uncopied and equal contiguous copies bit for
bit, head sizes off the grid (36) or past 256 (264) raise, and two launches of the bf16 dq or dkv kernel are
bit-equal (no atomics).
And the autograd path against the naive attention's gradients in fp32. The fused
cross-entropy kernels (forward, dx, dW) at ragged token counts and
vocabularies, with ignored rows, each output element by element within
atol + rtol x |plain| (`CE_TOL`), and their autograd route against the
plain route on the CPU; the bf16 forward's and backward's routes by width
(the C plans), the training shape, ragged vocabularies, two launches
bit-equal, and the kernel the profiler sees against the plan's. Lion and Adafactor steps on the card against the
same steps on the CPU. The grouped-matmul kernels (forward, dx, dW;
unscaled and scaled) over ragged groups with empty and singleton
experts, every row on one expert, and widths that are not multiples of
the 128-wide tiles, each output element by element within `GMM_TOL`;
the forward at a serving batch (a few rows per expert, mostly padding
tiles); two bf16 forward, two bf16 dx and two bf16 dW launches
bit-equal, and bf16 dW over 24576 rows of one expert within the fp32
limit;
the grouped dispatch's autograd route against the plain route on the
CPU, and an MoE layer through the kernels against its dense dispatch.

These carry the `cuda` marker and skip without a card. This file imports
no JAX, so on a machine without it run it alone, without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from distributed_pytorch_tpu_torch.models.mlp import activate
from distributed_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_pytorch_tpu_torch.ops import flash_decode as fd
from distributed_pytorch_tpu_torch.ops import fused_ce as ce
from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
from distributed_pytorch_tpu_torch.ops.attention_core import sdpa
from distributed_pytorch_tpu_torch.ops.quant import quantize_kv

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


def _decode_inputs(dev, dtype, B, nh, nkv, hs, bs, n_max, seed):
    """Pools with a spare block, a permuted (B, n_max) table, a query."""
    kp, vp, g = _pools(dev, dtype, 1 + B * n_max, bs, nkv, hs, seed=seed)
    tables = torch.from_numpy(np.random.default_rng(seed).permutation(
        np.arange(1, 1 + B * n_max)).reshape(B, n_max).astype(np.int32)) \
        .to(dev)
    q = torch.randn(B, nh, hs, generator=g, device=dev).to(dtype)
    return q, kp, vp, tables


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("route", ["paged", "contiguous"])
def test_paged_decode_split_boundaries(dev, dtype, route):
    """Lengths one short of, at and one past a 128-key split, the whole
    table (384 keys: three splits) and 0 (the row is zeros), paged and
    contiguous."""
    bs, n_max, nh, hs = 16, 24, 8, 64
    span = fd._SPAN
    cl = torch.tensor([span - 1, span, span + 1, n_max * bs, 0],
                      dtype=torch.int32, device=dev)
    B = cl.numel()
    q, kp, vp, tables = _decode_inputs(dev, dtype, B, nh, nh, hs, bs, n_max,
                                       seed=5)
    fd.reset_counts()
    if route == "paged":
        out = fd.paged_flash_decode(q, kp, vp, tables, cl, scale=hs ** -0.5)
        ref = fd.paged_flash_decode_plain(q, kp, vp, tables, cl,
                                          scale=hs ** -0.5)
    else:
        kc, vc, _ = _pools(dev, dtype, B, n_max * bs, nh, hs, seed=6)
        out = fd.flash_decode(q, kc, vc, cl, scale=hs ** -0.5)
        ref = fd.flash_decode_plain(q, kc, vc, cl, scale=hs ** -0.5)
    assert fd.LAUNCHES["paged_decode_attn"] == 1
    _close(out, ref, dtype)
    assert torch.count_nonzero(out[-1]) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nkv,hs", [(1, 64), (1, 128), (2, 64)],
                         ids=["mqa-64", "mqa-128", "gqa6-64"])
def test_paged_decode_many_rows_a_kv_head(dev, dtype, nkv, hs):
    """MQA at rep 12 (12 query rows on one kv head, two row chunks of the
    split kernel) and GQA at rep 6, over ragged lengths."""
    q, kp, vp, tables = _decode_inputs(dev, dtype, 4, 12, nkv, hs, 16, 20,
                                       seed=hs + nkv)
    cl = torch.tensor([1, 129, 200, 320], dtype=torch.int32, device=dev)
    out = fd.paged_flash_decode(q, kp, vp, tables, cl, scale=hs ** -0.5)
    _close(out, fd.paged_flash_decode_plain(q, kp, vp, tables, cl,
                                            scale=hs ** -0.5), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("cache", ["native", "int8"])
def test_paged_decode_is_deterministic(dev, dtype, cache):
    """Two launches of the split-KV decode are bit-equal, over a cache of
    the activations' dtype and over int8 codes: the warps merge in warp
    order and the combine merges the splits in split order."""
    q, kp, vp, tables = _decode_inputs(dev, dtype, 8, 12, 12, 64, 16, 64,
                                       seed=9)
    cl = torch.tensor([1, 17, 300, 1024, 5, 64, 511, 900],
                      dtype=torch.int32, device=dev)
    kw = dict(scale=0.125)
    if cache == "int8":
        (kp, ks), (vp, vs) = quantize_kv(kp.float()), quantize_kv(vp.float())
        kw.update(k_scale=ks, v_scale=vs)
    first, second = (fd.paged_flash_decode(q, kp, vp, tables, cl, **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


def _prefill_inputs(dev, T, off, nh, nkv, hs, bs, seed=0):
    """Pools with room for the chunk and two spare blocks, a permuted
    table, and a bf16 query chunk."""
    n_max = (off + T + bs - 1) // bs + 2
    kp, vp, g = _pools(dev, torch.bfloat16, 1 + n_max, bs, nkv, hs,
                       seed=seed)
    table = torch.from_numpy(np.random.default_rng(seed).permutation(
        np.arange(1, 1 + n_max)).astype(np.int32)).to(dev)[None]
    q = torch.randn(1, T, nh, hs, generator=g, device=dev).to(torch.bfloat16)
    return q, kp, vp, table


@pytest.mark.parametrize("T,off",
                         [(100, 0), (200, 288), (16, 96), (5, 101)])
@pytest.mark.parametrize("nh,nkv", [(12, 12), (8, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("hs", [32, 64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_prefill_bf16_wgmma(dev, bs, hs, nh, nkv, T, off):
    """The bf16 prefill's wgmma kernel (head sizes 32, 64 and 128) at the
    block sizes, head groupings and offsets a chunked engine gives it:
    chunks that are not whole 64-row tiles, offsets past 256, a 16-row
    MQA chunk that packs into one 64-row tile, and a one-slot speculative
    verify's 5 rows at an offset inside a block, against the plain version
    at the bf16 limit."""
    q, kp, vp, table = _prefill_inputs(dev, T, off, nh, nkv, hs, bs,
                                       seed=T + bs)
    fd.reset_counts()
    out = fd.paged_flash_prefill(q, kp, vp, table, off, scale=hs ** -0.5)
    assert fd.LAUNCHES["paged_prefill_attn"] == 1
    _close(out, fd.paged_flash_prefill_plain(q, kp, vp, table, off,
                                             scale=hs ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("hs", [96, 48])
def test_paged_prefill_bf16_other_head_sizes(dev, hs):
    """bf16 at a head size the wgmma kernel does not take runs the FMA
    kernel (`attend_rows`), within the same limit."""
    q, kp, vp, table = _prefill_inputs(dev, 100, 32, 8, 2, hs, 16)
    out = fd.paged_flash_prefill(q, kp, vp, table, 32, scale=hs ** -0.5)
    _close(out, fd.paged_flash_prefill_plain(q, kp, vp, table, 32,
                                             scale=hs ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("hs", [32, 64, 128])
def test_paged_prefill_bf16_is_deterministic(dev, hs):
    """Two launches of the bf16 wgmma prefill are bit-equal."""
    q, kp, vp, table = _prefill_inputs(dev, 512, 256, 12, 12, hs, 16)
    first, second = (fd.paged_flash_prefill(q, kp, vp, table, 256,
                                            scale=hs ** -0.5)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("T,off,nh,nkv", [(512, 0, 8, 4), (512, 256, 8, 4),
                                          (100, 32, 12, 12), (5, 101, 8, 4),
                                          (40, 0, 4, 1)])
def test_paged_prefill_hs32_split_and_whole(dev, monkeypatch, split, T, off,
                                            nh, nkv):
    """The bf16 prefill at head size 32 with the key tiles of each row
    tile split over two CTAs (a workspace and `prefill_combine`) and
    whole, whichever `prefill_splits` would pick for the shape: the
    default config's 512-row chunk at offsets 0 and 256, MHA, a one-slot
    verify's 5 rows inside a block, MQA in one row tile; against the plain
    version at the bf16 limit, and two launches bit-equal."""
    monkeypatch.setattr(fd, "prefill_splits", lambda *a: split)
    q, kp, vp, table = _prefill_inputs(dev, T, off, nh, nkv, 32, 16,
                                       seed=T + off)
    first, second = (fd.paged_flash_prefill(q, kp, vp, table, off,
                                            scale=32 ** -0.5)
                     for _ in range(2))
    _close(first, fd.paged_flash_prefill_plain(q, kp, vp, table, off,
                                               scale=32 ** -0.5),
           torch.bfloat16)
    assert torch.equal(first, second)


@pytest.mark.parametrize("hs,kernel", [
    (32, "prefill_kernel_sm90<32>"), (64, "prefill_kernel_sm90<64>"),
    (128, "prefill_kernel_sm90<128>"),
    (48, "paged_prefill_kernel<__nv_bfloat16, __nv_bfloat16>")])
def test_prefill_runs_the_kernel_its_route_names(dev, hs, kernel):
    """Under the profiler, a bf16 prefill over a bf16 cache launches the
    wgmma kernel built for its head size (32, the default config's, 64 and
    128) and the FMA kernel at other head sizes, and no other prefill
    kernel; its output equals the plain version's within the bf16
    limit."""
    from torch.profiler import ProfilerActivity, profile

    q, kp, vp, table = _prefill_inputs(dev, 512, 256, 8, 4, hs, 16, seed=6)
    fd.paged_flash_prefill(q, kp, vp, table, 256, scale=hs ** -0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fd.paged_flash_prefill(q, kp, vp, table, 256, scale=hs ** -0.5)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "prefill_kernel" in e.key]
    assert names and all(kernel in n for n in names), names
    _close(out, fd.paged_flash_prefill_plain(q, kp, vp, table, 256,
                                             scale=hs ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("dtype,hs", [(torch.float32, 256),
                                      (torch.bfloat16, 264)],
                         ids=["fp32-256", "bf16-264"])
@pytest.mark.parametrize("route", ["paged", "contiguous"])
def test_decode_rows_wider_than_the_split_kernel(dev, dtype, hs, route):
    """K/V rows past 512 bytes (fp32 head size 256, bf16 264) decode
    through the FMA tile kernel the C entry picks for them, paged and
    contiguous, GQA at rep 2, ragged lengths up to the whole table."""
    bs, n_max, nh, nkv = 16, 12, 4, 2
    cl = torch.tensor([1, 17, 130, n_max * bs], dtype=torch.int32,
                      device=dev)
    B = cl.numel()
    q, kp, vp, tables = _decode_inputs(dev, dtype, B, nh, nkv, hs, bs,
                                       n_max, seed=hs)
    assert fd.paged_flash_decode_usable(q[:, None], kp, vp)
    fd.reset_counts()
    if route == "paged":
        out = fd.paged_flash_decode(q, kp, vp, tables, cl, scale=hs ** -0.5)
        ref = fd.paged_flash_decode_plain(q, kp, vp, tables, cl,
                                          scale=hs ** -0.5)
    else:
        kc, vc, _ = _pools(dev, dtype, B, n_max * bs, nkv, hs, seed=hs + 1)
        out = fd.flash_decode(q, kc, vc, cl, scale=hs ** -0.5)
        ref = fd.flash_decode_plain(q, kc, vc, cl, scale=hs ** -0.5)
    assert fd.LAUNCHES["paged_decode_attn"] == 1
    assert fd.PLAIN_CALLS["paged_decode_attn"] == 1      # the reference
    _close(out, ref, dtype)


def test_fp32_head_136_layer_prefills_then_decodes_on_the_kernels(dev):
    """An fp32 attention layer at head size 136 (K/V rows of 544 bytes)
    over a paged cache: a 32-token prefill through paged_prefill_attn, then
    4 decode steps through paged_decode_attn's tile kernel, each output
    within 1e-4 of the same layer's uncached naive forward over all 36
    tokens."""
    from distributed_pytorch_tpu_torch.config import LLMConfig
    from distributed_pytorch_tpu_torch.models.attention import (
        GQA, init_paged_attn_cache)

    cfg = LLMConfig(vocab_size=64, block_size=64, n_embd=272, n_head=2,
                    n_kv_heads=2, attn="mha", n_layer=1, pos_emb="learn")
    torch.manual_seed(0)
    layer = GQA(cfg, device=dev, dtype=torch.float32)
    x = torch.randn(1, 36, 272, device=dev)
    layer.attn_impl = "naive"
    with torch.no_grad():
        ref = layer(x, None)
    layer.attn_impl = "auto"
    cache = init_paged_attn_cache(cfg, 5, 16, dtype=torch.float32,
                                  device=dev)
    tables = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=dev)
    fd.reset_counts()
    with torch.no_grad():
        outs = [layer(x[:, :32], None, cache, 0, block_tables=tables)]
        for i in range(32, 36):
            outs.append(layer(x[:, i:i + 1], None, cache, i,
                              block_tables=tables))
    assert fd.LAUNCHES["paged_prefill_attn"] == 1
    assert fd.LAUNCHES["paged_decode_attn"] == 4
    assert fd.PLAIN_CALLS == dict.fromkeys(fd.PLAIN_CALLS, 0)
    _close(torch.cat(outs, dim=1), ref, torch.float32)


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


def _q8_pools(dev, n_blocks, bs, nkv, hs, seed):
    """int8 code pools and their fp32 (..., nkv, 1) scale pools, as the
    cache's quantizing writes leave them."""
    kp, vp, g = _pools(dev, torch.float32, n_blocks, bs, nkv, hs, seed)
    (kc, ks), (vc, vs) = quantize_kv(kp), quantize_kv(vp)
    return kc, ks, vc, vs, g


def _q8_decode_inputs(dev, dtype, B, nh, nkv, hs, bs, n_max, seed):
    """int8 pools with two spare blocks, a permuted (B, n_max) table, a
    query."""
    kc, ks, vc, vs, g = _q8_pools(dev, 2 + B * n_max, bs, nkv, hs, seed)
    tables = torch.from_numpy(np.random.default_rng(seed).permutation(
        np.arange(1, 1 + B * n_max)).reshape(B, n_max).astype(np.int32)) \
        .to(dev)
    q = torch.randn(B, nh, hs, generator=g, device=dev).to(dtype)
    return q, kc, ks, vc, vs, tables


def _poison_dead_rows(ks, vs, tables, cl, spare=True):
    """NaN scales in every row at or past each sequence's cache_len and,
    with `spare`, in the pool's last block (no table holds it); for a
    contiguous cache `tables` is arange(B)[:, None]."""
    if spare:
        ks[-1] = float("nan")
        vs[-1] = float("nan")
    bs = ks.shape[1]
    for b, n in enumerate(cl.tolist()):
        for c, blk in enumerate(tables[b].tolist()):
            first = max(0, n - c * bs)
            ks[blk, first:] = float("nan")
            vs[blk, first:] = float("nan")


def _q8_decode_against_plain(dev, dtype, q, kc, ks, vc, vs, tables, cl,
                             route="paged"):
    """The int8 decode against its plain version (computed before the dead
    rows are poisoned), one launch, no plain call on the card."""
    hs = q.shape[-1]
    kw = dict(scale=hs ** -0.5, k_scale=ks, v_scale=vs)
    if route == "paged":
        ref = fd.paged_flash_decode_plain(q, kc, vc, tables, cl, **kw)
        _poison_dead_rows(ks, vs, tables, cl)
    else:
        ref = fd.flash_decode_plain(q, kc, vc, cl, **kw)
        _poison_dead_rows(ks, vs, torch.arange(
            q.shape[0], device=dev)[:, None], cl, spare=False)
    fd.reset_counts()
    out = fd.paged_flash_decode(q, kc, vc, tables, cl, **kw) \
        if route == "paged" else fd.flash_decode(q, kc, vc, cl, **kw)
    assert fd.LAUNCHES["paged_decode_attn_q8"] == 1
    assert fd.PLAIN_CALLS == dict.fromkeys(fd.PLAIN_CALLS, 0)
    _close(out, ref, dtype)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nh,nkv,hs", [(12, 12, 64), (8, 2, 40),
                                       (4, 1, 24), (8, 1, 128), (8, 2, 8),
                                       (8, 2, 256)])
def test_paged_decode_q8(dev, dtype, nh, nkv, hs):
    """The int8 decode (its split pair: rows of 1-32 8-byte vectors, 8 mod
    16 included) against its plain version; a block no table holds and
    every row past each sequence's length are poisoned (NaN scales) and
    never reach it."""
    B, bs, n_max = 5, 16, 8
    assert fd.takes_split(hs, torch.int8)
    q, kc, ks, vc, vs, tables = _q8_decode_inputs(dev, dtype, B, nh, nkv,
                                                  hs, bs, n_max, seed=nh)
    cl = torch.tensor([1, 16, 17, 100, 128], dtype=torch.int32, device=dev)
    _q8_decode_against_plain(dev, dtype, q, kc, ks, vc, vs, tables, cl)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_contiguous_decode_q8(dev, dtype):
    B, S, nh, nkv, hs = 4, 256, 8, 4, 64
    kc, ks, vc, vs, g = _q8_pools(dev, B, S, nkv, hs, seed=2)
    q = torch.randn(B, nh, hs, generator=g, device=dev).to(dtype)
    cl = torch.tensor([1, 77, 255, 256], dtype=torch.int32, device=dev)
    kw = dict(scale=hs ** -0.5, k_scale=ks, v_scale=vs)
    fd.reset_counts()
    out = fd.flash_decode(q, kc, vc, cl, **kw)
    assert fd.LAUNCHES["paged_decode_attn_q8"] == 1
    _close(out, fd.flash_decode_plain(q, kc, vc, cl, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("T,off,nh,nkv,hs", [(64, 0, 12, 12, 64),
                                             (100, 32, 8, 2, 40),
                                             (512, 256, 12, 12, 64),
                                             (16, 48, 4, 1, 24)])
def test_paged_prefill_q8(dev, dtype, T, off, nh, nkv, hs):
    bs, n_max = 16, 64
    kc, ks, vc, vs, g = _q8_pools(dev, 1 + n_max, bs, nkv, hs, seed=T)
    table = torch.from_numpy(np.random.default_rng(T).permutation(
        np.arange(1, 1 + n_max)).astype(np.int32)).to(dev)[None]
    q = torch.randn(1, T, nh, hs, generator=g, device=dev).to(dtype)
    kw = dict(scale=hs ** -0.5, k_scale=ks, v_scale=vs)
    fd.reset_counts()
    out = fd.paged_flash_prefill(q, kc, vc, table, off, **kw)
    assert fd.LAUNCHES["paged_prefill_attn_q8"] == 1
    _close(out, fd.paged_flash_prefill_plain(q, kc, vc, table, off, **kw),
           dtype)


def _q8_prefill_against_plain(dev, q, kc, ks, vc, vs, table, off):
    """The int8 prefill against its plain version (computed before the
    poisoning): NaN scales in the pool's spare last block (no table holds
    it) and in every row at or past off + T, which no key tile may load;
    one launch, no plain call on the card."""
    T, hs = q.shape[1], q.shape[-1]
    kw = dict(scale=hs ** -0.5, k_scale=ks, v_scale=vs)
    ref = fd.paged_flash_prefill_plain(q, kc, vc, table, off, **kw)
    _poison_dead_rows(ks, vs, table,
                      torch.tensor([off + T], dtype=torch.int32))
    fd.reset_counts()
    out = fd.paged_flash_prefill(q, kc, vc, table, off, **kw)
    assert fd.LAUNCHES["paged_prefill_attn_q8"] == 1
    assert fd.PLAIN_CALLS == dict.fromkeys(fd.PLAIN_CALLS, 0)
    _close(out, ref, q.dtype)
    return out


def _q8_prefill_inputs(dev, T, off, nh, nkv, hs, bs, seed=0):
    """int8 pools with room for the chunk, a spare last block and one
    more, a permuted table over all but the spare, a bf16 chunk."""
    n_max = (off + T + bs - 1) // bs + 1
    kc, ks, vc, vs, g = _q8_pools(dev, 2 + n_max, bs, nkv, hs, seed)
    table = torch.from_numpy(np.random.default_rng(seed).permutation(
        np.arange(1, 1 + n_max)).astype(np.int32)).to(dev)[None]
    q = torch.randn(1, T, nh, hs, generator=g, device=dev).to(torch.bfloat16)
    return q, kc, ks, vc, vs, table


@pytest.mark.parametrize("T,off", [(100, 0), (200, 288), (16, 96)])
@pytest.mark.parametrize("nh,nkv", [(12, 12), (8, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_prefill_q8_bf16_wgmma(dev, bs, hs, nh, nkv, T, off):
    """The bf16 int8-cache prefill's wgmma kernel (codes gathered by
    cp.async, converted to bf16 in shared memory) at the block sizes, head
    groupings and offsets a chunked engine gives it: chunks that are not
    whole 64-row tiles, offsets past 256, a 16-row MQA chunk packed into
    one tile; NaN scales in every row it must not read; against the plain
    version at the bf16 limit."""
    _q8_prefill_against_plain(dev, *_q8_prefill_inputs(
        dev, T, off, nh, nkv, hs, bs, seed=T + bs + hs), off)


@pytest.mark.parametrize("hs", [64, 128])
def test_paged_prefill_q8_extreme_codes_and_scales(dev, hs):
    """Codes at +-127 (every K and V code at a bound, signs random) and
    scales log-uniform over several orders of magnitude: K's over 1e-4 ..
    1 (scores from flat to one-hot rows), V's over 1e-5 .. 1e-2 (values
    up to 1.27, so the absolute bf16 limit still means what it means for
    unit outputs). The conversion is exact and the scales act on fp32
    values, so the kernel stays within the bf16 limit of the plain
    version."""
    T, off, nh, nkv, bs = 200, 64, 8, 2, 16
    q, kc, ks, vc, vs, table = _q8_prefill_inputs(dev, T, off, nh, nkv, hs,
                                                  bs, seed=hs)
    g = torch.Generator(device=dev)
    g.manual_seed(hs)
    for c in (kc, vc):
        c.copy_(torch.where(torch.rand(c.shape, generator=g, device=dev)
                            < 0.5, 127, -127).to(torch.int8))
    for s, lo, hi in ((ks, -4, 0), (vs, -5, -2)):
        s.copy_(10.0 ** (lo + (hi - lo) * torch.rand(
            s.shape, generator=g, device=dev)))
    _q8_prefill_against_plain(dev, q, kc, ks, vc, vs, table, off)


@pytest.mark.parametrize("hs", [64, 128])
def test_paged_prefill_q8_bf16_is_deterministic(dev, hs):
    """Two launches of the int8-cache wgmma prefill are bit-equal."""
    q, kc, ks, vc, vs, table = _q8_prefill_inputs(dev, 512, 256, 12, 12, hs,
                                                  16)
    kw = dict(scale=hs ** -0.5, k_scale=ks, v_scale=vs)
    first, second = (fd.paged_flash_prefill(q, kc, vc, table, 256, **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype,hs,kernel", [
    (torch.bfloat16, 64, "prefill_kernel_sm90_q8"),
    (torch.bfloat16, 128, "prefill_kernel_sm90_q8"),
    (torch.float32, 64, "paged_prefill_kernel"),
    (torch.bfloat16, 40, "paged_prefill_kernel")],
    ids=["bf16-64", "bf16-128", "fp32-64", "bf16-40"])
def test_q8_prefill_runs_the_kernel_its_route_names(dev, dtype, hs, kernel):
    """Under the profiler, an int8-cache prefill launches the wgmma kernel
    for bf16 at head sizes 64 and 128 and the FMA kernel
    (`paged_prefill_kernel<T, int8_t>`) for fp32 and other head sizes, and
    no other prefill kernel."""
    from torch.profiler import ProfilerActivity, profile

    q, kc, ks, vc, vs, table = _q8_prefill_inputs(dev, 100, 32, 8, 2, hs, 16,
                                                  seed=4)
    q = q.to(dtype)
    kw = dict(scale=hs ** -0.5, k_scale=ks, v_scale=vs)
    fd.paged_flash_prefill(q, kc, vc, table, 32, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fd.paged_flash_prefill(q, kc, vc, table, 32, **kw)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "prefill_kernel" in e.key]
    assert names and all(kernel in n for n in names), names
    if kernel == "paged_prefill_kernel":
        assert all("signed char" in n for n in names), names


def test_q8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """fp16 activations, or bf16 codes handed over as an int8 cache, raise
    on the card; nothing runs a plain version."""
    kc, ks, vc, vs, _ = _q8_pools(dev, 3, 16, 4, 64, seed=0)
    bt = torch.ones(2, 2, dtype=torch.int32, device=dev)
    cl = torch.ones(2, dtype=torch.int32, device=dev)
    fd.reset_counts()
    for q, k in ((torch.zeros(2, 4, 64, device=dev, dtype=torch.float16), kc),
                 (torch.zeros(2, 4, 64, device=dev, dtype=torch.bfloat16),
                  kc.bfloat16())):
        with pytest.raises(ValueError):
            fd.paged_flash_decode(q, k, vc, bt, cl, scale=0.125,
                                  k_scale=ks, v_scale=vs)
        with pytest.raises(ValueError):
            fd.paged_flash_prefill(torch.zeros(1, 8, 4, 64, device=dev,
                                               dtype=q.dtype),
                                   k, vc, bt[:1], 0, scale=0.125,
                                   k_scale=ks, v_scale=vs)
    assert fd.PLAIN_CALLS == {k: 0 for k in fd.PLAIN_CALLS}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("route", ["paged", "contiguous"])
def test_paged_decode_q8_split_boundaries(dev, dtype, route):
    """Lengths 1, one short of, at and one past a 128-key split, and the
    whole 1024-key table (eight splits), paged and contiguous."""
    bs, n_max, nh, hs = 16, 64, 12, 64
    cl = torch.tensor([1, 127, 128, 129, 1024], dtype=torch.int32,
                      device=dev)
    B = cl.numel()
    q, kc, ks, vc, vs, tables = _q8_decode_inputs(dev, dtype, B, nh, nh, hs,
                                                  bs, n_max, seed=7)
    if route == "contiguous":
        kc, ks, vc, vs, _ = _q8_pools(dev, B, n_max * bs, nh, hs, seed=8)
    _q8_decode_against_plain(dev, dtype, q, kc, ks, vc, vs, tables, cl,
                             route)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nkv", [12, 2, 1], ids=["mha", "rep6", "rep12"])
def test_paged_decode_q8_many_rows_a_kv_head(dev, dtype, nkv):
    """12 query heads over 12, 2 or 1 kv heads: rep 1, 6 (one chunk of 8
    rows) and 12 (two row chunks of the split kernel), ragged lengths."""
    q, kc, ks, vc, vs, tables = _q8_decode_inputs(dev, dtype, 4, 12, nkv,
                                                  64, 16, 20, seed=nkv)
    cl = torch.tensor([1, 129, 200, 320], dtype=torch.int32, device=dev)
    _q8_decode_against_plain(dev, dtype, q, kc, ks, vc, vs, tables, cl)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hs", [264, 320])
@pytest.mark.parametrize("route", ["paged", "contiguous"])
def test_decode_q8_rows_wider_than_the_split_kernel(dev, dtype, hs, route):
    """int8 rows past 256 codes (33 and 40 vectors) decode through the FMA
    tile kernel the C entry picks for them (no workspace), paged and
    contiguous, GQA at rep 2, ragged lengths up to the whole table."""
    assert not fd.takes_split(hs, torch.int8)
    bs, n_max = 16, 12
    cl = torch.tensor([1, 17, 130, n_max * bs], dtype=torch.int32,
                      device=dev)
    B = cl.numel()
    q, kc, ks, vc, vs, tables = _q8_decode_inputs(dev, dtype, B, 4, 2, hs,
                                                  bs, n_max, seed=hs)
    assert fd.paged_flash_decode_usable(q[:, None], kc, vc, ks, vs)
    if route == "contiguous":
        kc, ks, vc, vs, _ = _q8_pools(dev, B, n_max * bs, 2, hs, seed=hs + 1)
    _q8_decode_against_plain(dev, dtype, q, kc, ks, vc, vs, tables, cl,
                             route)


@pytest.mark.parametrize("hs,kernels", [
    (64, ("decode_split_kernel", "decode_combine_kernel")),
    (264, ("paged_decode_kernel",))])
def test_q8_decode_runs_the_kernels_its_row_width_names(dev, hs, kernels):
    """Under the profiler, an int8 decode launches the split and combine
    kernels (int8 instantiation) for rows of at most 256 codes, the tile
    kernel past that, and nothing else of the decode."""
    from torch.profiler import ProfilerActivity, profile

    q, kc, ks, vc, vs, tables = _q8_decode_inputs(dev, torch.bfloat16, 4, 8,
                                                  2, hs, 16, 8, seed=3)
    cl = torch.tensor([1, 40, 128, 128], dtype=torch.int32, device=dev)
    kw = dict(scale=hs ** -0.5, k_scale=ks, v_scale=vs)
    fd.paged_flash_decode(q, kc, vc, tables, cl, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fd.paged_flash_decode(q, kc, vc, tables, cl, **kw)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "_kernel<" in e.key
             and "decode" in e.key]
    assert sorted({k for k in kernels for n in names if k in n}) == \
        sorted(kernels), names
    assert all(any(k in n for k in kernels) for n in names), names
    if len(kernels) == 2:
        assert all("signed char" in n for n in names
                   if "split" in n), names


FLASH_CASES = [  # B, T, S, nh, nkv, D, causal
    (2, 128, 128, 4, 4, 64, True), (2, 128, 128, 4, 2, 64, False),
    (1, 100, 100, 4, 2, 64, True), (1, 40, 256, 4, 4, 64, True),
    (2, 96, 96, 2, 1, 128, True), (1, 70, 70, 2, 2, 128, False),
    # T and S off the bf16 kernels' 64-row (dkv at D 128: 32-row) tiles
    (1, 200, 200, 4, 2, 64, True), (2, 1, 1, 4, 4, 64, True),
    (2, 1, 70, 2, 1, 64, False),
    # D 128 with GQA rep 4 (dkv sums four query heads per kv head)
    (1, 200, 200, 8, 2, 128, True), (2, 130, 70, 8, 2, 128, False),
    # D 256 (MLA's q_c | q_r): MHA and GQA, causal and full, T and S off
    # the tiles (dq's 32-key stages; the forward's 128-row CTA, whose
    # second consumer has no live row at T 65 and 130 and some at 200; the
    # dkv's 64-row query tiles, each consumer's 32 queries of them)
    (2, 128, 128, 4, 4, 256, True), (1, 200, 200, 4, 2, 256, True),
    (2, 130, 70, 8, 2, 256, False), (1, 100, 100, 2, 2, 256, False),
    (1, 65, 65, 2, 2, 256, True), (2, 130, 130, 4, 1, 256, True),
    (1, 200, 200, 8, 2, 256, False), (1, 65, 130, 2, 2, 256, False),
    # head sizes under a built width (64, 128, 256), run at that width with
    # zero columns past d: 8, 32 (the default config), 40, 48 (MLA on the
    # default config), 96 (768 / 8 heads), 136, 192 (the flagship with the
    # launcher's rope head) and 248; and 80 (MLA on the flagship) at its
    # own width 80; causal and full, GQA, ragged T (130) and S != T, several
    # heads a row
    (2, 130, 130, 4, 2, 8, True), (2, 130, 130, 8, 4, 32, True),
    (1, 130, 70, 8, 4, 32, False), (2, 130, 130, 3, 3, 40, False),
    (1, 130, 130, 8, 8, 48, True), (2, 130, 130, 12, 12, 80, True),
    (1, 130, 200, 4, 2, 80, False), (2, 130, 130, 8, 2, 96, True),
    (1, 130, 130, 4, 4, 136, True), (2, 130, 130, 4, 2, 192, True),
    (1, 130, 70, 4, 4, 192, False), (1, 130, 130, 4, 1, 248, True),
    # the warp-specialized bf16 dq at widths 192 and 256 (128-row CTAs, a
    # consumer of 64 rows each): T = S 900 leaves the last CTA 4 rows, all
    # the first consumer's; 1000 gives the second consumer 40 of its 64;
    # 1088 is 128-aligned plus 64, the first consumer's rows only; GQA 8 /
    # 2, causal and full, at 256 and 192 and masked at 256 (200, 248)
    (1, 900, 900, 8, 2, 256, True), (1, 1000, 1000, 8, 2, 256, False),
    (1, 1088, 1088, 8, 2, 256, True), (1, 900, 900, 8, 2, 192, False),
    (1, 1000, 1000, 8, 2, 192, True), (1, 1088, 1088, 8, 2, 192, False),
    (1, 1000, 1000, 8, 2, 200, True), (1, 1088, 1088, 8, 2, 200, False),
    (1, 900, 900, 8, 2, 248, True), (1, 1000, 1000, 8, 2, 248, False)]


#: (atol, rtol) of the flash kernels, element by element:
#: |kernel - plain| <= atol + rtol * |plain|
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 2 ** -7)}


def _flash_close(out, ref, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def _flash_case(dev, dtype, B, T, S, nh, nkv, D, causal, rate):
    """Forward, dq and dkv of one case against their plain versions."""
    g = torch.Generator(device=dev)
    g.manual_seed(T + S + D)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, k, v = rnd(B, T, nh, D), rnd(B, S, nkv, D), rnd(B, S, nkv, D)
    dout = rnd(B, T, nh, D)
    seed = torch.tensor([7, -11], dtype=torch.int32, device=dev)
    kw = dict(scale=D ** -0.5, causal=causal, dropout_rate=rate)
    fa.reset_counts()
    out, lse = fa.flash_attn_fwd(q, k, v, seed, **kw)
    ref, ref_lse = fa.flash_attn_fwd_plain(q, k, v, seed, **kw)
    _flash_close(out, ref, dtype)
    _flash_close(lse, ref_lse, torch.float32)
    delta = (dout.float() * ref.float()).sum(-1).transpose(1, 2) \
        - torch.randn(B, nh, T, generator=g, device=dev)
    dq = fa.flash_attn_bwd_dq(q, k, v, dout, ref_lse, delta, seed, **kw)
    _flash_close(dq, fa.flash_attn_bwd_dq_plain(q, k, v, dout, ref_lse,
                                                delta, seed, **kw), dtype)
    dk, dv = fa.flash_attn_bwd_dkv(q, k, v, dout, ref_lse, delta, seed, **kw)
    rk, rv = fa.flash_attn_bwd_dkv_plain(q, k, v, dout, ref_lse, delta, seed,
                                         **kw)
    _flash_close(dk, rk, dtype)
    _flash_close(dv, rv, dtype)
    assert fa.LAUNCHES == {k: 1 for k in fa.LAUNCHES}


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,T,S,nh,nkv,D,causal", FLASH_CASES)
def test_flash_kernels(dev, dtype, B, T, S, nh, nkv, D, causal, rate):
    _flash_case(dev, dtype, B, T, S, nh, nkv, D, causal, rate)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_kernels_bf16_training_shape(dev, rate):
    """The bf16 kernels at the training path's shape: B 8, T 1024, 12
    heads x 64, causal (16 query and key tiles a head)."""
    _flash_case(dev, torch.bfloat16, 8, 1024, 1024, 12, 12, 64, True, rate)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_kernels_bf16_mla_training_shape(dev, rate):
    """The bf16 kernels at the MLA training path's shape: B 8, T 1024,
    8 heads x 256 (the launcher's q_c | q_r), causal."""
    _flash_case(dev, torch.bfloat16, 8, 1024, 1024, 8, 8, 256, True, rate)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("nh,nkv", [(12, 12), (12, 4)], ids=["mha", "gqa"])
@pytest.mark.parametrize("T", [65, 900, 1088])
@pytest.mark.parametrize("D", [72, 80])
def test_flash_kernels_bf16_width_80(dev, D, T, nh, nkv, causal, rate):
    """Head sizes 72 and 80 at width 80 (the bf16 forward, dq and dkv
    built for it; 72 on the masked instances) against the plain versions: T 65
    (one full 64-row tile and one row), 900 and 1088 (ragged and
    64-aligned), MHA and GQA (the dkv sums 3 query heads a kv head)."""
    _flash_case(dev, torch.bfloat16, 2 if T == 65 else 1, T, T, nh, nkv, D,
                causal, rate)


@pytest.mark.parametrize("D", [72, 80])
def test_flash_width_80_runs_its_own_instances(dev, D):
    """Under the profiler, head sizes 72 and 80 in bf16 launch the
    forward, dq and dkv built for width 80 (`<80, true>` masked for 72,
    `<80, false>` for 80), never a 128-wide one; each output equals its
    plain version within FLASH_TOL."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _flash_case(dev, torch.bfloat16, 2, 200, 200, 12, 4, D, True, 0.0)
    names = {e.key for e in prof.key_averages() if "kernel_sm90<" in e.key}
    part = "true" if D < 80 else "false"
    want = {"fwd": f"fwd_kernel_sm90<80, {part}>",
            "dkv": f"dkv_kernel_sm90<80, {part}>",
            "dq": f"dq_kernel_sm90<80, {part}>"}
    for kind, name in want.items():
        got = [n for n in names if re.search(rf"\b{kind}_kernel_sm90<", n)]
        assert got and all(name in n for n in got), (kind, names)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,S,nh,nkv", [(130, 130, 8, 4), (130, 70, 8, 8),
                                        (65, 200, 8, 2)],
                         ids=["gqa", "mha-s70", "gqa4-s200"])
@pytest.mark.parametrize("D", [8, 16, 24, 32])
def test_flash_kernels_bf16_width_32(dev, D, T, S, nh, nkv, causal, rate):
    """Head sizes 8-32 at width 32 (the bf16 forward, dq and dkv built
    for it; 8, 16 and 24 on the masked instances) against the plain
    versions: ragged T 130 and 65, S != T (70, 200), MHA and GQA (the dkv
    sums 2 and 4 query heads a kv head)."""
    _flash_case(dev, torch.bfloat16, 2, T, S, nh, nkv, D, causal, rate)


@pytest.mark.parametrize("D", [24, 32])
def test_flash_width_32_runs_its_own_instances(dev, D):
    """Under the profiler, head sizes 24 and 32 in bf16 launch the
    forward, dq and dkv built for width 32 (`<32, true>` masked for 24,
    `<32, false>` for 32), never a 64-wide one; each output equals its
    plain version within FLASH_TOL."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _flash_case(dev, torch.bfloat16, 2, 200, 200, 8, 4, D, True, 0.0)
    names = {e.key for e in prof.key_averages() if "kernel_sm90<" in e.key}
    part = "true" if D < 32 else "false"
    want = {"fwd": f"fwd_kernel_sm90<32, {part}>",
            "dkv": f"dkv_kernel_sm90<32, {part}>",
            "dq": f"dq_kernel_sm90<32, {part}>"}
    for kind, name in want.items():
        got = [n for n in names if re.search(rf"\b{kind}_kernel_sm90<", n)]
        assert got and all(name in n for n in got), (kind, names)


class _Torch:
    """`torch` with `empty` handing out the front of a larger buffer
    filled with NaN, whose tail shows any write past a tensor's end."""

    def __init__(self):
        self.tails = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *shape, dtype=None, device=None):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(
            shape[0], int) else shape
        n = int(np.prod(shape))
        buf = torch.full((n + 4096,), float("nan"), dtype=dtype,
                         device=device)
        self.tails.append(buf[n:])
        return buf[:n].view(shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("D", [8, 24, 40, 72, 80, 136, 200, 248])
def test_flash_writes_no_column_past_the_head_size(dev, monkeypatch, dtype,
                                                   D):
    """The kernels run D at a wider built width, whose columns past D
    they compute and must not store: row t's last head ends where row t +
    1's first head begins, and the last row's last head ends the tensor.
    Every output (out, lse, dq, dk, dv) is allocated as the front of a NaN
    buffer; after the three launches the tails are still NaN and each
    output, every head of it, equals its plain version."""
    shim = _Torch()
    monkeypatch.setattr(fa, "torch", shim)
    _flash_case(dev, dtype, 2, 130, 130, 4, 2, D, True, 0.0)
    assert len(shim.tails) == 5
    assert all(bool(t.isnan().all()) for t in shim.tails)


@pytest.mark.parametrize("D", [36, 264])
def test_flash_refuses_other_head_sizes(dev, D):
    """Head sizes off the kernels' grid (36: not a multiple of 8) or past
    their widest built width (264 = 136 + 128, MLA with the launcher's rope
    head on 136-wide heads) raise on the card; nothing falls back."""
    q = torch.zeros(1, 64, 2, D, device=dev, dtype=torch.bfloat16)
    stat = torch.zeros(1, 2, 64, device=dev)
    with pytest.raises(ValueError, match="head size"):
        fa.flash_attn_fwd(q, q, q, scale=0.1)
    for fn in (fa.flash_attn_bwd_dq, fa.flash_attn_bwd_dkv):
        with pytest.raises(ValueError, match="head size"):
            fn(q, q, q, q, stat, stat, scale=0.1)


@pytest.mark.parametrize("D,nh", [(64, 4), (256, 4), (80, 12), (32, 8)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_reads_strided_views(dev, dtype, D, nh):
    """q, k, v as views of one fused qkv projection (row stride 3*C), as
    the model hands them over, equal contiguous copies (bf16: through the
    TMA maps' time stride), and reach the kernels without a copy: at D 80
    (MLA on the flagship, at width 80 through a 64-column and a 16-column
    map of each operand) and D 32 (one 32-column map) too."""
    B, T = 2, 130
    qkv = torch.randn(B, T, 3 * nh * D, device=dev).to(dtype)
    q, k, v = (t.reshape(B, T, nh, D) for t in qkv.split(nh * D, dim=-1))
    assert q.stride(1) == 3 * nh * D
    assert all(fa._strided(t).data_ptr() == t.data_ptr() for t in (q, k, v))
    out, lse = fa.flash_attn_fwd(q, k, v, scale=D ** -0.5)
    ref, ref_lse = fa.flash_attn_fwd(q.contiguous(), k.contiguous(),
                                     v.contiguous(), scale=D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("D,nh,nkv", [(64, 4, 2), (128, 8, 2), (256, 8, 2),
                                      (200, 8, 2), (80, 12, 4), (32, 8, 4),
                                      (24, 8, 4)])
def test_flash_bwd_bf16_is_deterministic(dev, D, nh, nkv, kernel):
    """Two launches of a bf16 backward kernel on the same inputs are
    bit-equal: dq writes each query row once, dkv sums the GQA group in
    registers and writes each key row once, with no atomics."""
    B, T = 2, 200
    g = torch.Generator(device=dev)
    g.manual_seed(D)
    q, dout = (torch.randn(B, T, nh, D, generator=g, device=dev).bfloat16()
               for _ in range(2))
    k, v = (torch.randn(B, T, nkv, D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(scale=D ** -0.5, causal=True)
    out, lse = fa.flash_attn_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    fn = fa.flash_attn_bwd_dq if kernel == "dq" else fa.flash_attn_bwd_dkv
    first, second = (fn(q, k, v, dout, lse, delta, **kw) for _ in range(2))
    torch.cuda.synchronize()
    if kernel == "dq":
        first, second = (first,), (second,)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("nh,nkv,causal", [(4, 4, True), (4, 2, False)])
def test_flash_autograd_matches_naive(dev, nh, nkv, causal):
    """out and dq/dk/dv through the kernels against autograd through the
    naive einsum attention, fp32 (atol 2e-4: summation order over 200
    rows)."""
    from distributed_pytorch_tpu_torch.ops.attention_core import _naive_sdpa
    B, T, D = 2, 200, 64
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    ins = [torch.randn(B, T, n, D, generator=g, device=dev)
           for n in (nh, nkv, nkv)]
    w = torch.randn(B, T, nh, D, generator=g, device=dev)
    res = []
    for fn in (lambda a, b, c: fa.flash_attention(a, b, c, scale=0.125,
                                                  causal=causal),
               lambda a, b, c: _naive_sdpa(a, b, c, scale=0.125,
                                           causal=causal)):
        xs = [t.clone().requires_grad_() for t in ins]
        out = fn(*xs)
        res.append([out] + list(torch.autograd.grad((out * w).sum(), xs)))
    for a, b in zip(*res):
        assert (a - b).abs().max().item() <= 2e-4


# fused CE, per output: nll and lse are fp32 scores from the same operand
# values summed in another order (fp32 limits in both dtypes); dx and dW
# are fp32 sums of O(1) terms taken in another order (atol; chip_smoke
# saw 5e-5 at n 8192), and bf16 outputs round on both sides (one ulp:
# rtol 2^-7).
CE_TOL = {"lse": (1e-5, 1e-5), torch.float32: (1e-4, 1e-5),
          torch.bfloat16: (1e-4, 2 ** -7)}


def _ce_inputs(dev, dtype, n, C, V, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(n, C, generator=g, device=dev).to(dtype)
    w = (0.02 * torch.randn(V, C, generator=g, device=dev)).to(dtype)
    t = torch.randint(0, V, (n,), generator=g, device=dev, dtype=torch.int32)
    t[:5] = -2                                   # ignored rows
    coef = torch.randn(n, generator=g, device=dev)
    coef[:5] = 0.0
    return x, w, t, coef


def _within(out, ref, tol):
    atol, rtol = tol
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    d = (out.float() - ref.float()).abs()
    assert (d <= atol + rtol * ref.float().abs()).all(), d.max().item()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n,C,V", [(100, 128, 100), (300, 768, 50304),
                                   (64, 256, 96), (8, 640, 64),
                                   (130, 1024, 1000), (70, 1152, 300),
                                   (40, 1280, 50304)])
def test_fused_ce_kernels(dev, dtype, n, C, V):
    """Each kernel against its plain version. Past C 768 the kernels
    stream C in chunks: 1024 and 1280 in two equal ones, 1152 in 640 +
    512 columns."""
    x, w, t, coef = _ce_inputs(dev, dtype, n, C, V)
    ce.reset_counts()
    nll, lse = ce.fused_ce_fwd(x, w, t)
    r_nll, r_lse = ce.fused_ce_fwd_plain(x, w, t)
    _within(nll, r_nll, CE_TOL["lse"])
    _within(lse, r_lse, CE_TOL["lse"])
    dx = ce.fused_ce_bwd_dx(x, w, t, r_lse, coef)
    dw = ce.fused_ce_bwd_dw(x, w, t, r_lse, coef)
    _within(dx, ce.fused_ce_bwd_dx_plain(x, w, t, r_lse, coef), CE_TOL[dtype])
    _within(dw, ce.fused_ce_bwd_dw_plain(x, w, t, r_lse, coef), CE_TOL[dtype])
    assert torch.count_nonzero(dx[:5]) == 0      # ignored rows: exactly 0
    assert ce.LAUNCHES == {k: 1 for k in ce.LAUNCHES}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fused_ce_autograd_matches_plain_route(dev, dtype):
    """`pallas_cross_entropy`'s loss and gradients through the kernels
    against the same function on CPU copies (the plain versions): loss
    within 1e-5 relative, gradients within CE_TOL."""
    B, T, C, V = 2, 70, 256, 1000
    x, w, _, _ = _ce_inputs(dev, dtype, B * T, C, V, seed=1)
    tgt = torch.randint(0, V, (B, T), device=dev)
    tgt[:, -4:] = -1
    res = []
    for d in (dev, torch.device("cpu")):
        xs = x.reshape(B, T, C).to(d).clone().requires_grad_()
        ws = w.to(d).clone().requires_grad_()
        loss = ce.pallas_cross_entropy(xs, ws, tgt.to(d))
        loss.backward()
        res.append((loss.detach().cpu(), xs.grad.cpu(), ws.grad.cpu()))
    (lk, gxk, gwk), (lp, gxp, gwp) = res
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    for a, b in ((gxk, gxp), (gwk, gwp)):
        d = (a.float() - b.float()).abs()
        atol, rtol = CE_TOL[dtype]
        assert (d <= atol + rtol * b.float().abs()).all(), d.max().item()
    assert torch.count_nonzero(gxk[:, -4:]) == 0


def test_pallas_loss_at_gpt2_medium_width_runs_the_kernels(dev):
    """A model of GPT-2 medium's width (C 1024) with loss_impl='pallas' on
    the card: the loss runs the three kernels (no degrade, no plain call)
    and agrees with loss_impl='unchunked' in fp32 within 1e-5 relative,
    its gradients within 1e-4 of each parameter's largest."""
    import dataclasses

    from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
    from distributed_pytorch_tpu_torch.train.state import build_model

    cfg = LLMConfig(vocab_size=1000, block_size=64, n_embd=1024, n_head=8,
                    n_kv_heads=8, attn="mha", n_layer=1, up_dim=512,
                    loss_impl="pallas")
    model = build_model(cfg, TrainConfig(compute_dtype="float32"), dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    x = torch.randint(0, 1000, (2, 64), device=dev)
    res = []
    for impl in ("pallas", "unchunked"):
        model.config = dataclasses.replace(cfg, loss_impl=impl)
        model.zero_grad()
        ce.reset_counts()
        _, loss = model(x, x.roll(-1, 1))
        loss.backward()
        if impl == "pallas":
            assert ce.LAUNCHES == {k: 1 for k in ce.LAUNCHES}
            assert ce.DEGRADED["chunked"] == 0
            assert ce.PLAIN_CALLS == {k: 0 for k in ce.PLAIN_CALLS}
        res.append((loss.item(), {k: p.grad.clone() for k, p in
                                  model.named_parameters()}))
    (lk, gk), (lr, gr) = res
    assert abs(lk - lr) <= 1e-5 * abs(lr)
    for k in gr:
        scale = gr[k].abs().max().item()
        assert (gk[k] - gr[k]).abs().max().item() <= 1e-4 * scale, k


BWD = {"dx": (ce.fused_ce_bwd_dx, ce.fused_ce_bwd_dx_plain),
       "dw": (ce.fused_ce_bwd_dw, ce.fused_ce_bwd_dw_plain)}
# the kernel each route of `fused_ce_fwd_plan` and `fused_ce_bwd_plan`
# launches, as the profiler names it: 2 sm90, 1 mma.sync (bf16), 0 FMA
# (fp32)
ROUTE_KERNEL = {2: "ce_kernel_sm90", 1: "ce_kernel<", 0: "ce_kernel<"}


def _bwd_plan(n, V, C, dtype=torch.bfloat16):
    """csrc/fused_ce_bwd.cu `fused_ce_bwd_plan`: (route, ring stages,
    output-column blocks) of the backward for n tokens of width C."""
    import ctypes

    from distributed_pytorch_tpu_torch.ops import cuda_build
    stages, ny = ctypes.c_int(), ctypes.c_int()
    route = cuda_build.load("fused_ce_bwd_dx").fused_ce_bwd_plan(
        int(dtype == torch.bfloat16), n, V, C, ctypes.byref(stages),
        ctypes.byref(ny))
    return route, stages.value, ny.value


def _exact_ce_inputs(dev, n, C, V, seed):
    """`_ce_inputs` in bf16 with x on a grid of 1/8 (|x| <= 4) and W on a
    grid of 2^-10 (|W| <= 0.08): every partial sum of a score is a
    multiple of 2^-13 below 2^11, exact in fp32 in any order, so the
    kernel and the plain version round the same dlogits to bf16."""
    x, w, t, coef = _ce_inputs(dev, torch.float32, n, C, V, seed=seed)
    x = ((x * 8).round().clamp(-32, 32) / 8).to(torch.bfloat16)
    w = ((w * 1024).round().clamp(-80, 80) / 1024).to(torch.bfloat16)
    return x, w, t, coef


def _bwd_against_plain(dev, n, C, V, seed=0, exact=False):
    """bf16 dx and dW against their plain versions within CE_TOL; ignored
    rows (the first 5) have dx exactly 0."""
    x, w, t, coef = (_exact_ce_inputs(dev, n, C, V, seed) if exact else
                     _ce_inputs(dev, torch.bfloat16, n, C, V, seed=seed))
    _, lse = ce.fused_ce_fwd_plain(x, w, t)
    ce.reset_counts()
    for name, (fk, fp) in BWD.items():
        out = fk(x, w, t, lse, coef)
        _within(out, fp(x, w, t, lse, coef), CE_TOL[torch.bfloat16])
        if name == "dx":
            assert torch.count_nonzero(out[:5]) == 0
        del out
    assert ce.LAUNCHES["fused_ce_bwd_dx"] == ce.LAUNCHES["fused_ce_bwd_dw"] \
        == 1


@pytest.mark.parametrize("C,plan", [(128, (8, 1)), (384, (8, 1)),
                                    (640, (8, 2)), (768, (7, 2)),
                                    (896, (6, 3)), (1024, (5, 3)),
                                    (1152, None), (1280, None)])
def test_fused_ce_bwd_plan(dev, C, plan):
    """The backward's route by dtype and width, every width the gate
    accepts: bf16 runs the sm90 kernel up to C 1024, whose plan keeps the
    64 x C resident tile, the dlogits tile and a ring of 5-8 16 KB stages
    in 227 KB, and each warpgroup owns up to 3 output boxes of 64 columns
    (C 768: 7 stages, 2 output blocks; C 1024: 5 and 3); past it, and
    with no tokens or no vocabulary, the mma.sync kernel; fp32 the FMA
    kernel."""
    assert _bwd_plan(8192, 50304, C) == \
        ((1, 0, 0) if plan is None else (2, *plan))
    assert _bwd_plan(0, 50304, C) == (1, 0, 0)
    assert _bwd_plan(8192, 0, C) == (1, 0, 0)
    assert _bwd_plan(8192, 50304, C, torch.float32) == (0, 0, 0)


def test_fused_ce_bwd_bf16_training_shape(dev):
    """The training path's shape (n 8192, C 768, V 50304) on the sm90
    kernel."""
    assert _bwd_plan(8192, 50304, 768)[0] == 2
    _bwd_against_plain(dev, 8192, 768, 50304)


@pytest.mark.parametrize("C", [768, 1024, 1280])
@pytest.mark.parametrize("V", [96, 100, 1000, 50304])
def test_fused_ce_bwd_bf16_ragged(dev, C, V):
    """300 tokens (not a multiple of the 64 resident rows or the 128-row
    tiles) against vocabularies on and off the tiles; C 768 and 1024 run
    the sm90 kernel (2 and 3 output-column blocks), C 1280 the mma.sync
    kernel (its resident tile and ring do not fit). The scores are exact
    (`_exact_ce_inputs`): from normal inputs at V 96 and 100, where p is
    large, a dlogit on a bf16 rounding boundary rounds either way from
    scores that differ only in summation order, which moves a dW row by
    one bf16 step of dl times x, past CE_TOL at its small elements; the
    H100 showed it for both kernels (0.0156 at |dW| ~ 0.5)."""
    assert _bwd_plan(300, V, C)[0] == (2 if C <= 1024 else 1)
    _bwd_against_plain(dev, 300, C, V, seed=C + V, exact=True)


@pytest.mark.parametrize("C", [768, 1024, 1280])
def test_fused_ce_bwd_runs_the_kernel_its_route_names(dev, C):
    """Under the profiler, dx and dW launch the kernel the C plan names
    and no other."""
    from torch.profiler import ProfilerActivity, profile

    x, w, t, coef = _ce_inputs(dev, torch.bfloat16, 300, C, 1000)
    lse = torch.zeros(300, device=dev)
    route = _bwd_plan(300, 1000, C)[0]
    for fk, _ in BWD.values():
        fk(x, w, t, lse, coef)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fk(x, w, t, lse, coef)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if "fce::" in e.key]
        assert names and all(ROUTE_KERNEL[route] in k for k in names), names


@pytest.mark.parametrize("kernel", ["dx", "dw"])
def test_fused_ce_bwd_bf16_is_deterministic(dev, kernel):
    """Two launches of the sm90 dx or dW are bit-equal: each CTA owns its
    output rows and sums in a fixed order (no atomics)."""
    x, w, t, coef = _ce_inputs(dev, torch.bfloat16, 1000, 768, 5000, seed=3)
    _, lse = ce.fused_ce_fwd_plain(x, w, t)
    fk = BWD[kernel][0]
    first, second = (fk(x, w, t, lse, coef) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _fwd_plan(n, V, C, dtype=torch.bfloat16):
    """csrc/fused_ce_fwd.cu `fused_ce_fwd_plan`: (route, ring stages) of
    the forward for n tokens of width C."""
    import ctypes

    from distributed_pytorch_tpu_torch.ops import cuda_build
    stages = ctypes.c_int()
    route = cuda_build.load("fused_ce_fwd").fused_ce_fwd_plan(
        int(dtype == torch.bfloat16), n, V, C, ctypes.byref(stages))
    return route, stages.value


def _fwd_against_plain(dev, n, C, V, seed=0):
    """bf16 nll and lse against the plain version within CE_TOL["lse"];
    ignored rows (the first 5) have nll equal to lse."""
    x, w, t, _ = _ce_inputs(dev, torch.bfloat16, n, C, V, seed=seed)
    ce.reset_counts()
    nll, lse = ce.fused_ce_fwd(x, w, t)
    r_nll, r_lse = ce.fused_ce_fwd_plain(x, w, t)
    _within(nll, r_nll, CE_TOL["lse"])
    _within(lse, r_lse, CE_TOL["lse"])
    assert torch.equal(nll[:5], lse[:5])
    assert ce.LAUNCHES["fused_ce_fwd"] == 1
    assert ce.PLAIN_CALLS["fused_ce_fwd"] == 1          # the reference


@pytest.mark.parametrize("C,stages", [(128, 8), (640, 8), (768, 8),
                                      (896, 7), (1024, 6), (1152, None),
                                      (1280, None)])
def test_fused_ce_fwd_plan(dev, C, stages):
    """The forward's route by dtype and width: bf16 runs the sm90 kernel
    up to C 1024, its ring as deep as the 64 x C resident tile leaves room
    for (8 stages of 16 KB up to C 768, 6 at C 1024); past it, and with no
    tokens or no vocabulary, the mma.sync kernel; fp32 the FMA kernel."""
    assert _fwd_plan(8192, 50304, C) == \
        ((1, 0) if stages is None else (2, stages))
    assert _fwd_plan(0, 50304, C) == (1, 0)
    assert _fwd_plan(8192, 0, C) == (1, 0)
    assert _fwd_plan(8192, 50304, C, torch.float32) == (0, 0)


def test_fused_ce_fwd_bf16_training_shape(dev):
    """The training path's shape (n 8192, C 768, V 50304) on the sm90
    forward."""
    assert _fwd_plan(8192, 50304, 768) == (2, 8)
    _fwd_against_plain(dev, 8192, 768, 50304)


@pytest.mark.parametrize("C", [768, 1024, 1280])
@pytest.mark.parametrize("V", [96, 100, 1000, 50304])
def test_fused_ce_fwd_bf16_ragged(dev, C, V):
    """300 tokens (not a multiple of the 64 resident rows) against
    vocabularies on and off the 128-row tiles (V 96 and 100: one tile,
    whose columns past V are masked; V 1000: the last of 8 tiles is
    ragged; V 50304: none is) and an odd or even tile count; C 768 and 1024
    run the sm90 kernel, C 1280 the mma.sync kernel."""
    assert _fwd_plan(300, V, C)[0] == (2 if C <= 1024 else 1)
    _fwd_against_plain(dev, 300, C, V, seed=C + V)


def test_fused_ce_fwd_bf16_is_deterministic(dev):
    """Two launches of the sm90 forward are bit-equal: each CTA owns its
    rows and merges its lanes and warpgroups in a fixed order."""
    x, w, t, _ = _ce_inputs(dev, torch.bfloat16, 1000, 768, 5000, seed=4)
    (n1, l1), (n2, l2) = (ce.fused_ce_fwd(x, w, t) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(n1, n2) and torch.equal(l1, l2)


@pytest.mark.parametrize("C", [768, 1024, 1280])
def test_fused_ce_fwd_runs_the_kernel_its_route_names(dev, C):
    """Under the profiler, the forward launches the kernel the C plan
    names and no other."""
    from torch.profiler import ProfilerActivity, profile

    x, w, t, _ = _ce_inputs(dev, torch.bfloat16, 300, C, 1000)
    route = _fwd_plan(300, 1000, C)[0]
    ce.fused_ce_fwd(x, w, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ce.fused_ce_fwd(x, w, t)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "fce::" in e.key]
    assert names and all(ROUTE_KERNEL[route] in k for k in names), names


@pytest.mark.parametrize("optimizer,lr", [("lion", 1e-4), ("adafactor", 1e-2)])
def test_optimizer_steps_on_card_match_cpu(dev, optimizer, lr):
    """3 fp32 train steps with Lion or Adafactor from one init on the card
    and on the CPU: losses within 1e-5 relative; weights within 1e-5
    (Adafactor: reduction order), or for Lion 2 x lr per step (an update
    entry whose argument is within float noise of 0 can take the other
    sign, moving the weight by at most 2 lr)."""
    from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
    from distributed_pytorch_tpu_torch.train.state import (TrainState,
                                                           build_model,
                                                           make_optimizer)
    from distributed_pytorch_tpu_torch.train.step import make_train_step

    cfg = LLMConfig(vocab_size=256, block_size=32, n_embd=128, n_head=2,
                    n_kv_heads=2, attn="mha", n_layer=1, up_dim=256)
    tc = TrainConfig(compute_dtype="float32", optimizer=optimizer,
                     learning_rate=lr, warmup_steps=1, max_iters=5)
    init = build_model(cfg, tc, "cpu")
    init.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, 1, 2, 32)))
               for _ in range(3)]
    runs = []
    for d in ("cpu", dev):
        model = build_model(cfg, tc, d)
        model.load_state_dict(init.state_dict())
        state = TrainState(step=0, model=model,
                           optimizer=make_optimizer(model, tc))
        step = make_train_step(tc)
        losses = [float(step(state, b[0].to(d), b[1].to(d))["loss"])
                  for b in batches]
        runs.append((losses, {k: v.float().cpu() for k, v in
                              model.state_dict().items()}))
    (l_c, w_c), (l_g, w_g) = runs
    np.testing.assert_allclose(l_g, l_c, rtol=1e-5)
    atol = 2 * lr * len(batches) if optimizer == "lion" else 1e-5
    for k in w_c:
        assert torch.isfinite(w_g[k]).all()
        assert (w_g[k] - w_c[k]).abs().max().item() <= atol, k


# grouped matmul, kernel vs plain, element by element: |kernel - plain| <=
# atol x max|plain| + rtol x |plain|. Both sum the same fp32 products of
# the operands' values in another order (atol, relative to the output's
# scale: dW sums thousands of rows); bf16 outputs round on both sides (one
# ulp: rtol 2^-7); dW is fp32 whatever the operands.
GMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2 ** -7)}
GMM_CASES = [(768, 2048, [3000, 0, 1, 129, 2000, 0, 700, 5]),
             (1024, 768, [1024, 1024, 512, 0, 3]),
             (768, 256, [0, 0, 4096, 0]),
             (264, 136, [200, 57, 0, 300])]


def _gmm_within(out, ref, tol):
    atol, rtol = tol
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    ref = ref.float()
    d = (out.float() - ref).abs()
    lim = atol * ref.abs().max() + rtol * ref.abs()
    assert (d <= lim).all(), (d - lim).max().item()


def _gmm_inputs(dev, dtype, K, N, counts, bm=128, seed=0):
    """A packed buffer for groups of `counts` rows: metadata from the
    dispatch's own `_gmm_metadata`, random rows, weights and gates."""
    E = len(counts)
    flat_e = torch.repeat_interleave(torch.arange(E, device=dev),
                                     torch.tensor(counts, device=dev))
    n_tiles = -(-sum(counts) // bm) + E
    cnt, pstart, _, tile_group = gm._gmm_metadata(flat_e, E, n_tiles, bm)
    P = n_tiles * bm
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(P, K, generator=g, device=dev).to(dtype)
    w = (0.02 * torch.randn(E, K, N, generator=g, device=dev)).to(dtype)
    dy = torch.randn(P, N, generator=g, device=dev).to(dtype)
    s = torch.rand(P, 1, generator=g, device=dev)
    return x, w, dy, s, cnt, pstart, tile_group


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("K,N,counts", GMM_CASES,
                         ids=["ragged", "proj", "one_expert", "odd_widths"])
def test_grouped_kernels(dev, dtype, K, N, counts):
    """Each grouped kernel, unscaled and scaled, against its plain version
    on the same operands; dW of an expert with no rows is exactly 0."""
    x, w, dy, s, cnt, pstart, tg = _gmm_inputs(dev, dtype, K, N, counts)
    gm.reset_counts()
    for sc in (None, s):
        _gmm_within(gm.gmm_fwd(x, w, tg, sc, bm=128),
                    gm.gmm_fwd_plain(x, w, tg, sc, bm=128), GMM_TOL[dtype])
        _gmm_within(gm.gmm_bwd_dx(dy, w, tg, sc, bm=128),
                    gm.gmm_bwd_dx_plain(dy, w, tg, sc, bm=128),
                    GMM_TOL[dtype])
        dw = gm.gmm_bwd_dw(x, dy, cnt, pstart, sc, bm=128)
        _gmm_within(dw, gm.gmm_bwd_dw_plain(x, dy, cnt, pstart, sc, bm=128),
                    GMM_TOL[torch.float32])
        for e, c in enumerate(counts):
            if c == 0:
                assert torch.count_nonzero(dw[e]) == 0
    assert gm.LAUNCHES == {k: 2 for k in gm.LAUNCHES}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("K,N", [(768, 2048), (1024, 768)],
                         ids=["fc", "proj"])
def test_grouped_fwd_at_a_serving_batch(dev, dtype, K, N):
    """The forward as a decode step of the MoE server gives it: 8 tokens,
    1 shared + top 2 of 7 routed experts, so each expert owns a few rows
    of one 128-row tile and the buffer is mostly padding tiles."""
    counts = [8, 3, 0, 5, 2, 0, 1, 5]
    x, w, _, s, _, _, tg = _gmm_inputs(dev, dtype, K, N, counts, seed=4)
    for sc in (None, s):
        _gmm_within(gm.gmm_fwd(x, w, tg, sc, bm=128),
                    gm.gmm_fwd_plain(x, w, tg, sc, bm=128), GMM_TOL[dtype])


@pytest.mark.parametrize("scaled", [False, True], ids=["fc", "proj"])
def test_grouped_fwd_bf16_is_deterministic(dev, scaled):
    """Two bf16 forward launches on the same ragged groups are bit-equal:
    each CTA writes its block of y once, with no atomics."""
    K, N = (1024, 768) if scaled else (768, 2048)
    x, w, _, s, _, _, tg = _gmm_inputs(dev, torch.bfloat16, K, N,
                                       [3000, 0, 1, 129, 2000])
    sc = s if scaled else None
    first, second = (gm.gmm_fwd(x, w, tg, sc, bm=128) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("scaled", [False, True], ids=["fc", "proj"])
def test_grouped_dw_bf16_is_deterministic(dev, scaled):
    """Two bf16 dW launches on the same ragged groups are bit-equal: each
    CTA sums its expert's rows in a fixed order and writes its block
    once, with no atomics."""
    x, _, dy, s, cnt, pstart, _ = _gmm_inputs(dev, torch.bfloat16, 1024, 768,
                                              [3000, 0, 1, 129, 2000])
    sc = s if scaled else None
    first, second = (gm.gmm_bwd_dw(x, dy, cnt, pstart, sc, bm=128)
                     for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("scaled", [False, True], ids=["fc", "proj"])
def test_grouped_dx_bf16_is_deterministic(dev, scaled):
    """Two bf16 dx launches on the same ragged groups are bit-equal: each
    CTA writes its block of dx once, with no atomics."""
    _, w, dy, s, _, _, tg = _gmm_inputs(dev, torch.bfloat16, 768, 2048,
                                        [3000, 0, 1, 129, 2000])
    sc = s if scaled else None
    first, second = (gm.gmm_bwd_dx(dy, w, tg, sc, bm=128) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("scaled", [False, True], ids=["fc", "proj"])
def test_grouped_dw_bf16_long_sum_on_one_expert(dev, scaled):
    """Every row on one expert (24576, the length of a sum that a single
    fp32 register accumulation read 3.6e-5 of max|dW| off the plain
    version): bf16 dW within GMM_TOL[float32], the other experts exactly
    0."""
    counts = [0, 0, 24576, 0]
    x, _, dy, s, cnt, pstart, _ = _gmm_inputs(dev, torch.bfloat16, 1024, 768,
                                              counts)
    sc = s if scaled else None
    dw = gm.gmm_bwd_dw(x, dy, cnt, pstart, sc, bm=128)
    _gmm_within(dw, gm.gmm_bwd_dw_plain(x, dy, cnt, pstart, sc, bm=128),
                GMM_TOL[torch.float32])
    for e, c in enumerate(counts):
        if c == 0:
            assert torch.count_nonzero(dw[e]) == 0


def test_grouped_dispatch_autograd_matches_plain_route(dev):
    """`grouped_dispatch` (shared + routed experts through the kernels,
    bm 128) against the same function on CPU copies (the plain versions at
    bm 128), in fp32: output and the gradients of x, the gates and both
    weight stacks, element by element within GMM_TOL."""
    dtype = torch.float32
    N, C, up, E, k, n_shared = 300, 256, 384, 6, 2, 1
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(N, C, generator=g, device=dev).to(dtype)
    fc = (0.05 * torch.randn(E, C, 2 * up, generator=g, device=dev)).to(dtype)
    proj = (0.05 * torch.randn(E, up, C, generator=g, device=dev)).to(dtype)
    logits = torch.randn(N, E - n_shared, generator=g, device=dev)
    vals, idx = logits.topk(k, dim=1)
    gates = torch.softmax(vals, dim=1)
    dy = torch.randn(N, C, generator=g, device=dev).to(dtype)
    res = []
    for d in (dev, torch.device("cpu")):
        leaves = [t.to(d).clone().requires_grad_() for t in (x, gates, fc,
                                                             proj)]
        if d.type == "cpu":
            old, gm.CPU_BLOCK_M = gm.CPU_BLOCK_M, 128
        try:
            y = gm.grouped_dispatch(
                leaves[0], idx.to(d), leaves[1], leaves[2], leaves[3],
                act=lambda h: activate(h, "swiglu"), n_shared=n_shared)
        finally:
            if d.type == "cpu":
                gm.CPU_BLOCK_M = old
        y.backward(dy.to(d))
        res.append([y.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*res):
        _gmm_within(a, b, GMM_TOL[dtype])


def test_moe_layer_grouped_matches_dense_on_card(dev):
    """An fp32 MoE layer (1 shared + 7 routed experts, top 2) through the
    grouped kernels against its dense dispatch on the card: output and
    every gradient within 1e-5 of its largest entry (summation order);
    the kernels launch 2 forward, 1 recompute, 2 dx and 2 dW times."""
    import dataclasses

    from distributed_pytorch_tpu_torch.config import LLMConfig
    from distributed_pytorch_tpu_torch.models.mlp import MoE

    cfg = LLMConfig(n_embd=256, up_dim=384, moe=True, n_exp=8, n_shared=1,
                    n_act=3, moe_impl="grouped")
    x = torch.randn(2, 200, 256, device=dev)
    dy = torch.randn(2, 200, 256, device=dev)
    res = []
    for impl in ("grouped", "dense"):
        torch.manual_seed(0)
        layer = MoE(dataclasses.replace(cfg, moe_impl=impl), device=dev)
        with torch.no_grad():
            for p in layer.parameters():
                p.normal_(0.0, 0.05)
        xs = x.clone().requires_grad_()
        gm.reset_counts()
        y, aux = layer(xs)
        (y * dy).sum().add(aux).backward()
        if impl == "grouped":
            assert gm.LAUNCHES == {"grouped_mm_fwd": 3,
                                   "grouped_mm_bwd_dx": 2,
                                   "grouped_mm_bwd_dw": 2}
            assert gm.PLAIN_CALLS == {k: 0 for k in gm.PLAIN_CALLS}
            assert gm.DEGRADED["dense"] == 0
        res.append([y.detach(), xs.grad] + [p.grad for p in
                                            layer.parameters()])
    for a, b in zip(*res):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("impl", ["scatter", "grouped"])
def test_moe_dispatch_repeats_bit_for_bit(dev, impl):
    """Two bf16 forward + backward calls of an MoE layer (1 shared + 15
    routed experts, top 4, capacity factor 2.0 for 'scatter', so that its
    grid has unfilled slots, over 2048 tokens) give the same bytes: the
    output, the input's gradient and every parameter's. The token gather
    and combine sum each token's rows in a fixed order (no scatter-add)."""
    import dataclasses

    from distributed_pytorch_tpu_torch.config import LLMConfig
    from distributed_pytorch_tpu_torch.models.mlp import MoE

    cfg = LLMConfig(n_embd=256, up_dim=384, moe=True, n_exp=16, n_shared=1,
                    n_act=4, aux_free=True, capacity_factor=2.0)
    torch.manual_seed(0)
    layer = MoE(dataclasses.replace(cfg, moe_impl=impl), device=dev,
                dtype=torch.bfloat16)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.05)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(4, 512, 256, generator=g, device=dev).bfloat16()
    dy = torch.randn(4, 512, 256, generator=g, device=dev).bfloat16()
    res = []
    for _ in range(2):
        layer.zero_grad(set_to_none=True)
        xs = x.clone().requires_grad_()
        y, aux = layer(xs)
        (y.float() * dy.float()).sum().add(aux).backward()
        res.append([y.detach().clone(), xs.grad.clone()]
                   + [p.grad.clone() for p in layer.parameters()])
    torch.cuda.synchronize()
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_grouped_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, w, dy, s, cnt, pstart, tg = _gmm_inputs(dev, torch.bfloat16, 256,
                                               128, [100, 30])
    with pytest.raises(ValueError, match="dtype"):
        gm.gmm_fwd(x.half(), w.half(), tg, bm=128)
    with pytest.raises(ValueError, match="dtype"):
        gm.gmm_fwd(x, w.float(), tg, bm=128)
    with pytest.raises(ValueError, match="multiple"):
        gm.gmm_fwd(x[:, :252].contiguous(), w[:, :252].contiguous(), tg,
                   bm=128)
    with pytest.raises(ValueError, match="bm"):
        gm.gmm_fwd(x, w, tg, bm=64)
    with pytest.raises(ValueError, match="contiguous"):
        gm.gmm_bwd_dx(dy.t().contiguous().t(), w, tg, bm=128)
    with pytest.raises(ValueError, match="int32"):
        gm.gmm_bwd_dw(x, dy, cnt.long(), pstart, bm=128)
    with pytest.raises(ValueError, match="scales"):
        gm.gmm_fwd(x, w, tg, s.double(), bm=128)
