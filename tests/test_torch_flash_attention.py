"""The port's flash attention (distributed_pytorch_tpu_torch/ops/
flash_attention.py) against the reference's `_flash_lse` run in interpret
mode, as tests/test_flash_attention.py runs it: out, lse, and dq/dk/dv
through `jax.vjp` with a nonzero dlse, causal and full, MHA and GQA (rep
2), dropout 0 and 0.2 with the same (2,) seed on both sides. On the CPU
the wrappers run the kernels' plain versions. fp32, atol 1e-5: the two
sides sum in different orders (tiles of 16 in the reference, one pass
here). Also: `dropout_bits` is `_mix_bits` bit for bit, `sdpa` routes
uncached calls through the flash wrappers, and the kernels' operands come
from 16-byte aligned addresses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.ops.flash_attention import _flash_lse, _mix_bits
from distributed_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_pytorch_tpu_torch.ops.attention_core import sdpa

ATOL = 1e-5
SEED = np.array([123456789, -987654321], np.int32)


def _inputs(B, T, nh, nkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, nh, D)).astype(np.float32)
    k = rng.standard_normal((B, T, nkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, nkv, D)).astype(np.float32)
    dout = rng.standard_normal((B, T, nh, D)).astype(np.float32)
    dlse = rng.standard_normal((B, T, nh)).astype(np.float32)
    return q, k, v, dout, dlse


def _jax_flash(q, k, v, scale, causal, rate):
    """The reference's rows face: BTNH -> (B*H, T, D) rows, 16-row tiles."""
    B, T, nh, D = q.shape
    S, nkv = k.shape[1], k.shape[2]
    qt = jnp.transpose(q, (0, 2, 1, 3)).reshape(B * nh, T, D)
    kt = jnp.transpose(k, (0, 2, 1, 3)).reshape(B * nkv, S, D)
    vt = jnp.transpose(v, (0, 2, 1, 3)).reshape(B * nkv, S, D)
    out, lse = _flash_lse(qt, kt, vt, jnp.asarray(SEED), scale, 16, 16, 1,
                          True, causal, rate)
    out = jnp.transpose(out.reshape(B, nh, T, D), (0, 2, 1, 3))
    return out, jnp.transpose(lse.reshape(B, nh, T), (0, 2, 1))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_matches_reference_kernel(causal, nh, nkv, rate):
    B, T, D = 2, 32, 16
    scale = D ** -0.5
    q, k, v, dout, dlse = _inputs(B, T, nh, nkv, D, seed=nh + nkv)
    (ref_o, ref_l), vjp = jax.vjp(
        lambda a, b, c: _jax_flash(a, b, c, scale, causal, rate),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_g = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    fa.reset_counts()
    out, lse = fa.flash_attention_lse(tq, tk, tv, scale=scale, causal=causal,
                                      dropout_rate=rate,
                                      seed=torch.from_numpy(SEED))
    grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                (torch.from_numpy(dout),
                                 torch.from_numpy(dlse)))
    assert fa.PLAIN_CALLS == {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 1,
                              "flash_attn_bwd_dkv": 1}
    assert fa.LAUNCHES == {k: 0 for k in fa.LAUNCHES}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_o),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(ref_l),
                               atol=ATOL, rtol=0)
    for name, g, r in zip("qkv", grads, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("D", [16, 24, 32, 48, 64, 72, 80, 128, 192, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_matches_reference_kernel_at_head_size(causal, D):
    """Head sizes the configurations reach against the reference's
    `_flash_lse` in interpret mode: 16 and 24 (heads under 32, which the
    bf16 kernels run on their masked width-32 instances), 32 (the
    default LLMConfig, 256 / 8 heads), 48 (MLA on it, 32 + 16), 64, 72
    (MLA with a rope head of 8 on 64-wide heads), 80 (`--attn mla` on the
    124M flagship, 64 + 16), 128, 192 (the flagship with the launcher's
    rope head, 64 + 128) and 256 (the launcher's MLA, 128 + 128); in bf16
    the kernels run 16-32 at their built width 32, 48 at 64, and 72 at 80
    (masked). GQA
    (rep 2) with dropout 0.2, T 32 (the reference's 16-row tiles): out,
    lse and dq/dk/dv through `jax.vjp` with a nonzero dlse, fp32, atol
    1e-5."""
    B, T, nh, nkv, rate = 1, 32, 4, 2, 0.2
    scale = D ** -0.5
    q, k, v, dout, dlse = _inputs(B, T, nh, nkv, D, seed=D)
    (ref_o, ref_l), vjp = jax.vjp(
        lambda a, b, c: _jax_flash(a, b, c, scale, causal, rate),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_g = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = fa.flash_attention_lse(tq, tk, tv, scale=scale, causal=causal,
                                      dropout_rate=rate,
                                      seed=torch.from_numpy(SEED))
    grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                (torch.from_numpy(dout),
                                 torch.from_numpy(dlse)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_o),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(ref_l),
                               atol=ATOL, rtol=0)
    for name, g, r in zip("qkv", grads, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0, err_msg=f"d{name}")


def test_gate_takes_head_size_256_and_no_other_mla_size():
    """The kernels' gate takes every head size that is a multiple of 8
    from 8 to 256 (the launcher's MLA, 128 + 128, is the widest), each at
    the least width its kernel is built at in its dtype that holds it
    (`padded_width`; bf16: 8-32 at 32 and 72 and 80 at 80 for all three
    kernels, 136-192 at 192 for the
    dq and at 256 for the forward and dkv; fp32: 8-64 at 64, 72 and 80 at
    128, 136-192 at 256; 88 at 128 everywhere), and refuses MLA
    sizes past it or off the 8-element grid (36 = 20 + 16; 260, 264 = 136
    + 128), which the reference's gate may take; on the card the wrappers
    raise on them (tests/test_torch_cuda_kernels.py)."""
    bf16, fp32 = torch.bfloat16, torch.float32
    for D in range(1, 300):
        z = torch.zeros(1, 8, 4, D)
        ok = D % 8 == 0 and 8 <= D <= 256
        assert fa.flash_attention_usable(z, z, z) is ok, D
        assert fa.head_size_ok(D) is ok, D
        for kernel in fa.WIDTHS:
            if ok:
                assert fa.padded_width(D, kernel, bf16) == (
                    32 if D <= 32 else
                    64 if D <= 64 else 80 if D <= 80 else
                    128 if D <= 128 else
                    192 if D <= 192 and kernel == "flash_attn_bwd_dq"
                    else 256), (D, kernel)
                assert fa.padded_width(D, kernel, fp32) == (
                    64 if D <= 64 else 128 if D <= 128 else 256), (D, kernel)
            else:
                with pytest.raises(ValueError, match="multiples of 8"):
                    fa.padded_width(D, kernel, bf16)
    assert fa.WIDTHS == {
        "flash_attn_fwd": {fp32: (64, 128, 256),
                           bf16: (32, 64, 80, 128, 256)},
        "flash_attn_bwd_dq": {fp32: (64, 128, 256),
                              bf16: (32, 64, 80, 128, 192, 256)},
        "flash_attn_bwd_dkv": {fp32: (64, 128, 256),
                               bf16: (32, 64, 80, 128, 256)}}
    assert fa.MAX_HEAD_SIZE == 256
    for kernel in fa.WIDTHS:
        assert fa.padded_width(72, kernel, bf16) == \
            fa.padded_width(80, kernel, bf16) == 80
        assert fa.padded_width(80, kernel, fp32) == 128
        assert fa.padded_width(88, kernel, bf16) == 128
    for D in (36, 260, 264):
        z = torch.zeros(1, 8, 4, D)
        assert not fa.flash_attention_usable(z, z, z), D


@pytest.mark.parametrize("d,kernel,dtype,width", [
    (d, kernel, torch.bfloat16, 32) for d in (8, 16, 24, 32)
    for kernel in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")] + [
    (40, "flash_attn_bwd_dq", torch.bfloat16, 64),
    (40, "flash_attn_bwd_dkv", torch.bfloat16, 64),
    (32, "flash_attn_fwd", torch.bfloat16, 32),
    (8, "flash_attn_fwd", torch.bfloat16, 32),
    (40, "flash_attn_fwd", torch.bfloat16, 64)] + [
    (d, kernel, torch.float32, 64) for d in (8, 32)
    for kernel in ("flash_attn_fwd", "flash_attn_bwd_dq",
                   "flash_attn_bwd_dkv")])
def test_padded_width_of_small_heads(d, kernel, dtype, width):
    """Head sizes 8-32 (the default config's 32 and the heads under it)
    run the bf16 forward, dq and dkv at their width-32 instances; 40 stays
    at 64, as does every fp32 kernel."""
    assert fa.padded_width(d, kernel, dtype) == width


# the C entry of each flash kernel and its source
ENTRY_SOURCE = {"flash_attn_fwd": "flash_attn_fwd.cu",
                "flash_attn_bwd_dq": "flash_attn_bwd.cu",
                "flash_attn_bwd_dkv": "flash_attn_bwd.cu"}


@pytest.mark.parametrize("kernel", sorted(ENTRY_SOURCE))
def test_widths_table_is_what_the_c_entry_dispatches(kernel):
    """`WIDTHS` and the C entry, read from its source, name the same
    (dtype, width) pairs, and the entry runs each width D on the two
    instances built at D (full for d == D, masked for d < D), never on a
    wider one, and refuses every other width."""
    import re
    from pathlib import Path
    src = (Path(fa.__file__).resolve().parent.parent / "csrc"
           / ENTRY_SOURCE[kernel]).read_text()
    start = src.index(f'extern "C" int {kernel}(')
    body = src[start:src.index("\n}\n", start)]
    cases = re.findall(r"if \(dtype == (\d) && D == (\d+)\) return (.*?);",
                       body, re.S)
    assert cases and body.count("return") == len(cases) + 2, body
    assert body.rstrip().endswith("return (int)cudaErrorInvalidValue;")
    for dtype, D, call in cases:
        inst = re.findall(r"<(?:float, )?(\d+), (true|false)>\(p, stream\)",
                          call)
        assert call.startswith("full ? ") and inst == [
            (D, "false"), (D, "true")], (dtype, D, call)
    code = {0: torch.float32, 1: torch.bfloat16}
    got = {}
    for dtype, D, _ in cases:
        got.setdefault(code[int(dtype)], []).append(int(D))
    assert {k: tuple(v) for k, v in got.items()} == fa.WIDTHS[kernel]


def test_dropout_bits_match_mix_bits():
    """Bit for bit on a grid that covers uint32 wrap-around, with seeds of
    both signs."""
    row = np.arange(0, 2 ** 32, 2 ** 32 // 7, dtype=np.uint64)[:, None, None]
    qp = np.array([0, 1, 31, 1023, 65535, 2 ** 31 + 5])[None, :, None]
    kp = np.arange(0, 4096, 511)[None, None, :]
    for s0, s1 in [(0, 0), (123456789, -987654321), (-1, 2 ** 31 - 1)]:
        ref = np.asarray(_mix_bits(
            np.int32(s0), np.int32(s1),
            *np.broadcast_arrays(row.astype(np.uint32),
                                 qp.astype(np.uint32),
                                 kp.astype(np.uint32))))
        got = fa.dropout_bits(s0, s1, torch.from_numpy(row.astype(np.int64)),
                              torch.from_numpy(qp), torch.from_numpy(kp))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
    assert fa.dropout_threshold(0.2) == min(int(0.2 * 2.0 ** 32),
                                            2 ** 32 - 1)


def test_sdpa_routes():
    """Uncached T > 1 at a static offset 0 takes the flash wrappers (their
    plain versions on the CPU); 'naive' takes the einsum path with the
    same dropout mask; 'xla' raises NotImplementedError, and 'ring',
    'zigzag' and 'ulysses' on a full causal call with no live 'seq' axis
    raise ValueError, as the reference's do."""
    q, k, v, _, _ = _inputs(1, 24, 4, 2, 16, seed=3)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    seed = torch.from_numpy(SEED)
    fa.reset_counts()
    flash = sdpa(q, k, v, dropout_rate=0.3, dropout_seed=seed)
    assert fa.PLAIN_CALLS["flash_attn_fwd"] == 1
    naive = sdpa(q, k, v, dropout_rate=0.3, dropout_seed=seed, impl="naive")
    assert fa.PLAIN_CALLS["flash_attn_fwd"] == 1
    torch.testing.assert_close(flash, naive, atol=ATOL, rtol=0)
    sdpa(q, k, v, q_offset=torch.tensor(0))         # traced offset: naive
    assert fa.PLAIN_CALLS["flash_attn_fwd"] == 1
    with pytest.raises(NotImplementedError, match="XLA"):
        sdpa(q, k, v, impl="xla")
    for impl in ("ring", "zigzag", "ulysses"):
        with pytest.raises(ValueError, match="no live 'seq' axis"):
            sdpa(q, k, v, impl=impl)
    for impl in ("auto", "naive"):      # dropout never drops out quietly
        with pytest.raises(ValueError, match="dropout_seed"):
            sdpa(q, k, v, dropout_rate=0.3, impl=impl)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """A non-CPU tensor never takes the plain version: off the card the
    wrappers raise, and the usable gate names the kernels' limits."""
    q = torch.zeros(1, 8, 2, 64, device="meta")
    stat = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        fa.flash_attn_fwd(q, q, q, scale=0.125)
    for fn in (fa.flash_attn_bwd_dq, fa.flash_attn_bwd_dkv):
        with pytest.raises(ValueError):
            fn(q, q, q, q, stat, stat, scale=0.125)
    z = torch.zeros(1, 8, 2, 36)
    assert not fa.flash_attention_usable(z, z, z)
    assert fa.flash_attention_usable(torch.zeros(1, 8, 4, 64),
                                     torch.zeros(1, 8, 2, 64),
                                     torch.zeros(1, 8, 2, 64))
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention_lse(z, z, z, scale=1.0, dropout_rate=0.1)


def test_kernel_operands_are_16_byte_aligned():
    """What the wrappers hand the kernels: a q/k/v view is read in place
    through its (batch, time) strides when its base and strides are
    16-byte aligned (the fused qkv view), else as an aligned contiguous
    copy, also when the view is contiguous but starts off a 16-byte
    boundary; lse and delta likewise (the bf16 dkv kernel reads them
    through TMA)."""
    B, T, nh, D = 2, 10, 4, 64
    qkv = torch.zeros(B, T, 3 * nh * D)
    q = qkv[..., :nh * D].reshape(B, T, nh, D)
    assert fa._strided(q).data_ptr() == q.data_ptr()
    flat = torch.arange(B * T * nh * D + 1, dtype=torch.float32)
    odd = flat[1:].reshape(B, T, nh, D)          # contiguous, 4 bytes off
    assert odd.is_contiguous() and odd.data_ptr() % 16 == 4
    got = fa._strided(odd)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, odd)
    stat = torch.arange(B * nh * T, dtype=torch.float32).reshape(B, nh, T)
    assert fa._aligned(stat).data_ptr() == stat.data_ptr()
    for x in (flat[1:B * nh * T + 1].reshape(B, nh, T),
              stat.transpose(1, 2).contiguous().transpose(1, 2)):
        got = fa._aligned(x)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, x)
