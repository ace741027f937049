"""The port's small ops against the reference package's on the same numpy
inputs: paged_update / paged_gather (including the null-block routing of
an off-table write), RoPE tables, row slicing and rotation, and the MLP
with its activations. fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.models import mlp as jmlp
from distributed_pytorch_tpu.ops import block_pool as jbp
from distributed_pytorch_tpu.ops import rope as jrope
from distributed_pytorch_tpu_torch.models import mlp as tmlp
from distributed_pytorch_tpu_torch.ops import block_pool as tbp
from distributed_pytorch_tpu_torch.ops import rope as trope


def _rng(seed):
    return np.random.default_rng(seed)


def test_paged_update_decode_rows_and_null_routing():
    """T == 1 writes at per-sequence positions through the table; a row
    whose logical block falls past the table lands in the null block."""
    rng = _rng(0)
    pool = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    bt = np.array([[3, 5], [7, 1], [0, 0]], np.int32)
    new = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    pos = np.array([5, 2, 8], np.int32)          # slot 2 is off the table
    ref = np.asarray(jbp.paged_update(jnp.asarray(pool), jnp.asarray(new),
                                      jnp.asarray(pos), jnp.asarray(bt)))
    out = tbp.paged_update(torch.from_numpy(pool.copy()),
                           torch.from_numpy(new), torch.from_numpy(pos),
                           torch.from_numpy(bt))
    # the reference DROPS the off-table row; the port routes it to the
    # null block, which nothing reads — compare every other block
    np.testing.assert_array_equal(out.numpy()[1:], ref[1:])
    assert not np.array_equal(out.numpy()[0], pool[0])


@pytest.mark.parametrize("pos", [0, 4, 8], ids=lambda p: f"pos{p}")
def test_paged_update_prefill_blocks(pos):
    rng = _rng(1 + pos)
    pool = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    bt = np.array([[2, 6, 4, 8]], np.int32)
    new = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    ref = jbp.paged_update(jnp.asarray(pool), jnp.asarray(new), pos,
                           jnp.asarray(bt))
    out = tbp.paged_update(torch.from_numpy(pool.copy()),
                           torch.from_numpy(new), pos, torch.from_numpy(bt))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_paged_gather():
    rng = _rng(2)
    pool = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    bt = np.array([[2, 6, 4], [8, 1, 0]], np.int32)
    ref = jbp.paged_gather(jnp.asarray(pool), jnp.asarray(bt))
    out = tbp.paged_gather(torch.from_numpy(pool), torch.from_numpy(bt))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_block_pool_host_side_matches():
    """The copied allocator and radix index hand out the same blocks and
    the same chain keys as the reference for one admission history."""
    pools = [jbp.BlockPool(6, 4), tbp.BlockPool(6, 4)]
    toks = list(range(1, 13))
    trails = []
    for bp, mod in zip(pools, (jbp, tbp)):
        a = bp.alloc_many(3)
        for key, blk in zip(mod.chain_keys(toks, 4, 3), a):
            bp.register(blk, key)
        bp.release_all(a)
        b = bp.alloc_many(4)                    # evicts cached blocks
        hit = bp.lookup(mod.chain_keys(toks, 4, 1)[0])
        trails.append((a, b, hit, bp.n_evicted, bp.n_free, bp.n_cached))
    assert trails[0] == trails[1]
    assert jbp.chain_keys(toks, 4, 3) == tbp.chain_keys(toks, 4, 3)


def test_rope_table_slices_and_rotation():
    hs, n = 16, 32
    ref_tab = np.asarray(jrope.precompute_rope_freqs(hs, n))
    tab = trope.precompute_rope_freqs(hs, n)
    np.testing.assert_allclose(tab.numpy(), ref_tab, atol=1e-6, rtol=0)
    x = _rng(3).standard_normal((3, 5, 2, hs)).astype(np.float32)
    # shared rows at an int offset, clamped near the table end, and
    # per-sequence rows from a (B,) position tensor
    for pos in (0, 7, 30):
        f_ref = jrope.slice_rows(jnp.asarray(ref_tab), jnp.int32(pos), 5)
        f = trope.slice_rows(tab, pos, 5)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=1e-6)
        np.testing.assert_allclose(
            trope.apply_rotary_emb(torch.from_numpy(x), f).numpy(),
            np.asarray(jrope.apply_rotary_emb(jnp.asarray(x), f_ref)),
            atol=1e-6, rtol=0)
    pos = np.array([0, 11, 30], np.int32)
    f_ref = jrope.slice_rows(jnp.asarray(ref_tab), jnp.asarray(pos), 5)
    f = trope.slice_rows(tab, torch.from_numpy(pos), 5)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=1e-6)
    np.testing.assert_allclose(
        trope.apply_rotary_emb(torch.from_numpy(x), f).numpy(),
        np.asarray(jrope.apply_rotary_emb(jnp.asarray(x), f_ref)),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("act", ["swiglu", "glu", "gelu", "relu", "silu",
                                 "mish", "lrelu"])
def test_mlp_apply_matches(act):
    rng = _rng(4)
    C, up = 16, 24
    fc_out = 2 * up if act in ("swiglu", "glu") else up
    x = rng.standard_normal((2, 3, C)).astype(np.float32)
    w_fc = (0.2 * rng.standard_normal((C, fc_out))).astype(np.float32)
    w_proj = (0.2 * rng.standard_normal((up, C))).astype(np.float32)
    ref = jmlp.mlp_apply(jnp.asarray(x), jnp.asarray(w_fc),
                         jnp.asarray(w_proj), act)
    out = tmlp.mlp_apply(torch.from_numpy(x), torch.from_numpy(w_fc),
                         torch.from_numpy(w_proj), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
