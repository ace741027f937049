"""Dropout seeds and element dropout for training.

The reference draws each dropout site's mask from a `jax.random` key split
off the step key. The port keys every mask on an explicit integer seed
instead: the train step derives one per micro-batch from (seed, step,
micro) (`subseed`), and the model derives one per site from that. A site
builds its mask from its own seed alone, so a region recomputed under
`torch.utils.checkpoint` regenerates the mask it drew the first time.
`torch.Generator` streams differ from `jax.random`, so the packages agree
on dropout masks only where both use the attention kernels' counter hash
(`ops/flash_attention.dropout_bits`).

Under a published 'seq' axis (sequence parallelism) a site's `x` holds
this rank's T / sp positions of each row along dim 1: the mask is drawn
over the whole rows and taken at this rank's positions
(ops/ring_attention.py `seq_positions`), so the seq ranks together draw
the one mask a process holding the whole rows draws. No seed depends on
a rank, so the model and expert ranks of one data rank, which hold the
same rows, draw the same masks.
"""

from __future__ import annotations

import torch

from distributed_pytorch_tpu_torch.ops.ring_attention import seq_positions
from distributed_pytorch_tpu_torch.parallel import context

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def subseed(seed: int, *ids: int) -> int:
    """A 63-bit seed derived from `seed` and the integers `ids`."""
    x = _splitmix64(seed & _M64)
    for i in ids:
        x = _splitmix64(x ^ _splitmix64(i & _M64))
    return x & ((1 << 63) - 1)


def seed_pair(seed: int, device=None) -> torch.Tensor:
    """A (2,) int32 attention-dropout seed from a 63-bit seed."""
    lo, hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    return torch.tensor([lo - (1 << 32) if lo >= 1 << 31 else lo,
                         hi - (1 << 32) if hi >= 1 << 31 else hi],
                        dtype=torch.int32, device=device)


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout of `x` with a mask drawn from `seed`: kept
    elements are scaled by 1 / (1 - rate), as flax's nn.Dropout does."""
    if rate <= 0.0:
        return x
    rows = seq_positions(x.shape[1], x.device) if x.dim() > 1 else None
    shape = x.shape if rows is None else \
        (x.shape[0], x.shape[1] * context.seq_size(), *x.shape[2:])
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    keep = torch.rand(shape, generator=g, device=x.device)
    keep = (keep if rows is None else keep[:, rows]) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
