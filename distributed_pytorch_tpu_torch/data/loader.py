"""Memmap token loader.

Counterpart of the reference package's `data/loader.py`
(`make_synthetic_bin`, `DataLoader`; loader.py:28-110) with its numpy
backend: np.memmap of a raw uint16 token file; every batch is B
uniform-random start offsets drawn from a counter-based stream keyed on
(seed, step, accum slot, row) (`data/native.philox_offsets`), and y is x
shifted by one. The stream is the reference's, so both packages see the
same batches for the same (seed, step), and a resumed run continues the
exact stream. `next_batch` returns the whole optimizer step, (A, B, T)
int64 tensors on the loader's device.

Under a data-parallel recipe rank r of W takes exactly the rows of the
reference's global batch that its data shard gets (the reference's
loader.py:101-131 under `batch_pspec`): B is per rank, the global
micro-batch is B x W, and micro-step a's rows are a*B*W + r*B + (0..B-1); the model and expert
ranks of data rank r take r's rows too. Under a 'pipe' axis whose
micro-steps run M pipeline microbatches, rank r's m-th microbatch of B / M
rows is its share of the reference's m-th, rows [m B W / M, (m + 1) B W /
M) of the global micro-batch (`data_rows`), so the data ranks' m-th
microbatches together are the reference's (an MoE's routing statistics
are a microbatch's). Under a 'seq' axis of sp
ranks (sequence parallelism) seq rank s of data rank r takes r's rows and
its T / sp positions of each (ops/ring_attention.py `local_positions`:
[s T/sp, (s+1) T/sp) in the contiguous layout, stripes s and 2 sp - 1 - s
of length T / (2 sp) in the zig-zag one), x and y cut from the same whole
row, so the targets' shift is the reference's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from distributed_pytorch_tpu_torch.data.native import philox_offsets


def make_synthetic_bin(path: str, n_tokens: int = 2 ** 20,
                       vocab_size: int = 50304, seed: int = 1729) -> str:
    """Write a synthetic uint16 token file with mild Markov structure (so
    loss can decrease): a noisy ramp next ~ prev + small step (mod
    min(vocab, 1024)), with 5% uniform-noise resets. Written to a temp
    file and renamed, so a reader never sees a torn file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rng = np.random.default_rng(seed)
    eff_vocab = min(vocab_size, 1024)
    walk = np.cumsum(rng.integers(-3, 4, size=n_tokens)) % eff_vocab
    noise = rng.integers(0, eff_vocab, size=n_tokens)
    toks = np.where(rng.random(n_tokens) < 0.05, noise, walk)
    tmp = f"{path}.tmp.{os.getpid()}"
    toks.astype(np.uint16).tofile(tmp)
    os.replace(tmp, path)
    return path


def data_rows(B: int, W: int, rank: int, microbatches: int = 1
              ) -> np.ndarray:
    """Data rank `rank`'s B rows of a global micro-batch of B W rows, in
    the order it runs them: r B .. r B + B - 1, or under `microbatches` M
    its B / M rows of each of the M global microbatches of B W / M."""
    b = B // microbatches
    i = np.arange(B)
    return i // b * b * W + rank * b + i % b


class DataLoader:
    """Random-offset batch sampler over a uint16 token memmap."""

    def __init__(self, file_path: str, batch_size: int, block_size: int, *,
                 grad_accum: int = 1, seed: int = 1729, device=None,
                 rank: int = 0, world: int = 1, seq_rank: int = 0,
                 sp: int = 1, layout: str = "contiguous",
                 microbatches: int = 1):
        self.tokens = np.memmap(file_path, dtype=np.uint16, mode="r")
        assert len(self.tokens) > block_size + 1, (
            f"dataset {file_path} too small: {len(self.tokens)} tokens "
            f"<= block_size+1")
        self.B, self.T, self.A = batch_size, block_size, grad_accum
        self.seed = seed
        self.step = 0
        self.device = device
        assert 0 <= rank < world, f"rank {rank} outside a world of {world}"
        self.rank, self.world = rank, world
        self.microbatches = microbatches
        self.cols = None
        if sp > 1:
            from distributed_pytorch_tpu_torch.ops.ring_attention import \
                local_positions
            assert block_size % sp == 0, (
                f"sp={sp} does not divide block_size {block_size}")
            self.cols = local_positions(block_size, sp, seq_rank, layout)

    def _sample(self, step: int, rows: np.ndarray):
        """(len(rows), T) x/y int32 pairs for global batch-row ids `rows`
        at `step`."""
        hi = len(self.tokens) - self.T - 1
        offsets = philox_offsets(self.seed, step, rows, hi)
        idx = offsets[:, None] + np.arange(self.T + 1)[None, :]
        seqs = self.tokens[idx].astype(np.int32)
        return seqs[:, :-1], seqs[:, 1:]

    def rows(self) -> np.ndarray:
        """This rank's global batch-row ids, micro-step by micro-step."""
        B, W = self.B, self.world
        return (np.arange(self.A)[:, None] * B * W
                + data_rows(B, W, self.rank, self.microbatches)[None, :]
                ).reshape(-1)

    def next_batch(self, step: Optional[int] = None):
        """(x, y), each (A, B, T) int64 on the loader's device: this
        rank's rows of the step's global batch (T / sp positions of each
        under a 'seq' axis)."""
        step = self.step if step is None else step
        self.step = step + 1
        x, y = self._sample(step, self.rows())
        if self.cols is not None:
            x, y = x[:, self.cols], y[:, self.cols]
        shp = (self.A, self.B, x.shape[1])
        return (torch.from_numpy(x.reshape(shp)).long().to(self.device),
                torch.from_numpy(y.reshape(shp)).long().to(self.device))
