"""The loader's counter-based offset stream.

A copy of `philox_offsets` from the reference package's `data/native.py`
(:60-81): Philox4x32-10 keyed on (seed, step) with the global batch-row id
as the counter, in numpy. The reference's C++ sampler (csrc/sampler.cpp)
computes the same stream on the host; the port keeps only this numpy
version, which is what its loader needs.
"""

from __future__ import annotations

import numpy as np

_M0 = np.uint64(0xD2511F53)
_M1 = np.uint64(0xCD9E8D57)
_MASK32 = np.uint64(0xFFFFFFFF)


def philox_offsets(seed: int, step: int, rows: np.ndarray,
                   hi: int) -> np.ndarray:
    """Philox4x32-10 offsets in [0, hi) for global batch-row ids `rows` at
    (seed, step)."""
    rows = np.asarray(rows, np.uint32)
    c0 = rows.astype(np.uint64)
    c1 = np.full_like(c0, np.uint64(step & 0xFFFFFFFF))
    c2 = np.full_like(c0, np.uint64((step >> 32) & 0xFFFFFFFF))
    c3 = np.zeros_like(c0)
    k0 = seed & 0xFFFFFFFF          # python ints: explicit mod-2^32 adds
    k1 = (seed >> 32) & 0xFFFFFFFF
    for _ in range(10):
        p0 = _M0 * c0          # 64-bit products (c in [0, 2^32))
        p1 = _M1 * c2
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK32
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK32
        c0, c1, c2, c3 = (hi1 ^ c1 ^ np.uint64(k0), lo1,
                          hi0 ^ c3 ^ np.uint64(k1), lo0)
        k0 = (k0 + 0x9E3779B9) & 0xFFFFFFFF
        k1 = (k1 + 0xBB67AE85) & 0xFFFFFFFF
    u = (c1 << np.uint64(32)) | c0
    return (u % np.uint64(hi)).astype(np.int64)
