"""Rotary position embeddings (RoPE).

Counterpart of the reference package's `ops/rope.py`: theta base 10000,
pairs taken ADJACENTLY along the head dim (x[..., 2i], x[..., 2i+1]) —
not the rotate-half split — from a precomputed real (cos, sin) table,
rotated in fp32 and cast back to the input dtype.
"""

from __future__ import annotations

import torch


def precompute_rope_freqs(dim: int, max_seq_len: int, base: float = 10000.0,
                          device=None) -> torch.Tensor:
    """Return a (max_seq_len, dim//2, 2) fp32 table of (cos, sin) angles:
    theta_i = base^(-2i/dim), angle[t, i] = t * theta_i."""
    assert dim % 2 == 0, "head dimension must be even"
    theta = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))
    seq = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(seq, theta)                     # (T, dim//2)
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def slice_rows(table: torch.Tensor, pos, length: int) -> torch.Tensor:
    """table[pos : pos+length] along axis 0 for an int `pos`, a 0-d
    tensor, or a per-sequence (B,) tensor (then with a leading batch axis,
    (B, length, ...)). Starts clamp so the slice stays inside the table —
    the reference's dynamic-slice semantics."""
    n = table.shape[0]
    if isinstance(pos, int):
        start = min(max(pos, 0), n - length)
        return table[start:start + length]
    pos = torch.as_tensor(pos, device=table.device).long()
    start = pos.clamp(0, n - length)
    idx = start.unsqueeze(-1) + torch.arange(length, device=table.device)
    return table[idx]


def apply_rotary_emb(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., 2i], x[..., 2i+1]) by the angles in `freqs`.

    x: (B, T, H, hs); freqs: a shared (T, hs//2, 2) slice of the table or a
    per-sequence (B, T, hs//2, 2) one. Computed in fp32, cast back."""
    B, T, H, hs = x.shape
    xf = x.float().reshape(B, T, H, hs // 2, 2)
    x_re, x_im = xf[..., 0], xf[..., 1]
    if freqs.dim() == 4:                        # per-sequence rows
        cos = freqs[:, :, None, :, 0]            # (B, T, 1, hs//2)
        sin = freqs[:, :, None, :, 1]
    else:
        cos = freqs[None, :, None, :, 0]         # (1, T, 1, hs//2)
        sin = freqs[None, :, None, :, 1]
    out_re = x_re * cos - x_im * sin
    out_im = x_re * sin + x_im * cos
    return torch.stack([out_re, out_im], dim=-1).reshape(B, T, H, hs) \
        .to(x.dtype)
