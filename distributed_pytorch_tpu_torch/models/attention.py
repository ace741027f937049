"""Grouped-query attention (MHA / MQA / GQA) with contiguous or paged KV
caches.

Counterpart of the reference package's `models/attention.py` `GQA`,
`init_attn_cache` and `init_paged_attn_cache`: one fused qkv projection
`c_attn` of width C + 2*n_kv_heads*head_size with a bias, split
[q | k | v] at [C, C + nkv*hs], RoPE on q and k, the attention dispatch
(ops/attention_core.py), and the `c_proj` output projection. MLA waits for
its slice.

Caches are dicts {'k', 'v'} of tensors updated IN PLACE (the reference
returns new buffers; the port saves the copy). A contiguous cache is
(B, S, nkv, hs); a paged one is an (n_blocks, bs, nkv, hs) pool addressed
through `block_tables` (ops/block_pool.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.ops.attention_core import sdpa
from distributed_pytorch_tpu_torch.ops.block_pool import paged_update
from distributed_pytorch_tpu_torch.ops.rope import apply_rotary_emb, slice_rows

Cache = dict


def _update_cache(cache_arr: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write `new` (B, T, ...) into the (B, S, ...) buffer at [:, pos:pos+T]
    in place. An int `pos` (prefill) writes at that offset; a tensor `pos`
    (0-d or per-sequence (B,)) writes modulo S — the cache is a RING once
    the window fills. Starts clamp so the write stays inside the buffer,
    as the reference's dynamic update slice does."""
    new = new.to(cache_arr.dtype)
    B, T = new.shape[:2]
    S = cache_arr.shape[1]
    if isinstance(pos, int):
        start = min(max(pos, 0), S - T)
        cache_arr[:, start:start + T] = new
        return
    pos = torch.as_tensor(pos, device=cache_arr.device).long()
    start = (pos % S).clamp(max=S - T)
    rows = start.reshape(-1, 1) + torch.arange(T, device=cache_arr.device)
    rows = rows.expand(B, T)
    cache_arr[torch.arange(B, device=cache_arr.device)[:, None], rows] = new


class GQA(nn.Module):
    """Grouped-query attention; n_kv_heads == n_head gives MHA, == 1 MQA."""

    def __init__(self, config: LLMConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        C, nkv, hs = config.n_embd, config.n_kv_heads, config.head_size
        self.c_attn = nn.Linear(C, C + 2 * nkv * hs, bias=True,
                                device=device, dtype=dtype)
        self.c_proj = nn.Linear(C, C, bias=True, device=device, dtype=dtype)

    def forward(self, x, freqs, cache: Optional[Cache] = None, pos=0, *,
                block_tables=None):
        cfg = self.config
        B, T, C = x.shape
        nh, nkv, hs = cfg.n_head, cfg.n_kv_heads, cfg.head_size
        q, k, v = self.c_attn(x).split([C, nkv * hs, nkv * hs], dim=-1)
        q = q.reshape(B, T, nh, hs)
        k = k.reshape(B, T, nkv, hs)
        v = v.reshape(B, T, nkv, hs)

        if cfg.pos_emb == "rope":
            f = slice_rows(freqs, pos, T)
            q = apply_rotary_emb(q, f)
            k = apply_rotary_emb(k, f)

        q_offset = 0
        if cache is not None:
            if block_tables is not None:
                paged_update(cache["k"], k, pos, block_tables)
                paged_update(cache["v"], v, pos, block_tables)
                k, v = cache["k"], cache["v"]
            else:
                _update_cache(cache["k"], k, pos)
                _update_cache(cache["v"], v, pos)
                k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
            q_offset = pos

        y = sdpa(q, k, v, q_offset=q_offset, decode=cache is not None,
                 block_tables=block_tables)
        return self.c_proj(y.reshape(B, T, C))


def _check_family(config: LLMConfig) -> None:
    if config.attn not in ("mha", "mqa", "gqa"):
        raise NotImplementedError(
            f"attn={config.attn!r}: the port runs the mha/mqa/gqa family; "
            "MLA comes with a later slice")


def init_attn_cache(config: LLMConfig, batch_size: int, max_len: int,
                    dtype=torch.float32, device=None) -> Cache:
    """Per-layer contiguous (B, S, nkv, hs) KV buffers."""
    _check_family(config)
    shape = (batch_size, max_len, config.n_kv_heads, config.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_attn_cache(config: LLMConfig, n_blocks: int, block_size: int,
                          dtype=torch.float32, device=None) -> Cache:
    """Per-layer paged KV POOL buffers (n_blocks, block_size, nkv, hs).
    Block 0 is the null block (ops/block_pool.py)."""
    _check_family(config)
    shape = (n_blocks, block_size, config.n_kv_heads, config.head_size)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
