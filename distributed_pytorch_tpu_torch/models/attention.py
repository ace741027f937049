"""Grouped-query attention (MHA / MQA / GQA) with contiguous or paged KV
caches.

Counterpart of the reference package's `models/attention.py` `GQA`,
`init_attn_cache` and `init_paged_attn_cache`: one fused qkv projection
`c_attn` of width C + 2*n_kv_heads*head_size with a bias, split
[q | k | v] at [C, C + nkv*hs], RoPE on q and k, the attention dispatch
(ops/attention_core.py), the `c_proj` output projection and residual
dropout after it. MLA waits for its slice.

Weights may be held in fp32 while the activations run in bf16 (the
training model's fp32 masters): each projection casts its weight and bias
to the activations' dtype at use, as flax's Dense with `param_dtype=float32,
dtype=bfloat16` does. In training mode (`nn.Module.train()`) with
`config.dropout > 0`, attention-weight dropout runs inside the attention
kernels and residual dropout after `c_proj`, both keyed on `dropout_seed`
(ops/dropout.py).

Caches are dicts {'k', 'v'} of tensors updated IN PLACE (the reference
returns new buffers; the port saves the copy). A contiguous cache is
(B, S, nkv, hs); a paged one is an (n_blocks, bs, nkv, hs) pool addressed
through `block_tables` (ops/block_pool.py). An int8 cache adds fp32
'k_scale'/'v_scale' of the same leading shape with a last dim of 1: each
write quantizes its rows (ops/quant.py `quantize_kv`) and lands codes and
scales through the same row writes.

Under an active quantized-weight store (the engine's decode forwards,
ops/quant.py) `c_attn` and `c_proj` read int8 codes; the store knows them
by the name `LLM` gives each module (`qname`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.ops.attention_core import sdpa
from distributed_pytorch_tpu_torch.ops.block_pool import paged_update
from distributed_pytorch_tpu_torch.ops.dropout import (dropout, seed_pair,
                                                      subseed)
from distributed_pytorch_tpu_torch.ops.quant import (maybe_quantized_matmul,
                                                    quantize_kv)
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

    def __init__(self, config: LLMConfig, *, device=None, dtype=None,
                 attn_impl: str = "auto"):
        super().__init__()
        self.config = config
        self.attn_impl = attn_impl
        C, nkv, hs = config.n_embd, config.n_kv_heads, config.head_size
        self.c_attn = nn.Linear(C, C + 2 * nkv * hs, bias=True,
                                device=device, dtype=dtype)
        self.c_proj = nn.Linear(C, C, bias=True, device=device, dtype=dtype)

    def forward(self, x, freqs, cache: Optional[Cache] = None, pos=0, *,
                block_tables=None, dropout_seed: Optional[int] = None):
        """`dropout_seed` keys this layer's dropout masks in training
        mode (ops/dropout.py); unused otherwise."""
        cfg = self.config
        B, T, C = x.shape
        nh, nkv, hs = cfg.n_head, cfg.n_kv_heads, cfg.head_size
        qkv = _linear(x, self.c_attn)
        q, k, v = qkv.split([C, nkv * hs, nkv * hs], dim=-1)
        q = q.reshape(B, T, nh, hs)
        k = k.reshape(B, T, nkv, hs)
        v = v.reshape(B, T, nkv, hs)

        if cfg.pos_emb == "rope":
            f = slice_rows(freqs, pos, T)
            q = apply_rotary_emb(q, f)
            k = apply_rotary_emb(k, f)

        q_offset = 0
        scales = {}
        if cache is not None:
            new = {"k": k, "v": v}
            if "k_scale" in cache:
                # int8 cache: quantize on the write
                (new["k"], new["k_scale"]), (new["v"], new["v_scale"]) = \
                    quantize_kv(k), quantize_kv(v)
            for name, rows in new.items():
                if block_tables is not None:
                    paged_update(cache[name], rows, pos, block_tables)
                else:
                    _update_cache(cache[name], rows, pos)
            k, v = cache["k"], cache["v"]
            if "k_scale" in cache:
                scales = {"k_scale": cache["k_scale"],
                          "v_scale": cache["v_scale"]}
            elif block_tables is None:
                k, v = k.to(q.dtype), v.to(q.dtype)
            q_offset = pos

        drop = self.training and cfg.dropout > 0.0
        y = sdpa(q, k, v, q_offset=q_offset, decode=cache is not None,
                 block_tables=block_tables, impl=self.attn_impl,
                 dropout_rate=cfg.dropout if drop else 0.0,
                 dropout_seed=seed_pair(subseed(dropout_seed, 0), x.device)
                 if drop else None, **scales)
        y = _linear(y.reshape(B, T, C), self.c_proj)
        if drop:
            y = dropout(y, cfg.dropout, subseed(dropout_seed, 1))
        return y


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """`lin(x)` with the weight and bias cast to x's dtype at use; from
    the active quantized store's codes when it holds this weight."""
    name = getattr(lin, "qname", None)
    y = maybe_quantized_matmul(x, name and name + ".weight",
                               transpose_b=True)
    if y is not None:
        return y + lin.bias.to(x.dtype)
    return torch.nn.functional.linear(x, lin.weight.to(x.dtype),
                                      lin.bias.to(x.dtype))


def _check_family(config: LLMConfig) -> None:
    if config.attn not in ("mha", "mqa", "gqa"):
        raise NotImplementedError(
            f"attn={config.attn!r}: the port runs the mha/mqa/gqa family; "
            "MLA comes with a later slice")


def _kv_buffers(config: LLMConfig, rows: tuple, dtype, device) -> Cache:
    """k/v buffers of shape rows + (nkv, hs); for `torch.int8`, int8 code
    buffers and fp32 'k_scale'/'v_scale' of shape rows + (nkv, 1)."""
    _check_family(config)
    shape = rows + (config.n_kv_heads, config.head_size)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sc = rows + (config.n_kv_heads, 1)
        cache["k_scale"] = torch.zeros(sc, dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(sc, dtype=torch.float32,
                                       device=device)
    return cache


def init_attn_cache(config: LLMConfig, batch_size: int, max_len: int,
                    dtype=torch.float32, device=None) -> Cache:
    """Per-layer contiguous (B, S, nkv, hs) KV buffers (int8 with scale
    sidecars for `dtype=torch.int8`)."""
    return _kv_buffers(config, (batch_size, max_len), dtype, device)


def init_paged_attn_cache(config: LLMConfig, n_blocks: int, block_size: int,
                          dtype=torch.float32, device=None) -> Cache:
    """Per-layer paged KV POOL buffers (n_blocks, block_size, nkv, hs)
    (int8 with scale sidecars for `dtype=torch.int8`). Block 0 is the null
    block (ops/block_pool.py)."""
    return _kv_buffers(config, (n_blocks, block_size), dtype, device)
