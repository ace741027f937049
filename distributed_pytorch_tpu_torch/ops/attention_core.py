"""Scaled dot-product attention dispatch.

Counterpart of the reference package's `ops/attention_core.py`, cut to the
serving slice's routes. Layout: q (B, T, nh, hs); k, v (B, S, nkv, hs)
("BTNH"), or (n_blocks, bs, nkv, hs) pools with `block_tables`.

* Paged cache, one query token per sequence -> `paged_flash_decode`
  (CUDA kernel `paged_decode_attn` on the card).
* Paged cache, a multi-token chunk of ONE sequence at `q_offset` (the
  bucketed wave prefill) -> `paged_flash_prefill` (`paged_prefill_attn`).
* Contiguous cache, one query token -> `flash_decode` (`paged_decode_attn`
  over the cache as a pool of B blocks of S rows).
* Everything else — uncached full-sequence attention, a contiguous-cache
  prefill, a paged multi-sequence chunk — takes `_naive_sdpa`, the
  explicit causal einsum path (the paged route first gathers the logical
  view). The reference sends these to XLA's attention, not to a Pallas
  kernel; the port keeps the naive path there until the training slice
  ports `flash_attention`. No library attention call stands in for a
  kernel.

The kernel routes are chosen by shape alone. On the card a wrapper
launches its kernel or raises on operands the kernel does not take, so a
cached call never falls quietly to the naive path; on CPU tensors the
wrappers run their plain versions, so the CPU walks the same routes.
"""

from __future__ import annotations

from typing import Optional

import torch

from distributed_pytorch_tpu_torch.ops import flash_decode as fd
from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather


def _naive_sdpa(q, k, v, *, scale, q_offset=0):
    """Reference-semantics einsum attention with a cache-offset causal
    mask: query at global position q_offset + i attends keys j <=
    q_offset + i. `q_offset` may be an int, a 0-d tensor or a
    per-sequence (B,) tensor."""
    B, T, nh, hs = q.shape
    S, nkv = k.shape[1], k.shape[2]
    if nkv != nh:
        rep = nh // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    attn = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    off = torch.as_tensor(q_offset, device=q.device).long()
    qpos = off.reshape(-1, 1, 1) \
        + torch.arange(T, device=q.device)[None, :, None]       # (B|1, T, 1)
    kpos = torch.arange(S, device=q.device)[None, None, :]
    mask = qpos >= kpos                                        # (B|1, T, S)
    attn = attn.masked_fill(~mask[:, None], float("-inf"))
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bnts,bsnh->btnh", attn.to(v.dtype), v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         scale: Optional[float] = None, q_offset=0, decode: bool = False,
         block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal scaled dot-product attention over (B, T, N, H) tensors.

    `q_offset` is the global position of q[:, 0]: an int, a 0-d tensor or
    a per-sequence (B,) tensor. `decode=True` marks a KV-cached call.
    `block_tables` (B, max_blocks) int32 marks k/v as PAGED pools
    (ops/block_pool.py)."""
    B, T, _, hs = q.shape
    scale = (1.0 / hs ** 0.5) if scale is None else scale

    if block_tables is not None:
        if decode and T == 1:
            cl = (torch.as_tensor(q_offset, device=q.device).long()
                  .reshape(-1) + 1).expand(B)
            return fd.paged_flash_decode(q[:, 0], k, v, block_tables, cl,
                                         scale=scale)[:, None]
        if decode and B == 1:
            return fd.paged_flash_prefill(q, k, v, block_tables,
                                          int(q_offset), scale=scale)
        k = paged_gather(k, block_tables).to(q.dtype)
        v = paged_gather(v, block_tables).to(q.dtype)
    elif decode and T == 1:
        # live rows per sequence: the query's position + 1, capped at the
        # buffer length (a wrapped ring cache is fully live)
        cl = (torch.as_tensor(q_offset, device=q.device).long().reshape(-1)
              + 1).clamp(max=k.shape[1]).expand(B)
        return fd.flash_decode(q[:, 0], k, v, cl, scale=scale)[:, None]

    return _naive_sdpa(q, k, v, scale=scale, q_offset=q_offset)
