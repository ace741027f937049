"""Scaled dot-product attention dispatch.

Counterpart of the reference package's `ops/attention_core.py`, cut to the
routes of the serving and training slices. Layout: q (B, T, nh, hs);
k, v (B, S, nkv, hs) ("BTNH"), or (n_blocks, bs, nkv, hs) pools with
`block_tables`.

* Paged cache, one query token per sequence -> `paged_flash_decode`
  (CUDA kernel `paged_decode_attn` on the card).
* Paged cache, a multi-token chunk of ONE sequence at `q_offset` (the
  bucketed wave prefill, a prefill chunk) -> `paged_flash_prefill`
  (`paged_prefill_attn`).
* Contiguous cache, one query token -> `flash_decode` (`paged_decode_attn`
  over the cache as a pool of B blocks of S rows).
* An int8 cache (`k_scale`/`v_scale` given: k/v hold int8 codes) takes
  the same three routes to the `_q8` kernels (`paged_decode_attn_q8`,
  `paged_prefill_attn_q8`); on every other route it is dequantized up
  front to the query's dtype, as the reference does.
* Non-paged k/v, a static `q_offset == 0` and T > 1, `impl` 'auto' or
  'pallas' -> `flash_attention` (kernels `flash_attn_fwd`, and in the
  backward `flash_attn_bwd_dq` / `flash_attn_bwd_dkv`), with in-kernel
  attention-weight dropout. This is the training forward and `generate`'s
  prompt pass over its contiguous cache (keys past the prompt are masked
  by position). The reference sends these to XLA's attention under
  'auto' at T <= 4096; the port has no XLA, and no library attention
  stands in for a kernel.
* `impl='naive'`, a cache offset (int, 0-d or per-sequence tensor) or a
  paged multi-sequence chunk -> `_naive_sdpa`, the explicit einsum path
  (the paged route first gathers the logical view), with the same
  dropout mask as the kernels.
* Under a live 'seq' axis (parallel/context.py; the trainer's sequence
  parallelism), a training-shaped call — causal, no cache, a static
  `q_offset == 0`, q and k of one length — with `impl` 'auto', 'pallas',
  'ring', 'zigzag' or 'ulysses' -> `ring_attention.sp_sdpa`: this rank's
  T / sp rows attend the whole sequence by ring, zig-zag or Ulysses
  attention on the flash kernels, whichever the world resolved once from
  the run's config with the reference's gates (attention_core.py:242-300,
  `World.seq_impl`). 'naive' there raises: it has no
  sequence-parallel form. An explicit 'ring' / 'zigzag' / 'ulysses' on a
  training-shaped call with no live 'seq' axis raises ValueError, as the
  reference's does; on any other call (decode, prefill) it means 'auto':
  cached calls never route to the 'seq' path.
* 'xla' raises NotImplementedError: the port has no XLA.

The kernel routes are chosen by shape alone. On the card a wrapper
launches its kernel or raises on operands the kernel does not take, so no
call on the card falls quietly to the naive path; on CPU tensors the
wrappers run their plain versions, so the CPU walks the same routes.
"""

from __future__ import annotations

from typing import Optional

import torch

from distributed_pytorch_tpu_torch.ops import flash_attention as fa
from distributed_pytorch_tpu_torch.ops import flash_decode as fd
from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather
from distributed_pytorch_tpu_torch.ops.quant import dequantize_int8
from distributed_pytorch_tpu_torch.parallel import context

#: impls the reference offers that the port does not run
LATER_IMPLS = {
    "xla": "the port has no XLA; use 'auto' or 'pallas' (the flash "
           "kernels) or 'naive'",
}
SP_IMPLS = ("ring", "zigzag", "ulysses")


def _naive_sdpa(q, k, v, *, scale, q_offset=0, causal=True,
                dropout_rate=0.0, dropout_seed=None, heads=(0, None)):
    """Reference-semantics einsum attention with a cache-offset causal
    mask: query at global position q_offset + i attends keys j <=
    q_offset + i. `q_offset` may be an int, a 0-d tensor or a
    per-sequence (B,) tensor. Dropout multiplies the normalized weights by
    the kernels' keep-mask (`flash_attention.keep_mask`) of `heads` =
    (head offset, total heads)."""
    B, T, nh, hs = q.shape
    S, nkv = k.shape[1], k.shape[2]
    if nkv != nh:
        rep = nh // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    attn = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    if causal:
        off = torch.as_tensor(q_offset, device=q.device).long()
        qpos = off.reshape(-1, 1, 1) \
            + torch.arange(T, device=q.device)[None, :, None]   # (B|1, T, 1)
        kpos = torch.arange(S, device=q.device)[None, None, :]
        mask = qpos >= kpos                                    # (B|1, T, S)
        attn = attn.masked_fill(~mask[:, None], float("-inf"))
    attn = torch.softmax(attn, dim=-1)
    if dropout_rate > 0.0:
        attn = attn * fa.keep_mask(dropout_seed, dropout_rate, B, nh, T, S,
                                   q.device, *heads)
    return torch.einsum("bnts,bsnh->btnh", attn.to(v.dtype), v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, scale: Optional[float] = None, q_offset=0,
         dropout_rate: float = 0.0,
         dropout_seed: Optional[torch.Tensor] = None, impl: str = "auto",
         decode: bool = False,
         block_tables: Optional[torch.Tensor] = None,
         k_scale: Optional[torch.Tensor] = None,
         v_scale: Optional[torch.Tensor] = None, head_offset: int = 0,
         total_heads: Optional[int] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, T, N, H) tensors.

    `q_offset` is the global position of q[:, 0]: an int, a 0-d tensor or
    a per-sequence (B,) tensor. `decode=True` marks a KV-cached call.
    `block_tables` (B, max_blocks) int32 marks k/v as PAGED pools
    (ops/block_pool.py). `k_scale`/`v_scale` (k's shape with a last dim of
    1, fp32) mark k/v as int8 codes (ops/quant.py). `dropout_rate` > 0
    with a (2,) int32 `dropout_seed` drops attention weights (training); a
    rate > 0 without a seed raises. Under tensor parallelism q holds heads
    `head_offset` .. of the `total_heads` of the whole layer, and the
    dropout mask is that slice of the whole layer's."""
    if impl in LATER_IMPLS:
        raise NotImplementedError(f"attn_impl={impl!r}: {LATER_IMPLS[impl]}")
    if impl not in ("auto", "pallas", "naive") + SP_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected "
                         "'auto' | 'pallas' | 'naive' | 'ring' | 'zigzag' | "
                         "'ulysses'")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a (2,) int32 dropout_seed")
    B, T, _, hs = q.shape
    scale = (1.0 / hs ** 0.5) if scale is None else scale
    kv_scales = dict(k_scale=k_scale, v_scale=v_scale)

    training_like = (causal and not decode and block_tables is None
                     and k_scale is None and T > 1 and k.shape[1] == T
                     and isinstance(q_offset, int) and q_offset == 0)
    sp_live = context.seq_size() > 1 and not context.in_sp_region()
    if training_like and sp_live:
        if impl == "naive":
            raise ValueError("attn_impl='naive' under a 'seq' axis: the naive "
                             "path has no sequence-parallel form; use "
                             "'auto', 'pallas', 'ring', 'zigzag' or "
                             "'ulysses'")
        from distributed_pytorch_tpu_torch.ops.ring_attention import sp_sdpa
        return sp_sdpa(q, k, v, scale=scale, dropout_rate=dropout_rate,
                       dropout_seed=dropout_seed)
    if impl in SP_IMPLS:
        if training_like and not context.in_sp_region():
            raise ValueError(
                f"attn_impl={impl!r} on a full causal sequence with no live "
                "'seq' axis: publish a world with sp_size > 1 "
                "(parallel/context.py, as the trainer does under "
                "--sp_size) or use 'auto'; a silent fallback would lose "
                "sequence parallelism without a signal")
        impl = "auto"

    if block_tables is not None:
        if decode and T == 1:
            cl = (torch.as_tensor(q_offset, device=q.device).long()
                  .reshape(-1) + 1).expand(B)
            return fd.paged_flash_decode(q[:, 0], k, v, block_tables, cl,
                                         scale=scale, **kv_scales)[:, None]
        if decode and B == 1:
            return fd.paged_flash_prefill(q, k, v, block_tables,
                                          int(q_offset), scale=scale,
                                          **kv_scales)
        k = paged_gather(k, block_tables)
        v = paged_gather(v, block_tables)
        if k_scale is not None:
            k_scale = paged_gather(k_scale, block_tables)
            v_scale = paged_gather(v_scale, block_tables)
        else:
            k, v = k.to(q.dtype), v.to(q.dtype)
    elif decode and T == 1:
        # live rows per sequence: the query's position + 1, capped at the
        # buffer length (a wrapped ring cache is fully live)
        cl = (torch.as_tensor(q_offset, device=q.device).long().reshape(-1)
              + 1).clamp(max=k.shape[1]).expand(B)
        return fd.flash_decode(q[:, 0], k, v, cl, scale=scale,
                               **kv_scales)[:, None]
    if k_scale is not None:
        # int8 cache off the kernel routes (a contiguous prefill, a paged
        # multi-sequence chunk): dequantize up front
        k = dequantize_int8(k, k_scale, q.dtype)
        v = dequantize_int8(v, v_scale, q.dtype)

    if (block_tables is None and impl != "naive" and T > 1
            and isinstance(q_offset, int) and q_offset == 0):
        return fa.flash_attention(q, k, v, scale=scale, causal=causal,
                                  dropout_rate=dropout_rate,
                                  seed=dropout_seed, head_offset=head_offset,
                                  total_heads=total_heads)

    return _naive_sdpa(q, k, v, scale=scale, q_offset=q_offset,
                       causal=causal, dropout_rate=dropout_rate,
                       dropout_seed=dropout_seed,
                       heads=(head_offset, total_heads))
