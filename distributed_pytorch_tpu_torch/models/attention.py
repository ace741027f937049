"""Attention flavors: grouped-query attention (MHA / MQA / GQA) and
Multi-head Latent Attention (MLA), with contiguous or paged KV caches.

Counterpart of the reference package's `models/attention.py` (`GQA`,
`NaiveMLA`, `FullMLA`, the `Attention` factory, `init_attn_cache` and
`init_paged_attn_cache`):

* `GQA`: one fused qkv projection `c_attn` of width C + 2*n_kv_heads*
  head_size with a bias, split [q | k | v] at [C, C + nkv*hs], RoPE on q
  and k, the attention dispatch (ops/attention_core.py), the `c_proj`
  output projection and residual dropout after it.
* `NaiveMLA` (MLA without RoPE) and `FullMLA` (DeepSeek-V2 MLA with
  decoupled RoPE): bias-free projections held as bare (in, out)
  `nn.Parameter`s under the reference's names (`W_dq`, `W_uq`, `W_dkv`,
  `W_uk`, `W_uv`, `W_o`; FullMLA adds `W_qr` (q latent -> nh*dhr) and
  `W_kr` (C -> dhr), one rotary key head shared by every head). The
  training forward materializes per-head K and V from the kv latent and
  makes one `sdpa` call; FullMLA concatenates q_c | q_r and k_c | k_r,
  zero-pads v by dhr so one head size (hs + dhr) runs through q, k, v and
  out, scales by 1/sqrt(hs + dhr), and keeps out[..., :hs]. Cached calls
  attend over the latent cache by exact weight absorption
  (`_absorbed_decode`, einsums; the reference runs no Pallas kernel
  there either): the cache holds `c_kv` (rows, nlkv) and, for FullMLA,
  `k_r` (rows, 1, dhr), never per-head K/V.
* `Attention` picks the flavor: mha/mqa/gqa -> GQA; mla -> FullMLA when
  pos_emb == 'rope', else NaiveMLA.

Weights may be held in fp32 while the activations run in bf16 (the
training model's fp32 masters): each projection casts its weight (and
bias) to the activations' dtype at use, as flax's Dense with
`param_dtype=float32, dtype=bfloat16` does. In training mode
(`nn.Module.train()`) with `config.dropout > 0`, attention-weight dropout
runs inside the attention kernels and residual dropout after the output
projection, both keyed on `dropout_seed` (ops/dropout.py).

Caches are dicts of tensors updated IN PLACE (the reference returns new
buffers; the port saves the copy): GQA {'k', 'v'}, MLA {'c_kv'[, 'k_r']}.
A contiguous cache is (B, S, ...); a paged one is an (n_blocks, bs, ...)
pool addressed through `block_tables` (ops/block_pool.py). A GQA int8
cache adds fp32 'k_scale'/'v_scale' of the same leading shape with a last
dim of 1: each write quantizes its rows (ops/quant.py `quantize_kv`) and
lands codes and scales through the same row writes. MLA's latent cache
has no int8 form: asking for one raises ValueError, as in the reference
(the engine's int8 request keeps the model's dtype, `quant_kv_usable`).

Under an active quantized-weight store (the engine's decode forwards,
ops/quant.py) the projections read int8 codes; the store knows them by
the name `LLM` gives each module (`qname`). The absorbed W_uk / W_uv are
read dequantized (`maybe_dequantized_param`), as the reference does.

Tensor parallelism (parallel/tensor.py sets `tp` = (rank, tp) and cuts
the weights): a rank runs its nh / tp query heads (GQA: and nkv / tp kv
heads) through the same kernels, with the dropout mask of those heads of
the whole layer (`head_offset`, `total_heads`). GQA: `c_attn` is
column-parallel in the per-rank [q_r | k_r | v_r] layout, its input goes
through `copy_to_model`; `c_proj` is row-parallel, its partial products
summed by `reduce_from_model` and its bias added once after the sum.
MLA: W_uq, W_uk, W_uv and W_qr are column-parallel per head, W_o
row-parallel; the down-projections W_dq, W_dkv and the shared rotary key
W_kr stay whole, and their outputs enter the per-head products through
`copy_to_model`, so their gradients are the sums over the ranks' heads.
Only the uncached (training) forward runs under a 'model' axis.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.ops.attention_core import sdpa
from distributed_pytorch_tpu_torch.ops.block_pool import (paged_gather,
                                                          paged_update)
from distributed_pytorch_tpu_torch.ops.dropout import (dropout, seed_pair,
                                                      subseed)
from distributed_pytorch_tpu_torch.ops.quant import (maybe_dequantized_param,
                                                    maybe_quantized_matmul,
                                                    quantize_kv)
from distributed_pytorch_tpu_torch.ops.rope import apply_rotary_emb, slice_rows
from distributed_pytorch_tpu_torch.parallel import context

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


def _tp_uncached(mod: nn.Module, cache) -> tuple[int, int]:
    """The module's (rank, tp); a cached call under a 'model' axis
    raises."""
    rank, tp = mod.tp
    if tp > 1 and cache is not None:
        raise NotImplementedError(
            "cached attention under tensor parallelism comes with --shard "
            "serving (ROADMAP, Queue 1 item 6)")
    return rank, tp


class GQA(nn.Module):
    """Grouped-query attention; n_kv_heads == n_head gives MHA, == 1 MQA."""

    tp = (0, 1)

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
        rank, tp = _tp_uncached(self, cache)
        nh, nkv, hs = cfg.n_head // tp, cfg.n_kv_heads // tp, cfg.head_size
        qkv = _linear(context.copy_to_model(x), self.c_attn)
        q, k, v = qkv.split([nh * hs, nkv * hs, nkv * hs], dim=-1)
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
                 if drop else None, head_offset=rank * nh,
                 total_heads=cfg.n_head, **scales)
        if tp > 1:
            # row-parallel: the ranks' partial products summed, the bias
            # added once
            y = context.reduce_from_model(F.linear(
                y.reshape(B, T, nh * hs), self.c_proj.weight.to(x.dtype)))
            y = y + self.c_proj.bias.to(x.dtype)
        else:
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


def _qmm(mod: nn.Module, x: torch.Tensor, name: str) -> torch.Tensor:
    """`x @ W` for the module's bare (in, out) weight `name`, cast to x's
    dtype at use; from the active quantized store's codes when it holds
    this weight."""
    qn = getattr(mod, "qname", None)
    y = maybe_quantized_matmul(x, qn and f"{qn}.{name}")
    return y if y is not None else x @ getattr(mod, name).to(x.dtype)


def _causal_cache_mask(pos, T: int, S: int, device) -> torch.Tensor:
    """(B|1, T, S) bool: the query at global position pos + i attends
    cache slots j <= pos + i; `pos` an int, a 0-d or a per-sequence (B,)
    tensor. Under a wrapped ring cache every slot is valid."""
    qpos = torch.as_tensor(pos, device=device).long().reshape(-1, 1, 1) \
        + torch.arange(T, device=device)[None, :, None]
    return qpos >= torch.arange(S, device=device)[None, None, :]


def _absorbed_decode(q_c, c_kv, kuk, kuv, pos, scale, extra_scores=None):
    """Attention over the latent cache by exact weight absorption: q_c
    (B, T, nh, hs) content queries, c_kv (B, S, nlkv) the cache's logical
    view, kuk / kuv (nlkv, C) the up-projections, `extra_scores` (B, nh,
    T, S) FullMLA's rotary scores. Returns the (B, T, nh*hs) input of
    W_o."""
    B, T, nh, hs = q_c.shape
    S = c_kv.shape[1]
    dt = q_c.dtype
    nlkv = kuk.shape[0]
    kuk_h = kuk.reshape(nlkv, nh, hs).to(dt)
    kuv_h = kuv.reshape(nlkv, nh, hs).to(dt)
    c_kv = c_kv.to(dt)
    # q_abs[b,t,n,l] = q . W_uk_h^T: attend in the latent space
    q_abs = torch.einsum("btnh,lnh->btnl", q_c, kuk_h)
    attn = torch.einsum("btnl,bsl->bnts", q_abs, c_kv)
    if extra_scores is not None:
        attn = attn + extra_scores
    attn = attn * scale
    mask = _causal_cache_mask(pos, T, S, q_c.device)[:, None]
    attn = attn.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(attn.float(), dim=-1).to(dt)
    out_lat = torch.einsum("bnts,bsl->btnl", attn, c_kv)
    return torch.einsum("btnl,lnh->btnh", out_lat, kuv_h) \
        .reshape(B, T, nh * hs)


class _MLA(nn.Module):
    """The projections, cache writes and absorbed weights both MLA
    flavors share."""

    rope = False
    tp = (0, 1)

    def __init__(self, config: LLMConfig, *, device=None, dtype=None,
                 attn_impl: str = "auto"):
        super().__init__()
        self.config = config
        self.attn_impl = attn_impl
        # (in, out) shapes, by the reference's names (`_mla_kernels`)
        C, nlq, nlkv = config.n_embd, config.q_latent_dim, \
            config.kv_latent_dim
        shapes = {"W_dq": (C, nlq), "W_uq": (nlq, C), "W_dkv": (C, nlkv),
                  "W_uk": (nlkv, C), "W_uv": (nlkv, C), "W_o": (C, C)}
        if self.rope:
            dhr = config.rope_head_dim
            shapes.update(W_qr=(nlq, config.n_head * dhr), W_kr=(C, dhr))
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(
                shape, device=device, dtype=dtype)))

    def _write(self, cache: Cache, name: str, rows: torch.Tensor, pos,
               block_tables) -> torch.Tensor:
        """Write `rows` into cache[name] in place; returns the (B, S, ...)
        view the absorbed attention reads (a paged pool's gathered logical
        view: rows past a sequence's extent are causally masked)."""
        if block_tables is not None:
            paged_update(cache[name], rows, pos, block_tables)
            return paged_gather(cache[name], block_tables)
        _update_cache(cache[name], rows, pos)
        return cache[name]

    def _absorbed_weights(self):
        qn = getattr(self, "qname", None)
        return tuple(maybe_dequantized_param(qn and f"{qn}.{n}",
                                             getattr(self, n))
                     for n in ("W_uk", "W_uv"))

    def _attend(self, q, k, v, dropout_seed, x, scale=None):
        drop = self.training and self.config.dropout > 0.0
        return sdpa(q, k, v, scale=scale, impl=self.attn_impl,
                    dropout_rate=self.config.dropout if drop else 0.0,
                    dropout_seed=seed_pair(subseed(dropout_seed, 0),
                                           x.device) if drop else None,
                    head_offset=self.tp[0] * q.shape[2],
                    total_heads=self.config.n_head)

    def _out(self, y, dropout_seed):
        y = context.reduce_from_model(_qmm(self, y, "W_o"))
        if self.training and self.config.dropout > 0.0:
            y = dropout(y, self.config.dropout, subseed(dropout_seed, 1))
        return y


class NaiveMLA(_MLA):
    """MLA without RoPE (reference `NaiveMLA`): q = x W_dq W_uq; the cache
    holds c_kv = x W_dkv; K and V are c_kv W_uk and c_kv W_uv."""

    def forward(self, x, freqs, cache: Optional[Cache] = None, pos=0, *,
                block_tables=None, dropout_seed: Optional[int] = None):
        cfg = self.config
        B, T, C = x.shape
        _, tp = _tp_uncached(self, cache)
        nh, hs = cfg.n_head // tp, cfg.head_size
        dt = x.dtype
        q = _qmm(self, context.copy_to_model(_qmm(self, x, "W_dq")),
                 "W_uq").reshape(B, T, nh, hs)
        new_c_kv = _qmm(self, x, "W_dkv")                      # (B, T, nlkv)
        if cache is None:
            c_kv = context.copy_to_model(new_c_kv)
            k = (c_kv @ self.W_uk.to(dt)).reshape(B, T, nh, hs)
            v = (c_kv @ self.W_uv.to(dt)).reshape(B, T, nh, hs)
            y = self._attend(q, k, v, dropout_seed, x).reshape(B, T, nh * hs)
        else:
            c_kv = self._write(cache, "c_kv", new_c_kv, pos, block_tables)
            y = _absorbed_decode(q, c_kv, *self._absorbed_weights(), pos,
                                 1.0 / math.sqrt(hs))
        return self._out(y, dropout_seed)


class FullMLA(_MLA):
    """DeepSeek-V2 MLA with decoupled RoPE (reference `FullMLA`): the
    content path as NaiveMLA's, plus per-head rotary queries c_q W_qr and
    one shared rotary key head x W_kr; scores q_c.k_c + q_r.k_r scaled by
    1/sqrt(hs + dhr)."""

    rope = True

    def forward(self, x, freqs, cache: Optional[Cache] = None, pos=0, *,
                block_tables=None, dropout_seed: Optional[int] = None):
        cfg = self.config
        B, T, C = x.shape
        _, tp = _tp_uncached(self, cache)
        nh, hs, dhr = cfg.n_head // tp, cfg.head_size, cfg.rope_head_dim
        dt = x.dtype
        f = slice_rows(freqs, pos, T)
        c_q = context.copy_to_model(_qmm(self, x, "W_dq"))     # (B, T, nlq)
        q_c = _qmm(self, c_q, "W_uq").reshape(B, T, nh, hs)
        q_r = apply_rotary_emb(
            _qmm(self, c_q, "W_qr").reshape(B, T, nh, dhr), f)
        new_c_kv = _qmm(self, x, "W_dkv")                      # (B, T, nlkv)
        new_k_r = apply_rotary_emb(_qmm(self, x, "W_kr")[:, :, None, :], f)
        scale = 1.0 / math.sqrt(hs + dhr)
        if cache is None:
            c_kv = context.copy_to_model(new_c_kv)
            k_c = (c_kv @ self.W_uk.to(dt)).reshape(B, T, nh, hs)
            v = (c_kv @ self.W_uv.to(dt)).reshape(B, T, nh, hs)
            # one attention call over the concatenated content and rotary
            # features; v padded by dhr zeros (the padded half of the
            # output is exactly zero and is dropped)
            q_cat = torch.cat([q_c, q_r], dim=-1)
            k_r = context.copy_to_model(new_k_r)
            k_cat = torch.cat([k_c, k_r.expand(B, T, nh, dhr)], dim=-1)
            v_pad = F.pad(v, (0, dhr))
            y = self._attend(q_cat, k_cat, v_pad, dropout_seed, x,
                             scale=scale)
            y = y[..., :hs].reshape(B, T, nh * hs)
        else:
            c_kv = self._write(cache, "c_kv", new_c_kv, pos, block_tables)
            k_r = self._write(cache, "k_r", new_k_r, pos, block_tables)
            # the rotary scores; the one key head broadcasts over heads
            attn_r = torch.einsum("btnh,bskh->bnts", q_r, k_r.to(dt))
            y = _absorbed_decode(q_c, c_kv, *self._absorbed_weights(), pos,
                                 scale, extra_scores=attn_r)
        return self._out(y, dropout_seed)


def Attention(config: LLMConfig, *, device=None, dtype=None,
              attn_impl: str = "auto") -> nn.Module:
    """The flavor of `config` (reference `Attention`): mha/mqa/gqa ->
    GQA; mla -> FullMLA when pos_emb == 'rope', else NaiveMLA."""
    if config.attn in ("mha", "mqa", "gqa"):
        cls = GQA
    else:
        cls = FullMLA if config.pos_emb == "rope" else NaiveMLA
    return cls(config, device=device, dtype=dtype, attn_impl=attn_impl)


def _cache_buffers(config: LLMConfig, rows: tuple, dtype, device) -> Cache:
    """GQA: k/v buffers of shape rows + (nkv, hs); for `torch.int8`, int8
    code buffers and fp32 'k_scale'/'v_scale' of shape rows + (nkv, 1).
    MLA: c_kv of shape rows + (nlkv,) and, with RoPE, k_r rows + (1, dhr);
    an int8 MLA cache raises ValueError."""
    if config.attn not in ("mha", "mqa", "gqa"):
        if dtype == torch.int8:
            raise ValueError(
                "int8 KV cache supports the GQA family only (quant_kv_usable "
                "gates this; MLA latent caches stay in the compute dtype)")
        cache = {"c_kv": torch.zeros(rows + (config.kv_latent_dim,),
                                     dtype=dtype, device=device)}
        if config.pos_emb == "rope":
            cache["k_r"] = torch.zeros(rows + (1, config.rope_head_dim),
                                       dtype=dtype, device=device)
        return cache
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
    """Per-layer contiguous (B, S, ...) cache buffers (GQA int8 with scale
    sidecars for `dtype=torch.int8`)."""
    return _cache_buffers(config, (batch_size, max_len), dtype, device)


def init_paged_attn_cache(config: LLMConfig, n_blocks: int, block_size: int,
                          dtype=torch.float32, device=None) -> Cache:
    """Per-layer paged POOL buffers (n_blocks, block_size, ...), the same
    leaves as `init_attn_cache` (GQA int8 with scale sidecars for
    `dtype=torch.int8`). Block 0 is the null block (ops/block_pool.py)."""
    return _cache_buffers(config, (n_blocks, block_size), dtype, device)
