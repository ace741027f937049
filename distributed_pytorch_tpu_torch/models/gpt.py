"""The LLM: token/positional embeddings, pre-LN transformer blocks, a
weight-tied LM head, KV-cached decoding.

Counterpart of the reference package's `models/gpt.py` (`LLM`, `Block`,
`init_cache`, `init_paged_cache`, `count_params`), as `nn.Module`s:

* LayerNorm uses eps = 1e-6 (flax's default, not torch's 1e-5) and keeps
  fp32 statistics and parameters whatever the activation dtype, with the
  output in the activations' dtype — flax's LayerNorm with a float32
  param dtype.
* Linear/embedding/MLP weights live in the model's compute dtype (fp32, or
  bf16 for serving); the reference keeps fp32 master weights and casts at
  use, which for inference is the same numbers.
* The LM head is tied to the (V, C) token embedding.
* `logits_idx` (B,) picks each sequence's true last row of a right-padded
  (bucketed) prefill; `all_logits` returns every position.
* Caches are updated in place; `forward` returns the logits. The loss path
  comes with the training slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_tpu_torch import resolve_device
from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.models.attention import (
    GQA, init_attn_cache, init_paged_attn_cache)
from distributed_pytorch_tpu_torch.models.mlp import MLP
from distributed_pytorch_tpu_torch.ops.rope import (precompute_rope_freqs,
                                                   slice_rows)

LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm over the last axis, output in the input's dtype."""

    def __init__(self, n: int, *, device=None):
        super().__init__(n, eps=LN_EPS, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, config: LLMConfig, *, device=None, dtype=None):
        super().__init__()
        if config.moe:
            raise NotImplementedError("MoE blocks come with a later slice")
        self.ln1 = LayerNorm(config.n_embd, device=device)
        self.attn = GQA(config, device=device, dtype=dtype)
        self.ln2 = LayerNorm(config.n_embd, device=device)
        self.mlp = MLP(config, device=device, dtype=dtype)

    def forward(self, x, freqs, cache=None, pos=0, block_tables=None):
        x = x + self.attn(self.ln1(x), freqs, cache, pos,
                          block_tables=block_tables)
        return x + self.mlp(self.ln2(x))


def _sin_table(block_size: int, n_embd: int) -> torch.Tensor:
    """Fixed sinusoidal table: sin on even, cos on odd channels."""
    position = torch.arange(block_size, dtype=torch.float32)[:, None]
    div_term = torch.exp(torch.arange(0, n_embd, 2, dtype=torch.float32)
                         * (-math.log(10000.0) / n_embd))
    angles = position * div_term
    tab = torch.zeros(block_size, n_embd)
    tab[:, 0::2] = torch.sin(angles)
    tab[:, 1::2] = torch.cos(angles)
    return tab


class LLM(nn.Module):
    """The full model. Build with `device` (the card unless "cpu" is asked
    for; see `resolve_device`) and `dtype` (the compute dtype);
    `init_weights(generator)` draws the reference's N(0, 0.02) init."""

    def __init__(self, config: LLMConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        if cfg.pp_stages > 1:
            raise NotImplementedError("pipeline-parallel models come with "
                                      "the training slice")
        self.config = cfg
        self.dtype = dtype
        self.tkn_emb = nn.Embedding(cfg.vocab_size, cfg.n_embd,
                                    device=device, dtype=dtype)
        if cfg.pos_emb == "rope":
            self.register_buffer("freqs", precompute_rope_freqs(
                cfg.head_size, cfg.block_size, device=device),
                persistent=False)
        elif cfg.pos_emb == "learn":
            self.pos_emb = nn.Parameter(torch.empty(
                cfg.block_size, cfg.n_embd, device=device, dtype=dtype))
        else:
            self.register_buffer("sin_tab", _sin_table(
                cfg.block_size, cfg.n_embd).to(device), persistent=False)
        self.blocks = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, device=device)

    @property
    def device(self) -> torch.device:
        return self.tkn_emb.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 0.02) for every weight matrix and embedding, zero biases,
        unit LayerNorm scales — the reference's init, drawn from
        `generator` (on the model's device)."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln" in name or name.startswith("ln_f"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, idx, caches=None, pos=0, *, logits_idx=None,
                block_tables=None, all_logits: bool = False):
        """`idx` (B, T) token ids; `pos` the global position of idx[:, 0]
        (an int, a 0-d tensor, or a per-sequence (B,) tensor). Returns the
        logits of the last position (B, 1, V), of `logits_idx` (B,) rows,
        or of every position with `all_logits`."""
        cfg = self.config
        T = idx.shape[1]
        x = self.tkn_emb(idx)
        freqs = None
        if cfg.pos_emb == "rope":
            freqs = self.freqs
        else:
            tab = self.pos_emb if cfg.pos_emb == "learn" else self.sin_tab
            p = slice_rows(tab, pos, T).to(x.dtype)
            x = x + (p if p.dim() == 3 else p[None])
        if caches is None:
            caches = [None] * cfg.n_layer
        for blk, cache in zip(self.blocks, caches):
            x = blk(x, freqs, cache, pos, block_tables=block_tables)
        x = self.ln_f(x)
        if all_logits:
            sel = x
        elif logits_idx is None:
            sel = x[:, -1:, :]
        else:
            li = torch.as_tensor(logits_idx, device=x.device).long()
            sel = torch.gather(x, 1, li.reshape(-1, 1, 1)
                               .expand(-1, 1, x.shape[-1]))
        return sel @ self.tkn_emb.weight.t()


def init_cache(config: LLMConfig, batch_size: int, max_len=None,
               dtype=torch.float32, device=None) -> list:
    """Per-layer contiguous KV caches for one-shot decoding."""
    max_len = max_len or config.block_size
    return [init_attn_cache(config, batch_size, max_len, dtype, device)
            for _ in range(config.n_layer)]


def init_paged_cache(config: LLMConfig, n_blocks: int, block_size: int,
                     dtype=torch.float32, device=None) -> list:
    """Per-layer paged KV pools, shared by every sequence through
    per-sequence block tables (engine/decode.py owns the tables)."""
    return [init_paged_attn_cache(config, n_blocks, block_size, dtype,
                                  device)
            for _ in range(config.n_layer)]


def count_params(model: nn.Module, config: LLMConfig) -> tuple[int, int]:
    """(total, active) parameter counts; equal for the dense models the
    port runs."""
    total = sum(p.numel() for p in model.parameters())
    return total, total
