"""KV-cached autoregressive generation: temperature + top-k sampling.

Counterpart of the reference package's `models/generate.py`
(`sample_token`, `generate`): the prompt is cropped to the last
block_size tokens, prefilled in one forward over a contiguous cache, then
decoded one token per step in a Python loop (the reference's `lax.scan`).
Decode positions are tensors, so cache writes wrap as a ring once the
window fills, as in the reference. This one-shot path is the greedy
oracle the engine is held against; it decodes through `flash_decode`
(the contiguous-cache route of the `paged_decode_attn` kernel).

Sampling draws from an explicit `torch.Generator`; temperature 0 is greedy
argmax (first index on ties, as jnp.argmax).
"""

from __future__ import annotations

from typing import Optional

import torch

from distributed_pytorch_tpu_torch.models.gpt import init_cache


def sample_token(logits: torch.Tensor, generator=None, *,
                 temperature: float = 1.0,
                 top_k: Optional[int] = None) -> torch.Tensor:
    """Sample token ids (B,) int64 from (B, V) logits."""
    logits = logits.float()
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    # top_k in (None, 0) means no truncation (the CLI passes 0 for "off")
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, *, generator=None,
             temperature: float = 1.0, top_k: Optional[int] = None,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Return (B, T0 + max_new_tokens) tokens: the (cropped) prompt and
    what follows it. `prompt` is a 1-D or (B, T0) sequence of ids."""
    cfg = model.config
    device = model.device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    if prompt.dim() == 1:
        prompt = prompt[None]
    if prompt.shape[1] > cfg.block_size:
        prompt = prompt[:, -cfg.block_size:]
    if max_new_tokens <= 0:
        return prompt
    max_len = max_len or cfg.block_size
    assert max_len <= cfg.block_size, (
        f"max_len {max_len} exceeds block_size {cfg.block_size}")
    B, T0 = prompt.shape
    assert T0 <= max_len, f"prompt length {T0} exceeds cache size {max_len}"
    caches = init_cache(cfg, B, max_len, dtype=model.dtype, device=device)
    logits = model(prompt, caches, 0)
    tok = sample_token(logits[:, -1], generator, temperature=temperature,
                       top_k=top_k)
    out = [tok]
    pos = torch.tensor(T0, device=device)
    for _ in range(1, max_new_tokens):
        logits = model(tok[:, None], caches, pos)
        tok = sample_token(logits[:, -1], generator,
                           temperature=temperature, top_k=top_k)
        out.append(tok)
        pos = pos + 1
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
