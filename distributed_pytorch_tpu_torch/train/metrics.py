"""Throughput and MFU accounting.

Counterpart of the reference package's `train/metrics.py`
(`matmul_params_per_token`, `attn_matmul_params_per_token`, `step_flops`,
`moe_overcompute_factor`, `mfu`; metrics.py:121-238) for GQA and MLA,
dense and MoE, with a table of NVIDIA peaks in place
of the TPU one. An MoE token counts its active experts (the shared ones
and n_act_routed routed ones) and the router, whatever the dispatch
computes. Model FLOPs: every matmul a token touches
costs 2*in*out FLOPs forward, backward twice that; attention scores and
values add 4*T*C per token per layer, halved for causality; recomputation
adds the recomputed forward. The tied lm-head matmul counts; the
embedding lookup does not.
"""

from __future__ import annotations

import torch

from distributed_pytorch_tpu_torch.config import LLMConfig

# Peak dense bf16 FLOP/s per card, by `torch.cuda.get_device_name`
# substring (NVIDIA data sheets, SXM parts).
_PEAK_FLOPS = (
    ("H200", 989e12),
    ("H100", 989e12),
)


def peak_flops_per_chip(device=None) -> float | None:
    """The card's dense bf16 peak, or None off the card (CPU) or for a
    card not in the table."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for key, val in _PEAK_FLOPS:
        if key in name:
            return val
    return None


def attn_matmul_params_per_token(cfg: LLMConfig) -> int:
    """Matmul parameters of the attention sublayers per token: GQA's
    c_attn and c_proj; MLA's W_dq, W_uq, W_dkv, W_uk, W_uv and W_o, plus
    W_qr and W_kr with RoPE."""
    C, hs, nkvh = cfg.n_embd, cfg.head_size, cfg.n_kv_heads
    if cfg.attn != "mla":
        return cfg.n_layer * (C * (C + 2 * nkvh * hs) + C * C)
    nlq, nlkv = cfg.q_latent_dim, cfg.kv_latent_dim
    attn = C * nlq + nlq * C + C * nlkv + 2 * nlkv * C + C * C
    if cfg.pos_emb == "rope":
        attn += nlq * cfg.n_head * cfg.rope_head_dim + C * cfg.rope_head_dim
    return cfg.n_layer * attn


def matmul_params_per_token(cfg: LLMConfig) -> int:
    """Active matmul parameters a token touches: attention, the MLP (MoE:
    the shared and n_act_routed routed experts, plus the router), and the
    tied lm head."""
    C = cfg.n_embd
    fc_out = 2 * cfg.up_dim if cfg.non_linearity.lower() in ("swiglu", "glu") \
        else cfg.up_dim
    one_mlp = C * fc_out + cfg.up_dim * C
    if cfg.moe:
        ffn = one_mlp * (cfg.n_shared + cfg.n_act_routed) + C * cfg.n_routed
    else:
        ffn = one_mlp
    return attn_matmul_params_per_token(cfg) + cfg.n_layer * ffn \
        + cfg.vocab_size * C


def moe_overcompute_factor(cfg: LLMConfig) -> float:
    """Executed over useful expert-FFN FLOPs for the configured dispatch:
    MFU counts the active experts only, and this says how much more the
    dispatch runs — 'dense' every routed expert on every token, 'scatter'
    each expert padded to its capacity, 'grouped' ~1 (tile rounding
    only)."""
    if not cfg.moe:
        return 1.0
    active = cfg.n_shared + cfg.n_act_routed
    if cfg.moe_impl == "dense":
        return (cfg.n_shared + cfg.n_routed) / active
    if cfg.moe_impl == "scatter":
        return (cfg.n_shared + cfg.capacity_factor * cfg.n_act_routed) \
            / active
    return 1.0


def step_flops(cfg: LLMConfig, tokens_per_step: int, seq_len: int) -> float:
    """Total train-step FLOPs (fwd + bwd [+ recomputed fwd]); 'attn'
    recomputation counts only the attention projections and scores."""
    score_flops = cfg.n_layer * 2 * cfg.n_embd * seq_len  # causal: 4*T*C/2
    per_tok_fwd = 2 * matmul_params_per_token(cfg) + score_flops
    recompute = 0.0
    if cfg.act_recomp:
        if cfg.act_recomp_policy == "attn":
            recompute = 2 * attn_matmul_params_per_token(cfg) + score_flops
        else:
            recompute = per_tok_fwd
    return (3 * per_tok_fwd + recompute) * tokens_per_step


def mfu(cfg: LLMConfig, tokens_per_step: int, seq_len: int,
        step_time_s: float, n_chips: int = 1, device=None) -> float | None:
    """Model FLOP utilization per card: the step's FLOPs over the global
    `tokens_per_step`, spread over `n_chips` cards (a data-parallel
    world's size), against one card's peak. None off the card."""
    peak = peak_flops_per_chip(device)
    if peak is None or step_time_s <= 0:
        return None
    return step_flops(cfg, tokens_per_step, seq_len) / step_time_s \
        / (peak * n_chips)


def device_memory_gb(device=None) -> float | None:
    """Peak memory allocated on the card in GiB since the last reset
    (`torch.cuda.max_memory_allocated`), or None off the card."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30
