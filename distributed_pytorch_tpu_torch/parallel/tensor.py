"""Tensor and expert parallelism: each rank's pieces of the model and
back.

The reference cuts its parameters over 'model' by a PartitionSpec
(parallel/sharding.py `_TP_RULES`) and lets GSPMD derive the layers'
collectives; here `shard_model` replaces every parameter the table cuts by
this rank's piece, tells each layer its (rank, tp), and the layers issue
the collectives (parallel/context.py). A piece is a plain tensor, so the
kernels' wrappers read its `data_ptr` as ever.

A cut axis is a list of segments (`segments`), and rank r's piece is
segment by segment its r-th 1/tp, concatenated. So a fused tensor keeps
whole heads on a rank:

* `c_attn` (weight and bias), one [q | k | v] output of C + 2 nkv hs:
  rank r holds [q_r | k_r | v_r], its nh/tp query heads and nkv/tp kv
  heads (an even contiguous split would give rank 0 mostly q);
* a gated `c_fc` / `experts_fc`, [gate | up] with the gate first: rank r
  holds [gate_r | up_r], so `activate`'s halves pair up on every rank;
* every other cut axis is one segment, a contiguous 1/tp (the vocab rows
  of `tkn_emb`, the per-head columns of MLA's up-projections, the input
  rows of the row-parallel projections).

`split_state` and `join_state` map a whole state dict (the reference's
layout, the one checkpoints hold and `convert.params_from_jax` gives) to
rank r's pieces and back, exactly. `check_tp` refuses a head count that tp
does not divide (the reference runs it under GSPMD with a cut through a
head; ROADMAP lists the divergence) and an MLP or expert width that tp
does not divide; the vocab is cut where tp divides it and stays whole
otherwise, as the reference's table does.

Expert parallelism (an 'expert' axis of ep, parallel/sharding.py): the
reference's `spec_for_param` puts the leading axis of every `experts_*`
stack over 'expert'. `shard_experts` replaces `experts_fc` and
`experts_proj` by rank r's contiguous n_exp / ep experts (global ids r
n_exp / ep .. (r + 1) n_exp / ep - 1, the shared experts first as in the
whole stack), tells each MoE layer its (rank, ep) and keeps the cut names
as `model.expert_cuts`; `expert_piece` is the same cut of a whole tensor,
and `check_ep` refuses an expert count that ep does not divide (the
reference's `grouped_usable` rule, `n_exp % ep`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.parallel.sharding import (expert_cut,
                                                             tp_axis)


def _gated(cfg: LLMConfig) -> bool:
    return cfg.non_linearity.lower() in ("swiglu", "glu")


def check_tp(cfg: LLMConfig, tp: int) -> None:
    """Raise ValueError where tp does not cut the model into whole heads
    and whole MLP or expert widths."""
    if tp <= 1:
        return
    bad = []
    if cfg.n_head % tp:
        bad.append(f"n_head {cfg.n_head}")
    if cfg.attn != "mla" and cfg.n_kv_heads % tp:
        bad.append(f"n_kv_heads {cfg.n_kv_heads}")
    if cfg.up_dim % tp:
        bad.append(f"up_dim {cfg.up_dim}")
    if bad:
        raise ValueError(
            f"tp_size={tp} does not divide {', '.join(bad)}: the port cuts "
            "whole heads and whole widths over 'model' (ROADMAP: the "
            "reference runs an indivisible head axis under GSPMD)")


def vocab_cut(cfg: LLMConfig, tp: int) -> bool:
    """Whether the tied embedding is vocab-parallel (tp divides V)."""
    return tp > 1 and cfg.vocab_size % tp == 0


def segments(name: str, shape: tuple, cfg: LLMConfig,
             tp: int) -> Optional[tuple[int, tuple[int, ...]]]:
    """(axis, segment lengths) of the parameter `name` of whole `shape`
    under a 'model' axis of tp, or None where it stays whole."""
    if tp <= 1:
        return None
    ax = tp_axis(name)
    if ax is None or ax >= len(shape):
        return None
    n = shape[ax]
    leaf = name.rsplit(".", 2)
    if leaf[-1] == "weight" and leaf[-2] == "tkn_emb":
        return (ax, (n,)) if vocab_cut(cfg, tp) else None
    if "c_attn" in leaf[-2:]:
        kv = cfg.n_kv_heads * cfg.head_size
        return ax, (cfg.n_embd, kv, kv)
    if leaf[-1] in ("c_fc", "experts_fc") and _gated(cfg):
        return ax, (n // 2, n // 2)
    return ax, (n,)


def split(whole: torch.Tensor, cut: tuple[int, tuple[int, ...]], rank: int,
          tp: int) -> torch.Tensor:
    """Rank `rank`'s piece of `whole` (a copy)."""
    ax, segs = cut
    parts, at = [], 0
    for n in segs:
        w = n // tp
        parts.append(whole.narrow(ax, at + rank * w, w))
        at += n
    return torch.cat(parts, dim=ax).contiguous()


def join(pieces: list, cut: tuple[int, tuple[int, ...]]) -> torch.Tensor:
    """The whole tensor from the ranks' pieces, in rank order."""
    ax, segs = cut
    tp = len(pieces)
    out, at = [], 0
    for n in segs:
        w = n // tp
        out += [p.narrow(ax, at, w) for p in pieces]
        at += w
    return torch.cat(out, dim=ax)


def plan(names_shapes, cfg: LLMConfig, tp: int) -> dict:
    """{name: cut} of the parameters a 'model' axis of tp cuts, from
    (name, whole shape) pairs."""
    out = {}
    for name, shape in names_shapes:
        cut = segments(name, tuple(shape), cfg, tp)
        if cut is not None:
            out[name] = cut
    return out


def split_state(sd: dict, cfg: LLMConfig, rank: int, tp: int) -> dict:
    """Rank `rank`'s state dict from a whole one (tensors the table keeps
    whole, and buffers, as they are)."""
    cuts = plan(((k, v.shape) for k, v in sd.items()
                 if torch.is_tensor(v)), cfg, tp)
    return {k: split(v, cuts[k], rank, tp) if k in cuts else v
            for k, v in sd.items()}


def join_state(pieces: list, cfg: LLMConfig) -> dict:
    """The whole state dict from every model rank's (in rank order)."""
    tp = len(pieces)
    out = {}
    for k, v in pieces[0].items():
        if not torch.is_tensor(v):
            out[k] = v
            continue
        shape = list(v.shape)
        ax = tp_axis(k)
        if tp > 1 and ax is not None and ax < len(shape):
            shape[ax] *= tp
        cut = segments(k, tuple(shape), cfg, tp)
        out[k] = join([p[k] for p in pieces], cut) if cut is not None else v
    return out


def shard_model(model: nn.Module, rank: int, tp: int) -> dict:
    """Cut a whole `LLM` in place into rank `rank`'s pieces of a 'model'
    axis of tp, and tell every layer its (rank, tp). Returns {name: cut}
    of the cut parameters (also kept as `model.tp_cuts`). Build the
    optimizer after this: the cut parameters are new tensors."""
    cfg = model.config
    check_tp(cfg, tp)
    cuts = plan(((n, p.shape) for n, p in model.named_parameters()), cfg, tp)
    with torch.no_grad():
        for name, cut in cuts.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            old = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(split(old.data, cut, rank, tp),
                                            requires_grad=old.requires_grad))
    for mod in model.modules():
        if hasattr(type(mod), "tp"):
            mod.tp = (rank, tp)
    model.tp_cuts = cuts
    model.vocab_cut = "tkn_emb.weight" in cuts
    return cuts


def check_ep(cfg: LLMConfig, ep: int) -> None:
    """Raise ValueError where ep does not cut the experts into whole,
    equal slices."""
    if ep > 1 and (not cfg.moe or cfg.n_exp % ep):
        raise ValueError(
            f"ep_size={ep} does not divide n_exp {cfg.n_exp if cfg.moe else 0}"
            ": the port cuts whole experts, n_exp / ep a rank, over "
            "'expert' (the reference's grouped dispatch takes the same "
            "rule)")


def expert_piece(whole: torch.Tensor, rank: int, ep: int) -> torch.Tensor:
    """Expert rank `rank`'s experts of a whole expert stack (a copy)."""
    n = whole.shape[0] // ep
    return whole.narrow(0, rank * n, n).contiguous()


def shard_experts(model: nn.Module, rank: int, ep: int) -> list:
    """Cut a whole `LLM` in place into expert rank `rank`'s experts of an
    'expert' axis of ep and tell every MoE layer its (rank, ep). Returns
    the names of the cut parameters (also kept as `model.expert_cuts`).
    Build the optimizer after this: the cut parameters are new tensors."""
    check_ep(model.config, ep)
    names = [n for n, _ in model.named_parameters() if expert_cut(n)]
    with torch.no_grad():
        for name in names:
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            old = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(
                expert_piece(old.data, rank, ep),
                requires_grad=old.requires_grad))
    for mod in model.modules():
        if hasattr(type(mod), "ep"):
            mod.ep = (rank, ep)
    model.expert_cuts = names
    return names
