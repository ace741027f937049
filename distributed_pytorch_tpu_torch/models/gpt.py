"""The LLM: token/positional embeddings, pre-LN transformer blocks, a
weight-tied LM head with its cross-entropy loss, KV-cached decoding.

Counterpart of the reference package's `models/gpt.py` (`LLM`, `Block`,
`init_cache`, `init_paged_cache`, `count_params`), as `nn.Module`s:

* LayerNorm uses eps = 1e-6 (flax's default, not torch's 1e-5) and keeps
  fp32 statistics and parameters whatever the activation dtype, with the
  output in the activations' dtype — flax's LayerNorm with a float32
  param dtype.
* Linear/embedding/MLP weights live in `dtype` and the activations in
  `compute_dtype` (default: `dtype`); every weight is cast to the compute
  dtype at use, with explicit casts where flax casts (embedding table,
  positional rows, dense kernels and biases, the tied LM head), not
  `torch.autocast`, whose cast points differ. Training builds fp32 masters
  with bf16 compute (flax's `param_dtype=float32, dtype=bfloat16`);
  serving builds bf16 weights, so its casts are no-ops.
* The LM head is tied to the (V, C) token embedding.
* `forward(idx, targets)` returns (logits, loss): the mean cross-entropy
  over targets != -1 through `config.loss_impl` (ops/losses.py; 'pallas'
  through the fused CE kernels of ops/fused_ce.py), and the
  last position's logits (every position's with `all_logits`). The
  reference returns every position's logits and lets XLA drop them when
  unused; eager PyTorch would compute them, so the port does not.
  Without targets `forward` returns the logits alone.
* Training mode (`nn.Module.train()`) with `config.dropout > 0` applies
  embedding, attention-weight and residual dropout, keyed on the
  `dropout_seed` the train step passes (ops/dropout.py).
* `act_recomp` recomputes whole blocks ('block') or the attention sublayer
  ('attn') in the backward through `torch.utils.checkpoint`.
* MoE blocks (`config.moe`) run `models.mlp.MoE` in place of the MLP;
  with targets the loss adds the layers' aux losses over n_layer, in
  training and in eval, as the reference does. `commit_moe_state()`
  writes the routing state of the last training forward (models/mlp.py).
* `logits_idx` (B,) picks each sequence's true last row of a right-padded
  (bucketed) prefill; `all_logits` returns every position.
* Attention is GQA (mha/mqa/gqa) or MLA (`NaiveMLA`, `FullMLA`), by
  `config.attn` (models/attention.py `Attention`); MLA's RoPE table is
  built at `rope_head_dim`.
* Caches are updated in place; `dtype=torch.int8` caches hold int8 codes
  with fp32 scale sidecars (GQA only; models/attention.py).
* Weight-only int8: every module carries its dotted name (`qname`), the
  key of its weights in a quantized store (ops/quant.py); under an active
  store the attention and MLP products and the tied LM head read int8
  codes.
* Tensor parallelism (parallel/tensor.py `shard_model` sets `tp` and
  `vocab_cut`): the tied `tkn_emb` is vocab-parallel, V / tp rows a rank
  (the reference's rule `("tkn_emb", "embedding"), 0`). The lookup is a
  masked gather of the rank's rows, summed over 'model'; the loss is
  `vocab_parallel_cross_entropy` (ops/losses.py) whatever `loss_impl`
  asks, since the reference's gate keeps its pallas loss off under tp
  (gpt.py:219-235): `loss_impl='pallas'` counts that in
  `fused_ce.DEGRADED["vocab_parallel"]`, as the port's other gate refusals
  are counted. Returned logits are gathered over 'model'.
* Sequence parallelism (a published 'seq' axis, parallel/context.py): a
  training or eval forward holds this rank's T / sp positions of each row
  (data/loader.py), so RoPE and the learned and sinusoidal position
  embeddings are taken at those global positions
  (ops/ring_attention.py `seq_positions`), the element dropout masks are
  the whole rows' at them (ops/dropout.py),
  attention runs ring, zig-zag or Ulysses attention (ops/attention_core.py)
  and the loss is `sp_fused_cross_entropy` (the unchunked loss under
  'unchunked'); `loss_impl='pallas'` takes it too, as the reference's gate
  does (gpt.py:219-250), counted in
  `fused_ce.DEGRADED["sequence_parallel"]`.
* Pipeline parallelism (`config.pp_stages` S > 1): `LLM(cfg, stage=s)`
  is one stage, built with its own blocks only (models/pipeline.py
  `stage_layers`) under the whole model's names (`StageBlocks`: layer 7
  is `blocks.7.…` on whichever stage holds it); stage 0 holds the
  embedding and `pos_emb` / the sinusoidal table, the last stage `ln_f`
  and the tied head, so `tkn_emb` is on both. `embed`, `run_layers` and
  `head_loss` are the pieces `Pipeline.run` drives; `forward` refuses a
  stage (KV-cached decoding with the reference's message).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_pytorch_tpu_torch import resolve_device
from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.models.attention import (
    Attention, init_attn_cache, init_paged_attn_cache)
from distributed_pytorch_tpu_torch.models.mlp import MLP, MoE
from distributed_pytorch_tpu_torch.ops import fused_ce
from distributed_pytorch_tpu_torch.ops.dropout import dropout, subseed
from distributed_pytorch_tpu_torch.ops.losses import (
    fused_cross_entropy, sp_fused_cross_entropy, unchunked_cross_entropy,
    vocab_parallel_cross_entropy)
from distributed_pytorch_tpu_torch.ops.quant import maybe_quantized_matmul
from distributed_pytorch_tpu_torch.ops.ring_attention import seq_positions
from distributed_pytorch_tpu_torch.ops.rope import (precompute_rope_freqs,
                                                   slice_rows)
from distributed_pytorch_tpu_torch.parallel import context

LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm over the last axis, output in the input's dtype."""

    def __init__(self, n: int, *, device=None):
        super().__init__(n, eps=LN_EPS, device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def _recompute(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its activations recomputed in the backward
    (dropout masks come from explicit seeds, so no RNG state is kept)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(ln1(x)), then x + mlp(ln2(x))
    (the MoE layer for MoE configs). Returns (x, aux loss or None).
    `remat_attn` recomputes the attention sublayer in the backward."""

    def __init__(self, config: LLMConfig, *, device=None, dtype=None,
                 attn_impl: str = "auto", remat_attn: bool = False):
        super().__init__()
        self.remat_attn = remat_attn
        self.ln1 = LayerNorm(config.n_embd, device=device)
        self.attn = Attention(config, device=device, dtype=dtype,
                              attn_impl=attn_impl)
        self.ln2 = LayerNorm(config.n_embd, device=device)
        if config.moe:
            self.moe = MoE(config, device=device, dtype=dtype)
        else:
            self.mlp = MLP(config, device=device, dtype=dtype)

    def forward(self, x, freqs, cache=None, pos=0, block_tables=None,
                dropout_seed=None, stats_weight=1.0, moe_bias=None):
        drop = self.training and dropout_seed is not None
        a_seed = subseed(dropout_seed, 0) if drop else None
        h = self.ln1(x)
        if self.remat_attn and cache is None and torch.is_grad_enabled():
            y = _recompute(self.attn, h, freqs, dropout_seed=a_seed)
        else:
            y = self.attn(h, freqs, cache, pos, block_tables=block_tables,
                          dropout_seed=a_seed)
        x = x + y
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(x), stats_weight=stats_weight,
                              bias=moe_bias)
            return x + y, aux
        return x + self.mlp(self.ln2(x),
                            subseed(dropout_seed, 1) if drop else None), None


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


class StageBlocks(nn.ModuleDict):
    """A pipeline stage's blocks under their layer ids, so their names are
    the whole model's (`blocks.7.…`): iterates the blocks in layer order,
    and `[i]` is layer i."""

    def __iter__(self):
        return iter(self._modules.values())

    def __getitem__(self, i):
        return self._modules[str(i)]


class LLM(nn.Module):
    """The full model. Build with `device` (the card unless "cpu" is asked
    for; see `resolve_device`), `dtype` (the weights' dtype),
    `compute_dtype` (the activations'; default `dtype`) and `attn_impl`
    (ops/attention_core.py); `init_weights(generator)` draws the
    reference's N(0, 0.02) init. `self.dtype` is the compute dtype."""

    tp = (0, 1)
    ep = (0, 1)
    vocab_cut = False

    def __init__(self, config: LLMConfig, *, device=None,
                 dtype=torch.float32, compute_dtype=None,
                 attn_impl: str = "auto", stage: Optional[int] = None):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        S = cfg.pp_stages
        if S > 1 and stage is None:
            raise ValueError(f"pp_stages={S}: a pipeline-parallel model is "
                             "one stage of the LLM; pass stage=")
        self.config = cfg
        self.stage = stage
        self.dtype = compute_dtype or dtype
        self.attn_impl = attn_impl
        recomp = cfg.act_recomp
        self.remat_block = recomp and cfg.act_recomp_policy == "block"
        first = S == 1 or stage == 0
        last = S == 1 or stage == S - 1
        if first or last:
            self.tkn_emb = nn.Embedding(cfg.vocab_size, cfg.n_embd,
                                        device=device, dtype=dtype)
        if cfg.pos_emb == "rope":
            # MLA rotates only its decoupled rotary features
            d = cfg.rope_head_dim if cfg.attn == "mla" else cfg.head_size
            self.register_buffer("freqs", precompute_rope_freqs(
                d, cfg.block_size, device=device), persistent=False)
        elif first and cfg.pos_emb == "learn":
            self.pos_emb = nn.Parameter(torch.empty(
                cfg.block_size, cfg.n_embd, device=device, dtype=dtype))
        elif first:
            self.register_buffer("sin_tab", _sin_table(
                cfg.block_size, cfg.n_embd).to(device), persistent=False)

        def block():
            return Block(cfg, device=device, dtype=dtype,
                         attn_impl=attn_impl,
                         remat_attn=recomp and cfg.act_recomp_policy == "attn")

        if S == 1:
            self.blocks = nn.ModuleList(block() for _ in range(cfg.n_layer))
        else:
            from distributed_pytorch_tpu_torch.models.pipeline import \
                stage_layers
            self.blocks = StageBlocks(
                {str(i): block() for i in stage_layers(cfg, stage)})
        if last:
            self.ln_f = LayerNorm(cfg.n_embd, device=device)
        # the key of each module's weights in a quantized store
        for name, mod in self.named_modules():
            mod.qname = name

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

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

    def forward(self, idx, targets=None, caches=None, pos=0, *,
                dropout_seed=None, logits_idx=None, block_tables=None,
                all_logits: bool = False):
        """`idx` (B, T) token ids; `targets` (B, T) ids with -1 ignored;
        `pos` the global position of idx[:, 0] (an int, a 0-d tensor, or a
        per-sequence (B,) tensor). Returns the logits of the last position
        (B, 1, V), of `logits_idx` (B,) rows, or of every position with
        `all_logits` — and with `targets`, (logits, loss). In training
        mode with `config.dropout > 0`, `dropout_seed` (an int) keys every
        dropout mask."""
        cfg = self.config
        T = idx.shape[1]
        if cfg.pp_stages > 1:
            if caches is not None:
                raise ValueError(
                    "pipeline-parallel models don't support KV-cached "
                    "decoding; restore the checkpoint with pp_stages=1 "
                    "(a pp checkpoint holds the single model's tensors) "
                    "to sample from it")
            raise RuntimeError("a pipeline stage runs through "
                               "models/pipeline.py's Pipeline.run")
        if self.training and cfg.dropout > 0.0 and dropout_seed is None:
            raise ValueError("training with dropout > 0 needs a dropout_seed")
        if self.tp[1] != context.model_size():
            raise RuntimeError(
                f"a model cut for tp={self.tp[1]} runs under a world whose "
                f"'model' axis has {context.model_size()} rank(s)")
        rows = seq_positions(T, idx.device) if caches is None else None
        x = self.embed(idx, dropout_seed, pos=pos, rows=rows)
        x, total_aux = self.run_layers(
            range(cfg.n_layer), x, rows=rows, caches=caches, pos=pos,
            block_tables=block_tables, dropout_seed=dropout_seed)
        x = self.ln_f(x)
        if targets is not None:
            loss = self._loss(x, targets)
            if total_aux is not None:
                loss = loss + total_aux / cfg.n_layer
            sel = x if all_logits else x[:, -1:, :]
            return self._head(sel), loss
        if all_logits:
            sel = x
        elif logits_idx is None:
            sel = x[:, -1:, :]
        else:
            li = torch.as_tensor(logits_idx, device=x.device).long()
            sel = torch.gather(x, 1, li.reshape(-1, 1, 1)
                               .expand(-1, 1, x.shape[-1]))
        # the tied head from int8 codes under an active quantized store
        logits = maybe_quantized_matmul(sel, "tkn_emb.weight",
                                        transpose_b=True)
        if logits is not None:
            return logits
        return self._head(sel)

    # -- the pieces of `forward`, which a pipeline stage runs one by one
    # (models/pipeline.py) -------------------------------------------------

    def embed(self, idx: torch.Tensor, dropout_seed=None, *, pos=0,
              rows=None) -> torch.Tensor:
        """The (B, T, C) block input of `idx` at positions `pos` .. pos + T
        - 1 (`rows` under a 'seq' axis), with the embedding dropout."""
        cfg = self.config
        dt = self.dtype
        x = self._embed(idx, dt)
        if cfg.pos_emb != "rope":
            tab = self.pos_emb if cfg.pos_emb == "learn" else self.sin_tab
            p = (slice_rows(tab, pos, idx.shape[1]) if rows is None
                 else tab[rows]).to(dt)
            x = x + (p if p.dim() == 3 else p[None])
        if self.training and cfg.dropout > 0.0:
            if dropout_seed is None:
                raise ValueError("training with dropout > 0 needs a "
                                 "dropout_seed")
            x = dropout(x, cfg.dropout, subseed(dropout_seed, 0))
        return x

    def run_layers(self, layers, x: torch.Tensor, *, rows=None,
                   caches=None, pos=0, block_tables=None, dropout_seed=None,
                   microbatch: Optional[int] = None,
                   stats_weight: float = 1.0):
        """x through the blocks `layers` in order (the whole stack, or one
        pipeline chunk); returns (x, the sum of their aux losses or None).
        `rows` are this rank's positions under a 'seq' axis, `caches` one
        KV cache a layer (decoding at `pos`). Layer i draws its dropout
        from `subseed(dropout_seed, 1 + i)`, and in a pipeline's
        `microbatch` m from `subseed(dropout_seed, 1 + i, m)`; there an
        MoE block scales its aux loss and bias step by `stats_weight`, and
        an aux-free one routes with a copy of its bias taken now, which a
        recomputed block ('block' act_recomp) reuses after later
        microbatches moved the buffer."""
        cfg = self.config
        drop = self.training and cfg.dropout > 0.0
        freqs = None
        if cfg.pos_emb == "rope":
            # under sp the table's rows at this rank's positions, which the
            # attention layers then read from row 0
            freqs = self.freqs if rows is None else self.freqs[rows]
        remat = self.remat_block and (caches is None or caches[0] is None) \
            and torch.is_grad_enabled()
        total = None
        for i in layers:
            blk = self.blocks[i]
            ids = (1 + i,) if microbatch is None else (1 + i, microbatch)
            kw = {"dropout_seed": subseed(dropout_seed, *ids) if drop
                  else None}
            if microbatch is not None and hasattr(blk, "moe"):
                kw["stats_weight"] = stats_weight
                if cfg.aux_free:
                    kw["moe_bias"] = blk.moe.expert_bias.clone()
            if remat:
                x, aux = _recompute(blk, x, freqs, **kw)
            else:
                x, aux = blk(x, freqs, None if caches is None else caches[i],
                             pos, block_tables=block_tables, **kw)
            if aux is not None:
                total = aux if total is None else total + aux
        return x, total

    def head_loss(self, x: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
        """The last stage: ln_f and the mean loss of `forward` (without
        the aux term, which the stages' layers add)."""
        return self._loss(self.ln_f(x), targets)

    def _embed(self, idx: torch.Tensor, dt) -> torch.Tensor:
        """Token embeddings; vocab-parallel: this rank's rows looked up,
        the others' zero, summed over 'model'."""
        w = self.tkn_emb.weight.to(dt)
        if not self.vocab_cut:
            return F.embedding(idx, w)
        Vl = w.shape[0]
        local = idx - self.tp[0] * Vl
        inside = (local >= 0) & (local < Vl)
        x = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                        w)
        return context.reduce_from_model(
            torch.where(inside[..., None], x, torch.zeros((), dtype=dt,
                                                          device=x.device)))

    def _head(self, sel: torch.Tensor) -> torch.Tensor:
        """Logits of the tied head; vocab-parallel: gathered over
        'model'."""
        logits = sel @ self.tkn_emb.weight.to(self.dtype).t()
        return context.gather_from_model(logits) if self.vocab_cut \
            else logits

    def moe_layers(self) -> list:
        """The MoE layers, in block order (empty for dense models)."""
        return [blk.moe for blk in self.blocks if hasattr(blk, "moe")]

    def commit_moe_state(self, layers=None) -> None:
        """Write every MoE layer's routing state from the last training
        forward into its buffers (once per micro-step, after backward;
        under pp, `layers`' after each chunk's forward)."""
        blocks = self.blocks if layers is None else \
            [self.blocks[i] for i in layers]
        for blk in blocks:
            if hasattr(blk, "moe"):
                blk.moe.commit_state()

    def _loss(self, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Weight-tied mean cross-entropy (ignore_index -1, fp32 logits)
        through `config.loss_impl`."""
        cfg = self.config
        emb = self.tkn_emb.weight.to(self.dtype)
        if context.seq_size() > 1:
            if cfg.loss_impl == "pallas":
                # the reference's gate: no pallas loss under a 'seq' axis
                fused_ce.DEGRADED["sequence_parallel"] += 1
            if cfg.loss_impl == "unchunked":
                return unchunked_cross_entropy(x, emb, targets)
            return sp_fused_cross_entropy(x, emb, targets,
                                          chunk=cfg.loss_chunk)
        if self.tp[1] > 1:
            if cfg.loss_impl == "pallas":
                # the reference's gate: no pallas loss under tp
                fused_ce.DEGRADED["vocab_parallel"] += 1
            if self.vocab_cut:
                return vocab_parallel_cross_entropy(
                    x, emb, targets, self.tp[0] * emb.shape[0],
                    chunk=x.shape[1] if cfg.loss_impl == "unchunked"
                    else cfg.loss_chunk)
            if cfg.loss_impl == "unchunked":
                return unchunked_cross_entropy(x, emb, targets)
            return fused_cross_entropy(x, emb, targets, chunk=cfg.loss_chunk)
        if cfg.loss_impl == "pallas":
            # the reference's gate (models/gpt.py:218-236): shapes the
            # kernels tile, else degrade to the chunked path. CUDA tensors
            # run the kernels, CPU tensors the same function through the
            # plain versions (ops/fused_ce.py).
            n, C = x.shape[0] * x.shape[1], x.shape[-1]
            if fused_ce.pallas_ce_usable(n, C, x.dtype):
                return fused_ce.pallas_cross_entropy(x, emb, targets)
            fused_ce.DEGRADED["chunked"] += 1
            return fused_cross_entropy(x, emb, targets, chunk=cfg.loss_chunk)
        if cfg.loss_impl == "fused":
            return fused_cross_entropy(x, emb, targets, chunk=cfg.loss_chunk)
        return unchunked_cross_entropy(x, emb, targets)


def init_cache(config: LLMConfig, batch_size: int, max_len=None,
               dtype=torch.float32, device=None) -> list:
    """Per-layer contiguous KV caches for one-shot decoding (int8 codes
    with scale sidecars for `dtype=torch.int8`)."""
    max_len = max_len or config.block_size
    return [init_attn_cache(config, batch_size, max_len, dtype, device)
            for _ in range(config.n_layer)]


def init_paged_cache(config: LLMConfig, n_blocks: int, block_size: int,
                     dtype=torch.float32, device=None) -> list:
    """Per-layer paged KV pools, shared by every sequence through
    per-sequence block tables (engine/decode.py owns the tables); int8
    codes with scale sidecars for `dtype=torch.int8`."""
    return [init_paged_attn_cache(config, n_blocks, block_size, dtype,
                                  device)
            for _ in range(config.n_layer)]


def count_params(model: nn.Module, config: LLMConfig) -> tuple[int, int]:
    """(total, active) parameter counts (reference `count_params`): active
    counts the shared experts and n_act_routed routed experts of each MoE
    layer, everything else fully."""
    total = sum(p.numel() for p in model.parameters())
    if not config.moe:
        return total, total
    inactive = sum(p.numel() // config.n_exp
                   * (config.n_routed - config.n_act_routed)
                   for name, p in model.named_parameters()
                   if name.rsplit(".", 1)[-1] in ("experts_fc",
                                                  "experts_proj"))
    return total, total - inactive
