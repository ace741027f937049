"""Configuration: the model dataclass, the size presets and the env-knob
registry of the PyTorch port.

A copy of the reference package's `config.py` cut to what the serving
slice reads: `LLMConfig` (field-for-field, so one config drives both
packages and `convert.params_from_jax`), the GPT-2 presets, and the knobs
the copied serving modules look up. `TrainConfig` and the trainer CLI
come with the training slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional

# ---------------------------------------------------------------------------
# Env-knob registry. Every tunable the package reads from the process
# environment is declared HERE — name, default, parser, one-line doc — and
# read through `knob()`. Values are parsed PER READ (never cached here) so
# tests can monkeypatch the environment.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Knob:
    """One registered environment tunable."""

    name: str
    default: str                       # raw string, parsed like an env read
    parse: Callable[[str], Any]
    doc: str

    def read(self) -> Any:
        """Parsed value: the process env var when set, else the default."""
        raw = os.environ.get(self.name)
        if raw is None:
            raw = self.default
        return self.parse(raw)


ENV_KNOBS: dict[str, Knob] = {}


def register_knob(name: str, default: str, parse: Callable[[str], Any] = str,
                  doc: str = "") -> Knob:
    k = Knob(name, default, parse, doc)
    ENV_KNOBS[name] = k
    return k


def knob(name: str) -> Any:
    """Read one registered knob (KeyError on unregistered names — typos
    fail loudly instead of silently defaulting)."""
    return ENV_KNOBS[name].read()


def knobs_table() -> str:
    """Human-readable registry dump (the --knobs CLI payload): name,
    default, current value (* when the env overrides), doc."""
    rows = [("KNOB", "DEFAULT", "CURRENT", "DOC")]
    for k in sorted(ENV_KNOBS.values(), key=lambda k: k.name):
        cur = k.read()
        mark = "*" if os.environ.get(k.name) is not None else ""
        rows.append((k.name, k.default, f"{cur}{mark}", k.doc))
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    w2 = max(len(r[2]) for r in rows)
    return "\n".join(f"{r[0]:<{w0}}  {r[1]:<{w1}}  {r[2]:<{w2}}  {r[3]}"
                     for r in rows)


# --- observability ---
register_knob("TRACE", "on",
              lambda s: s.lower() not in ("off", "0", ""),
              "request-trace recorder enable (obs/trace.py)")
register_knob("TRACE_CAPACITY", "8192", int,
              "span-ring capacity of the process-default TraceRecorder")

# --- control plane: SLO classes (serve/control.py) ---
def _slo_class(s: str) -> str:
    v = s.strip().lower()
    if v not in ("interactive", "batch"):
        raise ValueError(f"expected interactive|batch, got {s!r}")
    return v


register_knob("SLO_CLASS_DEFAULT", "interactive", _slo_class,
              "SLO class assumed when a request names none "
              "(X-SLO-Class header / 'slo_class' body field): "
              "interactive | batch")
register_knob("SLO_BATCH_RESUME_TIMEOUT_S", "0",
              lambda s: float(s) if s.strip() else 0.0,
              "max seconds a preemption-requeued batch request may wait "
              "for re-admission before an explicit "
              "ShedError(preempted_batch_timeout); 0 = never (resumed "
              "batch waits out any interactive burst, lossless)")


ACTIVATIONS = (
    "relu", "gelu", "swish", "mish", "silu", "selu", "celu", "elu",
    "glu", "sigmoid", "lrelu", "tanh", "swiglu",
)

ATTENTION_KINDS = ("mha", "mqa", "gqa", "mla")
POS_EMB_KINDS = ("learn", "sin", "rope")

@dataclass(frozen=True)
class LLMConfig:
    """Model hyperparameters, field-for-field the reference package's
    `LLMConfig`. The port's serving slice runs the dense mha/mqa/gqa
    family; MoE, MLA, the loss and the pipeline fields are carried so one
    config value describes a model to both packages."""

    # token params
    vocab_size: int = 50304
    block_size: int = 1024
    n_embd: int = 256
    pos_emb: str = "rope"  # Literal['learn','sin','rope']

    # feed-forward network
    up_dim: int = 384
    non_linearity: str = "swiglu"  # see ACTIVATIONS
    dropout: float = 0.0
    n_layer: int = 6

    # MoE (DeepSeekMoE; reference single-gpu/model.py:409-506)
    moe: bool = False
    n_exp: int = 16
    n_shared: int = 2
    n_act: int = 8          # INCLUDES the shared experts
    coeff: float = 0.01     # classic aux-loss coefficient
    aux_free: bool = True   # aux-loss-free balancing (bias-based)
    alpha: float = 1e-4     # complementary seq-wise aux loss coeff
    gamma: float = 1e-3     # bias update speed
    # routed-expert dispatch: 'dense' | 'scatter' | 'grouped'
    moe_impl: str = "dense"
    capacity_factor: float = 2.0  # scatter: per-expert slots = cf * N*k/E

    # attention
    attn: str = "gqa"  # Literal['mha','mqa','gqa','mla']
    n_head: int = 8
    n_kv_heads: int = 4
    # MLA only (defaults match reference ModelConfig, train.py:128-131, so
    # `--attn mla` works out of the box):
    q_latent_dim: Optional[int] = 32
    kv_latent_dim: Optional[int] = 32
    rope_head_dim: Optional[int] = 16

    # activation recomputation: 'block' (whole blocks) | 'attn' (the
    # attention sublayer only)
    act_recomp: bool = False
    act_recomp_policy: str = "block"  # 'block' | 'attn'

    # loss path ('fused' | 'pallas' | 'unchunked') and its T-chunk size
    loss_impl: str = "fused"
    loss_chunk: int = 0

    # pipeline parallelism: stages, microbatches (0 = auto), schedule
    # ('auto' | 'carry' | '1f1b') and virtual chunks per stage (0 = auto)
    pp_stages: int = 1
    pp_microbatches: int = 0
    pp_schedule: str = "auto"  # 'auto' | 'carry' | '1f1b'
    pp_vpp: int = 0

    def __post_init__(self):
        # Cross-field normalization, mirroring reference
        # single-gpu/train.py:198-206 (mha -> n_kv_heads=n_head, mqa -> 1,
        # mla requires latent dims; rope-mla additionally rope_head_dim).
        if self.attn == "mha":
            object.__setattr__(self, "n_kv_heads", self.n_head)
        elif self.attn == "mqa":
            object.__setattr__(self, "n_kv_heads", 1)
        elif self.attn == "gqa":
            assert self.n_head % self.n_kv_heads == 0, \
                "n_head must be divisible by n_kv_heads"
        elif self.attn == "mla":
            assert self.q_latent_dim is not None and self.kv_latent_dim is not None, \
                "Either q_latent_dim or kv_latent_dim is missing"
            if self.pos_emb == "rope":
                assert self.rope_head_dim is not None, "Need dim of Rotary heads"
        else:
            raise ValueError(f"unknown attention kind {self.attn!r}")
        assert self.n_embd % self.n_head == 0, "n_embd must be divisible by n_head"
        assert self.pos_emb in POS_EMB_KINDS, f"unknown pos_emb {self.pos_emb!r}"
        assert self.non_linearity.lower() in ACTIVATIONS, \
            f"unknown non_linearity {self.non_linearity!r}"
        if self.moe:
            assert self.n_act > self.n_shared, \
                "Number of active experts must be greater than shared experts"
            assert self.n_exp > self.n_shared
            assert self.n_act <= self.n_exp, \
                "n_act (which includes shared experts) cannot exceed n_exp"
        assert self.moe_impl in ("dense", "scatter", "grouped"), \
            f"unknown moe_impl {self.moe_impl!r}"
        assert self.capacity_factor > 0
        assert self.act_recomp_policy in ("block", "attn"), \
            f"unknown act_recomp_policy {self.act_recomp_policy!r}"
        assert self.loss_impl in ("fused", "unchunked", "pallas"), \
            f"unknown loss_impl {self.loss_impl!r}"
        if self.loss_chunk > 0:
            # a non-dividing chunk would silently fall back to the
            # full-logits path — fail loudly at config time instead
            assert self.block_size % self.loss_chunk == 0, (
                f"loss_chunk {self.loss_chunk} must divide block_size "
                f"{self.block_size}")
        if self.pp_stages > 1:
            assert self.n_layer % self.pp_stages == 0, (
                f"pp_stages {self.pp_stages} must divide n_layer "
                f"{self.n_layer}")
        assert self.pp_schedule in ("auto", "carry", "1f1b"), \
            f"unknown pp_schedule {self.pp_schedule!r}"
        assert self.pp_vpp >= 0, "pp_vpp must be >= 0 (0 = auto)"
        if self.pp_vpp > 0 and self.pp_stages > 1:
            assert self.n_layer % (self.pp_stages * self.pp_vpp) == 0, (
                f"pp_stages*pp_vpp {self.pp_stages * self.pp_vpp} must "
                f"divide n_layer {self.n_layer}")

    @property
    def head_size(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_routed(self) -> int:
        return self.n_exp - self.n_shared

    @property
    def n_act_routed(self) -> int:
        return self.n_act - self.n_shared


def flagship_gpt124m(**overrides) -> "LLMConfig":
    """The headline GPT-2-124M-class model: 12 layers, width 768, 12-head
    MHA, RoPE, swiglu, vocab 50304, block_size 1024.

    up_dim is 2048, not GPT-2's 3072: with the gated swiglu FFN the fused
    up projection is (C, 2*up_dim), so 2048 reproduces exactly GPT-2's
    4.7M FFN params/layer (the standard 2/3 scaling) and the model is a
    true ~124M."""
    base = dict(vocab_size=50304, block_size=1024, n_embd=768, n_head=12,
                n_kv_heads=12, attn="mha", n_layer=12, up_dim=2048,
                non_linearity="swiglu", pos_emb="rope")
    base.update(overrides)
    return LLMConfig(**base)


def _gpt2_preset(width: int, depth: int, heads: int, up: int,
                 **overrides) -> "LLMConfig":
    base = dict(vocab_size=50304, block_size=1024, n_embd=width,
                n_head=heads, n_kv_heads=heads, attn="mha",
                n_layer=depth, up_dim=up, non_linearity="swiglu",
                pos_emb="rope")
    base.update(overrides)
    return LLMConfig(**base)


def gpt2_350m(**overrides) -> "LLMConfig":
    """GPT-2 medium class (~351M with the gated-FFN 2/3 scaling:
    up_dim 2688 ~= 8*1024/3 rounded to a lane multiple, reproducing
    GPT-2's 8*C^2 FFN params/layer like flagship_gpt124m does)."""
    return _gpt2_preset(1024, 24, 16, 2688, **overrides)


def gpt2_774m(**overrides) -> "LLMConfig":
    """GPT-2 large class (~769M; up_dim 3392 ~= 8*1280/3)."""
    return _gpt2_preset(1280, 36, 20, 3392, **overrides)


def gpt2_1p5b(**overrides) -> "LLMConfig":
    """GPT-2 XL class (~1.55B; up_dim 4224 ~= 8*1600/3; 25 heads of 64 as
    in GPT-2 XL)."""
    return _gpt2_preset(1600, 48, 25, 4224, **overrides)


def gpt2_7b(**overrides) -> "LLMConfig":
    """~6.7B Llama-7B-class rung (up_dim 10880 ~= 8*4096/3 rounded to a
    lane multiple; 32 heads of 128)."""
    return _gpt2_preset(4096, 32, 32, 10880, **overrides)


# name -> factory
PRESETS = {
    "gpt2_124m": flagship_gpt124m,
    "gpt2_350m": gpt2_350m,
    "gpt2_774m": gpt2_774m,
    "gpt2_1p5b": gpt2_1p5b,
    "gpt2_7b": gpt2_7b,
}

