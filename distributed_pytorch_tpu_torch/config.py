"""Configuration: the model dataclass, the size presets and the env-knob
registry of the PyTorch port.

A copy of the reference package's `config.py` cut to what the serving and
training slices read: `LLMConfig` and `TrainConfig` (field-for-field, so
one config drives both packages and `convert.params_from_jax`), the GPT-2
presets, the trainer CLI (`build_parser`, `configs_from_args`) and the
knobs the copied modules look up. Fields of later slices are carried and
refused where they are read (train/loop.py).
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _onoff(s: str) -> str:
    v = s.strip().lower() or "auto"
    if v not in ("auto", "on", "off"):
        raise ValueError(f"expected auto|on|off, got {s!r}")
    return v


def resolve_gate(mode: str, requested: bool) -> bool:
    """The auto|on|off contract of a feature knob: 'auto' follows the
    caller's explicit request, 'on' and 'off' force it (a bench leg's
    env)."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"gate mode must be auto|on|off, got {mode!r}")
    return requested if mode == "auto" else mode == "on"


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


# --- training (train/step.py, train/loop.py, train/checkpoint.py) ---
register_knob("TRAIN_POISON_IT", "-1", int,
              "NaN-bomb iteration k's loss+grads (anomaly-guard fault "
              "injection, train/step.py)")
register_knob("CKPT_VERIFY", "on",
              lambda s: s.lower() not in ("off", "0", ""),
              "deep blake2b manifest verification on checkpoint restore "
              "(train/checkpoint.py); off = structural checks only")
register_knob("TRAIN_KEEP_CKPTS", "0", int,
              "checkpoint retention: keep the newest K verified step dirs, "
              "prune older ones after each save; 0 = keep everything "
              "(TrainConfig.keep_ckpts overrides when > 0)")

# --- pipeline schedule (models/pipeline.py) ---
register_knob("PP_SCHEDULE", "", lambda s: s.strip().lower(),
              "pipeline schedule override: carry | 1f1b | auto; empty "
              "defers to LLMConfig.pp_schedule (models/pipeline.py)")
register_knob("PP_VPP", "0", lambda s: int(s) if s.strip() else 0,
              "virtual chunks per pipeline stage for the 1f1b schedule; "
              "0 defers to LLMConfig.pp_vpp (0 = auto: n_layer/pp_stages, "
              "i.e. one-layer chunks, the maximally interleaved schedule)")

# --- serving (engine/decode.py) ---
register_knob("SPEC_DECODE", "auto", _onoff,
              "self-speculative decoding gate (engine/decode.py; greedy "
              "engines only — temperature>0 falls back to the plain step)")
register_knob("SPEC_K", "4", lambda s: int(s) if s.strip() else 4,
              "speculative draft length: tokens the n-gram drafter "
              "proposes per step (verify runs K+1 positions)")

# --- kernels (ops/fused_ce.py) ---
register_knob("CE_BLOCK_N", "512", int,
              "fused-CE token tile of the reference's usability gate "
              "(ops/fused_ce.py pallas_ce_usable)")


PARALLELISM_RECIPES = (
    "single", "dp", "zero1", "zero2", "fsdp", "tp", "fsdp_tp", "ep", "sp",
    "pp",
)


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



@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters, field-for-field the reference package's
    `TrainConfig`. The port trains `parallelism` 'single', 'dp', 'zero1',
    'zero2', 'fsdp', 'tp', 'fsdp_tp' (`tp_size` ranks on 'model') and
    'sp' (`sp_size` ranks on 'seq', which dp / zero1 / zero2 / fsdp take
    too) and 'ep' (`ep_size` ranks on 'expert', which fsdp takes too;
    parallel/sharding.py) on CUDA cards, one process each, or on the
    CPU with `platform='cpu'` over gloo; the loop refuses the fields of later
    slices (train/loop.py `check_slice`)."""

    dataset: str = "tinystories"  # shakespeare | tinystories | fineweb | synthetic
    data_dir: str = "data"
    total_batch_size: int = 2 ** 11   # in tokens
    batch_size: int = 2              # micro-batch size (sequences)
    max_iters: int = 2500
    eval: bool = False
    eval_interval: int = 100
    eval_iters: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"         # adamw | lion | adafactor
    save_model: bool = False
    save_stats: bool = True          # persist run stats as <ckpt>/stats.json
    file_name: str = "llm_model"
    act_recomp: bool = False
    seed: int = 1729

    parallelism: str = "single"      # see PARALLELISM_RECIPES
    platform: str = "auto"           # auto | cuda | cpu (the reference:
                                     # auto | tpu | cpu)
    dp_size: int = -1
    tp_size: int = 1
    ep_size: int = 1
    sp_size: int = 1
    pp_size: int = 1
    compute_dtype: str = "bfloat16"  # bf16 compute, fp32 params/opt state
    attn_impl: str = "auto"  # auto | xla | pallas | naive | ring | zigzag | ulysses
    moe_impl: str = "dense"          # 'dense' | 'scatter' | 'grouped'
    overlap: str = "auto"            # auto | on | off
    ckpt_interval: int = 0           # 0 = end-of-run only
    resume: bool = False
    keep_ckpts: int = 0              # keep newest K verified step dirs;
                                     # 0 defers to TRAIN_KEEP_CKPTS
    log_interval: int = 1
    profile: bool = False
    profile_dir: str = ""
    telemetry: bool = True
    metrics_port: int = -1
    anomaly: str = "warn"            # loss/grad guard: 'skip' withholds
                                     # the optimizer update on a NaN/inf
                                     # step, 'warn' records only, 'off'
    offload: str = "auto"            # auto | on | off

    def __post_init__(self):
        assert self.parallelism in PARALLELISM_RECIPES, \
            f"unknown parallelism recipe {self.parallelism!r}"
        assert self.moe_impl in ("dense", "scatter", "grouped"), \
            f"unknown moe_impl {self.moe_impl!r}"
        assert self.attn_impl in ("auto", "xla", "pallas", "naive", "ring",
                                  "zigzag", "ulysses"), \
            f"unknown attn_impl {self.attn_impl!r}"
        assert self.platform in ("auto", "cuda", "cpu"), \
            f"unknown platform {self.platform!r}"
        assert self.overlap in ("auto", "on", "off"), \
            f"unknown overlap mode {self.overlap!r}"
        assert self.optimizer in ("adamw", "lion", "adafactor"), \
            f"unknown optimizer {self.optimizer!r}"
        assert self.anomaly in ("skip", "warn", "off"), \
            f"unknown anomaly mode {self.anomaly!r}"
        assert self.offload in ("auto", "on", "off"), \
            f"unknown offload mode {self.offload!r}"


# ---------------------------------------------------------------------------
# CLI: one flag per dataclass field, routed to whichever config owns it
# ---------------------------------------------------------------------------

_BOOL_FLAGS = {
    "moe", "aux_free", "eval", "save_model", "act_recomp",
    "resume", "profile", "save_stats", "telemetry",
}


def build_parser(model_defaults: LLMConfig | None = None,
                 train_defaults: TrainConfig | None = None
                 ) -> argparse.ArgumentParser:
    """An argparse parser exposing every field of both dataclasses, plus
    `--total_batch_size_str` (an arithmetic expression such as "2**14"),
    `--preset` and `--knobs`."""
    model_defaults = model_defaults or LLMConfig()
    train_defaults = train_defaults or TrainConfig()
    p = argparse.ArgumentParser(
        description="Train an LLM on a CUDA card (PyTorch)")
    seen: set[str] = set()
    for cfg in (train_defaults, model_defaults):
        for f in dataclasses.fields(cfg):
            name = f.name
            if name in seen:  # act_recomp lives in both configs
                continue
            seen.add(name)
            if name == "total_batch_size":
                p.add_argument("--total_batch_size_str", type=str,
                               default=str(train_defaults.total_batch_size),
                               help="Total batch size in tokens, as an "
                                    "arithmetic expression, e.g. '2**14'")
                continue
            default = getattr(cfg, name)
            if name in _BOOL_FLAGS:
                if default:
                    p.add_argument(f"--{name}", default=default,
                                   action=argparse.BooleanOptionalAction)
                else:
                    p.add_argument(f"--{name}", action="store_true",
                                   default=default)
            elif f.type in ("int", "Optional[int]", int):
                p.add_argument(f"--{name}", type=int, default=default)
            elif f.type in ("float", float):
                p.add_argument(f"--{name}", type=float, default=default)
            else:
                p.add_argument(f"--{name}", type=str, default=default)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="model-size preset; explicit flags still override "
                        "its fields")
    p.add_argument("--knobs", action="store_true", default=False,
                   help="print the env-knob registry (name, default, "
                        "current value, doc) and exit")
    return p


def _safe_int_expr(s: str) -> int:
    """Arithmetic-only evaluation of an int expression such as "2**14"."""
    import ast
    node = ast.parse(s, mode="eval")
    allowed = (ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant,
               ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Pow,
               ast.USub, ast.Mod)
    for n in ast.walk(node):
        if not isinstance(n, allowed):
            raise ValueError(f"disallowed expression: {s!r}")
    return int(eval(compile(node, "<total_batch_size_str>", "eval")))  # noqa: S307


def configs_from_args(args: argparse.Namespace,
                      model_defaults: LLMConfig | None = None,
                      train_defaults: TrainConfig | None = None,
                      ) -> tuple[LLMConfig, TrainConfig]:
    """Route parsed flags onto the owning dataclass: strings lowercased
    except `non_linearity` and paths; act_recomp is copied into the model
    config."""
    model_defaults = model_defaults or LLMConfig()
    train_defaults = train_defaults or TrainConfig()
    model_fields = {f.name for f in dataclasses.fields(LLMConfig)}
    train_fields = {f.name for f in dataclasses.fields(TrainConfig)}
    no_lower = {"non_linearity", "file_name", "data_dir", "profile_dir"}
    m_kw, t_kw = {}, {}
    for key, value in vars(args).items():
        if key == "total_batch_size_str":
            t_kw["total_batch_size"] = _safe_int_expr(value)
            continue
        if isinstance(value, str) and key not in no_lower:
            value = value.lower().strip()
        if key in train_fields:
            t_kw[key] = value
        if key in model_fields:
            m_kw[key] = value
    if "act_recomp" in t_kw:
        m_kw["act_recomp"] = t_kw["act_recomp"]
    model = dataclasses.replace(model_defaults, **m_kw)
    train = dataclasses.replace(train_defaults, **t_kw)
    return model, train
