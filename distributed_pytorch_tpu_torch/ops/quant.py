"""Symmetric int8 quantization for serving: the KV cache and weight-only
int8 matmuls.

Counterpart of the reference package's `ops/quant.py`, with its arithmetic
kept exactly (the CPU tests hold the codes bit for bit):

* `quantize_int8`: scale = amax / 127 over the reduced dims, inv =
  1 / max(scale, 1e-30) where the scale is > 0 and 0 elsewhere, codes =
  round-half-to-even(x * inv) clipped to +-127 (the -128 code is unused,
  so dequantization is a plain scale multiply). All-zero groups get scale
  0 and codes 0.
* **int8 KV cache**: `quantize_kv` turns each new K/V row (B, T, nkv, hs)
  into int8 codes and one fp32 scale per (row, kv head), (B, T, nkv, 1),
  written beside the codes by the same row writes (models/attention.py).
  The decode and chunk-prefill kernels read the codes and fold the row
  scales into the scores and probabilities (ops/flash_decode.py); every
  other cached path dequantizes up front (ops/attention_core.py).
* **weight-only int8**: `quantize_params` maps each matmul weight of the
  blocks (attention `c_attn`/`c_proj`, MLA's eight bare (in, out)
  matrices `W_dq, W_uq, W_dkv, W_uk, W_uv, W_o, W_qr, W_kr`, the MLP's
  fused `c_fc` and its `c_proj`) and the tied (V, C) embedding to int8
  codes with one fp32 scale per output channel, keyed by the parameter's
  name in the model. The engine enters `use_quantized_params(store)`
  around its DECODE forwards only; there the call sites ask
  `maybe_quantized_matmul` first and compute `(x @ codes) * scale`
  (prefill keeps the original weights); MLA's absorbed decode reads
  W_uk / W_uv reshaped per head, so it asks `maybe_dequantized_param`.

Both are chosen by the caller alone (the engine's `cache_dtype=` and
`quantize_weights=`). `quant_kv_usable` declines MLA's latent cache, which
falls back to the compute dtype.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional

import torch

# int8 symmetric range: +-127
_Q_MAX = 127.0


def quant_kv_usable(cfg) -> bool:
    """int8 KV serves the GQA family (mha/mqa/gqa), whose cache rows are
    per-head vectors a row scale covers; MLA's latent cache declines and
    callers keep the compute dtype."""
    return getattr(cfg, "attn", None) in ("mha", "mqa", "gqa")


# ---------------------------------------------------------------------------
# core quantize / dequantize
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor, dim) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over `dim` (kept as size-1 dims): (int8 codes, fp32
    scale) with codes * scale ~ x."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax / _Q_MAX
    inv = torch.where(scale > 0, 1.0 / scale.clamp_min(1e-30),
                      torch.zeros_like(scale))
    codes = torch.round(xf * inv).clamp(-_Q_MAX, _Q_MAX).to(torch.int8)
    return codes, scale


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """New K/V rows (B, T, nkv, hs) -> int8 codes and per-(row, kv head)
    scales (B, T, nkv, 1)."""
    return quantize_int8(x, dim=-1)


# ---------------------------------------------------------------------------
# weight-only int8
# ---------------------------------------------------------------------------

#: MLA's bare (in, out) projections (reference `_KERNEL_NAMES`)
MLA_WEIGHTS = frozenset(("W_dq", "W_uq", "W_dkv", "W_uk", "W_uv", "W_o",
                         "W_qr", "W_kr"))

def _quant_dim(name: str, t: torch.Tensor) -> Optional[int]:
    """The reduced dim of one parameter, or None when it stays as it is.
    `nn.Linear` weights (out, in) and the (V, C) embedding reduce over
    dim 1 (a scale per output row / vocab row); the MLP's and MLA's bare
    (in, out) matrices over dim 0 (a scale per output column)."""
    if t.dim() != 2:
        return None
    parts = name.split(".")
    if name == "tkn_emb.weight":
        return 1
    if parts[0] != "blocks":
        return None
    if parts[-3:-1] in (["attn", "c_attn"], ["attn", "c_proj"]) \
            and parts[-1] == "weight":
        return 1
    if parts[-2] == "mlp" and parts[-1] in ("c_fc", "c_proj"):
        return 0
    if parts[-2] == "attn" and parts[-1] in MLA_WEIGHTS:
        return 0
    return None


def quantize_params(params: Mapping[str, torch.Tensor]) -> dict:
    """{name: tensor} (e.g. `dict(model.named_parameters())`) -> {name:
    {'q8': int8 codes, 'scale': fp32 scale}} for every eligible matmul
    weight; biases, norms and positional tables do not appear."""
    out = {}
    with torch.no_grad():
        for name, t in params.items():
            dim = _quant_dim(name, t)
            if dim is not None:
                codes, scale = quantize_int8(t, dim=dim)
                out[name] = {"q8": codes, "scale": scale}
    return out


# ---------------------------------------------------------------------------
# the active store (the engine's decode forwards run inside it)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mapping] = None


@contextlib.contextmanager
def use_quantized_params(store: Optional[Mapping]):
    """Make a quantized-weight store visible to the matmul call sites for
    the duration of the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = store or None
    try:
        yield
    finally:
        _ACTIVE = prev


def maybe_quantized_matmul(x: torch.Tensor, name: Optional[str], *,
                           transpose_b: bool = False
                           ) -> Optional[torch.Tensor]:
    """`x @ W` (`x @ W.T` with `transpose_b`: `nn.Linear` weights and the
    tied head) from the active store, or None when no store is active or
    `name` has no entry (the caller keeps its own matmul). The codes cast
    to x's dtype, the per-output-channel scale multiplies the fp32 product,
    the result is cast back to x's dtype."""
    if _ACTIVE is None or name is None:
        return None
    entry = _ACTIVE.get(name)
    if entry is None:
        return None
    w = entry["q8"].to(x.dtype)
    y = x @ (w.t() if transpose_b else w)
    return (y.float() * entry["scale"].reshape(-1)).to(x.dtype)


def maybe_dequantized_param(name: Optional[str], fallback: torch.Tensor,
                            dtype=None) -> torch.Tensor:
    """The active store's weight `name` dequantized (to `dtype`, default
    the fallback's), else `fallback` as it is: for call sites that
    contract a weight in a reshaped form (MLA's absorbed W_uk / W_uv),
    where the scale does not fold into the product's output."""
    if _ACTIVE is None or name is None:
        return fallback
    entry = _ACTIVE.get(name)
    if entry is None:
        return fallback
    return dequantize_int8(entry["q8"], entry["scale"],
                           dtype or fallback.dtype)
