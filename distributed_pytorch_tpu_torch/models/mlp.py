"""Dense feed-forward layer.

Counterpart of the reference package's `models/mlp.py` `MLP`/`mlp_apply`:
bias-free up/down projections stored as bare (in, out) parameters
`c_fc` (C, fc_out) and `c_proj` (up, C), as the reference stores them;
gated variants ('swiglu'/'glu') split ONE fused (C, 2*up) product in half
with the gate FIRST. The weights are cast to the activations' dtype at use
(fp32 masters under bf16 compute); in training mode with `config.dropout >
0` the output takes residual dropout keyed on `dropout_seed`. Under an
active quantized-weight store (the engine's decode forwards, ops/quant.py)
both products read int8 codes with a scale per output column, applied
before the gating split (exact: the scale is per column of the fused
product). `MoE` waits for its slice.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.ops.dropout import dropout
from distributed_pytorch_tpu_torch.ops.quant import maybe_quantized_matmul


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = name.lower()
    table = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "swish": F.silu,
        "silu": F.silu,
        "mish": F.mish,
        "selu": F.selu,
        "celu": F.celu,
        "elu": F.elu,
        "sigmoid": torch.sigmoid,
        "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "tanh": torch.tanh,
    }
    return table.get(name, lambda x: F.gelu(x, approximate="none"))


def _is_gated(name: str) -> bool:
    return name.lower() in ("swiglu", "glu")


def mlp_apply(x: torch.Tensor, w_fc: torch.Tensor, w_proj: torch.Tensor,
              non_linearity: str, qnames=None) -> torch.Tensor:
    """Apply one MLP given its (in, out) weights. Gated variants: w_fc is
    (C, 2*up_dim), split in half, h = act(x1) * x2. `qnames` (fc name,
    proj name) offers both products to the active quantized store."""
    fc_name, proj_name = qnames or (None, None)
    h = maybe_quantized_matmul(x, fc_name)
    if h is None:
        h = x @ w_fc
    if _is_gated(non_linearity):
        x1, x2 = h.chunk(2, dim=-1)
        gate = F.silu(x1) if non_linearity.lower() == "swiglu" \
            else torch.sigmoid(x1)
        h = gate * x2
    else:
        h = _activation(non_linearity)(h)
    y = maybe_quantized_matmul(h, proj_name)
    return h @ w_proj if y is None else y


class MLP(nn.Module):
    """Dense feed-forward block; weights in the model's compute dtype."""

    def __init__(self, config: LLMConfig, *, device=None, dtype=None):
        super().__init__()
        C, up = config.n_embd, config.up_dim
        fc_out = 2 * up if _is_gated(config.non_linearity) else up
        self.non_linearity = config.non_linearity
        self.dropout = config.dropout
        self.c_fc = nn.Parameter(torch.empty(C, fc_out, device=device,
                                             dtype=dtype))
        self.c_proj = nn.Parameter(torch.empty(up, C, device=device,
                                               dtype=dtype))

    def forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        name = getattr(self, "qname", None)
        y = mlp_apply(x, self.c_fc.to(x.dtype), self.c_proj.to(x.dtype),
                      self.non_linearity,
                      name and (name + ".c_fc", name + ".c_proj"))
        if self.training and self.dropout > 0.0:
            y = dropout(y, self.dropout, dropout_seed)
        return y
