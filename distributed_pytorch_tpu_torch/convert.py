"""Convert the reference package's flax parameters into the port's
weights.

`params_from_jax(params, cfg)` takes the flax param tree (`variables
["params"]`) as nested dicts of numpy arrays — `jax.device_get` output
works, and so does anything else with the same keys — and returns a
`state_dict` for `models.gpt.LLM` (fp32 torch tensors; `load_state_dict`
casts to the model's dtypes). Flax dense kernels are (in, out) while
`nn.Linear` stores (out, in), so `c_attn`/`c_proj` kernels transpose; the
MLP's bare (in, out) matrices and the (V, C) embedding carry over as they
are. The fused qkv keeps its [q | k | v] column order.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_pytorch_tpu_torch.config import LLMConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(params: dict, cfg: LLMConfig) -> dict:
    """Map the flax tree {tkn_emb, [pos_emb], block_i/{ln1, ln2, attn/
    {c_attn, c_proj}, mlp/{c_fc, c_proj}}, ln_f} onto `LLM`'s names."""
    if cfg.attn not in ("mha", "mqa", "gqa") or cfg.moe:
        raise NotImplementedError("the port converts the dense mha/mqa/gqa "
                                  "family")
    sd = {"tkn_emb.weight": _t(params["tkn_emb"]["embedding"]),
          "ln_f.weight": _t(params["ln_f"]["scale"]),
          "ln_f.bias": _t(params["ln_f"]["bias"])}
    if cfg.pos_emb == "learn":
        sd["pos_emb"] = _t(params["pos_emb"])
    for i in range(cfg.n_layer):
        b = params[f"block_{i}"]
        pre = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[pre + ln + ".weight"] = _t(b[ln]["scale"])
            sd[pre + ln + ".bias"] = _t(b[ln]["bias"])
        for lin in ("c_attn", "c_proj"):
            sd[pre + f"attn.{lin}.weight"] = _t(b["attn"][lin]["kernel"]).t() \
                .contiguous()
            sd[pre + f"attn.{lin}.bias"] = _t(b["attn"][lin]["bias"])
        sd[pre + "mlp.c_fc"] = _t(b["mlp"]["c_fc"])
        sd[pre + "mlp.c_proj"] = _t(b["mlp"]["c_proj"])
    return sd
