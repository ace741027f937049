"""Convert the reference package's flax parameters into the port's
weights.

`params_from_jax(params, cfg)` takes the flax param tree (`variables
["params"]`) as nested dicts of numpy arrays — `jax.device_get` output
works, and so does anything else with the same keys — and returns a
`state_dict` for `models.gpt.LLM` (fp32 torch tensors; `load_state_dict`
casts to the model's dtypes). Flax dense kernels are (in, out) while
`nn.Linear` stores (out, in), so `c_attn`/`c_proj` kernels transpose; MLA's
bare (in, out) projections (`W_dq` ... `W_kr`), the MLP's bare (in, out)
matrices, the MoE layer's stacked (n_exp, in, out)
expert weights and (C, n_routed) router, and the (V, C) embedding carry
over as they are. The fused qkv keeps its [q | k | v] column order. The
MoE routing state (the reference's `moe_state` collection: `expert_bias`
and `dropped_frac` per layer) maps onto the MoE layers' buffers; without
it they keep their zero initial values. A pipeline-parallel tree (the
reference's pp init, blocks stacked as {'blocks': {'stack': ...}} in the
params and in `moe_state`) is unstacked first, so a pp run's state maps
onto the single model's names; a pipeline stage takes its slice of that
(models/pipeline.py `stage_state_dict`).
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_pytorch_tpu_torch.config import LLMConfig
from distributed_pytorch_tpu_torch.models.pipeline import \
    unstack_block_params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(params: dict, cfg: LLMConfig,
                    moe_state: dict | None = None) -> dict:
    """Map the flax tree {tkn_emb, [pos_emb], block_i/{ln1, ln2, attn/
    {c_attn, c_proj} or attn/{W_dq, W_uq, W_dkv, W_uk, W_uv, W_o[, W_qr,
    W_kr]}, mlp/{c_fc, c_proj} or moe/{experts_fc, experts_proj, gate}},
    ln_f} and the optional `moe_state` tree {block_i/moe/{expert_bias,
    dropped_frac}} onto `LLM`'s names; stacked pipeline trees too."""
    if "blocks" in params:
        params = unstack_block_params(params, cfg.n_layer)
    if moe_state and "blocks" in moe_state:
        moe_state = unstack_block_params(moe_state, cfg.n_layer)
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
        if cfg.attn == "mla":
            for name, w in b["attn"].items():
                sd[pre + f"attn.{name}"] = _t(w)
        else:
            for lin in ("c_attn", "c_proj"):
                sd[pre + f"attn.{lin}.weight"] = \
                    _t(b["attn"][lin]["kernel"]).t().contiguous()
                sd[pre + f"attn.{lin}.bias"] = _t(b["attn"][lin]["bias"])
        if not cfg.moe:
            sd[pre + "mlp.c_fc"] = _t(b["mlp"]["c_fc"])
            sd[pre + "mlp.c_proj"] = _t(b["mlp"]["c_proj"])
            continue
        for name in ("experts_fc", "experts_proj", "gate"):
            sd[pre + "moe." + name] = _t(b["moe"][name])
        st = (moe_state or {}).get(f"block_{i}", {}).get("moe", {})
        if cfg.aux_free:
            sd[pre + "moe.expert_bias"] = _t(
                st.get("expert_bias", np.zeros(cfg.n_routed)))
        sd[pre + "moe.dropped_frac"] = _t(st.get("dropped_frac", 0.0))
    return sd
