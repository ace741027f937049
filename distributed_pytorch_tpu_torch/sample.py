"""Sampling CLI: `python -m distributed_pytorch_tpu_torch.sample --ckpt <dir>`.

Counterpart of the reference package's `sample.py`: load a checkpoint the
trainer wrote (`--save_model`, `--ckpt_interval`, or a preemption save),
tokenize a prompt, decode. Tokenization uses tiktoken's GPT-2 BPE when it
is installed; otherwise the prompt is comma-separated token ids and the
output is printed as ids.

The model is built in the serving dtype (the checkpoint's compute dtype,
or `--cache-dtype bfloat16|float32`) from the checkpoint's configs, on the
card unless `--cpu` is given. Decoding runs `models/generate.py:generate`
(the flash forward for the prompt, the contiguous-cache decode kernel per
step); `--cache-dtype`, `--quant-weights` and `--prefill-chunk N` route it
through the `DecodeEngine` instead (paged kernels; an int8 cache through
the `_q8` kernels; weight-only int8 decode; chunked prefill), one slot per
sample, as in the reference. An MLA checkpoint takes the same paths, with
no kernel: its cached attention is the absorbed einsums over the latent
cache (models/attention.py). Refused, naming the slice that brings it:
`--shard` (slice 6).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch


def _encoder():
    try:
        import tiktoken
        return tiktoken.get_encoding("gpt2")
    except Exception:  # noqa: BLE001 — no tokenizer: token-id prompts
        return None


def load_for_inference(ckpt: str, *, device=None, dtype=None,
                       shard: bool = False, log=print):
    """Restore a trainer checkpoint for decoding; shared by this CLI and
    the serving front-end (`python -m distributed_pytorch_tpu_torch.serve
    --ckpt`). `ckpt` is a step dir or a run root (its newest complete
    step is used). The model is built with the checkpoint's configs in
    `dtype` (default: its compute dtype) on `device` (default: the card)
    and gets the weights alone (checkpoint.restore_for_inference).

    Returns `(model, model_cfg, train_cfg, step, weights_version)`;
    `weights_version` is the step dir's identity (`step_N-<manifest digest
    prefix>`, None for a dir without a manifest), which the serving
    front-end puts on /metrics and on every completion payload."""
    from distributed_pytorch_tpu_torch import resolve_device
    from distributed_pytorch_tpu_torch.models.gpt import LLM
    from distributed_pytorch_tpu_torch.train import checkpoint as ckpt_mod

    if shard:
        raise NotImplementedError("--shard (a sharded restore in the "
                                  "training recipe's layout) comes with "
                                  "slice 6 (parallel recipes)")
    path = ckpt
    if not os.path.exists(os.path.join(path, "config.json")):
        last = ckpt_mod.latest_step_dir(path)
        if last is None:
            raise FileNotFoundError(f"no checkpoint found under {path}")
        path = last
    model_cfg, train_cfg, step = ckpt_mod.load_configs(path)
    if model_cfg.pp_stages > 1:
        # a pp checkpoint holds the single model's tensors; decoding runs
        # the blocks in order (reference sample.py:97-110)
        model_cfg = dataclasses.replace(model_cfg, pp_stages=1,
                                        pp_microbatches=0)
        log("pp checkpoint: decoding with pp_stages=1")
    weights_version = ckpt_mod.weights_version(path)
    log(f"loaded config from {path} (step {step}): "
        f"{model_cfg.n_layer}L/{model_cfg.n_embd}d {model_cfg.attn}"
        + (f" [{weights_version}]" if weights_version else ""))
    dtype = dtype or getattr(torch, train_cfg.compute_dtype)
    model = LLM(model_cfg, device=resolve_device(device), dtype=dtype,
                attn_impl=train_cfg.attn_impl)
    ckpt_mod.restore_for_inference(path, model)
    model.eval()
    return model, model_cfg, train_cfg, step, weights_version


def build_args(argv=None):
    p = argparse.ArgumentParser(description="Sample from a trained checkpoint")
    p.add_argument("--ckpt", type=str, required=True,
                   help="checkpoint dir (checkpoints/<name>/step_N or the "
                        "<name> root, in which case the newest step is used)")
    p.add_argument("--prompt", type=str, default="\n",
                   help="text prompt (or comma-separated token ids when no "
                        "tokenizer is available)")
    p.add_argument("--max_new_tokens", type=int, default=200)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=50)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--seed", type=int, default=1729)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--shard", action="store_true",
                   help="sharded restore (slice 6; refused)")
    p.add_argument("--cache-dtype", "--cache_dtype", dest="cache_dtype",
                   default="", choices=["", "int8", "bfloat16", "float32"],
                   help="KV-cache dtype (bfloat16/float32: the model's "
                        "too; int8: int8 codes with fp32 row scales); "
                        "routes decoding through the DecodeEngine")
    p.add_argument("--quant-weights", "--quant_weights",
                   dest="quant_weights", action="store_true",
                   help="weight-only int8 decode (through the "
                        "DecodeEngine)")
    p.add_argument("--prefill-chunk", "--prefill_chunk",
                   dest="prefill_chunk", type=int, default=0,
                   help="chunked prefill of N tokens a step (a multiple "
                        "of the engine's KV block, 16; through the "
                        "DecodeEngine)")
    return p.parse_args(argv)


def main(argv=None) -> list[list[int]]:
    """Decode and print; returns each sample's tokens (prompt included)."""
    args = build_args(argv)
    dtype = getattr(torch, args.cache_dtype) \
        if args.cache_dtype not in ("", "int8") else None
    model, model_cfg, _, _, _ = load_for_inference(
        args.ckpt, device="cpu" if args.cpu else None, dtype=dtype,
        shard=args.shard)

    enc = _encoder()
    if enc is not None:
        ids = enc.encode(args.prompt, allowed_special="all")
    else:
        ids = [int(t) for t in args.prompt.split(",") if t.strip()]
        ids = ids or [0]
    ids = ids[-model_cfg.block_size:]
    n_new = args.num_samples * args.max_new_tokens

    t0 = time.perf_counter()
    if args.cache_dtype or args.quant_weights or args.prefill_chunk:
        # one slot per sample, continuous batching degenerate to one wave
        from distributed_pytorch_tpu_torch.engine import DecodeEngine
        eng = DecodeEngine(model, n_slots=args.num_samples,
                           cache_dtype=args.cache_dtype or None,
                           quantize_weights=args.quant_weights,
                           temperature=args.temperature, top_k=args.top_k,
                           seed=args.seed,
                           prefill_chunk=args.prefill_chunk)
        outs = eng.run([ids] * args.num_samples, args.max_new_tokens)
        route = (f"engine, cache={str(eng.cache_dtype).removeprefix('torch.')}"
                 f" quant_w={eng.weights_quantized} "
                 f"prefill_chunk={eng.prefill_chunk or 'wave'}")
    else:
        from distributed_pytorch_tpu_torch.models.generate import generate
        gen = torch.Generator(device=model.device)
        gen.manual_seed(args.seed)
        out = generate(model, [ids] * args.num_samples, args.max_new_tokens,
                       generator=gen, temperature=args.temperature,
                       top_k=args.top_k)
        outs = out.tolist()
        route = f"generate, cache={str(model.dtype).removeprefix('torch.')}"
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    print(f"decode: {n_new} tokens in {dt:.2f}s ({n_new / dt:.1f} tok/s; "
          f"{route})")
    for toks in outs:
        print("-" * 40)
        print(enc.decode(toks) if enc is not None else toks)
    return outs


if __name__ == "__main__":
    main()
