"""Serving CLI: `python -m distributed_pytorch_tpu_torch.serve --preset
gpt2_124m` or `--demo`.

Builds a model (a size preset with seeded N(0, 0.02) weights, or the tiny
`--demo` model), wraps a `DecodeEngine` in the async scheduler, and
serves `POST /v1/completions` (SSE streaming), `/healthz` and `/metrics`
until interrupted. Runs on the CUDA card unless `--cpu` is given; with no
card and no `--cpu` it exits with an error.

Waiting for later slices: `--ckpt`/`--shard` (checkpoint restore),
`--aot-store`, int8 cache and weights, chunked prefill, the host KV tier,
and `POST /admin/profile`.
"""

from __future__ import annotations

import argparse
import asyncio


def build_args(argv=None):
    from distributed_pytorch_tpu_torch.config import PRESETS
    p = argparse.ArgumentParser(
        description="Streaming HTTP serving over the DecodeEngine")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--preset", choices=sorted(PRESETS),
                     help="serve a model preset at full width with seeded "
                          "random weights (token-id prompts only)")
    src.add_argument("--demo", action="store_true",
                     help="serve a tiny random-init model (token-id "
                          "prompts only) — smoke tests")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks an ephemeral port (printed at startup)")
    p.add_argument("--slots", type=int, default=8, help="decode slots")
    p.add_argument("--max-len", "--max_len", dest="max_len", type=int,
                   default=None,
                   help="per-sequence KV capacity (default block_size)")
    p.add_argument("--max-queue", type=int, default=128,
                   help="admission queue bound; overflow is shed as 429")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="default per-request queue-wait deadline")
    p.add_argument("--max-tokens-default", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top_k", "--top-k", dest="top_k", type=int, default=50)
    p.add_argument("--eos-id", type=int, default=None,
                   help="retire sequences on this token (GPT-2: 50256)")
    p.add_argument("--seed", type=int, default=1729,
                   help="seeds the weights and the sampling generator")
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default=None,
                   help="compute and KV-cache dtype (default bfloat16 on "
                        "the card, float32 with --cpu)")
    p.add_argument("--kv-block", "--kv_block", dest="kv_block", type=int,
                   default=None,
                   help="paged-cache block size in KV rows (pow2; "
                        "default 16)")
    p.add_argument("--kv-blocks", "--kv_blocks", dest="kv_blocks", type=int,
                   default=None,
                   help="block-pool size (default: slots x max_len worth "
                        "of blocks)")
    p.add_argument("--no-prefix-cache", dest="prefix_cache",
                   action="store_false",
                   help="disable radix prefix reuse (A/B baseline)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--request-timeout-s", "--request_timeout_s",
                   dest="request_timeout_s", type=float, default=30.0,
                   help="per-connection read timeout while parsing a "
                        "request (stalled clients get 408)")
    p.add_argument("--no-trace", dest="trace", action="store_false",
                   help="disable the request-trace recorder (obs/trace.py"
                        "; spans cost ~µs per REQUEST, so default on)")
    return p.parse_args(argv)


def _demo_config():
    from distributed_pytorch_tpu_torch.config import LLMConfig
    return LLMConfig(vocab_size=1024, block_size=256, n_embd=128, n_head=4,
                     n_kv_heads=4, attn="mha", n_layer=2, up_dim=256,
                     non_linearity="swiglu", pos_emb="rope")


def build_engine(args):
    """Engine spin-up: the model on the card (or the CPU with --cpu), its
    seeded weights, and the DecodeEngine over it. Returns (engine,
    encoder, weights_version, spinup) where `spinup` is the phase record
    list {phase: load, ms}."""
    import time

    import torch

    from distributed_pytorch_tpu_torch import resolve_device
    from distributed_pytorch_tpu_torch.config import PRESETS
    from distributed_pytorch_tpu_torch.engine import DecodeEngine
    from distributed_pytorch_tpu_torch.models.gpt import LLM

    device = resolve_device("cpu" if args.cpu else None)
    dtype = getattr(torch, args.dtype) if args.dtype else (
        torch.bfloat16 if device.type == "cuda" else torch.float32)
    t0 = time.perf_counter()
    if args.demo:
        cfg = _demo_config()
        weights_version = "demo"
        print("demo mode: tiny random-init model, token-id prompts only")
    else:
        cfg = PRESETS[args.preset]()
        weights_version = f"{args.preset}-random-seed{args.seed}"
    model = LLM(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    model.init_weights(gen)
    model.eval()
    spinup = [{"spinup": "weights", "phase": "load",
               "ms": round((time.perf_counter() - t0) * 1e3, 3)}]
    eng = DecodeEngine(model, n_slots=args.slots, max_len=args.max_len,
                       temperature=args.temperature, top_k=args.top_k,
                       eos_id=args.eos_id, seed=args.seed,
                       block_size=args.kv_block, n_blocks=args.kv_blocks,
                       prefix_cache=args.prefix_cache)
    return eng, None, weights_version, spinup


async def _amain(args) -> None:
    from distributed_pytorch_tpu_torch.obs import trace as obs_trace
    from distributed_pytorch_tpu_torch.serve.scheduler import Scheduler
    from distributed_pytorch_tpu_torch.serve.server import ServeApp

    if not args.trace:
        obs_trace.get_recorder().enabled = False

    eng, encoder, weights_version, _ = build_engine(args)
    sched = Scheduler(eng, max_queue=args.max_queue,
                      default_deadline_s=args.deadline_s)
    sched.metrics.set_build_info(
        preset="demo" if args.demo else args.preset, trace=args.trace)
    sched.metrics.set_weights_version(weights_version)
    app = ServeApp(sched, host=args.host, port=args.port, encoder=encoder,
                   default_max_tokens=args.max_tokens_default,
                   request_timeout_s=args.request_timeout_s)
    await sched.start()
    await app.start()
    print(f"serving on http://{args.host}:{app.port} "
          f"(device={eng.device}, slots={args.slots}, "
          f"queue<={args.max_queue}, "
          f"blocks={eng.n_blocks}x{eng.block_size}, "
          f"prefix_cache={eng.prefix_cache})")
    print(f"  curl -N -X POST http://{args.host}:{app.port}/v1/completions "
          "-d '{\"prompt\": [1, 2, 3], \"max_tokens\": 16}'")
    try:
        await app.serve_forever()
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await app.stop()
        await sched.stop()


def main(argv=None) -> None:
    args = build_args(argv)
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        print("\nshutting down")


if __name__ == "__main__":
    main()
