"""Where a parallel train step's time goes, on every rank.

Run under torch.distributed.run with the trainer's flags: each rank builds
the state of `--parallelism` (and `--tp_size`, `--sp_size`, `--pp_size`,
which sets the model's `pp_stages` as the trainer does: its rows and
positions are the trainer's loader's) as the trainer does, takes
2 steps to warm up, times 3 steps by the host clock (ending in a
synchronize), then profiles 2 steps with torch.profiler and prints one
JSON line: host wall and device kernel time a step, the compute
kernels' busy share of the wall (NCCL's stream aside, whose kernels
overlap the compute), and the
kernels' time a step split into NCCL point-to-point
sends and receives (a pipeline's), other NCCL collectives (their time
includes waiting for the other ranks), flash attention, the fused CE
kernels, the grouped-matmul kernels, cuBLAS matmuls and everything else,
with the top kernels.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m distributed_pytorch_tpu_torch.bench.step_profile \\
        --preset gpt2_124m --parallelism tp --tp_size 2 ...

The data is the trainer's synthetic set under `--data_dir`.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


KINDS = ("nccl_sendrecv", "nccl", "flash", "ce", "grouped", "matmul",
         "other")


def split(prof, n: int) -> dict:
    """Device kernel ms a step by kind, and the top 8 kernels."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.key_averages()
          if e.device_type != DeviceType.CPU and _dev_us(e) > 0
          and not getattr(e, "is_user_annotation", False)]
    out = dict.fromkeys(KINDS, 0.0)
    for e in ev:
        k = e.key.lower()
        kind = ("nccl_sendrecv" if "nccl" in k and "sendrecv" in k else
                "nccl" if "nccl" in k else
                "ce" if "fce::" in k else
                "grouped" if "gmm::" in k or "gmm_kernel" in k else
                "flash" if "flash" in k or "kernel_sm90" in k else
                "matmul" if any(m in k for m in ("gemm", "nvjet", "xmma",
                                                 "cutlass")) else "other")
        out[kind] += _dev_us(e) / n / 1e3
    out["top"] = [f"{_dev_us(e) / n / 1e3:.3f} ms {e.count // n}x "
                  f"{e.key[:70]}"
                  for e in sorted(ev, key=_dev_us, reverse=True)[:8]]
    return out


def main(argv=None) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.data.loader import DataLoader
    from distributed_pytorch_tpu_torch.models import pipeline as pipe_mod
    from distributed_pytorch_tpu_torch.parallel import context, sharding
    from distributed_pytorch_tpu_torch.parallel.mesh import close_world
    from distributed_pytorch_tpu_torch.train.loop import (data_paths,
                                                          make_world)
    from distributed_pytorch_tpu_torch.train.state import create_train_state
    from distributed_pytorch_tpu_torch.train.step import make_train_step

    model_cfg, tc = parse_train_argv(sys.argv[1:] if argv is None else argv)
    tc = dataclasses.replace(tc, parallelism=sharding.tp_recipe(
        tc.parallelism, tc.tp_size, tc.ep_size, tc.pp_size))
    model_cfg = dataclasses.replace(model_cfg, pp_stages=tc.pp_size)
    world = make_world(model_cfg, tc)
    try:
        with context.use_world(world):
            B, T = tc.batch_size, model_cfg.block_size
            if world.is_main:
                data_paths(tc, model_cfg.vocab_size)
            context.barrier()
            loader = DataLoader(
                data_paths(tc, model_cfg.vocab_size)[0], B, T,
                grad_accum=tc.total_batch_size // (B * world.dp * T),
                seed=tc.seed, device=world.device, rank=world.data_rank,
                world=world.dp, seq_rank=world.seq_rank, sp=world.sp,
                layout=world.seq_layout,
                microbatches=pipe_mod.n_microbatches(model_cfg, B, world.dp)
                if world.pp > 1 else 1)
            state = create_train_state(model_cfg, tc, world.device, world)
            step = make_train_step(tc)
            cuda = world.device.type == "cuda"
            sync = torch.cuda.synchronize if cuda else (lambda: None)
            x, y = loader.next_batch(step=0)
            for _ in range(2):
                step(state, x, y)
            sync()
            n = 3
            t0 = time.perf_counter()
            for _ in range(n):
                step(state, x, y)
            sync()
            wall = (time.perf_counter() - t0) / n * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    step(state, x, y)
                sync()
            s = split(prof, 2)
            dev = sum(s[k] for k in KINDS)
            # NCCL kernels run on their own stream beside the compute (a
            # pipeline's SendRecv waits out most of a step), so the
            # device sum can pass the wall; the compute kernels' cannot
            comp = dev - s["nccl_sendrecv"] - s["nccl"]
            print(json.dumps({
                "rank": world.rank, "recipe": tc.parallelism, "tp": world.tp,
                "sp": world.sp, "pp": world.pp, "stage": world.pipe_rank,
                "data": world.dp, "micro_steps": x.shape[0],
                "host_wall_ms": wall, "device_ms": dev, "compute_ms": comp,
                "compute_busy": comp / wall, **s,
                "device": torch.cuda.get_device_name(world.device)
                if cuda else "cpu"}),
                flush=True)
    finally:
        close_world(world)


if __name__ == "__main__":
    main()
