"""A/B timing of the flash kernels (forward, dq, dkv) of two source trees
on one CUDA card, in turns: each turn is its own process that imports the
turn's tree of `distributed_pytorch_tpu_torch` (built from that tree's
csrc), so trees whose C entries differ can be compared. Turns run A, B, B,
A by default, so that a drift of the card over the call shows.

    python distributed_pytorch_tpu_torch/bench/flash_ab.py \\
        --tree parent=/path/to/parent/checkout --tree change=. \\
        [--shape 64:8,1024,12,12 --shape 256:8,1024,8,8] [--order ABBA]

A shape is `head size:B,T,heads,kv heads`, causal. For each turn, dtype
(bf16, fp32), shape and kernel it prints the median of 5 CUDA-event
windows of 10 calls, their spread, the device time of one call
(torch.profiler: the self time of the device events, the median of 3
profiles of 10 calls) and a checksum of each output's bytes (sha256,
first 16 hex digits); then, for each dtype, shape and kernel, per tree
the mean of its turns' device times, and whether every turn of both trees
wrote the same bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def _windows(torch, fn, iters=10, windows=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b) / iters)
    ts.sort()
    return ts[len(ts) // 2], [ts[0], ts[-1]]


def _device_ms(torch, fn, iters=10, profiles=3):
    """The device ms of one call: the median over `profiles` profiles of
    `iters` calls (one profile of 10 spread by several percent between
    turns of one tree), of those that recorded an event a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        n = 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if e.device_type != DeviceType.CPU and t > 0 and \
                    not getattr(e, "is_user_annotation", False):
                us += t
                n += e.count
        if n >= iters:
            got.append(us / iters / 1e3)
    got.sort()
    return got[len(got) // 2] if got else None


def _checksums(torch, out) -> list:
    """sha256 (first 16 hex digits) of each output tensor's bytes."""
    outs = out if isinstance(out, tuple) else (out,)
    torch.cuda.synchronize()
    return [hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                           .tobytes()).hexdigest()[:16] for t in outs]


def worker(shapes) -> None:
    """Time this process's tree (the `distributed_pytorch_tpu_torch` first
    on sys.path); one JSON line per (dtype, shape, kernel)."""
    import torch

    from distributed_pytorch_tpu_torch.ops import cuda_build
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa
    cuda_build.build(["flash_attn_fwd", "flash_attn_bwd_dq"])
    dev = torch.device("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        for d, (B, T, nh, nkv) in shapes:
            g = torch.Generator(device=dev)
            g.manual_seed(3)

            def rnd(n):
                return torch.randn(B, T, n, d, generator=g,
                                   device=dev).to(dtype)

            q, k, v, dout = rnd(nh), rnd(nkv), rnd(nkv), rnd(nh)
            kw = dict(scale=d ** -0.5, causal=True)
            out, lse = fa.flash_attn_fwd(q, k, v, **kw)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            fns = {"flash_attn_fwd": lambda: fa.flash_attn_fwd(q, k, v, **kw),
                   "flash_attn_bwd_dq": lambda: fa.flash_attn_bwd_dq(
                       q, k, v, dout, lse, delta, **kw),
                   "flash_attn_bwd_dkv": lambda: fa.flash_attn_bwd_dkv(
                       q, k, v, dout, lse, delta, **kw)}
            for name in KERNELS:
                ms, spread = _windows(torch, fns[name])
                print(json.dumps({
                    "dtype": str(dtype).removeprefix("torch."), "d": d,
                    "shape": [B, T, nh, nkv], "kernel": name, "ms": ms,
                    "spread": spread,
                    "device_ms": _device_ms(torch, fns[name]),
                    "sha256": _checksums(torch, fns[name]())}), flush=True)


def _shape(s: str):
    d, dims = s.split(":")
    return int(d), tuple(int(x) for x in dims.split(","))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", required=True,
                   help="label=path of a checkout (two of them: A, B)")
    p.add_argument("--shape", action="append", type=_shape,
                   help="head size:B,T,heads,kv heads (causal)")
    p.add_argument("--order", default="ABBA")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    shapes = args.shape or [(64, (8, 1024, 12, 12)), (256, (8, 1024, 8, 8))]
    if args.worker:
        worker(shapes)
        return
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) != 2:
        p.error("give two trees, A and B")
    shape_args = [a for d, (B, T, nh, nkv) in shapes
                  for a in ("--shape", f"{d}:{B},{T},{nh},{nkv}")]
    rows = []
    for turn, which in enumerate(args.order):
        label, path = trees["AB".index(which)]
        env = dict(os.environ, PYTHONPATH=os.path.abspath(path))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--tree", "x=.", "--tree", "y=.", *shape_args],
            cwd=os.path.abspath(path), env=env, capture_output=True,
            text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"turn {turn} ({label}) failed:\n{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                r = dict(json.loads(line), tree=label, turn=turn)
                rows.append(r)
                dev = r["device_ms"]
                print(f"turn {turn} {label:8s} {r['dtype']:9s} d {r['d']:3d} "
                      f"{','.join(map(str, r['shape'])):14s} "
                      f"{r['kernel']:18s} {r['ms']:.4f} ms "
                      f"[{r['spread'][0]:.4f}-{r['spread'][1]:.4f}], device "
                      f"{'n/a' if dev is None else f'{dev:.4f}'} ms, "
                      f"sha256 {' '.join(r['sha256'])}", flush=True)
    print("mean device ms of each tree's turns:")

    def key_of(r):
        return r["dtype"], r["d"], tuple(r["shape"]), r["kernel"]

    for key in sorted({key_of(r) for r in rows}):
        cells = []
        for label, _ in trees:
            ts = [r["device_ms"] for r in rows if r["tree"] == label
                  and key_of(r) == key and r["device_ms"] is not None]
            cells.append(f"{label} {sum(ts) / len(ts):.4f}" if ts
                         else f"{label} n/a")
        sums = {tuple(r["sha256"]) for r in rows if key_of(r) == key}
        same = "same bytes" if len(sums) == 1 else "bytes differ"
        shape = ",".join(map(str, key[2]))
        print(f"  {key[0]:9s} d {key[1]:3d} {shape:14s} {key[3]:18s} "
              + ", ".join(cells) + f"; {same}")


if __name__ == "__main__":
    main()
