"""A/B timing of the flash kernels (forward, dq, dkv) and of the bf16
paged prefill of two source trees on one CUDA card, in turns: each turn is
its own process that imports the turn's tree of
`distributed_pytorch_tpu_torch` (built from that tree's csrc), so trees
whose C entries differ can be compared. Turns run A, B, B, A by default,
so that a drift of the card over the call shows.

    python distributed_pytorch_tpu_torch/bench/flash_ab.py \\
        --tree parent=/path/to/parent/checkout --tree change=. \\
        [--shape 64:8,1024,12,12 --shape 256:8,1024,8,8] \\
        [--prefill 32:512,8,4,256] [--order ABBA] [--dropout 0.2]

A shape is `head size:B,T,heads,kv heads`, causal; a prefill is `head
size:T,heads,kv heads,offset`: one sequence's T-row bf16 chunk at that
offset over a paged bf16 cache (block size 16, a permuted table), as
chip_smoke's phase 3 calls it. With --prefill and no --shape only the
prefills run. For each turn, dtype (bf16, fp32; the prefill bf16 only),
shape and kernel it prints the median of 5 CUDA-event windows of 10 calls,
their spread, the device time of one call (torch.profiler: the self time
of the device events, the median of 3 profiles of 10 calls), for the bf16
forward and the prefill also the device time of the same function by
`scaled_dot_product_attention` (the library yardstick, over the gathered
cache for the prefill), and a checksum of each output's bytes (sha256,
first 16 hex digits); then, for each dtype, shape and kernel, per tree
the mean of its turns' device times, and whether every turn of both trees
wrote the same bytes. `--dropout RATE` runs the flash kernels with
attention-weight dropout at that rate, from one fixed seed.
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


def _row(torch, dtype, d, shape, name, fn, library=None) -> None:
    """Time `fn` (and the yardstick `library`) and print its JSON line."""
    ms, spread = _windows(torch, fn)
    print(json.dumps({
        "dtype": str(dtype).removeprefix("torch."), "d": d,
        "shape": list(shape), "kernel": name, "ms": ms, "spread": spread,
        "device_ms": _device_ms(torch, fn),
        "library_device_ms": (None if library is None
                              else _device_ms(torch, library)),
        "sha256": _checksums(torch, fn())}), flush=True)


def prefill_worker(torch, prefills) -> None:
    """The bf16 paged prefill at each (head size, (T, heads, kv heads,
    offset)): a permuted table of 16-row blocks over seeded pools."""
    import numpy as np
    import torch.nn.functional as F

    from distributed_pytorch_tpu_torch.ops import flash_decode as fd
    from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather
    dev = torch.device("cuda")
    bs = 16
    for hs, (T, nh, nkv, off) in prefills:
        n_max = (off + T + bs - 1) // bs + 2
        g = torch.Generator(device=dev)
        g.manual_seed(5)

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev) \
                .to(torch.bfloat16)

        kp, vp = rnd(1 + n_max, bs, nkv, hs), rnd(1 + n_max, bs, nkv, hs)
        q = rnd(1, T, nh, hs)
        table = torch.from_numpy(np.random.default_rng(5).permutation(
            np.arange(1, 1 + n_max)).astype(np.int32)).to(dev)[None]
        kl = paged_gather(kp, table)[:, :off + T].transpose(1, 2)
        vl = paged_gather(vp, table)[:, :off + T].transpose(1, 2)
        mask = (torch.arange(off + T, device=dev)[None, :]
                <= off + torch.arange(T, device=dev)[:, None])
        scale = hs ** -0.5
        _row(torch, torch.bfloat16, hs, (T, nh, nkv, off),
             "paged_prefill_attn",
             lambda: fd.paged_flash_prefill(q, kp, vp, table, off,
                                            scale=scale),
             lambda: F.scaled_dot_product_attention(
                 q.transpose(1, 2), kl, vl, attn_mask=mask, scale=scale,
                 enable_gqa=nkv != nh))


def worker(shapes, prefills, rate: float = 0.0) -> None:
    """Time this process's tree (the `distributed_pytorch_tpu_torch` first
    on sys.path); one JSON line per (dtype, shape, kernel)."""
    import torch
    import torch.nn.functional as F

    from distributed_pytorch_tpu_torch.ops import cuda_build
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa
    cuda_build.build(["flash_attn_fwd", "flash_attn_bwd_dq",
                      "paged_prefill_attn"])
    if prefills:
        prefill_worker(torch, prefills)
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
            if rate > 0.0:
                kw.update(dropout_rate=rate, seed=torch.tensor(
                    [20240601, -7], dtype=torch.int32, device=dev))
            out, lse = fa.flash_attn_fwd(q, k, v, **kw)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            fns = {"flash_attn_fwd": lambda: fa.flash_attn_fwd(q, k, v, **kw),
                   "flash_attn_bwd_dq": lambda: fa.flash_attn_bwd_dq(
                       q, k, v, dout, lse, delta, **kw),
                   "flash_attn_bwd_dkv": lambda: fa.flash_attn_bwd_dkv(
                       q, k, v, dout, lse, delta, **kw)}
            gqa = dict(enable_gqa=True) if nkv != nh else {}
            sdpa = None if dtype != torch.bfloat16 else (
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, scale=d ** -0.5, **gqa))
            for name in KERNELS:
                _row(torch, dtype, d, (B, T, nh, nkv), name, fns[name],
                     sdpa if name == "flash_attn_fwd" else None)


def _shape(s: str):
    d, dims = s.split(":")
    return int(d), tuple(int(x) for x in dims.split(","))


def _fmt(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", required=True,
                   help="label=path of a checkout (two of them: A, B)")
    p.add_argument("--shape", action="append", type=_shape,
                   help="head size:B,T,heads,kv heads (causal)")
    p.add_argument("--prefill", action="append", type=_shape,
                   help="head size:T,heads,kv heads,offset (bf16)")
    p.add_argument("--order", default="ABBA")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    prefills = args.prefill or []
    shapes = args.shape or ([] if prefills else
                            [(64, (8, 1024, 12, 12)), (256, (8, 1024, 8, 8))])
    if args.worker:
        worker(shapes, prefills, args.dropout)
        return
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) != 2:
        p.error("give two trees, A and B")
    shape_args = [a for flag, items in (("--shape", shapes),
                                        ("--prefill", prefills))
                  for d, dims in items
                  for a in (flag, f"{d}:{','.join(map(str, dims))}")]
    rows = []
    for turn, which in enumerate(args.order):
        label, path = trees["AB".index(which)]
        env = dict(os.environ, PYTHONPATH=os.path.abspath(path))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--tree", "x=.", "--tree", "y=.", "--dropout",
             str(args.dropout), *shape_args],
            cwd=os.path.abspath(path), env=env, capture_output=True,
            text=True, timeout=900)
        if out.returncode != 0:
            sys.exit(f"turn {turn} ({label}) failed:\n{out.stderr[-3000:]}")
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                r = dict(json.loads(line), tree=label, turn=turn)
                rows.append(r)
                lib = r["library_device_ms"]
                print(f"turn {turn} {label:8s} {r['dtype']:9s} d {r['d']:3d} "
                      f"{','.join(map(str, r['shape'])):14s} "
                      f"{r['kernel']:18s} {r['ms']:.4f} ms "
                      f"[{r['spread'][0]:.4f}-{r['spread'][1]:.4f}], device "
                      f"{_fmt(r['device_ms'])} ms"
                      + ("" if lib is None else f" (SDPA {_fmt(lib)})")
                      + f", sha256 {' '.join(r['sha256'])}", flush=True)
    print("mean device ms of each tree's turns:")

    def key_of(r):
        return r["dtype"], r["d"], tuple(r["shape"]), r["kernel"]

    def mean(xs):
        xs = [x for x in xs if x is not None]
        return sum(xs) / len(xs) if xs else None

    for key in sorted({key_of(r) for r in rows}):
        cells = []
        for label, _ in trees:
            mine = [r for r in rows if r["tree"] == label
                    and key_of(r) == key]
            cells.append(f"{label} {_fmt(mean(r['device_ms'] for r in mine))}")
        lib = mean(r["library_device_ms"] for r in rows if key_of(r) == key)
        if lib is not None:
            cells.append(f"SDPA {_fmt(lib)}")
        sums = {tuple(r["sha256"]) for r in rows if key_of(r) == key}
        same = "same bytes" if len(sums) == 1 else "bytes differ"
        shape = ",".join(map(str, key[2]))
        print(f"  {key[0]:9s} d {key[1]:3d} {shape:14s} {key[3]:18s} "
              + ", ".join(cells) + f"; {same}")


if __name__ == "__main__":
    main()
