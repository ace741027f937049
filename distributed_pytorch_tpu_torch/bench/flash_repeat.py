"""Repeat check of the bf16 flash kernels (forward, dq, dkv) on one CUDA
card: each kernel is called many times on fixed inputs, alone and while a
matmul loop runs on another stream (which moves the CTAs' timing), and
every call's output bytes are compared with the first call's. The
kernels sum in a fixed order, so any differing call points at a race.

    python distributed_pytorch_tpu_torch/bench/flash_repeat.py [--calls 300]

Cases: head sizes 80 and 72 (width 80, full and masked) at B 8, T 1024,
12 heads with 12 and 4 kv heads, causal, dropout 0 and 0.2; T 65, 900 and
1088, causal and full; then 32, 64, 128, 192 and 256 at B 8, T 1024, 12
heads, causal. Prints, per case and kernel, the calls whose bytes differ
from the first call's; exits 1 if any did or an output is not finite.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def cases() -> list:
    out = []
    for d in (80, 72):
        out += [(8, 1024, 12, 12, d, True, 0.0), (8, 1024, 12, 4, d, True, 0.0),
                (8, 1024, 12, 12, d, True, 0.2), (2, 65, 12, 4, d, True, 0.0),
                (1, 900, 12, 4, d, False, 0.2),
                (1, 1088, 12, 12, d, False, 0.0)]
    return out + [(8, 1024, 12, 12, d, True, 0.0)
                  for d in (32, 64, 128, 192, 256)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args()
    import torch

    from distributed_pytorch_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    side = torch.cuda.Stream()
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    n, total, finite = args.calls, 0, True
    t0 = time.perf_counter()
    for B, T, nh, nkv, d, causal, rate in cases():
        g = torch.Generator(device=dev)
        g.manual_seed(T + d)

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(
                torch.bfloat16)

        q, k, v, dout = (rnd(B, T, nh, d), rnd(B, T, nkv, d),
                         rnd(B, T, nkv, d), rnd(B, T, nh, d))
        seed = torch.tensor([7, -11], dtype=torch.int32, device=dev)
        kw = dict(scale=d ** -0.5, causal=causal, dropout_rate=rate)
        out, lse = fa.flash_attn_fwd(q, k, v, seed, **kw)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        fns = {"fwd": lambda: fa.flash_attn_fwd(q, k, v, seed, **kw),
               "dq": lambda: (fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta,
                                                   seed, **kw),),
               "dkv": lambda: fa.flash_attn_bwd_dkv(q, k, v, dout, lse,
                                                    delta, seed, **kw)}
        for name, fn in fns.items():
            first = [x.clone() for x in fn()]
            ok = all(bool(torch.isfinite(x).all()) for x in first)
            finite &= ok
            got = {}
            for mode in ("alone", "beside"):
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                if mode == "beside":
                    with torch.cuda.stream(side):
                        for _ in range(n // 4):
                            a @ a
                for _ in range(n):
                    for x, r in zip(fn(), first):
                        bad += (x.view(torch.int16) != r.view(torch.int16)
                                if x.dtype == torch.bfloat16
                                else x != r).any().long()
                torch.cuda.synchronize()
                got[mode] = int(bad)
                total += int(bad)
            print(f"B {B} T {T} heads {nh}/{nkv} d {d} causal {causal} "
                  f"dropout {rate} {name:3s}: finite {ok}; calls whose bytes "
                  f"differ from the first's: alone {got['alone']}/{n}, beside "
                  f"a matmul stream {got['beside']}/{n}", flush=True)
    print(f"differing calls in all: {total}; every output finite: {finite}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0 if total == 0 and finite else 1


if __name__ == "__main__":
    sys.exit(main())
