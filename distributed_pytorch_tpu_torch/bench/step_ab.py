"""A/B of chip_smoke's training phases of two source trees on one CUDA
card, in turns: each turn is its own process that imports the turn's tree
(its `distributed_pytorch_tpu_torch` and its `chip_smoke.py`) and runs
the phases with that tree's own phase functions, each in a temporary
directory: phase 10 (the launcher's MLA model with the 'scatter' MoE
dispatch, `MLA_ARGV`), phase 9 (the flagship MoE on the grouped
dispatch, `MOE_ARGV`), phase 11 (a) (the default config, `DEFAULT_ARGV`:
trained, then its checkpoint sampled and served in bf16 and fp32). Turns
run A, B, B, A by default, so that a drift of the card over the call
shows.

    python distributed_pytorch_tpu_torch/bench/step_ab.py \\
        --tree parent=/path/to/parent/checkout --tree change=. \\
        [--order ABBA] [--phase 10 --phase 9 --phase 11a]

Each turn prints its trainer's log, the phase's profile of two steady
steps (host wall, kernels a step, the split, the top kernels a step) and
one JSON line a phase: step ms p50, tok/s and MFU from the trainer's
stats and the profile's split (11a: also each serve leg's numbers).
Then, per phase, each tree's turns side by side.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

def _phase_11a(cs, torch, dev, tmp) -> dict:
    """Phase 11 (a): the default config trained, then served."""
    out = cs.run_train_small(torch, dev, "", cs.DEFAULT_ARGV, "default",
                             tmp)
    out["serve"] = cs.run_serve_default(
        torch, dev, "", os.path.join(tmp, "checkpoints",
                                     "chip_smoke_default"))
    return out


PHASES = {"10": "run_train_mla", "9": "run_train_moe", "11a": _phase_11a}


def worker(phases) -> None:
    """Train each phase with this process's tree (first on sys.path)."""
    import torch

    import chip_smoke as cs
    from distributed_pytorch_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build()
    dev = torch.device("cuda")
    cwd = os.getcwd()
    for ph in phases:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                run = PHASES[ph]
                out = (run(cs, torch, dev, tmp) if callable(run)
                       else getattr(cs, run)(torch, dev, "", tmp))
            finally:
                os.chdir(cwd)
        legs = out.get("serve", {}).get("legs", {})
        print(json.dumps({"phase": ph, "step_ms": out["step_ms"],
                          "tok_s": out["tok_s"], "mfu": out["mfu"],
                          "split": out["split"],
                          "serve": {dn: leg["numbers"]
                                    for dn, leg in legs.items()}}),
              flush=True)
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", required=True,
                   help="label=path of a checkout (two of them: A, B)")
    p.add_argument("--phase", action="append", choices=sorted(PHASES))
    p.add_argument("--order", default="ABBA")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    phases = args.phase or ["10", "9"]
    if args.worker:
        worker(phases)
        return
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) != 2:
        p.error("give two trees, A and B")
    rows = []
    for turn, which in enumerate(args.order):
        label, path = trees["AB".index(which)]
        path = os.path.abspath(path)
        env = dict(os.environ, PYTHONPATH=path)
        print(f"=== turn {turn}: {label} ({path})", flush=True)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--tree", "x=.", "--tree", "y=.",
             *[a for ph in phases for a in ("--phase", ph)]],
            cwd=path, env=env, capture_output=True, text=True, timeout=1200)
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                rows.append(dict(json.loads(line), tree=label, turn=turn))
            else:
                print(f"  {line}", flush=True)
        if out.returncode != 0:
            sys.exit(f"turn {turn} ({label}) failed:\n{out.stderr[-3000:]}")
    print("per phase, each tree's turns:")
    for ph in phases:
        for label, _ in trees:
            for r in (r for r in rows if r["phase"] == ph
                      and r["tree"] == label):
                s = r["split"]
                print(f"  phase {ph} {label:8s} turn {r['turn']}: step p50 "
                      f"{r['step_ms']:.3f} ms, tok/s {r['tok_s']:.1f}, MFU "
                      f"{r['mfu']:.4f}; host wall {s['host_wall_ms']:.3f} "
                      f"ms, kernels {s['device_ms']:.3f} ms (busy "
                      f"{100 * s['device_ms'] / s['host_wall_ms']:.1f}%), "
                      f"everything else {s['everything else']:.3f} ms; "
                      f"flash fwd / dq / dkv {s['flash_attn_fwd']:.3f} / "
                      f"{s['flash_attn_bwd_dq']:.3f} / "
                      f"{s['flash_attn_bwd_dkv']:.3f} ms", flush=True)
                for dn, n in r.get("serve", {}).items():
                    print(f"    serve {dn}: {n['tok_s']:.1f} tok/s, TTFT "
                          f"p50 / p99 {n['ttft_p50_ms']:.1f} / "
                          f"{n['ttft_p99_ms']:.1f} ms, ITL p99 "
                          f"{n['itl_p99_ms']:.1f} ms, step ms p50 "
                          f"{n['step_ms_p50']:.2f}", flush=True)


if __name__ == "__main__":
    main()
