"""The parallel recipes across the cards of one machine.

Each recipe trains the flagship with chip_smoke phase 7's flags
(`--attn_impl pallas --loss_impl pallas`, bf16 over fp32 masters, B 8 x
T 1024 a card, `--tokens_per_card` 2**14 a step, so accum 2) through
`python -m torch.distributed.run --standalone --nproc_per_node N`, and
`single` trains the same global batch on one card (accum 2 N; the ranks'
rows of a step are single's rows, data/loader.py). Every run's losses are
held to single's within `--rtol`; its step p50, tok/s, tok/s and MFU per
card and rank 0's peak memory come from the trainer's stats.json.

A recipe is `name`, `name:tp`, `name:spS[@attn]`, `name:epE` or
`name:ppS[vV]`: tp the
`--tp_size` of a tensor-parallel run ('model' groups of tp adjacent cards,
the rest of the cards on 'data'), S the `--sp_size` of a sequence-parallel
one ('seq' groups of S adjacent cards; `@attn` its `--attn_impl`, ring,
zigzag or ulysses, for phase 7's pallas, which zig-zag takes), E the
`--ep_size` of an expert-parallel one ('expert' groups of E adjacent
cards), S the `--pp_size` of a pipeline-parallel one ('pipe' groups of S
adjacent cards; V its `--pp_vpp`). `tp` alone gives the
rows tp:N (all cards on 'model') and tp:2 (2 x N/2), `fsdp_tp` alone
fsdp_tp:2, `sp` alone sp:spN (zig-zag), sp:spN@ring, sp:spN@ulysses and
sp:sp2 (2 x N/2).

    python -m distributed_pytorch_tpu_torch.bench.recipes --nproc 4 \\
        [--recipes dp,zero1,zero2,fsdp,tp,fsdp_tp,sp,fsdp:sp2] \\
        [--iters 6] [--rtol 1e-3] [-- extra trainer flags]

Pipeline rows take the schedule and the microbatches from the trailing
flags (`-- --pp_schedule carry --pp_microbatches 8`), which single and
every row get alike (single ignores them):

    python -m distributed_pytorch_tpu_torch.bench.recipes --nproc 4 \\
        --recipes dp,pp:pp4v3,pp:pp2 -- --pp_microbatches 8

A long context runs with `-- --block_size 8192 --batch_size 1` and a
`--tokens_per_card` of 8192: single trains the same global batch on one
card in accum 4 x 8192 tokens.

`--moe` trains chip_smoke phase 9's MoE instead (the flagship with 8
experts, 1 shared, 3 active, up_dim 1024, `--moe_impl grouped`, B 8 x T
1024 a card); its rows are the expert-parallel ones, and a trailing `--
--moe_impl scatter` puts single and every row on 'scatter':

    python -m distributed_pytorch_tpu_torch.bench.recipes --nproc 4 --moe \\
        --recipes ep:ep4,ep:ep2,fsdp:ep2
    python -m distributed_pytorch_tpu_torch.bench.recipes --nproc 4 --moe \\
        --recipes fsdp:sp2 -- --moe_impl scatter

A rehearsal on the CPU (gloo, the kernels' plain versions) passes
`--platform cpu`, a tiny model and its `--tokens_per_card` after `--`.
Exits 1 when a run fails or leaves `--rtol`; the last line is one JSON
object of every run's numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGS = ["--preset", "gpt2_124m", "--attn_impl", "pallas", "--loss_impl",
         "pallas", "--compute_dtype", "bfloat16", "--dataset", "synthetic",
         "--batch_size", "8", "--warmup_steps", "5", "--learning_rate",
         "1e-3", "--seed", "0"]
# chip_smoke's MOE_ARGV without its run length, checkpoints and file name
MOE_FLAGS = ["--preset", "gpt2_124m", "--moe", "--n_exp", "8", "--n_shared",
             "1", "--n_act", "3", "--up_dim", "1024", "--moe_impl",
             "grouped", "--attn_impl", "pallas", "--compute_dtype",
             "bfloat16", "--dataset", "synthetic", "--batch_size", "8",
             "--warmup_steps", "5", "--learning_rate", "1e-3", "--seed", "0"]


def rows(spec: str, nproc: int) -> list:
    """(recipe, tp, sp, ep, attn_impl or None, (pp, vpp)) of each
    `--recipes` entry."""
    out = []
    for item in spec.split(","):
        item, _, attn = item.partition("@")
        name, _, axis = item.partition(":")
        if axis.startswith("sp"):
            out.append((name, 1, int(axis[2:]), 1, attn or None, (1, 0)))
        elif axis.startswith("ep"):
            out.append((name, 1, 1, int(axis[2:]), None, (1, 0)))
        elif axis.startswith("pp"):
            pp, _, vpp = axis[2:].partition("v")
            out.append((name, 1, 1, 1, None, (int(pp), int(vpp or 0))))
        elif axis:
            out.append((name, int(axis), 1, 1, None, (1, 0)))
        elif name == "tp":
            out += [("tp", nproc, 1, 1, None, (1, 0))] + (
                [("tp", 2, 1, 1, None, (1, 0))] if nproc > 2 else [])
        elif name == "fsdp_tp":
            out.append(("fsdp_tp", 2, 1, 1, None, (1, 0)))
        elif name == "sp":
            out += [("sp", 1, nproc, 1, None, (1, 0)),
                    ("sp", 1, nproc, 1, "ring", (1, 0)),
                    ("sp", 1, nproc, 1, "ulysses", (1, 0))] + (
                [("sp", 1, 2, 1, None, (1, 0))] if nproc > 2 else [])
        else:
            out.append((name, 1, 1, 1, None, (1, 0)))
    return out


def run(recipe: str, nproc: int, tokens: int, iters: int, extra: list,
        tmp: str, timeout: float, tp: int = 1, sp: int = 1, ep: int = 1,
        attn=None, pipe=(1, 0), flags=FLAGS) -> dict:
    """One trainer run under torch.distributed.run; its numbers."""
    pp, vpp = pipe
    name = (f"recipes_{recipe}_{nproc}_tp{tp}_sp{sp}_ep{ep}_pp{pp}v{vpp}_"
            f"{attn}")
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), "-m",
            "distributed_pytorch_tpu_torch", *flags, "--parallelism",
            recipe, "--tp_size", str(tp), "--sp_size", str(sp),
            "--ep_size", str(ep), "--pp_size", str(pp), "--pp_vpp",
            str(vpp),
            "--total_batch_size_str", str(tokens), "--max_iters",
            str(iters - 1), "--data_dir", os.path.join(tmp, "data"),
            "--file_name", name, *extra] + (
                ["--attn_impl", attn] if attn else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=tmp, env=env, capture_output=True,
                       text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{recipe} x {nproc} exited {r.returncode}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    with open(os.path.join(tmp, "checkpoints", name, "stats.json")) as f:
        st = json.load(f)
    head = next(line for line in r.stdout.splitlines() if "recipe=" in line)
    sched = next((line for line in r.stdout.splitlines()
                  if line.startswith("pp schedule:")), None)
    return {"recipe": recipe, "nproc": nproc, "tp": tp, "sp": sp, "ep": ep,
            "pp": pp, "vpp": vpp, "attn": attn,
            "data": nproc // (tp * sp * ep * pp), "wall_s": wall,
            "log": head, "pp_schedule": sched,
            "losses": st["train_losses"],
            "step_ms": st["median_step_time"] * 1e3,
            "tok_s": st["median_tokens_per_sec"],
            "tok_s_per_card": st["median_tokens_per_sec"] / nproc,
            "mfu_per_card": st.get("median_mfu"),
            "peak_gb_rank0": st["peak_mem_gb"], "device": st["device"],
            "backend": st["backend"], "world": st["world"],
            "moe_dropped_frac": st.get("moe_dropped_frac"),
            "moe_degraded_dense": st.get("moe_degraded_dense")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--recipes", default="dp,zero1,zero2,fsdp,tp,fsdp_tp")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--tokens_per_card", type=int, default=2 ** 14)
    ap.add_argument("--rtol", type=float, default=1e-3)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--moe", action="store_true",
                    help="train chip_smoke phase 9's MoE")
    ap.add_argument("extra", nargs="*")
    args = ap.parse_args(argv)
    extra = args.extra
    flags = MOE_FLAGS if args.moe else FLAGS
    if "cpu" not in extra:
        from distributed_pytorch_tpu_torch.ops import cuda_build
        t0 = time.perf_counter()
        cuda_build.build()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    tokens = args.tokens_per_card * args.nproc
    runs, ok = [], True
    with tempfile.TemporaryDirectory() as tmp:
        base = run("single", 1, tokens, args.iters, extra, tmp,
                   args.timeout, flags=flags)
        runs.append(base)
        for recipe, tp, sp, ep, attn, pipe in rows(args.recipes,
                                                   args.nproc):
            runs.append(run(recipe, args.nproc, tokens, args.iters, extra,
                            tmp, args.timeout, tp, sp, ep, attn, pipe,
                            flags))
    ref = np.asarray(base["losses"])
    for r in runs:
        got = np.asarray(r["losses"])
        r["max_rel_loss_diff"] = float(np.max(np.abs(got - ref)
                                              / np.abs(ref)))
        r["bit_equal"] = bool((got == ref).all())
        r["ok"] = r["max_rel_loss_diff"] <= args.rtol \
            and (r["recipe"] == "single" or r["world"] == args.nproc)
        ok &= r["ok"]
        mfu = r["mfu_per_card"]
        drop = r["moe_dropped_frac"]
        moe = "" if not drop else (
            f"; moe_drop {max(drop):.4%} at most, degraded layers "
            f"{r['moe_degraded_dense']}")
        pipe = f" x pipe {r['pp']}" if r["pp"] > 1 else ""
        print(f"{r['recipe']:>7} x {r['nproc']} (data {r['data']} x seq "
              f"{r['sp']} x expert {r['ep']} x model {r['tp']}{pipe}"
              f"{', ' + r['attn'] if r['attn'] else ''}) over "
              f"{r['backend']}: step "
              f"ms p50 {r['step_ms']:.3f}, tok/s {r['tok_s']:.1f} "
              f"({r['tok_s_per_card']:.1f} a card), MFU a card "
              f"{'-' if mfu is None else f'{mfu:.4f}'}, rank 0 peak "
              f"{r['peak_gb_rank0'] or 0:.3f} GB, wall {r['wall_s']:.1f} s; "
              f"losses vs single max rel {r['max_rel_loss_diff']:.3e} "
              f"(tol {args.rtol:.0e}), bit-equal {r['bit_equal']}{moe}; "
              f"{'ok' if r['ok'] else 'FAILED'}", flush=True)
        if r["pp_schedule"]:
            print(f"        {r['pp_schedule']}", flush=True)
    print(json.dumps({"ok": ok, "runs": runs}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
