#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`distributed_pytorch_tpu_torch`) on one
CUDA card: build the hand-written kernels, hold each against its plain
version, run the flagship GPT-124M at full width, serve it over HTTP, and
train it.

    python3 chip_smoke.py          # from the repo root, one CUDA card

Phases, each of which ends the run with a non-zero exit on failure:

1. device  — a CUDA card must be visible; prints its name and power limit
             (nvidia-smi); TF32 off for matmuls and cuDNN.
2. build   — compiles every CUDA source under
             distributed_pytorch_tpu_torch/csrc/ (one nvcc each, in
             parallel) and prints the seconds it took; counts each
             flash, grouped and paged kernel's HGMMA, UTMALDG and LDGSTS
             instructions (`cuobjdump -sass`): the 46 bf16 wgmma kernels
             (flash forward, dq and dkv at widths 32, 64, 80, 128 and 256,
             dq at 192, each for head sizes equal to and under the width,
             the paged prefill at 32, 64 and 128 over a bf16 cache and at
             64 and 128 over an int8 one,
             the grouped forward, dx and dW unscaled and scaled, the
             fused CE forward, dx and dW) must hold
             HGMMA and their loads (TMA; cp.async and no TMA in the paged
             prefill, which gathers through the block table; the
             warp-specialized flash forward, dq and dkv at 256 and dq at
             192 also setmaxnreg and no local-memory store, the forward,
             dq and dkv at 80 and at 32 and the prefill at 32 no
             local-memory store), the others
             (fp32, int8, the bf16 CE kernels' mma.sync version for C
             past 1024, the split-KV decode's split kernels over fp32,
             bf16 and int8 caches and its combine kernels, which must be
             there; the fp32 flash kernels at head size 256 too) neither
             HGMMA nor a TMA load.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the serving path's shapes (decode, prefill; over a bf16/fp32
             cache and over an int8 cache with fp32 row scales, the _q8
             kernels, whose yardstick is the path they replace: the
             gathered rows dequantized, then SDPA; and the bf16 prefill
             at the default config's head size 32, 8 / 4 heads, on its
             wgmma kernel) and the training
             path's (flash forward, dq, dkv at B 8, T 1024, causal: 12
             heads x 64, the flagship; 8 heads x 256, the launcher's MLA;
             8 / 4 kv heads x 32, the default config, at its own width
             32; 12 heads x 80, the flagship with MLA, at its own width 80
             (forward, dq and dkv); and, held but not
             timed, 8 x 48 and 12 x 192, under their built widths as 32
             is), in fp32 and bf16, then bf16 device times of head size
             192 at widths 192 and 256, of 80 at 80 and at 128 beside
             128 at 128, and of 32 at 32 and at 64, with times (CUDA
             events; a
             kernel's and its yardstick's are the median of 5 timed
             windows, printed with their spread, beside their device
             time under torch.profiler, which leaves out the host's time
             between launches), the
             least time the card could take (bound), and one PyTorch
             library call for the same function as a yardstick
             (`scaled_dot_product_attention`; its backward for dq and dkv
             together). The fused CE kernels (forward, dx, dW) at the
             training path's shape (n 8192, C 768, V 50304) beside the
             chunked loss they replace and `torch.mm` of x W^T, with
             their device time; each one's launched kernel (read from the
             device-time profile) must be the one its C plan
             (`fused_ce_fwd_plan`, `fused_ce_bwd_plan`) names, the
             forward's ring stages are printed, and for the backward's
             sm90 kernel the floor of its design (the score product
             recomputed by each of its output-column blocks). The decode
             and prefill cases print the kernels their device-time
             profile saw.
4. model   — flagship_gpt124m (12 x 768, vocab 50304) with seeded
             N(0, 0.02) weights: a 300-token paged prefill and 16 paged
             decode steps held against the uncached forward of the same
             tokens through the naive einsum attention (no kernel), in
             fp32 and bf16; the contiguous-cache `generate` held against
             greedy argmax of that naive forward, and again with an int8
             cache (its decode steps through paged_decode_attn_q8) against
             the naive forward over the dequantized int8 cache. Every
             run must launch the kernels layers x steps times (generate:
             its prompt pass through flash_attn_fwd, its decode steps
             through the contiguous route) and call no plain version.
5. serve   — the serve CLI's engine (bf16, 8 slots, max_len 1024, KV block
             16, greedy) behind the Scheduler and ServeApp on 127.0.0.1:
             8 concurrent SSE completions, three sharing a 256-token
             prefix. Every stream must end on its budget, the prefix cache
             must hit, the kernel launch counters must move by layers x
             steps (decode) and layers x admissions (prefill), and the
             plain versions must not run.
6. train   — the trainer's own `train()` on flagship_gpt124m at full width
             (`--attn_impl pallas`, bf16 compute over fp32 masters, B 8 x
             T 1024, accum 2, synthetic data, 20 iterations, a checkpoint
             at iteration 10): the loss must stay finite and fall by
             TRAIN_DROP, the flash kernels must launch layers x
             micro-steps times each (no plain calls), and the checkpoint
             must verify and restore. Then a full-width fp32 parity check
             at B 2 (loss and gradients through the kernels against
             `attn_impl='naive'`) and a profile of two steps, its flash
             time split per kernel (fwd, dq, dkv ms a step).
7. train with the fused CE kernels, then sample and serve the checkpoint
           — phase 6's run with `--loss_impl pallas --eval --eval_interval
             10 --eval_iters 2 --save_model`: a falling loss whose first
             iteration agrees with phase 6's, exact launch counts (CE
             forward per micro-step and per eval batch, dx and dW per
             micro-step; no plain calls, no degraded loss); an fp32 parity
             step at B 2 against `loss_impl='unchunked'`; then the saved
             checkpoint sampled (`sample.main`, greedy) and served (`serve
             --ckpt`'s engine, 4 concurrent greedy streams, bf16 and fp32)
             with its weights_version, and a profile of two steps.
8. int8 and chunked serving — phase 5's traffic served from phase 7's
             checkpoint (trained weights, so that top-2 margins are wide
             enough to hold tokens to) through three engines: (w) the
             bf16 wave engine, (a) a bf16 cache with prefill_chunk 256,
             (b) an int8 cache with int8 weights, chunked. Every stream
             ends on its budget; the prefill kernel launches layers x
             chunk steps, the decode kernel layers x steps (the _q8
             kernels in (b)), no plain version; (a)'s tokens equal (w)'s
             up to the first small top-2 margin; (a)'s and (b)'s tokens
             equal the argmax of a kernel-free reference (the uncached
             forward; for (b) the forward over a dequantized int8 cache
             on the engine's int8 weights) at every position whose margin
             clears the limit, for at least MIN_CHECKED of each stream;
             /metrics shows the chunk use and the engine's options. Then
             the engine's own admit/step path teacher-forced on (a)'s
             tokens (staged admissions that hit the shared prefix, a pool
             small enough to preempt): bf16 within LOGIT_TOL of the
             uncached forward, int8 within Q8_LOGIT_TOL of bf16. The spec
             leg (`run_spec_legs`): greedy bf16, wave and chunked 256,
             speculative decoding off and on (`SPEC_DECODE`, `SPEC_K` 4,
             read by the serve CLI's `build_engine`), SPEC_RUNS runs of
             each on fresh engines: every on-run's tokens held to the
             uncached argmax at every position whose margin clears the
             limit, the first's equal the off-run's up to the first small
             margin; no plain version; the decode kernel launches layers
             x the steps that did not speculate (an 8-slot verify reads
             the gathered cache by the naive path); tok/s, TTFT and ITL
             p50 / p99, tokens_per_step and accepted_token_rate printed
             as the median and range of the runs. An fp32
             chunked run is held to an fp32 wave run and the uncached
             forward the same way. Then the serve CLI itself with
             `--cache-dtype int8 --quant-weights --prefill-chunk 256`, in
             a subprocess, answers one completion.
9. MoE     — the trainer's own `train()` on the flagship DeepSeekMoE
             (12 x 768, 1 shared + 7 routed experts, top-2, up_dim 1024,
             `moe_impl='grouped'`, `--attn_impl pallas`, bf16 over fp32
             masters, B 8 x T 1024, accum 2, 20 iterations, checkpoints at
             10 and 20): a falling loss, the expert bias moved, no dropped
             rows, no degraded layer, the grouped kernels launched exactly
             3/2/2 x layers x micro-steps (fwd/dx/dW), a profile of two
             steps, two bf16 forward + backward calls of MoE layer 0 that
             must give the same bytes (`moe_repeats`; the saved weights'
             sha256 printed beside, to compare runs); an fp32
             parity step at B 2 against
             `moe_impl='dense'`; then the checkpoint through `sample.main`,
             `serve --ckpt`'s engine with phase 5's traffic (bf16 and
             fp32) and the serve CLI. Served tokens are held to the
             uncached naive-attention dense-dispatch forward at every
             position (NEAR_TOP), launches 2 x layers per forward.
10. MLA    — the trainer's own `train()` on the launcher's model
             (scripts/train.sh: 12 x 1024, MLA with 8 heads of 128,
             latents 256 / 256, rope head 128, DeepSeekMoE 16 experts
             through 'scatter', 'attn' recomputation; `--attn_impl
             pallas`, bf16 over fp32 masters, phase 6's optimizer, data
             and batch, 20 iterations, a checkpoint at the end): a
             falling loss, the flash kernels at head size 256 launched
             exactly (the forward twice a layer a micro-step, dq and dkv
             once), no plain call, `moe_drop`, step time, tok/s, MFU (MLA
             FLOP count), peak memory and a profile of two steps (its top
             kernels a step printed again before the last lines), the
             bitwise repeat of MoE layer 0 as in phase 9; an fp32
             parity step at B 2 against `attn_impl='naive'`; then the
             checkpoint through `sample.main` and `serve --ckpt`'s engine
             with phase 5's traffic, wave, chunked 256 and chunked with
             `--cache-dtype int8 --quant-weights` (MLA declines the int8
             cache: bf16 latent pools, int8 weights): every stream on its
             budget, no kernel launched (MLA attends over its latent
             cache by absorption), tokens held by NEAR_TOP at every
             position to the same absorbed arithmetic without the engine
             (the parity step holds absorbed to materialized logits in
             fp32); and the serve CLI answering one completion.
11. small head sizes — the trainer's own `train()` with phase 6's batch,
             optimizer and data flags and the default attention route
             ('auto') on (a) the default LLMConfig as the CLI builds it
             with no preset (6 x 256, GQA 8 / 4 heads of 32, swiglu 384)
             and (b) `--preset gpt2_124m --attn mla` with the CLI's
             latents (12 heads of 64 + rope 16 = 80): each a falling loss,
             the flash kernels launched exactly layers x micro-steps each
             at head size 32 or 80, no plain call, a profile of two steps
             whose flash kernels must be the instances built at widths 32
             and 80 (`flash_pipe::*_kernel_sm90<32, false>`,
             `flash_sm90::*_kernel_sm90<80, false>`), its flash time split
             per kernel, and an fp32 parity step at B 2 against
             `attn_impl='naive'`; then (a)'s checkpoint through
             `sample.main` (its prompt pass through flash_attn_fwd at head
             size 32) and `serve --ckpt`'s engine with phase 5's traffic
             in bf16 and fp32 (paged decode and prefill at head size 32),
             every stream on its budget, tokens held by NEAR_TOP at every
             position to the uncached naive forward; then two fresh
             prompts through the bf16 engine under torch.profiler, whose
             paged prefills must all be `prefill_kernel_sm90<32>`.
12. parallel recipes — at world size 1 over NCCL (one card), with
             phase 7's flags (`--attn_impl pallas --loss_impl pallas`, B 8,
             2**14 tokens a step, accum 2): (1) the trainer's own
             `train()` under `single`, `dp`, `zero1`, `zero2`, `fsdp`,
             `tp` and `fsdp_tp` (a 'model' axis of one rank: the
             tensor-parallel recipes' wiring over NCCL; the cut itself
             runs on four cards, bench/recipes.py), `sp` and `fsdp
             --sp_size 1` (a 'seq' axis of one rank) and `pp` (a 'pipe'
             axis of one rank, which is dp), 6 iterations each,
             in this process with torchrun's environment set for one rank:
             every recipe's loss at every iteration within RECIPE_RTOL of
             `single`'s (tp and fsdp_tp within TP_RTOL, the sp legs bit
             for bit; bit-equality printed), the flash and CE kernels
             launched exactly layers x
             micro-steps / micro-steps times, no plain call, step ms p50,
             tok/s, MFU and peak memory per recipe; (2) `fsdp` through
             `python -m torch.distributed.run --standalone
             --nproc_per_node 1 -m distributed_pytorch_tpu_torch`, which
             must exit 0 and log recipe=fsdp, world 1, nccl on cuda:0;
             (3) phase 9's MoE under `fsdp`, 4 iterations: the grouped
             kernels launched exactly, the expert bias moved, the final
             checkpoint (whole tensors gathered from the shards) verified;
             (4) ring attention's hops and merge in one process
             (`run_ring_hops`): 4 chunks of one sequence, contiguous and
             zig-zag, through `ring_fwd` / `ring_bwd` with a list rotation
             in place of the permute, held against one whole flash call's
             plain version at head sizes 64 and 32, causal, dropout 0 and
             0.2; (5) pipeline parallelism in one process
             (`run_pipelines`): the flagship with phase 7's flags at S 4
             stages over the in-process transport, M 8 microbatches of
             one row, under '1f1b' at vpp 3 and under 'carry', and phase
             9's MoE under 'carry' with 'grouped', PP_ITERS steps each
             on the synthetic dataset's batches, weight decay 0: every
             step's loss within RECIPE_RTOL and gradient norm within
             PP_NORM_RTOL (a tighter limit at step 0; the MoE's wider,
             its statistics being a microbatch's) of the single model's
             on the same batches from
             the same init (single's loss falling by PP_LEARNS times the
             loss limit), the flash kernels
             launched layers x M x micro-steps times, the CE kernels once
             a micro-step (one call over the concatenated exits) and the
             grouped kernels 3 / 2 / 2 x layers x M x micro-steps, no
             plain call, the tied embedding's two copies and their
             moments equal bit for bit, step ms p50, tok/s and peak
             memory; then the flash kernels at a microbatch's b 1 x T
             1024 x 12 heads of 64, bf16, held to their plain versions
             and timed beside phase 3's B 8.

Phase 3 also holds the three flash kernels over a tensor-parallel rank's
slice of the heads (`head_offset`, `total_heads`) at dropout 0.2 against
their plain versions and against the whole call's bytes
(`run_flash_offsets`), over a block of a longer sequence (`q_pos0`,
`k_pos0`, as a ring attention hop calls them) at dropout 0.2 against their
plain versions and against those rows of the whole call's bytes
(`run_flash_positions`), and the three grouped-matmul kernels (fwd, dx, dW) against
their plain versions at the MoE training shapes (P 25600; K 768 / N 2048
unscaled, K 1024 / N 768 gate-scaled), with an empty expert and with every
row on one expert, beside `torch._grouped_mm` (or a loop of `torch.mm`).

The last two lines are a JSON line of per-kernel numbers and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,            # dense tensor-core bf16
              "float32": 67e12}              # fp32 outside the tensor cores
# kernel vs plain, max abs: fp32 differs by summation order; bf16 rounds
# p against a running max in the kernel, the global max in the plain
# version (largest bf16 error seen on the H100: 3.9e-3)
TOL = {"float32": 1e-4, "bfloat16": 8e-3}
# logits of a cached path vs the uncached forward: fp32 differs by summation
# order only; bf16 rounds activations at different points across 12 layers
# (largest bf16 gap seen on the H100: 3.1e-2)
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 6e-2}
# flash kernels vs plain, element by element, for each output on its own:
# |kernel - plain| <= atol + rtol * |plain|. fp32 differs by summation
# order; a bf16 output rounds to bf16 on both sides (at most one ulp
# apart: rtol 2^-7), and the forward rounds p against a running max in
# the kernel, the global max in the plain version (atol). lse is fp32
# whatever the inputs' dtype and takes the fp32 limits.
FLASH_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (4e-3, 2 ** -7)}
FLASH_OUTPUTS = {"flash_attn_fwd": ("out", "lse"),
                 "flash_attn_bwd_dq": ("dq",),
                 "flash_attn_bwd_dkv": ("dk", "dv")}
# fused CE kernels vs plain, element by element, |kernel - plain| <= atol +
# rtol * |plain|: nll and lse are fp32 scores of the same operand values
# summed in another order (mma tiles vs one product), fp32 limits in both
# dtypes. dx and dW are fp32 sums over the vocabulary (dx) or the 8192
# tokens (dW) of terms up to |coef x| ~ 3, taken in another order: errors
# reach ~5e-5 at |dW| ~ 15 (atol); bf16 outputs also round on both sides
# (one ulp: rtol 2^-7)
CE_TOL = {"lse": (1e-5, 1e-5), "float32": (1e-4, 1e-5),
          "bfloat16": (1e-4, 2 ** -7)}
CE_SHAPE = (8, 1024, 768, 50304)       # B, T, C, V of the training path
CE_OUTPUTS = {"fused_ce_fwd": ("nll", "lse"), "fused_ce_bwd_dx": ("dx",),
              "fused_ce_bwd_dw": ("dw",)}
# phase 8: teacher-forced logits of the engine with an int8 KV cache, and
# with an int8 cache and int8 weights, against the bf16 engine's on phase
# 7's checkpoint, max abs over phase 5's 8 streams. int8 codes hold each
# K/V row and weight row to 1/254 of its largest entry; the H100 read
# 0.0469 and 0.0625, so the limits keep about 2x headroom
Q8_LOGIT_TOL = {"cache": 0.1, "cache_weights": 0.15}
# tokens checked against a reference's argmax at every position whose
# top-2 margin clears the limit: at least this share of each stream. bf16
# logits keep 8 significant bits (steps of 0.0625 at |logit| 8-16), so the
# bf16 share counts margins of about one rounding step or more; the H100
# read 30-100% per stream in bf16, 95-100% in fp32
MIN_CHECKED = {"float32": 0.5, "bfloat16": 0.2}
# NEAR_TOP: phase 9 serves a checkpoint trained for 20 steps, whose
# leading logits sit within a few bf16 steps of each other along whole
# streams, and its training sums the experts' outputs with atomics, so
# each run serves other weights: the H100 read 9 of 48 and 16 of 60
# positions with a bf16 margin over 0.06 (the share asks for 9 and 12),
# and fewer in another run. So phase 9 checks every position instead: the
# served token's reference logit lies within LOGIT_TOL of the row's
# largest. Where the margin clears LOGIT_TOL that is the argmax check
# above; elsewhere the token is one of the leaders.
# phase 8's teacher-forced engines: a pool smaller than the traffic's 162
# blocks (after the shared prefix), so that sequences are preempted
TF_BLOCKS = 128
# phase 6: the loss must fall at least this much from the first iteration
# to the mean of the last three
TRAIN_DROP = 1.0
# phase 7: iteration 0's loss against phase 6's. Same seed, init and
# batch, and the hidden states come from the same deterministic kernels;
# only the loss differs (fp32 logits of bf16 operands summed by the CE
# kernels' mma tiles instead of cuBLAS, logsumexp online over vocab tiles)
ITER0_TOL = 1e-4
# phase 6 parity (fp32): |loss difference|, and for every parameter the
# largest gradient difference as a fraction of that parameter's largest
# gradient
PARITY_TOL = {"loss": 1e-4, "grad": 1e-4}
# grouped matmul vs plain, element by element: |kernel - plain| <= atol x
# max|plain| + rtol x |plain|. Both sum the same fp32 products in another
# order (atol, relative to the output's scale: dW sums thousands of rows);
# bf16 outputs round on both sides (one ulp: rtol 2^-7); dW is fp32.
GMM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}
GMM_ROUTE = (8192, 8, 1, 2)     # tokens, experts, shared, routed top-k
# the training path's two products: K, N, gate-scaled
GMM_SHAPES = {"fc": (768, 2048, False), "proj": (1024, 768, True)}
GMM_SOURCE = {"grouped_mm_fwd": "grouped_mm_fwd",
              "grouped_mm_bwd_dx": "grouped_mm_bwd",
              "grouped_mm_bwd_dw": "grouped_mm_bwd"}
REPLACES = {
    "paged": "distributed_pytorch_tpu/ops/flash_decode.py:264 "
             "(_paged_body, driven by paged_flash_decode :276)",
    "contiguous": "distributed_pytorch_tpu/ops/flash_decode.py:90 "
                  "(_kernel, driven by flash_decode :184)",
    "prefill": "distributed_pytorch_tpu/ops/flash_decode.py:361 "
               "(_prefill_kernel, driven by paged_flash_prefill :458)",
    "flash_attn_fwd": "distributed_pytorch_tpu/ops/flash_attention.py:339 "
                      "(_fwd_kernel -> _fwd :367; slab face "
                      "_slab_fwd_kernel :570 -> _slab_fwd :662)",
    "flash_attn_bwd_dq": "distributed_pytorch_tpu/ops/flash_attention.py:414 "
                         "(_bwd_dq_kernel -> _bwd_impl :460; slab face "
                         "_slab_bwd_dq_kernel :601 -> _slab_bwd :707)",
    "flash_attn_bwd_dkv": "distributed_pytorch_tpu/ops/flash_attention.py:436 "
                          "(_bwd_dkv_kernel -> _bwd_impl :460; slab face "
                          "_slab_bwd_dkv_kernel :626 -> _slab_bwd :707)",
}
FLASH_SOURCE = {"flash_attn_fwd": "flash_attn_fwd",
                "flash_attn_bwd_dq": "flash_attn_bwd",
                "flash_attn_bwd_dkv": "flash_attn_bwd"}
CE_SOURCE = {"fused_ce_fwd": "fused_ce_fwd", "fused_ce_bwd_dx": "fused_ce_bwd",
             "fused_ce_bwd_dw": "fused_ce_bwd"}
REPLACES.update({
    "fused_ce_fwd": "distributed_pytorch_tpu/ops/fused_ce.py:84 "
                    "(_fwd_kernel -> _fwd :112, pallas_call :115)",
    "fused_ce_bwd_dx": "distributed_pytorch_tpu/ops/fused_ce.py:153 "
                       "(_bwd_dx_kernel -> _bwd :190, pallas_call :193)",
    "fused_ce_bwd_dw": "distributed_pytorch_tpu/ops/fused_ce.py:171 "
                       "(_bwd_dw_kernel -> _bwd :190, pallas_call :210)",
})
REPLACES.update({
    "paged_q8": "distributed_pytorch_tpu/ops/flash_decode.py:271 "
                "(_paged_body_q8, driven by paged_flash_decode :276, "
                "pallas_call :350)",
    "contiguous_q8": "distributed_pytorch_tpu/ops/flash_decode.py:131 "
                     "(_kernel_q8, driven by flash_decode :184, "
                     "pallas_call :253)",
    "prefill_q8": "distributed_pytorch_tpu/ops/flash_decode.py:408 "
                  "(_prefill_kernel_q8, driven by paged_flash_prefill :458, "
                  "pallas_call :534)",
})
REPLACES.update({
    "grouped_mm_fwd": "distributed_pytorch_tpu/ops/grouped_matmul.py:111 "
                      "(_fwd_kernel / _fwd_kernel_scaled :105 -> _fwd_call "
                      ":148, pallas_call :169)",
    "grouped_mm_bwd_dx": "distributed_pytorch_tpu/ops/grouped_matmul.py:122 "
                         "(_dx_kernel / _dx_kernel_scaled :116 -> _dx_call "
                         ":178, pallas_call :199)",
    "grouped_mm_bwd_dw": "distributed_pytorch_tpu/ops/grouped_matmul.py:127 "
                         "(_dw_kernel -> _dw_call_impl :208, pallas_call "
                         ":231)",
})
SOURCE = "distributed_pytorch_tpu_torch/csrc/{}.cu"
DEVICE = "cuda"
PHASE = ["0 start"]                       # the phase running, for fail()


def fail(msg: str) -> None:
    """End the run with exit 1, naming the phase and the failed check on
    stdout and on stderr (whose end is what a caller that keeps only the
    tail of stderr sees)."""
    line = f"chip_smoke FAILED in phase {PHASE[0]}: {msg}"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase(name: str) -> None:
    PHASE[0] = name
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def _counter_modules():
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa
    from distributed_pytorch_tpu_torch.ops import flash_decode as fd
    from distributed_pytorch_tpu_torch.ops import fused_ce as ce
    from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
    return fd, fa, ce, gm


def reset_counts() -> None:
    for m in _counter_modules():
        m.reset_counts()


def counts() -> tuple[dict, dict]:
    """(launches, plain calls) of every kernel."""
    mods = _counter_modules()
    return ({k: v for m in mods for k, v in m.LAUNCHES.items()},
            {k: v for m in mods for k, v in m.PLAIN_CALLS.items()})


def time_windows(fn, iters: int = 20, warmup: int = 3,
                 windows: int = 5) -> tuple[float, list]:
    """(median, [least, largest]) of `windows` timed windows of `iters`
    calls each (`time_ms`): a single window of SDPA's prefill read times
    1.7x apart in two runs."""
    ts = sorted(time_ms(fn, iters=iters, warmup=warmup if i == 0 else 0)
                for i in range(windows))
    return ts[len(ts) // 2], [ts[0], ts[-1]]


def device_ms(fn, iters: int = 10, tries: int = 3, names=None):
    """Device time of one call of `fn` in ms: the self time of its device
    events (kernels, copies, memsets) under torch.profiler, over `iters`
    calls. The event-timed windows also hold the host's time between
    launches, which sets them for calls shorter than their wrapper's host
    work (the bf16 prefill and SDPA's prefill: tens of us). A profile that
    recorded fewer device events than calls lost some (on the H100 one
    read 0 events, another a tenth of them) and is taken again; None if
    every try lost some. The names of the kept profile's device events go
    into the set `names` where one is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev, ms = device_kernels(prof, iters)
        if sum(e.count for e in ev) >= iters:
            if names is not None:
                names.update(e.key for e in ev)
            return ms
    return None


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# SASS mnemonics phase 2 counts: wgmma, TMA loads, cp.async, setmaxnreg
# (warp-specialized kernels hand registers between warpgroups) and stores
# to local memory (register spills)
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "USETMAXREG", "STL")
# the libraries whose kernels phase 2 inventories (flash_attn_bwd_dq and
# _dkv share one, as do grouped_mm_bwd_dx and _dw, and the bf16/fp32 and
# int8 entries of the paged kernels)
SASS_LIBS = ("flash_attn_fwd", "flash_attn_bwd_dq", "grouped_mm_fwd",
             "grouped_mm_bwd_dw", "paged_prefill_attn", "paged_decode_attn",
             "fused_ce_fwd", "fused_ce_bwd_dx")
# the bf16 kernels on wgmma: fwd, dq and dkv at D 32, 64, 80, 128 and
# 256 and dq at D 192 (the forward and dkv run head sizes 136-192 at 256),
# each built twice, for d == D and for d < D (masked stores, `kPartial`),
# the grouped forward, dx and dW unscaled (fc) and gate-scaled (proj), the
# paged prefill at hs 32, 64 and 128 over a bf16 cache and at 64 and 128
# over an int8 one, the fused CE forward, dx and dW
SASS_WGMMA_KERNELS = 46
# what a wgmma kernel's SASS must hold and must not: TMA loads, except in
# the paged prefills (bf16 and int8 caches), which gather their tiles
# through the block table with cp.async (LDGSTS) and issue no TMA load;
# the warp-specialized flash kernels (forward, dq and dkv at head size
# 256, dq at 192) also hand registers to their consumers (setmaxnreg) and
# spill none; the forward, dq and dkv at widths 80 and 32 and the bf16
# prefill at hs 32 spill none
_WS = ({"HGMMA", "UTMALDG", "USETMAXREG"}, {"STL"})
_NO_SPILL = ({"HGMMA", "UTMALDG"}, {"STL"})
SASS_EXPECT = {"prefill_kernel_sm90_q8": ({"HGMMA", "LDGSTS"}, {"UTMALDG"}),
               "prefill_kernel_sm90ILi32E": ({"HGMMA", "LDGSTS"},
                                             {"UTMALDG", "STL"}),
               "prefill_kernel_sm90": ({"HGMMA", "LDGSTS"}, {"UTMALDG"}),
               "fwd_kernel_sm90ILi256E": _WS, "dkv_kernel_sm90ILi256E": _WS,
               "dq_kernel_sm90ILi256E": _WS, "dq_kernel_sm90ILi192E": _WS,
               "fwd_kernel_sm90ILi80E": _NO_SPILL,
               "dkv_kernel_sm90ILi80E": _NO_SPILL,
               "dq_kernel_sm90ILi80E": _NO_SPILL,
               "fwd_kernel_sm90ILi32E": _NO_SPILL,
               "dkv_kernel_sm90ILi32E": _NO_SPILL,
               "dq_kernel_sm90ILi32E": _NO_SPILL}
SASS_EXPECT_SM90 = ({"HGMMA", "UTMALDG"}, set())
# every other kernel (fp32, int8, the decode's split-KV pair over every
# cache type) holds neither wgmma nor TMA loads
SASS_EXPECT_OTHER = (set(), {"HGMMA", "UTMALDG"})
# kernels that must be in the inventory by name: the split-KV decode's two
# (one query row per head makes no matrix product: CUDA cores), the
# int8-cache prefill on wgmma, the flash kernels at head size 256
# (MLA's q_c | q_r): wgmma in bf16 (`..._sm90ILi256E`; the dq, like the
# dq at 192, warp-specialized in `flash_ws`), FMA in fp32 (`...IfLi256E`),
# the bf16 forward, dq and dkv at width 80 (the flagship with MLA) and at
# width 32 (the default config; pipelined, `flash_pipe`), and the bf16
# prefill at hs 32 (the default config's serving) with the merge of its
# split launches (`prefill_combine`, on CUDA cores)
SASS_REQUIRED = ("decode_split_kernel", "decode_combine_kernel",
                 "prefill_kernel_sm90_q8", "prefill_kernel_sm90ILi32E",
                 "prefill_combineILi32E",
                 "flash_pipe15fwd_kernel_sm90ILi32E",
                 "fwd_kernel_sm90ILi80E", "dkv_kernel_sm90ILi80E",
                 "flash_sm9014dq_kernel_sm90ILi80E",
                 "flash_pipe15dkv_kernel_sm90ILi32E",
                 "flash_pipe14dq_kernel_sm90ILi32E",
                 "flash_ws14dq_kernel_sm90ILi192E",
                 "fwd_kernel_sm90ILi256E",
                 "flash_ws14dq_kernel_sm90ILi256E", "dkv_kernel_sm90ILi256E",
                 "fwd_kernelIfLi256E", "dq_kernelIfLi256E",
                 "dkv_kernelIfLi256E")


def sass_inventory() -> dict:
    """{kernel: {op: count}} of SASS_OPS in the built libraries of
    SASS_LIBS (`cuobjdump -sass`), kernels by their mangled names."""
    import shutil

    from distributed_pytorch_tpu_torch.ops import cuda_build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    counts = {}
    for name in SASS_LIBS:
        out = subprocess.run([tool, "-sass", str(cuda_build.lib_path(name))],
                             capture_output=True, text=True, timeout=120)
        check(out.returncode == 0,
              f"cuobjdump -sass failed on {name}: {out.stderr[-500:]}")
        fn = None
        for line in out.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
            elif fn is not None:
                for op in SASS_OPS:
                    counts[fn][op] += re.search(rf"\b{op}\b", line) is not None
    return counts


def sass_expected(fn: str) -> tuple[set, set]:
    """(instructions kernel `fn` must hold, instructions it must not)."""
    if "kernel_sm90" not in fn:
        return SASS_EXPECT_OTHER
    for key, want in SASS_EXPECT.items():
        if key in fn:
            return want
    return SASS_EXPECT_SM90


def check_sass(counts: dict) -> None:
    """The bf16 wgmma kernels (`*_kernel_sm90*`) hold HGMMA and their
    loads (TMA, or cp.async in the paged prefills, which hold no TMA
    load); the flash forward, dq and dkv at head size 256 and the dq at
    192 hold setmaxnreg and no local-memory store, the forward, dq and
    dkv at widths 80 and 32 and the bf16 prefill at hs 32 no local-memory
    store; the split-KV decode's kernels, the int8-cache prefill, the
    bf16 prefill at hs 32 and its split's merge, the flash kernels at
    head size 256 and the forward, dq and dkv at widths 80 and 32 are
    there; every other kernel holds neither HGMMA nor a TMA load."""
    for name in SASS_REQUIRED:
        check(any(name in fn for fn in counts),
              f"no {name} in the inventory: {sorted(counts)}")
    n_sm90 = sum("kernel_sm90" in fn for fn in counts)
    check(n_sm90 == SASS_WGMMA_KERNELS,
          f"expected {SASS_WGMMA_KERNELS} bf16 wgmma kernels, found "
          f"{n_sm90}: {sorted(counts)}")
    for fn, c in sorted(counts.items()):
        # drop nvcc's anonymous-namespace prefix (_GLOBAL__N__<hash>_<n>_)
        short = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_", "", fn)[:80]
        print(f"  {short}: " + ", ".join(f"{op} {n}" for op, n in c.items()),
              flush=True)
        need, ban = sass_expected(fn)
        missing = sorted(op for op in need if not c.get(op))
        found = sorted(op for op in ban if c.get(op))
        check(not missing, f"{short}: no {missing} in its SASS")
        check(not found, f"{short}: {found} in its SASS, which should have "
                         f"none ({c})")


def _timed(r: dict, key: str) -> str:
    """'<median> ms [<least>-<largest>]' of result `r`'s kernel ('ms') or
    library ('library') windows, and its device time where measured."""
    pre = "" if key == "ms" else "library_"
    lo, hi = r[("ms" if key == "ms" else "library") + "_spread"]
    dev = r.get(pre + "device_ms")
    return (f"{r[pre + 'ms']:.4f} ms [{lo:.4f}-{hi:.4f}]"
            + ("" if dev is None else f" (device {dev:.4f} ms)"))


def bound(n_bytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def kernel_cases(torch, fd, dev):
    """Yield (case, fn_kernel, fn_plain, fn_library, n_bytes, flops) per
    dtype at the serving path's shapes."""
    import torch.nn.functional as F

    from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather
    from distributed_pytorch_tpu_torch.ops.quant import quantize_kv

    B, nh, nkv, hs, bs, n_max = 8, 12, 12, 64, 16, 64
    n_blocks = 520
    scale = hs ** -0.5
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cl_list = [1, 17, 300, 1024, 5, 64, 511, 900]
    rng = np.random.default_rng(0)
    tables = torch.from_numpy(rng.permutation(np.arange(1, 1 + B * n_max))
                              .reshape(B, n_max).astype(np.int32)).to(dev)
    cl = torch.tensor(cl_list, dtype=torch.int32, device=dev)
    S = n_max * bs
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        el = torch.finfo(dtype).bits // 8
        kp = torch.randn(n_blocks, bs, nkv, hs, generator=g, device=dev) \
            .to(dtype)
        vp = torch.randn(n_blocks, bs, nkv, hs, generator=g, device=dev) \
            .to(dtype)
        q = torch.randn(B, nh, hs, generator=g, device=dev).to(dtype)
        live = sum(cl_list)
        dec_bytes = (2 * B * nh * hs + 2 * live * nkv * hs) * el \
            + tables.numel() * 4 + B * 4
        dec_flops = 4 * live * nh * hs

        # paged decode; library yardstick: SDPA over the gathered view
        kl = paged_gather(kp, tables).transpose(1, 2)        # (B, nkv, S, hs)
        vl = paged_gather(vp, tables).transpose(1, 2)
        dmask = (torch.arange(S, device=dev)[None, :] < cl[:, None]) \
            [:, None, None, :]
        yield (dn, "paged",
               lambda: fd.paged_flash_decode(q, kp, vp, tables, cl,
                                             scale=scale),
               lambda: fd.paged_flash_decode_plain(q, kp, vp, tables, cl,
                                                   scale=scale),
               lambda: F.scaled_dot_product_attention(
                   q[:, :, None], kl, vl, attn_mask=dmask, scale=scale),
               dec_bytes, dec_flops)

        # contiguous decode: S = 1024 rows per sequence
        kc = torch.randn(B, S, nkv, hs, generator=g, device=dev).to(dtype)
        vc = torch.randn(B, S, nkv, hs, generator=g, device=dev).to(dtype)
        kct, vct = kc.transpose(1, 2), vc.transpose(1, 2)
        yield (dn, "contiguous",
               lambda: fd.flash_decode(q, kc, vc, cl, scale=scale),
               lambda: fd.flash_decode_plain(q, kc, vc, cl, scale=scale),
               lambda: F.scaled_dot_product_attention(
                   q[:, :, None], kct, vct, attn_mask=dmask, scale=scale),
               dec_bytes - tables.numel() * 4, dec_flops)

        # paged prefill: a 512-row chunk at offsets 0 and 256
        T = 512
        qp = torch.randn(1, T, nh, hs, generator=g, device=dev).to(dtype)
        table = tables[3:4]
        for off in (0, 256):
            kpre = paged_gather(kp, table)[:, :off + T].transpose(1, 2)
            vpre = paged_gather(vp, table)[:, :off + T].transpose(1, 2)
            pmask = (torch.arange(off + T, device=dev)[None, :]
                     <= off + torch.arange(T, device=dev)[:, None])
            keys = T * off + T * (T + 1) // 2
            yield (dn, f"prefill_off{off}",
                   lambda off=off: fd.paged_flash_prefill(
                       qp, kp, vp, table, off, scale=scale),
                   lambda off=off: fd.paged_flash_prefill_plain(
                       qp, kp, vp, table, off, scale=scale),
                   lambda kpre=kpre, vpre=vpre, pmask=pmask:
                   F.scaled_dot_product_attention(
                       qp.transpose(1, 2), kpre, vpre, attn_mask=pmask,
                       scale=scale),
                   (2 * T * nh * hs + 2 * (off + T) * nkv * hs) * el
                   + n_max * 4,
                   4 * keys * nh * hs)

        # the bf16 prefill at the default config's head size 32 (GQA 8 / 4,
        # its own wgmma kernel), same chunk, table and offsets; its own
        # generator, so that the cases after it draw what they drew before
        if dtype == torch.bfloat16:
            yield from _prefill_hs32_cases(torch, fd, dev, dn, table, T,
                                           n_blocks, bs, n_max)

        # the same calls over an int8 cache with fp32 row scales (the _q8
        # kernels). No PyTorch call takes int8 codes with row scales: the
        # yardstick is the path they replace, the gathered rows
        # dequantized to the activations' dtype, then SDPA.
        (pkc, pks), (pvc, pvs) = quantize_kv(kp), quantize_kv(vp)
        sc = dict(k_scale=pks, v_scale=pvs)
        q8_row = nkv * (2 * hs + 2 * 4)          # K and V codes + scales

        def deq(codes, scales):
            return (codes.float() * scales).to(dtype)

        gk = (paged_gather(pkc, tables), paged_gather(pks, tables))
        gv = (paged_gather(pvc, tables), paged_gather(pvs, tables))
        yield (dn, "paged_q8",
               lambda: fd.paged_flash_decode(q, pkc, pvc, tables, cl,
                                             scale=scale, **sc),
               lambda: fd.paged_flash_decode_plain(q, pkc, pvc, tables, cl,
                                                   scale=scale, **sc),
               lambda: F.scaled_dot_product_attention(
                   q[:, :, None], deq(*gk).transpose(1, 2),
                   deq(*gv).transpose(1, 2), attn_mask=dmask, scale=scale),
               2 * B * nh * hs * el + live * q8_row + tables.numel() * 4
               + B * 4, dec_flops)
        (kcc, kcs), (vcc, vcs) = quantize_kv(kc), quantize_kv(vc)
        csc = dict(k_scale=kcs, v_scale=vcs)
        yield (dn, "contiguous_q8",
               lambda: fd.flash_decode(q, kcc, vcc, cl, scale=scale, **csc),
               lambda: fd.flash_decode_plain(q, kcc, vcc, cl, scale=scale,
                                             **csc),
               lambda: F.scaled_dot_product_attention(
                   q[:, :, None], deq(kcc, kcs).transpose(1, 2),
                   deq(vcc, vcs).transpose(1, 2), attn_mask=dmask,
                   scale=scale),
               2 * B * nh * hs * el + live * q8_row + B * 4, dec_flops)
        for off in (0, 256):
            rows = slice(0, off + T)
            pk = (paged_gather(pkc, table)[:, rows],
                  paged_gather(pks, table)[:, rows])
            pv = (paged_gather(pvc, table)[:, rows],
                  paged_gather(pvs, table)[:, rows])
            pmask = (torch.arange(off + T, device=dev)[None, :]
                     <= off + torch.arange(T, device=dev)[:, None])
            keys = T * off + T * (T + 1) // 2
            yield (dn, f"prefill_q8_off{off}",
                   lambda off=off: fd.paged_flash_prefill(
                       qp, pkc, pvc, table, off, scale=scale, **sc),
                   lambda off=off: fd.paged_flash_prefill_plain(
                       qp, pkc, pvc, table, off, scale=scale, **sc),
                   lambda pk=pk, pv=pv, pmask=pmask:
                   F.scaled_dot_product_attention(
                       qp.transpose(1, 2), deq(*pk).transpose(1, 2),
                       deq(*pv).transpose(1, 2), attn_mask=pmask,
                       scale=scale),
                   2 * T * nh * hs * el + (off + T) * q8_row + n_max * 4,
                   4 * keys * nh * hs)


def _prefill_hs32_cases(torch, fd, dev, dn, table, T, n_blocks, bs, n_max):
    """The paged prefill at head size 32, 8 / 4 heads (the default
    config's serving): a T-row bf16 chunk at offsets 0 and 256 through
    `table`, beside SDPA over the gathered rows (GQA)."""
    import torch.nn.functional as F

    from distributed_pytorch_tpu_torch.ops.block_pool import paged_gather

    hs, nh, nkv, el = 32, 8, 4, 2
    scale = hs ** -0.5
    g = torch.Generator(device=dev)
    g.manual_seed(32)
    kp, vp = (torch.randn(n_blocks, bs, nkv, hs, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    qp = torch.randn(1, T, nh, hs, generator=g, device=dev) \
        .to(torch.bfloat16)
    for off in (0, 256):
        kpre = paged_gather(kp, table)[:, :off + T].transpose(1, 2)
        vpre = paged_gather(vp, table)[:, :off + T].transpose(1, 2)
        pmask = (torch.arange(off + T, device=dev)[None, :]
                 <= off + torch.arange(T, device=dev)[:, None])
        keys = T * off + T * (T + 1) // 2
        yield (dn, f"prefill_hs32_off{off}",
               lambda off=off: fd.paged_flash_prefill(
                   qp, kp, vp, table, off, scale=scale),
               lambda off=off: fd.paged_flash_prefill_plain(
                   qp, kp, vp, table, off, scale=scale),
               lambda kpre=kpre, vpre=vpre, pmask=pmask:
               F.scaled_dot_product_attention(
                   qp.transpose(1, 2), kpre, vpre, attn_mask=pmask,
                   scale=scale, enable_gqa=True),
               (2 * T * nh * hs + 2 * (off + T) * nkv * hs) * el
               + n_max * 4,
               4 * keys * nh * hs)


#: the flash kernels' shapes on the training paths, by head size: (B, T,
#: heads, kv heads) of the flagship's attention (64, phase 6), the
#: launcher's MLA model, whose q_c | q_r and k_c | k_r are 128 + 128 wide
#: (256, phase 10), the default LLMConfig (32, GQA 8 / 4, phase 11) and
#: the flagship with `--attn mla` (80 = 64 + 16, phase 11). Timed.
FLASH_SHAPES = {64: (8, 1024, 12, 12), 256: (8, 1024, 8, 8),
                32: (8, 1024, 8, 4), 80: (8, 1024, 12, 12)}
#: head sizes held against their plain versions but not timed: MLA on the
#: default config (48 = 32 + 16), the flagship with the launcher's rope
#: head (192 = 64 + 128) and 24 (the bf16 dq and dkv on their masked
#: width-32 instances)
FLASH_CHECKED = {48: (8, 1024, 8, 8), 192: (8, 1024, 12, 12),
                 24: (8, 1024, 8, 4)}


def flash_cases(torch, dev):
    """Yield (dtype, kernel, head size, fn_kernel, fn_plain, fn_library,
    n_bytes, flops) for the three flash kernels at each FLASH_SHAPES and
    FLASH_CHECKED shape. Bytes and operations count the true head size,
    not the width the kernels run it at."""
    for D, shape in {**FLASH_SHAPES, **FLASH_CHECKED}.items():
        yield from _flash_cases_at(torch, dev, *shape, D)


def _flash_cases_at(torch, dev, B, T, nh, nkv, D):
    import torch.nn.functional as F

    from distributed_pytorch_tpu_torch.ops import flash_attention as fa

    scale = D ** -0.5
    pairs = B * nh * T * (T + 1) // 2          # causal (query, key) pairs
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        el = torch.finfo(dtype).bits // 8

        def rnd(n):
            return torch.randn(B, T, n, D, generator=g, device=dev).to(dtype)

        q, k, v, dout = rnd(nh), rnd(nkv), rnd(nkv), rnd(nh)
        out, lse = fa.flash_attn_fwd_plain(q, k, v, scale=scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        kw = dict(scale=scale, causal=True)
        act = B * T * nh * D * el                # a query-head activation
        kv = B * T * nkv * D * el                # a kv-head one (k, v, dk, dv)
        stat = B * nh * T * 4                    # lse or delta (fp32)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        gqa = dict(enable_gqa=True) if nkv != nh else {}
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 scale=scale, **gqa)
        lib_dout = dout.transpose(1, 2)
        yield (dn, "flash_attn_fwd", D,
               lambda: fa.flash_attn_fwd(q, k, v, **kw),
               lambda: fa.flash_attn_fwd_plain(q, k, v, **kw),
               lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   is_causal=True, scale=scale, **gqa),
               2 * act + 2 * kv + stat, 4 * pairs * D)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (qt, kt, vt), lib_dout,
                                       retain_graph=True)

        yield (dn, "flash_attn_bwd_dq", D,
               lambda: fa.flash_attn_bwd_dq(q, k, v, dout, lse, delta, **kw),
               lambda: fa.flash_attn_bwd_dq_plain(q, k, v, dout, lse, delta,
                                                  **kw),
               lib_bwd, 3 * act + 2 * kv + 2 * stat, 6 * pairs * D)
        yield (dn, "flash_attn_bwd_dkv", D,
               lambda: fa.flash_attn_bwd_dkv(q, k, v, dout, lse, delta,
                                             **kw),
               lambda: fa.flash_attn_bwd_dkv_plain(q, k, v, dout, lse,
                                                   delta, **kw),
               lib_bwd, 2 * act + 4 * kv + 2 * stat, 8 * pairs * D)


def _elementwise(out, ref, atol: float, rtol: float) -> dict:
    """Readings of `out` against `ref` under |out - ref| <= atol + rtol *
    |ref|: the largest error, the reference's largest and RMS magnitude,
    the worst error as a fraction of its limit, and the least atol that
    would pass at this rtol."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    return dict(err=d.max().item(), mag=r.max().item(),
                rms=r.square().mean().sqrt().item(),
                frac=(d / (atol + rtol * r)).max().item(),
                need_atol=(d - rtol * r).clamp_min(0).max().item())


def run_flash_kernels(torch, dev) -> dict:
    results = {}
    for dn, name, D, fk, fp, fl, n_bytes, flops in flash_cases(torch, dev):
        out, ref = fk(), fp()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        check(all(bool(torch.isfinite(t).all()) for t in outs),
              f"{name} {dn}: non-finite")
        errs, tols = {}, {}
        for oname, a, b in zip(FLASH_OUTPUTS[name], outs, refs):
            atol, rtol = FLASH_TOL["float32" if oname == "lse" else dn]
            e = errs[oname] = _elementwise(a, b, atol, rtol)
            tols[oname] = {"atol": atol, "rtol": rtol}
            print(f"  {name:18s} D {D:3d} {dn:9s} {oname:3s} max_abs_err "
                  f"{e['err']:.3e} (|ref| max {e['mag']:.3e}, rms "
                  f"{e['rms']:.3e}); worst {e['frac']:.3f} of its limit "
                  f"{atol:.0e} + {rtol:.2e} x |ref|; least atol at this "
                  f"rtol {e['need_atol']:.3e}", flush=True)
            check(e["frac"] <= 1.0,
                  f"{name} D {D} {dn}: {oname} differs from its plain "
                  f"version beyond {atol} + {rtol} x |plain| "
                  f"({e['frac']:.3f} of "
                  f"the limit)")
        b_ms, b_by = bound(n_bytes, flops, dn)
        if D not in FLASH_SHAPES:       # checked only
            results[(name, dn, D)] = dict(
                max_abs_err=max(e["err"] for o, e in errs.items()
                                if o != "lse"), tol=tols)
            continue
        ms, spread = time_windows(fk, iters=10)
        lib_ms, lib_spread = time_windows(fl, iters=10)
        results[(name, dn, D)] = dict(
            max_abs_err=max(e["err"] for o, e in errs.items() if o != "lse"),
            lse_max_abs_err=errs["lse"]["err"] if "lse" in errs else None,
            tol=tols, ms=ms, ms_spread=spread, device_ms=device_ms(fk),
            plain_ms=time_ms(fp, iters=3, warmup=1),
            library_ms=lib_ms, library_spread=lib_spread,
            library_device_ms=device_ms(fl), bound_ms=b_ms,
            bound_by=b_by, bytes=n_bytes, flops=flops)
        r = results[(name, dn, D)]
        print(f"  {'':18s} {'':5s} {'':9s} kernel {_timed(r, 'ms')}, plain "
              f"{r['plain_ms']:.4f} ms, library {_timed(r, 'library')}, "
              f"bound {r['bound_ms']:.4f} ms ({b_by})", flush=True)
    torch.cuda.empty_cache()
    return results


#: phase 3's head-offset check: (head size, B, T, heads, kv heads, tp) of a
#: tensor-parallel rank's flash calls, the flagship at tp 4 (3 of 12
#: heads of 64 a rank) and the default config at tp 2 (4 of 8 query and 2
#: of 4 kv heads of 32 a rank)
FLASH_OFFSETS = ((64, 4, 512, 12, 12, 4), (32, 4, 512, 8, 4, 2))
FLASH_OFFSET_RATE = 0.2


def run_flash_offsets(torch, dev) -> dict:
    """The three flash kernels over a slice of the heads (`head_offset`,
    `total_heads`, as a tensor-parallel rank calls them) at dropout 0.2,
    fp32 and bf16, at FLASH_OFFSETS: each rank's outputs held against the
    plain version with the same offset under FLASH_TOL, and equal, byte for
    byte, to that slice of the whole call's; the whole call with offset 0
    and its own head count given explicitly equal, byte for byte, to the
    call without them. Returns {(kernel, dtype, D): max_abs_err}."""
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa

    res = {}
    for D, B, T, nh, nkv, tp in FLASH_OFFSETS:
        g = torch.Generator(device=dev)
        g.manual_seed(4)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).removeprefix("torch.")

            def rnd(n):
                return torch.randn(B, T, n, D, generator=g,
                                   device=dev).to(dtype)

            q, k, v, dout = rnd(nh), rnd(nkv), rnd(nkv), rnd(nh)
            seed = torch.tensor([977, -31], dtype=torch.int32, device=dev)
            kw = dict(scale=D ** -0.5, causal=True,
                      dropout_rate=FLASH_OFFSET_RATE)
            out, lse = fa.flash_attn_fwd(q, k, v, seed, **kw)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            whole = {
                "flash_attn_fwd": (out, lse),
                "flash_attn_bwd_dq": (fa.flash_attn_bwd_dq(
                    q, k, v, dout, lse, delta, seed, **kw),),
                "flash_attn_bwd_dkv": fa.flash_attn_bwd_dkv(
                    q, k, v, dout, lse, delta, seed, **kw)}
            explicit = dict(kw, head_offset=0, total_heads=nh)
            again = fa.flash_attn_fwd(q, k, v, seed, **explicit)
            check(all(torch.equal(a, b) for a, b in zip(again, (out, lse))),
                  f"flash_attn_fwd {dn} D {D}: offset 0 over its own heads "
                  "wrote other bytes than the call without them")
            for r in range(tp):
                hq = slice(r * nh // tp, (r + 1) * nh // tp)
                hk = slice(r * nkv // tp, (r + 1) * nkv // tp)
                part = dict(kw, head_offset=hq.start, total_heads=nh)
                args = (q[:, :, hq], k[:, :, hk], v[:, :, hk])
                bw = (*args, dout[:, :, hq], lse[:, hq].contiguous(),
                      delta[:, hq].contiguous(), seed)
                calls = {
                    "flash_attn_fwd": (
                        lambda: fa.flash_attn_fwd(*args, seed, **part),
                        lambda: fa.flash_attn_fwd_plain(*args, seed, **part),
                        lambda t: (t[0][:, :, hq], t[1][:, hq])),
                    "flash_attn_bwd_dq": (
                        lambda: (fa.flash_attn_bwd_dq(*bw, **part),),
                        lambda: (fa.flash_attn_bwd_dq_plain(*bw, **part),),
                        lambda t: (t[0][:, :, hq],)),
                    "flash_attn_bwd_dkv": (
                        lambda: fa.flash_attn_bwd_dkv(*bw, **part),
                        lambda: fa.flash_attn_bwd_dkv_plain(*bw, **part),
                        lambda t: (t[0][:, :, hk], t[1][:, :, hk]))}
                for name, (fk, fp, sl) in calls.items():
                    outs, refs = fk(), fp()
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in
                              zip(outs, sl(whole[name]))),
                          f"{name} {dn} D {D}: heads {hq.start} .. of "
                          f"{nh} differ from the whole call's bytes")
                    onames = FLASH_OUTPUTS[name]
                    for oname, a, b in zip(onames, outs, refs):
                        atol, rtol = FLASH_TOL["float32" if oname == "lse"
                                               else dn]
                        e = _elementwise(a, b, atol, rtol)
                        check(e["frac"] <= 1.0,
                              f"{name} {dn} D {D} heads {hq.start} ..: "
                              f"{oname} beyond its limit "
                              f"({e['frac']:.3f})")
                        if oname != "lse":
                            res[(name, dn, D)] = max(
                                res.get((name, dn, D), 0.0), e["err"])
            print(f"  head offset, dropout {FLASH_OFFSET_RATE}, {dn} D {D} "
                  f"({nh} / {nkv} heads over tp {tp}): every rank's heads "
                  f"equal the whole call's bytes; against the plain "
                  f"version max_abs_err "
                  + ", ".join(f"{n.removeprefix('flash_attn_')} "
                              f"{res[(n, dn, D)]:.3e}" for n in FLASH_SOURCE),
                  flush=True)
    torch.cuda.empty_cache()
    return res


#: phase 3's position-offset check: (head size, B, T, heads, kv heads) of
#: a ring attention hop's flash calls (the flagship's 12 heads of 64, the
#: default config's 8 / 4 heads of 32), and the row at which the block
#: starts (a multiple of every kernel's 128-row tile)
FLASH_POSITIONS = ((64, 2, 1024, 12, 12), (32, 2, 1024, 8, 4))
FLASH_POSITION_START = 512


def run_flash_positions(torch, dev) -> dict:
    """The three flash kernels over a block of a longer sequence (`q_pos0`
    / `k_pos0`, as a ring attention hop calls them) at dropout 0.2, fp32
    and bf16, full (non-causal) attention as an off-diagonal hop runs: the
    forward and dq over query rows FLASH_POSITION_START .. at q_pos0 =
    that row, and dkv over the key rows from there at k_pos0, each held
    against its plain version at the same offsets under FLASH_TOL and
    equal, byte for byte, to those rows of the whole call's outputs (the
    mask keyed on global positions). Returns {(kernel, dtype, D):
    max_abs_err}."""
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa

    res = {}
    s0 = FLASH_POSITION_START
    for D, B, T, nh, nkv in FLASH_POSITIONS:
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).removeprefix("torch.")

            def rnd(n):
                return torch.randn(B, T, n, D, generator=g,
                                   device=dev).to(dtype)

            q, k, v, dout = rnd(nh), rnd(nkv), rnd(nkv), rnd(nh)
            seed = torch.tensor([-5, 1229], dtype=torch.int32, device=dev)
            kw = dict(scale=D ** -0.5, causal=False,
                      dropout_rate=FLASH_OFFSET_RATE)
            out, lse = fa.flash_attn_fwd(q, k, v, seed, **kw)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            bw = (q, k, v, dout, lse, delta, seed)
            dq = fa.flash_attn_bwd_dq(*bw, **kw)
            dk, dv = fa.flash_attn_bwd_dkv(*bw, **kw)
            r = slice(s0, T)
            qb = (q[:, r], k, v)
            qbw = (*qb, dout[:, r], lse[:, :, r].contiguous(),
                   delta[:, :, r].contiguous(), seed)
            kbw = (q, k[:, r], v[:, r], dout, lse, delta, seed)
            at_q, at_k = dict(kw, q_pos0=s0), dict(kw, k_pos0=s0)
            calls = {
                "flash_attn_fwd": (
                    lambda: fa.flash_attn_fwd(*qb, seed, **at_q),
                    lambda: fa.flash_attn_fwd_plain(*qb, seed, **at_q),
                    (out[:, r], lse[:, :, r])),
                "flash_attn_bwd_dq": (
                    lambda: (fa.flash_attn_bwd_dq(*qbw, **at_q),),
                    lambda: (fa.flash_attn_bwd_dq_plain(*qbw, **at_q),),
                    (dq[:, r],)),
                "flash_attn_bwd_dkv": (
                    lambda: fa.flash_attn_bwd_dkv(*kbw, **at_k),
                    lambda: fa.flash_attn_bwd_dkv_plain(*kbw, **at_k),
                    (dk[:, r], dv[:, r]))}
            for name, (fk, fp, whole) in calls.items():
                outs, refs = fk(), fp()
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(outs, whole)),
                      f"{name} {dn} D {D}: the block at position {s0} "
                      "differs from those rows of the whole call")
                for oname, a, b in zip(FLASH_OUTPUTS[name], outs, refs):
                    atol, rtol = FLASH_TOL["float32" if oname == "lse"
                                           else dn]
                    e = _elementwise(a, b, atol, rtol)
                    check(e["frac"] <= 1.0,
                          f"{name} {dn} D {D} at position {s0}: {oname} "
                          f"beyond its limit ({e['frac']:.3f})")
                    if oname != "lse":
                        res[(name, dn, D)] = max(res.get((name, dn, D), 0.0),
                                                 e["err"])
            print(f"  positions from {s0}, dropout {FLASH_OFFSET_RATE}, {dn} "
                  f"D {D} ({nh} / {nkv} heads, T {T}): every block equals "
                  f"the whole call's rows byte for byte; against the plain "
                  f"version max_abs_err "
                  + ", ".join(f"{n.removeprefix('flash_attn_')} "
                              f"{res[(n, dn, D)]:.3e}" for n in FLASH_SOURCE),
                  flush=True)
    torch.cuda.empty_cache()
    return res


#: phase 3's width comparison, bf16 at B 8, T 1024, causal: (head size,
#: the built width it runs at, where the kernel is built at it, heads, kv
#: heads). 192 at 192 (the 192-wide warp-specialized dq; the forward and
#: dkv have no width 192 and run 256 in both rows) against 256 (the
#: 256-wide dq); 80 at its own width 80 (forward, dq, dkv) against 80 at
#: 128, masked, and 128 at 128; 32 at its own width 32 (forward, dq,
#: dkv) against 32 at 64, masked (the instances these head sizes ran
#: before), at the default config's GQA 8 / 4 heads: the padded columns'
#: cost.
FLASH_WIDTHS = ((192, 192, 12, 12), (192, 256, 12, 12), (80, 80, 12, 12),
                (80, 128, 12, 12), (128, 128, 12, 12), (32, 32, 8, 4),
                (32, 64, 8, 4))


def run_flash_widths(torch, dev) -> dict:
    """Device ms of the bf16 flash kernels at head size d run at each
    FLASH_WIDTHS width (`padded_width` pinned to it where the kernel is
    built at it, else the width the wrapper picks), each held to its
    plain version under FLASH_TOL first. Returns {(kernel, d, width):
    device ms}."""
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa

    chosen = fa.padded_width
    res = {}
    for d, w, nh, nkv in FLASH_WIDTHS:
        for dn, name, _, fk, fp, _, n_bytes, flops in _flash_cases_at(
                torch, dev, 8, 1024, nh, nkv, d):
            if dn != "bfloat16":
                continue
            fa.padded_width = lambda d_, kernel, dtype, w=w: (
                w if w in fa.WIDTHS[kernel][dtype]
                else chosen(d_, kernel, dtype))
            ran = fa.padded_width(d, name, torch.bfloat16)
            try:
                outs = fk()
                outs = outs if isinstance(outs, tuple) else (outs,)
                refs = fp()
                refs = refs if isinstance(refs, tuple) else (refs,)
                for oname, a, b in zip(FLASH_OUTPUTS[name], outs, refs):
                    atol, rtol = FLASH_TOL["float32" if oname == "lse"
                                           else dn]
                    e = _elementwise(a, b, atol, rtol)
                    check(e["frac"] <= 1.0,
                          f"{name} d {d} at width {ran}: {oname} beyond its "
                          f"limit ({e['frac']:.3f})")
                ms = res[(name, d, w)] = device_ms(fk)
            finally:
                fa.padded_width = chosen
            b_ms, b_by = bound(n_bytes, flops, dn)
            print(f"  {name:18s} d {d:3d} at width {ran:3d} (bf16, {nh} / "
                  f"{nkv} heads): "
                  f"device {ms if ms is None else round(ms, 4)} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}); the width the wrapper picks: "
                  f"{chosen(d, name, torch.bfloat16)}", flush=True)
    torch.cuda.empty_cache()
    return res


# the kernel each phase 3 prefill row must run, by (case, dtype): the C
# entries pick it by dtype and head size (64, and 32 in "prefill_hs32",
# whose split launches also merge the halves, `prefill_combine<32>`)
# before launch
PREFILL_KERNELS = {
    ("prefill", "bfloat16"): "prefill_kernel_sm90<64>",
    ("prefill_hs32", "bfloat16"): "prefill_kernel_sm90<32>",
    ("prefill_q8", "bfloat16"): "prefill_kernel_sm90_q8<64>",
    ("prefill", "float32"): "paged_prefill_kernel<float, float>",
    ("prefill_q8", "float32"): "paged_prefill_kernel<float, signed char>"}


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without its return type, namespace
    and parameter list: 'decode_split_kernel<float, float, 1>'."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split(">(")[0] + ">" if ">(" in key else key


def run_kernels(torch, fd, dev) -> dict:
    results = {}
    for dn, case, fk, fp, fl, n_bytes, flops in kernel_cases(torch, fd, dev):
        out = fk()
        ref = fp()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{case} {dn}: non-finite")
        err = (out.float() - ref.float()).abs().max().item()
        ok = err <= TOL[dn]
        print(f"  {case:14s} {dn:9s} max_abs_err {err:.3e} "
              f"(tol {TOL[dn]:.0e})", flush=True)
        check(ok, f"{case} {dn}: kernel differs from its plain version by "
                  f"{err} > {TOL[dn]}")
        b_ms, b_by = bound(n_bytes, flops, dn)
        ms, spread = time_windows(fk)
        lib_ms, lib_spread = time_windows(fl)
        launched = set()
        results[(case, dn)] = dict(
            max_abs_err=err, tol=TOL[dn], ms=ms, ms_spread=spread,
            device_ms=device_ms(fk, names=launched), plain_ms=time_ms(fp),
            library_ms=lib_ms, library_spread=lib_spread,
            library_device_ms=device_ms(fl), bound_ms=b_ms, bound_by=b_by,
            bytes=n_bytes, flops=flops)
        r = results[(case, dn)]
        kernels = r["kernels"] = sorted({kernel_name(k) for k in launched
                                         if "_kernel" in k or "combine" in k})
        want = PREFILL_KERNELS.get((case.split("_off")[0], dn))
        if want is not None:
            # the route's kernel, and (hs 32, split) the merge of its halves
            names = (want,) + (("prefill_combine<32>",)
                               if case.startswith("prefill_hs32") else ())
            check(r["device_ms"] is None or (
                any(want in k for k in kernels)
                and all(any(n in k for n in names) for k in kernels)),
                f"{case} {dn}: the profile saw {kernels}, not {names}")
        if case in ("paged", "contiguous", "paged_q8", "contiguous_q8"):
            # the split-KV pair at head size 64, over every cache type
            check(r["device_ms"] is None or (
                any("decode_split_kernel" in k for k in kernels)
                and any("decode_combine_kernel" in k for k in kernels)),
                f"{case} {dn}: the profile saw {kernels}, not the split-KV "
                f"pair")
        print(f"  {'':14s} {'':9s} kernel {_timed(r, 'ms')}, plain "
              f"{r['plain_ms']:.4f} ms, library {_timed(r, 'library')}, "
              f"bound {r['bound_ms']:.4f} ms ({b_by}); launched "
              f"{kernels}", flush=True)
    return results


def ce_cases(torch, dev):
    """Yield per dtype first the yardsticks {name: fn}: the chunked loss
    the kernels replace (forward; forward and backward) and torch.mm of
    x W^T alone; then (dtype, kernel, fn_kernel, fn_plain, n_bytes, flops)
    for the three fused CE kernels at the training path's shape."""
    from distributed_pytorch_tpu_torch.ops import fused_ce as ce
    from distributed_pytorch_tpu_torch.ops.losses import (_mm_f32,
                                                          fused_cross_entropy)

    B, T, C, V = CE_SHAPE
    n = B * T
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        el = torch.finfo(dtype).bits // 8
        x = torch.randn(n, C, generator=g, device=dev).to(dtype)
        w = (0.02 * torch.randn(V, C, generator=g, device=dev)).to(dtype)
        t = torch.randint(0, V, (n,), generator=g, device=dev,
                          dtype=torch.int32)
        t[:64] = -2                                  # ignored rows
        # coef of unit scale, so dx and dW are not all near 0 (the loss's
        # own 1/n would shrink every gradient below the limits' atol)
        coef = torch.randn(n, generator=g, device=dev)
        coef[:64] = 0.0
        _, lse = ce.fused_ce_fwd_plain(x, w, t)
        rows = n * 4 * 3                             # t, lse, coef
        xw = (n + V) * C * el
        tgt = torch.where(t >= 0, t, -1).long().reshape(B, T)
        xl = x.reshape(B, T, C).detach().requires_grad_()
        wl = w.detach().requires_grad_()

        def chunked_fwd():
            with torch.no_grad():
                return fused_cross_entropy(xl, wl, tgt)

        def chunked_fwd_bwd():
            return torch.autograd.grad(fused_cross_entropy(xl, wl, tgt),
                                       (xl, wl))

        yield (dn, "yardsticks", {
            "replaced_fwd": chunked_fwd, "replaced_fwd_bwd": chunked_fwd_bwd,
            "mm": lambda: _mm_f32(x, w.t())}, None, None, None)
        yield (dn, "fused_ce_fwd", lambda: ce.fused_ce_fwd(x, w, t),
               lambda: ce.fused_ce_fwd_plain(x, w, t),
               xw + n * 4 * 3, 2 * n * V * C)
        yield (dn, "fused_ce_bwd_dx",
               lambda: ce.fused_ce_bwd_dx(x, w, t, lse, coef),
               lambda: ce.fused_ce_bwd_dx_plain(x, w, t, lse, coef),
               xw + rows + n * C * el, 4 * n * V * C)
        yield (dn, "fused_ce_bwd_dw",
               lambda: ce.fused_ce_bwd_dw(x, w, t, lse, coef),
               lambda: ce.fused_ce_bwd_dw_plain(x, w, t, lse, coef),
               xw + rows + V * C * el, 4 * n * V * C)
        del x, w, xl, wl, lse, coef


# the kernel each route of `fused_ce_fwd_plan` and `fused_ce_bwd_plan`
# launches, as the profiler names it: 2 sm90, 1 mma.sync (bf16), 0 FMA
# (fp32)
CE_KERNELS = {2: "ce_kernel_sm90", 1: "ce_kernel<", 0: "ce_kernel<"}


def ce_plan(kernel: str, n: int, V: int, C: int, dtype: str) -> tuple:
    """The C plan of `kernel` (csrc/fused_ce_fwd.cu `fused_ce_fwd_plan`,
    csrc/fused_ce_bwd.cu `fused_ce_bwd_plan`) for n tokens of width C over
    V vocab rows: (route, ring stages, output-column blocks; 1 for the
    forward)."""
    import ctypes
    from distributed_pytorch_tpu_torch.ops import cuda_build
    stages, ny = ctypes.c_int(), ctypes.c_int(1)
    code = int(dtype == "bfloat16")
    if kernel == "fused_ce_fwd":
        route = cuda_build.load(kernel).fused_ce_fwd_plan(
            code, n, V, C, ctypes.byref(stages))
    else:
        route = cuda_build.load(kernel).fused_ce_bwd_plan(
            code, n, V, C, ctypes.byref(stages), ctypes.byref(ny))
    return route, stages.value, ny.value


def run_ce_kernels(torch, dev) -> dict:
    from distributed_pytorch_tpu_torch.ops import fused_ce as ce
    results = {}
    for dn, name, fk, fp, n_bytes, flops in ce_cases(torch, dev):
        if name == "yardsticks":
            it = 2 if dn == "float32" else 10
            results[("yardsticks", dn)] = {k: time_ms(f, iters=it)
                                           for k, f in fk.items()}
            print(f"  {'yardsticks':18s} {dn:9s} " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in
                results[("yardsticks", dn)].items()), flush=True)
            torch.cuda.empty_cache()
            continue
        out, ref = fk(), fp()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"{name} {dn}: non-finite")
        errs, tols = {}, {}
        for oname, a, b in zip(CE_OUTPUTS[name], outs, refs):
            atol, rtol = CE_TOL["lse" if oname in ("nll", "lse") else dn]
            e = errs[oname] = _elementwise(a, b, atol, rtol)
            tols[oname] = {"atol": atol, "rtol": rtol}
            print(f"  {name:18s} {dn:9s} {oname:3s} max_abs_err "
                  f"{e['err']:.3e} (|ref| max {e['mag']:.3e}, rms "
                  f"{e['rms']:.3e}); worst {e['frac']:.3f} of its limit "
                  f"{atol:.0e} + {rtol:.2e} x |ref|; least atol at this "
                  f"rtol {e['need_atol']:.3e}", flush=True)
            check(e["frac"] <= 1.0,
                  f"{name} {dn}: {oname} differs from its plain version "
                  f"beyond {atol} + {rtol} x |plain| ({e['frac']:.3f} of "
                  f"the limit)")
        if name == "fused_ce_bwd_dx":
            check(int(torch.count_nonzero(outs[0][:64])) == 0,
                  f"{name} {dn}: ignored rows have nonzero dx")
        del out, ref, outs, refs
        b_ms, b_by = bound(n_bytes, flops, dn)
        slow = dn == "float32"          # FMA loops: tens of ms a call
        ms, spread = time_windows(fk, iters=2 if slow else 10,
                                  warmup=1 if slow else 3)
        launched = set()
        results[(name, dn)] = dict(
            max_abs_err=max(e["err"] for e in errs.values()), errs=errs,
            tol=tols, ms=ms, ms_spread=spread,
            device_ms=device_ms(fk, iters=2 if slow else 10,
                                names=launched),
            plain_ms=time_ms(fp, iters=2, warmup=1), bound_ms=b_ms,
            bound_by=b_by, bytes=n_bytes, flops=flops)
        r = results[(name, dn)]
        B, T, C, V = CE_SHAPE
        plan, stages, ny = ce_plan(name, B * T, V, C, dn)
        kernels = sorted(k for k in launched if "fce::" in k)
        check(r["device_ms"] is None or (kernels and all(
            CE_KERNELS[plan] in k for k in kernels)),
            f"{name} {dn}: the profile saw {kernels}, the C plan "
            f"names {CE_KERNELS[plan]}")
        note = f", launched {CE_KERNELS[plan]}"
        if plan == 2:
            note += f" ({stages} ring stages)"
        if plan == 2 and name != "fused_ce_fwd":
            # the backward's floor: each of its ny output-column blocks
            # recomputes the 2 n V C score FLOP
            floor = (ny + 1) * flops / 2 / PEAK_FLOPS[dn] * 1e3
            note += f", design floor {floor:.4f} ms"
        print(f"  {'':18s} {dn:9s} kernel {_timed(r, 'ms')}, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({b_by}){note}; torch.mm of x W^T "
              f"{results[('yardsticks', dn)]['mm']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    return results


def gmm_routing(torch, dev, kind: str, seed: int = 11):
    """Metadata of the training path's packed buffer (GMM_ROUTE: 8192
    tokens, 1 shared expert over every token, top 2 of 7 routed from a
    seeded router: 'ragged'), of the same with routed expert 3 never
    chosen ('empty'), or with every assignment on expert 2 ('one').
    Returns (counts, pstart, tile_group, P, bm)."""
    from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
    n_tok, E, n_sh, k = GMM_ROUTE
    A = n_tok * (n_sh + k)
    if kind == "one":
        flat_e = torch.full((A,), 2, dtype=torch.long, device=dev)
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        logits = torch.randn(n_tok, E - n_sh, generator=g, device=dev)
        if kind == "empty":
            logits[:, 3] = -1e9
        idx = logits.topk(k, dim=1).indices + n_sh
        flat_e = torch.cat([torch.arange(n_sh, device=dev).repeat_interleave(
            n_tok), idx.reshape(-1)])
    bm = gm.block_m(dev)
    n_tiles = -(-A // bm) + E
    counts, pstart, _, tile_group = gm._gmm_metadata(flat_e, E, n_tiles, bm)
    return counts, pstart, tile_group, n_tiles * bm, bm


def _library_gmm(torch, dn, kernel, x, w, dy, pstart, counts, bm):
    """One PyTorch call for the grouped product where the card's torch has
    it (`torch._grouped_mm`, bf16, over the same padded group offsets),
    else a loop of per-expert `torch.mm` over the group slices (offsets
    read on the host before timing). Returns (fn, what)."""
    padded = ((counts.long() + bm - 1) // bm * bm)
    ends = torch.cumsum(padded, 0).to(torch.int32)
    starts = pstart.tolist()
    stops = ends.tolist()
    loops = {
        "grouped_mm_fwd": lambda: [torch.mm(x[a:b], w[e]) for e, (a, b)
                                   in enumerate(zip(starts, stops))],
        "grouped_mm_bwd_dx": lambda: [torch.mm(dy[a:b], w[e].t()) for e, (a, b)
                                      in enumerate(zip(starts, stops))],
        "grouped_mm_bwd_dw": lambda: [torch.mm(x[a:b].t(), dy[a:b])
                                      for a, b in zip(starts, stops)]}
    one = {
        "grouped_mm_fwd": lambda: torch._grouped_mm(x, w, offs=ends),
        "grouped_mm_bwd_dx": lambda: torch._grouped_mm(
            dy, w.transpose(-2, -1), offs=ends),
        "grouped_mm_bwd_dw": lambda: torch._grouped_mm(
            x.t(), dy, offs=ends)}
    if dn == "bfloat16" and hasattr(torch, "_grouped_mm"):
        try:
            one[kernel]()
            torch.cuda.synchronize()
            return one[kernel], "torch._grouped_mm (unscaled)"
        except (RuntimeError, TypeError, ValueError) as e:
            print(f"  torch._grouped_mm refused {kernel}: "
                  f"{str(e).splitlines()[0][:120]}", flush=True)
    return loops[kernel], "per-expert torch.mm loop (unscaled)"


def gmm_cases(torch, dev):
    """Yield (dtype, case, kernel, fn_kernel, fn_plain, fn_library,
    library_what, n_bytes, flops, counts, R) for the three grouped kernels
    at the training path's two products (GMM_SHAPES) over the seeded
    routing, bf16 dx also at proj's shape without the gate (what the gate
    pass costs), and with no timing (fn_library None) over an empty expert
    and over every row on one expert. R is the rows the experts own (each
    group padded to bm), over which every bound counts bytes and FLOPs."""
    from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        el = torch.finfo(dtype).bits // 8
        for kind in ("ragged", "empty", "one"):
            counts, pstart, tg, P, bm = gmm_routing(torch, dev, kind)
            E = counts.numel()
            R = int(((counts.long() + bm - 1) // bm * bm).sum())
            for shape, (K, N, scaled) in GMM_SHAPES.items():
                if kind != "ragged" and shape == "proj":
                    continue
                g = torch.Generator(device=dev)
                g.manual_seed(K + N)
                x = torch.randn(P, K, generator=g, device=dev).to(dtype)
                w = (0.02 * torch.randn(E, K, N, generator=g, device=dev)
                     ).to(dtype)
                dy = torch.randn(P, N, generator=g, device=dev).to(dtype)
                s = torch.rand(P, 1, generator=g, device=dev) \
                    if scaled else None
                # every bound counts the R rows the experts own: the
                # trailing tiles no expert owns are not the product's work
                sb = 4 * R if scaled else 0
                meta = 4 * (R // bm)
                case = f"{shape}_{kind}"
                for kernel, fk, fp, n_bytes, flops in (
                        ("grouped_mm_fwd",
                         lambda: gm.gmm_fwd(x, w, tg, s, bm=bm),
                         lambda: gm.gmm_fwd_plain(x, w, tg, s, bm=bm),
                         (R * K + E * K * N + R * N) * el + sb + meta,
                         2 * R * K * N),
                        ("grouped_mm_bwd_dx",
                         lambda: gm.gmm_bwd_dx(dy, w, tg, s, bm=bm),
                         lambda: gm.gmm_bwd_dx_plain(dy, w, tg, s, bm=bm),
                         (R * N + E * K * N + R * K) * el + sb + meta,
                         2 * R * K * N),
                        ("grouped_mm_bwd_dw",
                         lambda: gm.gmm_bwd_dw(x, dy, counts, pstart, s,
                                               bm=bm),
                         lambda: gm.gmm_bwd_dw_plain(x, dy, counts, pstart,
                                                     s, bm=bm),
                         (R * K + R * N) * el + 4 * E * K * N + sb
                         + 8 * E,
                         2 * R * K * N)):
                    fl, what = (None, None)
                    if kind == "ragged":
                        fl, what = _library_gmm(torch, dn, kernel, x, w, dy,
                                                pstart, counts, bm)
                    yield (dn, case, kernel, fk, fp, fl, what, n_bytes,
                           flops, counts, R)
                if scaled and dn == "bfloat16":
                    # dx at proj's shape without the gate: what the gate
                    # pass costs
                    yield (dn, f"{case}_nogate", "grouped_mm_bwd_dx",
                           lambda: gm.gmm_bwd_dx(dy, w, tg, None, bm=bm),
                           lambda: gm.gmm_bwd_dx_plain(dy, w, tg, None,
                                                       bm=bm),
                           _library_gmm(torch, dn, "grouped_mm_bwd_dx", x,
                                        w, dy, pstart, counts, bm)[0],
                           "torch._grouped_mm (unscaled)",
                           (R * N + E * K * N + R * K) * el + meta,
                           2 * R * K * N, counts, R)
                del x, w, dy, s
            torch.cuda.empty_cache()


def run_gmm_kernels(torch, dev) -> dict:
    results = {}
    for (dn, case, name, fk, fp, fl, what, n_bytes, flops,
         counts, R) in gmm_cases(torch, dev):
        out, ref = fk(), fp()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{name} {case} {dn}: "
              "non-finite")
        rel, rtol = GMM_TOL["float32" if name == "grouped_mm_bwd_dw"
                            else dn]
        atol = rel * ref.float().abs().max().item()
        e = _elementwise(out, ref, atol, rtol)
        print(f"  {name:18s} {case:12s} {dn:9s} max_abs_err {e['err']:.3e} "
              f"(|ref| max {e['mag']:.3e}); worst {e['frac']:.3f} of its "
              f"limit {rel:.0e} x max|ref| + {rtol:.2e} x |ref|", flush=True)
        check(e["frac"] <= 1.0,
              f"{name} {case} {dn}: differs from its plain version beyond "
              f"{rel} x max|plain| + {rtol} x |plain| ({e['frac']:.3f} of "
              f"the limit)")
        if name == "grouped_mm_bwd_dw":
            empty = (counts == 0).nonzero().flatten().tolist()
            check(all(int(torch.count_nonzero(out[i])) == 0 for i in empty),
                  f"{name} {case} {dn}: experts {empty} have rows of dW")
        del out, ref
        if fl is None:
            continue
        b_ms, b_by = bound(n_bytes, flops, dn)
        slow = dn == "float32"
        ms, spread = time_windows(fk, iters=3 if slow else 20,
                                  warmup=1 if slow else 3)
        lib_ms, lib_spread = time_windows(fl, iters=3 if slow else 20)
        results[(name, case, dn)] = dict(
            max_abs_err=e["err"], tol={"atol_of_max": rel, "rtol": rtol},
            ms=ms, ms_spread=spread,
            device_ms=device_ms(fk, iters=2 if slow else 10),
            plain_ms=time_ms(fp, iters=3, warmup=1),
            library_ms=lib_ms, library_spread=lib_spread,
            library_device_ms=device_ms(fl, iters=2 if slow else 10),
            library_call=what, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes,
            flops=flops, bound_rows=R)
        r = results[(name, case, dn)]
        print(f"  {'':18s} {'':12s} {dn:9s} kernel {_timed(r, 'ms')}, plain "
              f"{r['plain_ms']:.4f} ms, library {_timed(r, 'library')} "
              f"({what}), bound {r['bound_ms']:.4f} ms ({b_by})", flush=True)
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 4: the model at full width
# ---------------------------------------------------------------------------

def _counted(want: dict, what: str) -> dict:
    """Read the launch counters after a run and hold them to `want` (every
    kernel it does not name at 0); the plain versions must not have
    run."""
    launches, plain = counts()
    check(plain == {k: 0 for k in plain},
          f"{what}: plain versions ran on the card: {plain}")
    want = {k: want.get(k, 0) for k in launches}
    check(launches == want, f"{what}: launches {launches}, expected {want}")
    return launches


def naive_forward(model, idx, **kw):
    """The model's uncached forward through the plain einsum attention
    (`attn_impl='naive'`) and, for an MoE model, the dense dispatch
    (`moe_impl='dense'`, the same dropless routing through no grouped
    kernel), so that the references launch none of the kernels they
    check."""
    import dataclasses
    moe = model.moe_layers()
    impl = [m.config for m in moe]
    for blk in model.blocks:
        blk.attn.attn_impl = "naive"
    for m, c in zip(moe, impl):
        m.config = dataclasses.replace(c, moe_impl="dense")
    reset_counts()
    try:
        out = model(idx, **kw)
    finally:
        for blk in model.blocks:
            blk.attn.attn_impl = model.attn_impl
        for m, c in zip(moe, impl):
            m.config = c
    launches, _ = counts()
    check(launches == {k: 0 for k in launches},
          f"the naive reference launched kernels: {launches}")
    return out


def _agree_upto_margin(torch, model, dev, prompt, tokens, ref_tokens,
                       lim: float, what: str) -> int:
    """`tokens` against `ref_tokens` (both continuations of `prompt`) up to
    the first position where the uncached naive forward of the reference
    sequence has a top-2 margin <= lim. Returns how many were checked."""
    lg = uncached_logits(torch, model, dev, prompt, ref_tokens)
    top2 = lg.topk(2, dim=-1).values
    k = 0
    for m in (top2[:, 0] - top2[:, 1]).tolist():
        if m <= lim:
            break
        check(tokens[k] == ref_tokens[k],
              f"{what}: token {k} differs (margin {m:.3g} > {lim})")
        k += 1
    return k


def uncached_logits(torch, model, dev, prompt, tokens):
    """The naive uncached forward over `prompt` + `tokens`, teacher-forced:
    one fp32 logits row per token of `tokens`, the row that predicts it."""
    seq = list(prompt) + list(tokens)
    with torch.no_grad():
        return naive_forward(model, torch.tensor([seq[:-1]], device=dev),
                             all_logits=True)[0, len(prompt) - 1:].float()


def mirror_logits(torch, model, dev, prompt, tokens, store=None,
                  cache_dtype=None):
    """A serving path's arithmetic without the engine and its kernels,
    teacher-forced on `tokens`: `prompt` through the naive forward on the
    model's own weights into a contiguous cache of `cache_dtype` (default
    int8: rows quantized as they are written, read back dequantized; MLA
    passes the model's dtype), then `tokens` from the same cache under the
    quantized-weight `store` when one is given (the engine runs only its
    decode forwards on int8 weights). One fp32 logits row per token of
    `tokens`."""
    from distributed_pytorch_tpu_torch.models.gpt import init_cache
    from distributed_pytorch_tpu_torch.ops import quant

    P = len(prompt)
    caches = init_cache(model.config, 1, P + len(tokens),
                        dtype=cache_dtype or torch.int8, device=dev)
    with torch.no_grad():
        first = naive_forward(model, torch.tensor([list(prompt)], device=dev),
                              caches=caches, pos=0)[0, -1:]
        with quant.use_quantized_params(store):
            rest = naive_forward(model, torch.tensor([list(tokens[:-1])],
                                                     device=dev),
                                 caches=caches, pos=P, all_logits=True)[0]
    return torch.cat([first, rest]).float()


def held_per_position(torch, lg, tokens, lim: float, least: int,
                      what: str) -> int:
    """`tokens` against the argmax of reference logits `lg` (one row per
    token, teacher-forced on `tokens`) at EVERY position whose top-2
    margin exceeds `lim`; at least `least` positions must be checked.
    Returns how many were."""
    top2 = lg.topk(2, dim=-1)
    margin = top2.values[:, 0] - top2.values[:, 1]
    sel = margin > lim
    want = torch.as_tensor(list(tokens), device=lg.device)
    bad = (sel & (top2.indices[:, 0] != want)).nonzero().flatten().tolist()
    check(not bad, f"{what}: tokens at {bad} are not the reference's argmax "
          f"(margins {[round(margin[i].item(), 4) for i in bad]} > {lim})")
    n = int(sel.sum())
    check(n >= least, f"{what}: only {n} of {len(tokens)} positions have a "
          f"top-2 margin above {lim}, fewer than {least}")
    return n


def held_near_top(torch, lg, tokens, lim: float, least: int,
                  what: str) -> tuple[int, float]:
    """`tokens` against reference logits `lg` (one row per token,
    teacher-forced on `tokens`) at EVERY position: the token's reference
    logit must lie within `lim` of its row's largest (NEAR_TOP). At least
    `least` positions must have a top-2 margin above `lim`, where that
    makes the token the argmax. Returns how many do and the largest gap
    below the row's largest logit."""
    top2 = lg.topk(2, dim=-1)
    margin = top2.values[:, 0] - top2.values[:, 1]
    want = torch.as_tensor(list(tokens), device=lg.device)
    gap = top2.values[:, 0] - lg.gather(1, want[:, None])[:, 0]
    bad = (gap > lim).nonzero().flatten().tolist()
    check(not bad, f"{what}: tokens at {bad} lie "
          f"{[round(gap[i].item(), 4) for i in bad]} below the reference's "
          f"largest logit (limit {lim})")
    n = int((margin > lim).sum())
    check(n >= least, f"{what}: only {n} of {len(tokens)} positions have a "
          f"top-2 margin above {lim}, fewer than {least}")
    return n, float(gap.max())


def run_model(torch, fd, dev) -> tuple[dict, dict]:
    """Returns the contiguous route's kernel launches in `generate`, per
    dtype: over the native cache and over an int8 cache."""
    from distributed_pytorch_tpu_torch.config import flagship_gpt124m
    from distributed_pytorch_tpu_torch.models.generate import generate
    from distributed_pytorch_tpu_torch.models.gpt import (LLM,
                                                          init_paged_cache)

    cfg = flagship_gpt124m()
    prompt_len, n_steps, bs = 300, 16, 16
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, prompt_len).tolist()
    L = cfg.n_layer
    contiguous, contiguous_q8 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).removeprefix("torch.")
        model = LLM(cfg, device=dev, dtype=dtype)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        model.init_weights(g)
        n_max = cfg.block_size // bs
        caches = init_paged_cache(cfg, n_max + 1, bs, dtype=dtype,
                                  device=dev)
        table = torch.arange(1, n_max + 1, dtype=torch.int32,
                             device=dev)[None]
        toks = list(prompt)
        worst = 0.0
        paged_launches = {"paged_decode_attn": 0, "paged_prefill_attn": 0}
        with torch.no_grad():
            bucket = 512
            buf = torch.tensor([toks + [0] * (bucket - prompt_len)],
                               device=dev)
            reset_counts()
            logits = model(buf, caches=caches, pos=0,
                           logits_idx=[prompt_len - 1],
                           block_tables=table)[0, -1]
            paged_launches["paged_prefill_attn"] += \
                _counted({"paged_prefill_attn": L},
                         f"paged prefill {dn}")["paged_prefill_attn"]
            for step in range(n_steps + 1):
                ref = naive_forward(model,
                                    torch.tensor([toks], device=dev))[0, -1]
                check(bool(torch.isfinite(logits).all()),
                      f"model {dn}: non-finite logits")
                worst = max(worst, (logits.float() - ref.float())
                            .abs().max().item())
                if step == n_steps:
                    break
                nxt = int(ref.float().argmax())
                toks.append(nxt)
                pos = torch.tensor([len(toks) - 1], device=dev)
                reset_counts()
                logits = model(torch.tensor([[nxt]], device=dev),
                               caches=caches, pos=pos,
                               block_tables=table)[0, -1]
                paged_launches["paged_decode_attn"] += \
                    _counted({"paged_decode_attn": L},
                             f"paged decode {dn}")["paged_decode_attn"]
        print(f"  paged prefill {prompt_len} + {n_steps} decode steps, "
              f"{dn}: max |logit - uncached| {worst:.3e} "
              f"(tol {LOGIT_TOL[dn]:.0e}); launches {paged_launches}",
              flush=True)
        check(worst <= LOGIT_TOL[dn],
              f"model {dn}: paged logits differ from the uncached forward "
              f"by {worst}")

        # contiguous-cache generate vs greedy argmax of the uncached
        # forward, where the top-2 margin exceeds the tolerance: the
        # prompt pass over the contiguous cache launches the flash forward
        # once per layer, each later step the decode kernel once per layer
        reset_counts()
        out = generate(model, prompt, n_steps, temperature=0.0)[0].tolist()
        contiguous[dn] = _counted(
            {"paged_decode_attn": L * (n_steps - 1), "flash_attn_fwd": L},
            f"generate {dn}")["paged_decode_attn"]
        agree = held_per_position(
            torch, uncached_logits(torch, model, dev, prompt,
                                   out[prompt_len:]),
            out[prompt_len:], LOGIT_TOL[dn], MIN_CHECKED[dn] * n_steps,
            f"generate {dn} vs the uncached argmax")
        print(f"  generate {dn}: {agree}/{n_steps} tokens checked against "
              f"the uncached argmax (top-2 margin > {LOGIT_TOL[dn]})"
              f"; paged_decode_attn launched {contiguous[dn]} times "
              f"({n_steps - 1} steps x {L} layers), flash_attn_fwd {L} "
              f"(prompt pass)", flush=True)

        # the same over an int8 cache: the prompt pass reads it
        # dequantized, each decode step goes through paged_decode_attn_q8
        # (the reference's _kernel_q8 face); tokens against the argmax of
        # the same arithmetic without the kernels
        reset_counts()
        out8 = generate(model, prompt, n_steps, temperature=0.0,
                        cache_dtype=torch.int8)[0].tolist()
        contiguous_q8[dn] = _counted(
            {"paged_decode_attn_q8": L * (n_steps - 1), "flash_attn_fwd": L},
            f"generate int8 {dn}")["paged_decode_attn_q8"]
        agree8 = held_per_position(
            torch, mirror_logits(torch, model, dev, prompt,
                                 out8[prompt_len:]),
            out8[prompt_len:], LOGIT_TOL[dn], MIN_CHECKED[dn] * n_steps,
            f"generate int8 {dn} vs the dequantized-cache forward")
        print(f"  generate int8 cache {dn}: {agree8}/{n_steps} tokens "
              f"checked against the argmax of the naive forward over the "
              f"dequantized int8 cache (top-2 margin > {LOGIT_TOL[dn]}); "
              f"{sum(a == b for a, b in zip(out8, out)) - prompt_len}/"
              f"{n_steps} equal the native cache's; paged_decode_attn_q8 "
              f"launched {contiguous_q8[dn]} times, flash_attn_fwd {L}",
              flush=True)
        del model, caches
        torch.cuda.empty_cache()
    return contiguous, contiguous_q8


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------

async def _sse(port: int, prompt: list, max_tokens: int) -> dict:
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens}).encode()
    writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split(b" ")[1])
    while (await reader.readline()).strip():
        pass
    tokens, times, done = [], [], None
    while status == 200:
        line = (await reader.readline()).decode().strip()
        if not line:
            if reader.at_eof():
                break
            continue
        payload = line[len("data: "):]
        if payload == "[DONE]":
            break
        ev = json.loads(payload)
        if "token" in ev:
            times.append(time.perf_counter() - t0)
            tokens.append(ev["token"])
        else:
            done = ev
    writer.close()
    return {"status": status, "tokens": tokens, "done": done,
            "ttft": times[0] if times else None, "times": times,
            "e2e": time.perf_counter() - t0}


async def _get(port: int, path: str) -> str:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    return data.partition(b"\r\n\r\n")[2].decode()


async def _serve(eng, prompts, budgets, weights_version=None):
    """Serve the streams; returns (results, wall s, /metrics body)."""
    from distributed_pytorch_tpu_torch.serve.scheduler import Scheduler
    from distributed_pytorch_tpu_torch.serve.server import ServeApp

    sched = Scheduler(eng, max_queue=64)
    if weights_version is not None:
        sched.metrics.set_weights_version(weights_version)
    app = ServeApp(sched, host="127.0.0.1", port=0)
    await sched.start()
    await app.start()
    try:
        t0 = time.perf_counter()
        res = await asyncio.gather(*(_sse(app.port, p, b)
                                     for p, b in zip(prompts, budgets)))
        wall = time.perf_counter() - t0
        metrics = await _get(app.port, "/metrics")
    finally:
        await app.stop()
        await sched.stop()
    return res, wall, metrics


SERVE_ARGV = ["--preset", "gpt2_124m", "--slots", "8", "--kv-block", "16",
              "--temperature", "0", "--seed", "0", "--port", "0"]


def serve_traffic(vocab: int) -> tuple[list, list]:
    """8 requests of 5-906 prompt tokens and 32-64 output tokens, three
    sharing a 256-token prefix (phases 5 and 8)."""
    rng = np.random.default_rng(2)

    def toks(n):
        return rng.integers(0, vocab, n).tolist()

    prefix = toks(256)
    prompts = [toks(5), toks(40), toks(130), prefix + toks(20),
               prefix + toks(61), prefix + toks(150), toks(600), toks(900)]
    return prompts, [32, 40, 48, 56, 64, 33, 50, 60]


def _pct(xs, p: float) -> float:
    """The p-th percentile of xs (nearest rank)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(np.ceil(p / 100 * len(xs))) - 1))]


def serve_leg(torch, eng, prompts, budgets, what: str) -> dict:
    """Serve the streams through `eng` with the counters zeroed just
    before; check every stream ended on its budget. Returns the results,
    the counts, the engine's steps (and chunk steps) in the run, and the
    end-to-end numbers."""
    steps0, admits0 = eng.n_steps, eng.n_admitted
    tok0 = (eng.prompt_tokens, eng.prefix_hit_tokens, eng.prefilled_tokens)
    gc.collect()                     # earlier phases' tensors are freed
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, wall, metrics = asyncio.run(asyncio.wait_for(
        _serve(eng, prompts, budgets), 600))
    launches, plain = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = eng.n_steps - steps0
    flight = eng.flight.entries(steps)
    for i, (r, b) in enumerate(zip(res, budgets)):
        check(r["status"] == 200, f"{what} stream {i}: HTTP {r['status']}")
        check(r["done"] is not None and r["done"].get("reason") == "budget"
              and len(r["tokens"]) == b,
              f"{what} stream {i}: ended {r['done']} after "
              f"{len(r['tokens'])} of {b} tokens")
        check(all(0 <= t < eng.cfg.vocab_size for t in r["tokens"]),
              f"{what} stream {i}: token id out of range")
    check(plain == {k: 0 for k in plain},
          f"{what}: plain versions ran on the serve path: {plain}")
    n_tok = sum(len(r["tokens"]) for r in res)
    ttft = [r["ttft"] for r in res]
    itl = [b - a for r in res for a, b in zip(r["times"], r["times"][1:])]
    step_ms = sorted(e["step_ms"] for e in flight)
    prompt_tok, hit_tok, prefilled = (
        a - b for a, b in zip((eng.prompt_tokens, eng.prefix_hit_tokens,
                               eng.prefilled_tokens), tok0))
    check(prompt_tok == sum(map(len, prompts)) == hit_tok + prefilled,
          f"{what}: {prompt_tok} prompt tokens, {hit_tok} from the prefix "
          f"cache, {prefilled} prefilled")
    return dict(res=res, metrics=metrics, launches=launches, steps=steps,
                admits=eng.n_admitted - admits0,
                chunk_steps=sum(e["prefill_tokens"] > 0 for e in flight),
                spec_steps=sum(e["drafted"] > 0 for e in flight),
                chunk_tokens=sum(e["prefill_tokens"] for e in flight),
                prefilled=prefilled,
                numbers=dict(tok_s=n_tok / wall, wall_s=wall, tokens=n_tok,
                             ttft_p50_ms=_pct(ttft, 50) * 1e3,
                             ttft_p99_ms=_pct(ttft, 99) * 1e3,
                             itl_p50_ms=_pct(itl, 50) * 1e3,
                             itl_p99_ms=_pct(itl, 99) * 1e3,
                             step_ms_p50=step_ms[len(step_ms) // 2],
                             step_ms_max=step_ms[-1], peak_gb=peak,
                             resident_gb=resident))


def _numbers_line(n: dict, prof: dict) -> str:
    return (f"{n['tokens']} tokens in {n['wall_s']:.3f} s = "
            f"{n['tok_s']:.1f} tok/s; TTFT p50 {n['ttft_p50_ms']:.1f} ms, "
            f"p99 {n['ttft_p99_ms']:.1f} ms; ITL p99 {n['itl_p99_ms']:.1f} "
            f"ms; step ms p50 {n['step_ms_p50']:.2f}, max "
            f"{n['step_ms_max']:.2f}; decode step host {prof['host_ms']:.3f}"
            f" ms, kernels {prof['device_ms']:.3f} ms, device busy "
            f"{prof['busy_pct']:.1f}%; peak memory {n['peak_gb']:.3f} GB "
            f"({n['resident_gb']:.3f} GB resident before)")


def run_serve(torch, fd, card: str) -> dict:
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)

    eng, _, _, _ = build_engine(build_args(SERVE_ARGV + ["--dtype",
                                                         "bfloat16"]))
    cfg = eng.cfg
    check(eng.device.type == DEVICE and eng.cache_dtype == torch.bfloat16,
          "serve engine is not bf16 on the card")
    print(f"  engine: {cfg.n_layer} layers x {cfg.n_embd}, "
          f"{eng.n_slots} slots, max_len {eng.max_len}, "
          f"{eng.n_blocks} blocks x {eng.block_size} rows", flush=True)
    prompts, budgets = serve_traffic(cfg.vocab_size)
    L = cfg.n_layer
    r = serve_leg(torch, eng, prompts, budgets, "serve")
    launches, steps, admits = r["launches"], r["steps"], r["admits"]
    check(eng.prefix_hit_rate > 0, "the shared prefix never hit the cache")
    check(launches["paged_decode_attn"] == L * steps,
          f"paged_decode_attn launched {launches['paged_decode_attn']} "
          f"times for {steps} steps x {L} layers")
    check(launches["paged_prefill_attn"] == L * admits,
          f"paged_prefill_attn launched {launches['paged_prefill_attn']} "
          f"times for {admits} admissions x {L} layers")
    check(sum(launches.values()) == launches["paged_decode_attn"]
          + launches["paged_prefill_attn"],
          f"other kernels ran on the serve path: {launches}")
    prof = profile_decode(torch, eng, prompts)
    print(f"  8/8 streams ended on budget; {_numbers_line(r['numbers'], prof)}"
          f"; prefix hit rate {eng.prefix_hit_rate:.3f}; {steps} steps, "
          f"{admits} admissions; launches {launches}; plain calls 0; card "
          f"{card}", flush=True)
    del eng
    torch.cuda.empty_cache()
    return dict(launches=launches, prompts=prompts, budgets=budgets,
                tokens=[x["tokens"] for x in r["res"]],
                numbers=r["numbers"], profile=prof)


def profile_decode(torch, eng, prompts) -> dict:
    """Where a steady 8-slot decode step's time goes: host wall per step
    (no profiler), device time per step and by kernel (torch.profiler),
    and the device's busy share. Runs after the main path's counts were
    read. A chunked engine first steps until every prompt is in, under
    the profiler too: there the parked slots make the decode kernel walk
    their whole table (the null block), so its device time per launch is
    read on those chunk steps and on the plain steps apart, and the paged
    prefill's device time per launch on the chunk steps beside it (the
    bf16 and int8 prefill kernels, so the chunked legs compare there)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for p in prompts:
        eng.admit(p[:200], 64)
    parked, n_chunk = [], 0
    with profile(activities=acts) as prof_c:
        for _ in range(64):
            parked.append(sum(eng._is_partial(q) for q in
                              eng._slots.values()))
            if eng.step().prefill_tokens == 0:
                parked.pop()
                break
            n_chunk += 1
        torch.cuda.synchronize()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=acts) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()

    ev, dev_ms = device_kernels(prof, n)
    print(f"  decode step (8 live slots): host wall {wall_ms:.3f} ms, "
          f"device {dev_ms:.3f} ms (kernels), device busy "
          f"{100 * dev_ms / wall_ms:.1f}%", flush=True)
    print_kernels(ev, n, 8)
    out = {"host_ms": wall_ms, "device_ms": dev_ms,
           "busy_pct": 100 * dev_ms / wall_ms,
           "decode_kernel_ms": decode_ms_per_launch(ev)}
    if np.isnan(out["decode_kernel_ms"]):
        print("  no paged attention kernel on these steps (MLA attends "
              "over its latent cache by absorption)", flush=True)
        return out
    line = (f"  decode kernel per launch (device): "
            f"{out['decode_kernel_ms']:.4f} ms on plain steps (8 live slots)")
    if n_chunk:
        ev_c, _ = device_kernels(prof_c, n_chunk)
        out.update(chunk_decode_kernel_ms=decode_ms_per_launch(ev_c),
                   chunk_prefill_kernel_ms=_per_launch(ev_c, "prefill_kernel"),
                   chunk_prefill_kernels=sorted({
                       kernel_name(e.key) for e in ev_c
                       if "prefill_kernel" in e.key}),
                   chunk_steps=n_chunk,
                   parked_mean=sum(parked) / n_chunk)
        line += (f", {out['chunk_decode_kernel_ms']:.4f} ms on {n_chunk} "
                 f"chunk steps (mean {out['parked_mean']:.2f} parked slots "
                 f"walking {eng.table_width} table columns of the null "
                 f"block); paged prefill per launch (device) on the chunk "
                 f"steps {out['chunk_prefill_kernel_ms']:.4f} ms "
                 f"({out['chunk_prefill_kernels']})")
    print(line, flush=True)
    return out


def _per_launch(ev, name: str) -> float:
    """Device ms per launch of the kernels whose name contains `name`."""
    hit = [e for e in ev if name in e.key]
    n = sum(e.count for e in hit)
    return sum(_dev_us(e) for e in hit) / n / 1e3 if n else float("nan")


def decode_ms_per_launch(ev) -> float:
    """Device ms per decode launch: the split-KV pair (split plus combine
    kernel, over the split kernel's launches; fp32, bf16 and int8 caches)
    where it ran, else the tile kernel `paged_decode_kernel` (rows past a
    warp's 32 vectors)."""
    split = [e for e in ev if "decode_split_kernel" in e.key]
    if not split:
        return _per_launch(ev, "paged_decode_kernel")
    both = split + [e for e in ev if "decode_combine_kernel" in e.key]
    return sum(_dev_us(e) for e in both) / sum(e.count for e in split) / 1e3


# each flash kernel's own name in csrc/flash_attn_fwd.cu and
# csrc/flash_attn_bwd.cu, whatever its design (FMA or wgmma) and its
# parameter types
FLASH_KERNEL_NAMES = {"flash_attn_fwd": "::fwd_kernel",
                      "flash_attn_bwd_dq": "::dq_kernel",
                      "flash_attn_bwd_dkv": "::dkv_kernel"}


def flash_kernel_of(key: str):
    """The flash kernel a profiler event's name belongs to, or None."""
    for kname, mark in FLASH_KERNEL_NAMES.items():
        if mark in key:
            return kname
    return None


# the modes of `gmm::gmm_kernel<T, MODE>` (csrc/grouped_mm_common.cuh)
GMM_MODES = {"0": "grouped_mm_fwd", "1": "grouped_mm_bwd_dx",
             "2": "grouped_mm_bwd_dw"}


def gmm_kernel_of(key: str):
    """The grouped kernel a profiler event's name belongs to, or None:
    the bf16 `gmm::fwd_kernel_sm90` / `dx_kernel_sm90` / `dw_kernel_sm90`,
    or the fp32 `gmm::gmm_kernel<float, MODE>` by its mode."""
    if "gmm::" not in key:
        return None
    if "fwd_kernel_sm90" in key:
        return "grouped_mm_fwd"
    if "dw_kernel_sm90" in key:
        return "grouped_mm_bwd_dw"
    if "dx_kernel_sm90" in key:
        return "grouped_mm_bwd_dx"
    m = re.search(r"gmm_kernel<[^>]*?(\d)\s*>", key)
    return GMM_MODES.get(m.group(1)) if m else None


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_kernels(prof, n: int) -> tuple[list, float]:
    """The profile's device-side events (kernels, copies) and their time
    per step in ms. Operator-level events and user annotations are left
    out: their device time repeats the time of the kernels inside them."""
    from torch.autograd import DeviceType
    ev = [e for e in prof.key_averages()
          if e.device_type != DeviceType.CPU and _dev_us(e) > 0
          and not getattr(e, "is_user_annotation", False)]
    return ev, sum(_dev_us(e) for e in ev) / n / 1e3


def print_kernels(ev, n: int, top: int) -> list:
    """Print the `top` kernels by device time a step; returns the lines."""
    lines = [f"    {_dev_us(e) / n / 1e3:8.4f} ms/step  {e.count // n:4d}x  "
             f"{e.key[:90]}"
             for e in sorted(ev, key=_dev_us, reverse=True)[:top]]
    for line in lines:
        print(line, flush=True)
    return lines


# ---------------------------------------------------------------------------
# phase 8: int8 and chunked serving
# ---------------------------------------------------------------------------

CHUNK = 256
# the serve CLI as phase 8 starts it
CLI_ARGV = ["--preset", "gpt2_124m", "--cache-dtype", "int8",
            "--quant-weights", "--prefill-chunk", str(CHUNK), "--port", "0",
            "--temperature", "0"]


def engine_teacher_forced(torch, model, prompts, forced, **kw) -> dict:
    """The DecodeEngine's own admit/step path (chunked, 8 slots, blocks of
    16) fed `forced[i]` as stream i's tokens: its sampler is swapped for
    one that keeps every row's logits and returns the forced token.
    Streams 4 and 5 are admitted only once stream 3's prompt is in, so they
    reuse the 256-token prefix blocks its chunks published; the pool holds
    TF_BLOCKS blocks, fewer than the traffic needs, so sequences are
    preempted and resumed from their retained blocks. `kw` picks the cache
    dtype and weights. Returns per-stream fp32 logits (one row per forced
    token) and the run's prefix-hit tokens and preemptions."""
    from collections import deque

    from distributed_pytorch_tpu_torch.engine import (DecodeEngine,
                                                      NoFreeBlocks)

    eng = DecodeEngine(model, n_slots=8, block_size=16, n_blocks=TF_BLOCKS,
                       prefill_chunk=CHUNK, temperature=0.0, **kw)
    rows = [[None] * len(f) for f in forced]

    def sample(logits, **_):
        if logits.shape[0] == 1:           # a chunk: the oldest partial
            slots = [min((q.order, s) for s, q in eng._slots.items()
                         if eng._is_partial(q))[1]]
        else:                              # a decode step: the live slots
            live = eng.live.tolist()
            slots = [s if live[s] else None for s in range(len(live))]
        out = torch.zeros(logits.shape[0], dtype=torch.long,
                          device=logits.device)
        for r, s in enumerate(slots):
            q = eng._slots.get(s)
            if q is None:
                continue
            i = q.seq_id
            k = len(q.tokens) - len(prompts[i])    # the token it predicts
            rows[i][k] = logits[r].float()         # a last chunk's stays
            out[r] = forced[i][k]
        return out

    eng._sample = sample
    queue = deque((i, list(prompts[i])) for i in (0, 1, 2, 3, 6, 7))
    later = [(i, list(prompts[i])) for i in (4, 5)]
    got = [[] for _ in prompts]
    preempted = 0
    while queue or later or eng._slots:
        if later and got[3]:
            queue.extend(later)
            later = []
        while queue and eng.free_slots:
            i, toks = queue[0]
            try:
                eng.admit(toks, len(forced[i]) - len(got[i]), seq_id=i)
            except NoFreeBlocks:
                break
            queue.popleft()
        check(bool(eng._slots), "teacher-forced engine: nothing to step")
        res = eng.step()
        for i, t in res.emitted.items():
            got[i] += t
        for i, ret in res.retired.items():
            if ret.reason == "preempted":
                preempted += 1
                queue.appendleft((i, list(ret.tokens)))
            else:
                check(ret.reason == "budget", f"teacher-forced stream {i} "
                      f"ended {ret.reason}")
    check(got == [list(f) for f in forced]
          and all(r is not None for rs in rows for r in rs),
          "teacher-forced engine: tokens or logits rows missing")
    return dict(logits=[torch.stack(r) for r in rows],
                prefix_hit=eng.prefix_hit_tokens, preempted=preempted)


def run_int8_chunked(torch, dev, card: str, wave: dict, root: str) -> dict:
    """Phase 5's traffic served from phase 7's checkpoint under `root`
    (trained weights, so that top-2 margins are wide enough to check
    tokens against): (w) the bf16 wave engine, (a) bf16 with prefill_chunk
    CHUNK, (b) the same with an int8 cache and int8 weights. Then the
    engine teacher-forced on leg (a)'s tokens in bf16, with an int8 cache
    and with both int8. Returns leg (b)'s q8 launches and the legs'
    numbers."""
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)

    prompts, budgets = wave["prompts"], wave["budgets"]
    base = ["--ckpt", root, "--slots", "8", "--kv-block", "16",
            "--temperature", "0", "--seed", "0", "--port", "0", "--dtype",
            "bfloat16"]
    chunked = ["--prefill-chunk", str(CHUNK)]
    lim = LOGIT_TOL["bfloat16"]
    out, toks = {}, {}
    for leg, extra in (("w", []), ("a", chunked),
                       ("b", chunked + ["--cache-dtype", "int8",
                                        "--quant-weights"])):
        eng, _, _, _ = build_engine(build_args(base + extra))
        q8, L = leg == "b", eng.cfg.n_layer
        check(eng.prefill_chunk == (0 if leg == "w" else CHUNK)
              and eng.kv_quantized == q8 and eng.weights_quantized == q8
              and eng.model.dtype == torch.bfloat16,
              f"leg {leg}: engine {eng.cache_dtype}, quant_w "
              f"{eng.weights_quantized}, chunk {eng.prefill_chunk}")
        r = serve_leg(torch, eng, prompts, budgets, f"int8/chunked {leg}")
        sfx = "_q8" if q8 else ""
        want = {f"paged_prefill_attn{sfx}":
                L * (r["admits"] if leg == "w" else r["chunk_steps"]),
                f"paged_decode_attn{sfx}": L * r["steps"]}
        check(r["launches"] == {k: want.get(k, 0) for k in r["launches"]},
              f"leg {leg}: launches {r['launches']}, expected {want} "
              f"({r['chunk_steps']} chunk steps of {r['steps']})")
        toks[leg] = [x["tokens"] for x in r["res"]]
        if leg == "w":
            detail = "the reference for leg a"
        else:
            check(r["chunk_tokens"] == r["prefilled"],
                  f"leg {leg}: chunks carried {r['chunk_tokens']} prompt "
                  f"tokens of {r['prefilled']} prefilled")
            lines = dict(ln.rsplit(" ", 1) for ln in r["metrics"].splitlines()
                         if ln and not ln.startswith("#"))
            info = [ln for ln in r["metrics"].splitlines()
                    if ln.startswith("serve_build_info{")]
            labels = [f'prefill_chunk="{CHUNK}"',
                      f'cache_dtype="{"int8" if q8 else "bfloat16"}"',
                      f'quant_weights="{q8}"']
            check(float(lines.get("serve_prefill_tokens_per_step_count", -1))
                  == r["steps"] and float(lines.get(
                      "serve_prefill_tokens_per_step_sum", -1))
                  == r["prefilled"] and info
                  and all(lb in info[0] for lb in labels),
                  f"leg {leg}: /metrics lacks the chunk use or {labels}")
        least = [int(MIN_CHECKED["bfloat16"] * b) for b in budgets]
        if leg == "a":
            # against the wave's tokens up to the first small margin, and
            # at every position against the uncached forward's argmax
            agree = [_agree_upto_margin(
                torch, eng.model, dev, p, t, w, lim,
                f"leg a stream {i} vs the wave")
                for i, (p, t, w) in enumerate(zip(prompts, toks["a"],
                                                  toks["w"]))]
            held = [held_per_position(
                torch, uncached_logits(torch, eng.model, dev, p, t), t, lim,
                n, f"leg a stream {i} vs the uncached forward")
                for i, (p, t, n) in enumerate(zip(prompts, toks["a"],
                                                  least))]
            detail = (f"tokens equal the wave's for {agree} of {budgets} "
                      f"(up to the first top-2 margin <= {lim}); the "
                      f"uncached argmax at every position with a margin > "
                      f"{lim}: {held} checked, all equal")
            out["held_a"] = held
        elif leg == "b":
            # at every position against the same arithmetic without the
            # kernels: the prompt on the model's weights into an int8
            # cache, the served tokens on the engine's int8 weights. The
            # quantization is on both sides, so the kernels' rounding is
            # all that differs, as for leg a against the uncached forward
            held = [held_per_position(
                torch, mirror_logits(torch, eng.model, dev, p, t,
                                     eng._qparams), t, lim, n,
                f"leg b stream {i} vs the dequantized-cache forward")
                for i, (p, t, n) in enumerate(zip(prompts, toks["b"],
                                                  least))]
            same = [sum(x == y for x, y in zip(t, u))
                    for t, u in zip(toks["b"], toks["a"])]
            detail = (f"the argmax of the naive forward over the "
                      f"dequantized int8 cache on int8 weights at every "
                      f"position with a margin > {lim}: {held} "
                      f"checked, all equal; equal to leg a's, position by "
                      f"position: {same}")
            out["held_b"] = held
        prof = profile_decode(torch, eng, prompts)
        out[leg] = dict(numbers=r["numbers"], profile=prof,
                        launches=r["launches"], steps=r["steps"],
                        chunk_steps=r["chunk_steps"])
        what = {"w": "bf16, wave", "a": f"bf16, prefill_chunk {CHUNK}",
                "b": f"int8 cache + int8 weights, prefill_chunk {CHUNK}"}
        print(f"  leg {leg} ({what[leg]}): 8/8 streams on budget; "
              f"{_numbers_line(r['numbers'], prof)}; {r['steps']} steps, "
              f"{r['chunk_steps']} with a chunk; launches {r['launches']}; "
              f"plain calls 0; {detail}; card {card}", flush=True)
        if leg == "b":
            del eng
        else:
            model = eng.model
            del eng
        torch.cuda.empty_cache()
    n5, p5 = wave["numbers"], wave["profile"]
    print(f"  phase 5 (bf16, wave, seeded weights) for comparison: "
          f"{_numbers_line(n5, p5)}", flush=True)

    # teacher-forced through the engine on leg a's tokens: int8 against
    # bf16, and bf16 against the uncached forward
    reset_counts()
    tf = {v: engine_teacher_forced(torch, model, prompts, toks["a"], **kw)
          for v, kw in (("bf16", {}), ("cache", {"cache_dtype": "int8"}),
                        ("cache_weights", {"cache_dtype": "int8",
                                           "quantize_weights": True}))}
    launches, plain = counts()
    check(plain == {k: 0 for k in plain} and all(
        launches[k] > 0 for k in ("paged_decode_attn", "paged_prefill_attn",
                                  "paged_decode_attn_q8",
                                  "paged_prefill_attn_q8")),
          f"teacher-forced engines: launches {launches}, plain {plain}")
    ref = [uncached_logits(torch, model, dev, p, t)
           for p, t in zip(prompts, toks["a"])]
    diff = {"bf16": max((x - y).abs().max().item()
                        for x, y in zip(tf["bf16"]["logits"], ref))}
    for v in ("cache", "cache_weights"):
        diff[v] = max((x - y).abs().max().item() for x, y in
                      zip(tf[v]["logits"], tf["bf16"]["logits"]))
    check(all(r["prefix_hit"] >= 2 * 256 and r["preempted"] > 0
              for r in tf.values()),
          f"teacher-forced engines: prefix hits "
          f"{[r['prefix_hit'] for r in tf.values()]}, preemptions "
          f"{[r['preempted'] for r in tf.values()]}")
    check(diff["bf16"] <= lim, f"teacher-forced bf16 engine vs uncached: "
          f"max |logit diff| {diff['bf16']:.4g} > {lim}")
    for v in ("cache", "cache_weights"):
        check(diff[v] <= Q8_LOGIT_TOL[v], f"teacher-forced int8 {v} vs "
              f"bf16 engine: max |logit diff| {diff[v]:.4g} > "
              f"{Q8_LOGIT_TOL[v]}")
    print(f"  teacher-forced engine on leg a's {sum(budgets)} tokens "
          f"(8 streams, {TF_BLOCKS}-block pool: "
          f"{tf['bf16']['preempted']} preemptions, "
          f"{tf['bf16']['prefix_hit']} prefix-hit tokens): max |logit "
          f"diff| bf16 engine vs uncached {diff['bf16']:.4g} (limit {lim}); "
          f"int8 cache vs bf16 engine {diff['cache']:.4g} (limit "
          f"{Q8_LOGIT_TOL['cache']}); int8 cache + weights vs bf16 engine "
          f"{diff['cache_weights']:.4g} (limit "
          f"{Q8_LOGIT_TOL['cache_weights']})", flush=True)
    out["teacher_forced"] = diff
    del model, tf, ref
    torch.cuda.empty_cache()
    out["spec"] = run_spec_legs(torch, dev, card, prompts, budgets, root)
    out["held_fp32"] = run_chunked_fp32(torch, dev, prompts, budgets, root)
    run_serve_cli(torch)
    return out


SPEC_K = 4
SPEC_RUNS = 3


def _spread(xs) -> str:
    xs = sorted(xs)
    return f"{xs[len(xs) // 2]:.2f} [{xs[0]:.2f}-{xs[-1]:.2f}]"


def run_spec_legs(torch, dev, card: str, prompts, budgets,
                  root: str) -> dict:
    """The spec leg: phase 5's traffic from phase 7's checkpoint, greedy
    bf16, wave and prefill_chunk CHUNK, each with speculative decoding
    off and on (`SPEC_DECODE` off / on, `SPEC_K` SPEC_K, read by the serve
    CLI's `build_engine`), SPEC_RUNS runs of each, off and on in turn,
    each on a fresh engine (the first of each from the checkpoint, the
    others on its model). Every on-run's tokens are the uncached
    forward's argmax at every position whose top-2 margin clears the bf16
    limit, and the first's equal the off-run's up to the first margin
    within it; no plain version runs; the paged decode kernel launches
    once a layer on each step that did not speculate (a verify of 8 slots
    reads the gathered cache by the naive path), the prefill kernel as in
    legs w and a. Returns each setting's runs."""
    from distributed_pytorch_tpu_torch.engine import DecodeEngine
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)

    base = ["--ckpt", root, "--slots", "8", "--kv-block", "16",
            "--temperature", "0", "--seed", "0", "--port", "0", "--dtype",
            "bfloat16"]
    lim = LOGIT_TOL["bfloat16"]
    least = [int(MIN_CHECKED["bfloat16"] * b) for b in budgets]
    env0 = {k: os.environ.get(k) for k in ("SPEC_DECODE", "SPEC_K")}
    out = {}
    model = None
    try:
        for mode, extra in (("wave", []),
                            ("chunked", ["--prefill-chunk", str(CHUNK)])):
            first = {}
            for run in range(SPEC_RUNS):
                for spec in ("off", "on"):
                    os.environ.update(SPEC_DECODE=spec, SPEC_K=str(SPEC_K))
                    if (mode, spec) not in first:
                        eng, _, _, _ = build_engine(build_args(base + extra))
                        first[(mode, spec)] = dict(
                            n_slots=eng.n_slots, max_len=eng.max_len,
                            temperature=0.0, seed=0,
                            block_size=eng.block_size,
                            n_blocks=eng.n_blocks,
                            prefill_chunk=eng.prefill_chunk)
                    else:
                        eng = DecodeEngine(model, **first[(mode, spec)])
                    model, L = eng.model, eng.cfg.n_layer
                    what = f"spec leg ({mode}, spec {spec}, run {run})"
                    check(eng.spec_decode == (spec == "on")
                          and eng.spec_k == SPEC_K,
                          f"{what}: engine spec_decode {eng.spec_decode}, "
                          f"spec_k {eng.spec_k}")
                    r = serve_leg(torch, eng, prompts, budgets, what)
                    plain_steps = r["steps"] - r["spec_steps"]
                    want = {"paged_prefill_attn":
                            L * (r["chunk_steps"] if eng.prefill_chunk
                                 else r["admits"]),
                            "paged_decode_attn": L * plain_steps}
                    check(r["launches"] == {k: want.get(k, 0)
                                            for k in r["launches"]},
                          f"{what}: launches {r['launches']}, expected "
                          f"{want} ({r['spec_steps']} of {r['steps']} "
                          f"steps speculated)")
                    toks = [x["tokens"] for x in r["res"]]
                    held = None
                    if spec == "on":
                        check(eng.spec_drafted_tokens > 0,
                              f"{what}: the drafter never proposed a token")
                        held = [held_per_position(
                            torch, uncached_logits(torch, model, dev, p, t),
                            t, lim, n, f"{what} stream {i} vs the uncached "
                            f"forward") for i, (p, t, n) in
                            enumerate(zip(prompts, toks, least))]
                        if run == 0:
                            held = (held, [_agree_upto_margin(
                                torch, model, dev, p, t, u, lim,
                                f"{what} stream {i} vs spec off")
                                for i, (p, t, u) in enumerate(
                                    zip(prompts, toks, off_toks))])
                    else:
                        off_toks = toks
                    rec = dict(
                        r["numbers"], steps=r["steps"],
                        spec_steps=r["spec_steps"],
                        tokens_per_step=eng.tokens_per_step,
                        accepted_token_rate=eng.accepted_token_rate,
                        drafted=eng.spec_drafted_tokens,
                        accepted=eng.spec_accepted_tokens, held=held)
                    if mode == "wave" and run == 0:
                        # where a step's time goes, spec off and on
                        rec["profile"] = profile_decode(torch, eng, prompts)
                        rec["profile"]["speculated"] = sum(
                            e["drafted"] > 0 for e in eng.flight.entries(10))
                    out.setdefault((mode, spec), []).append(rec)
                    del eng
                    torch.cuda.empty_cache()
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for (mode, spec), runs in out.items():
        def col(key, runs=runs):
            return _spread([x[key] for x in runs])
        print(f"  spec leg ({mode}, spec {spec}, {len(runs)} runs, median "
              f"[min-max]): tok/s {col('tok_s')}; TTFT p50 "
              f"{col('ttft_p50_ms')} ms, p99 {col('ttft_p99_ms')} ms; ITL "
              f"p50 {col('itl_p50_ms')} ms, p99 {col('itl_p99_ms')} ms; step "
              f"ms p50 {col('step_ms_p50')}; steps "
              f"{[x['steps'] for x in runs]}, speculated "
              f"{[x['spec_steps'] for x in runs]}; tokens_per_step "
              f"{col('tokens_per_step')}; accepted_token_rate "
              f"{col('accepted_token_rate')} (drafted "
              f"{[x['drafted'] for x in runs]}, accepted "
              f"{[x['accepted'] for x in runs]}); positions held to the "
              f"uncached argmax (margin > {lim}) and, run 0, tokens equal "
              f"to spec off up to the first margin <= {lim}: "
              f"{[x['held'] for x in runs]}; plain calls 0; card {card}",
              flush=True)
        prof = runs[0].get("profile")
        if prof:
            print(f"  spec leg ({mode}, spec {spec}) profile: "
                  f"{prof['speculated']} of 10 steps speculated; host wall "
                  f"{prof['host_ms']:.3f} ms, kernels "
                  f"{prof['device_ms']:.3f} ms a step, busy "
                  f"{prof['busy_pct']:.1f}%", flush=True)
    return out


def run_chunked_fp32(torch, dev, prompts, budgets, root: str) -> list:
    """Leg (a) in fp32, offline, from the same checkpoint: the chunked
    engine's tokens equal the uncached argmax at every position whose
    margin exceeds the fp32 limit. (An fp32 wave engine and the agreement
    with it up to the first near-tie were cut to hold the run near 900 s;
    leg (a) holds the bf16 chunked engine to the wave's.)"""
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)

    eng, _, _, _ = build_engine(build_args(
        ["--ckpt", root, "--slots", "8", "--kv-block", "16",
         "--temperature", "0", "--port", "0", "--dtype", "float32",
         "--prefill-chunk", str(CHUNK)]))
    chunked = [t[len(p):] for t, p in
               zip(eng.run(prompts, budgets), prompts)]
    model = eng.model
    del eng
    lim = LOGIT_TOL["float32"]
    held = [held_per_position(
        torch, uncached_logits(torch, model, dev, p, c), c, lim,
        int(MIN_CHECKED["float32"] * b),
        f"fp32 chunked stream {i} vs the uncached forward")
        for i, (p, c, b) in enumerate(zip(prompts, chunked, budgets))]
    print(f"  fp32, prefill_chunk {CHUNK}: the uncached argmax at every "
          f"position with a margin > {lim}: {held} checked, all equal",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return held


def run_serve_cli(torch, argv=None, startup=None) -> None:
    """`python -m distributed_pytorch_tpu_torch.serve` with `argv`
    (default: `--preset gpt2_124m --cache-dtype int8 --quant-weights
    --prefill-chunk 256 --port 0`) in a subprocess: it must name its
    options (`startup`) at startup and answer one greedy completion on its
    budget; it is stopped (SIGINT, then killed) after."""
    import queue
    import signal
    import threading

    if startup is None:
        startup = ("cache=int8", "quant_w=True", f"prefill_chunk={CHUNK}")
    cmd = [sys.executable, "-m", "distributed_pytorch_tpu_torch.serve",
           *(argv or CLI_ARGV)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    try:
        deadline = time.time() + 300
        start = None
        seen = []
        while start is None and time.time() < deadline:
            try:
                ln = lines.get(timeout=max(0.1, deadline - time.time()))
            except queue.Empty:
                break
            seen.append(ln.rstrip())
            if ln.startswith("serving on http://"):
                start = ln.strip()
        check(start is not None, f"serve CLI did not start: {seen[-20:]}")
        check(all(f in start for f in startup),
              f"serve CLI startup line lacks its options: {start}")
        port = int(start.split("http://", 1)[1].split()[0].rsplit(":", 1)[1])
        prompt = list(range(1, 201))
        r = asyncio.run(asyncio.wait_for(_sse(port, prompt, 16), 300))
        check(r["status"] == 200 and len(r["tokens"]) == 16
              and r["done"] is not None
              and r["done"].get("reason") == "budget",
              f"serve CLI completion: {r['status']} {r['done']}")
        print(f"  serve CLI ({' '.join(cmd[3:])}): {start}; one 200-token "
              f"completion of 16 tokens on budget, TTFT "
              f"{r['ttft'] * 1e3:.1f} ms", flush=True)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--preset", "gpt2_124m", "--attn_impl", "pallas",
              "--compute_dtype", "bfloat16", "--dataset", "synthetic",
              "--batch_size", "8", "--total_batch_size_str", "2**14",
              "--max_iters", "19", "--warmup_steps", "5",
              "--learning_rate", "1e-3", "--ckpt_interval", "10",
              "--file_name", "chip_smoke_train", "--seed", "0"]


def run_train(torch, dev, card: str) -> dict:
    """The trainer's own train() at full width; returns the flash kernels'
    launches in it."""
    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
    from distributed_pytorch_tpu_torch.train.loop import train

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            model_cfg, train_cfg = parse_train_argv(
                TRAIN_ARGV + ["--data_dir", os.path.join(tmp, "data")])
            L = model_cfg.n_layer
            accum = train_cfg.total_batch_size // (
                train_cfg.batch_size * model_cfg.block_size)
            iters = train_cfg.max_iters + 1
            reset_counts()
            stats = train(model_cfg, train_cfg,
                          log=lambda line: print(f"  {line}", flush=True))
            launches = _counted(
                {k: L * accum * iters for k in FLASH_SOURCE},
                "train")
            losses = stats["train_losses"]
            check(len(losses) == iters and all(np.isfinite(losses)),
                  f"train: losses {losses}")
            last = float(np.mean(losses[-3:]))
            check(last <= losses[0] - TRAIN_DROP,
                  f"train: loss fell from {losses[0]:.4f} to {last:.4f}, "
                  f"less than {TRAIN_DROP}")
            root = os.path.join("checkpoints", train_cfg.file_name)
            step_dir = os.path.join(root, "step_10")
            check(ckpt.verify_manifest(step_dir) == [],
                  f"train: checkpoint {step_dir} does not verify")
            state = stats["state"]
            restored = ckpt.restore_latest(root, state)
            check(restored is not None and restored[1].endswith("step_10")
                  and restored[0].step == 11,
                  f"train: restore_latest gave {restored and restored[1:]}")
            profile_train(torch, state, train_cfg, model_cfg)
            del state, stats["state"], restored
        finally:
            os.chdir(cwd)
    print(f"  20 iterations x {accum} micro-steps of {train_cfg.batch_size} x "
          f"{model_cfg.block_size}: loss {losses[0]:.4f} -> {last:.4f} "
          f"(mean of the last 3; drop >= {TRAIN_DROP}); step ms p50 "
          f"{stats['median_step_time'] * 1e3:.3f}, tok/s "
          f"{stats['median_tokens_per_sec']:.1f}, MFU "
          f"{stats['median_mfu']:.4f}, peak memory "
          f"{stats['peak_mem_gb']:.3f} GB; launches "
          f"{ {k: launches[k] for k in FLASH_SOURCE} }; "
          f"checkpoint step_10 verified and restored; card {card}",
          flush=True)
    torch.cuda.empty_cache()
    return {k: launches[k] for k in FLASH_SOURCE}, losses[0]


def profile_train(torch, state, train_cfg, model_cfg) -> dict:
    """Where a steady train step's time goes: host wall per step, device
    time by kernel (torch.profiler), device busy share. Runs after the
    main path's counts were read. Returns the split in ms per step."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_pytorch_tpu_torch.data.loader import DataLoader
    from distributed_pytorch_tpu_torch.train.loop import data_paths
    from distributed_pytorch_tpu_torch.train.step import make_train_step

    step = make_train_step(train_cfg)
    B, T = train_cfg.batch_size, model_cfg.block_size
    loader = DataLoader(data_paths(train_cfg, model_cfg.vocab_size)[0], B, T,
                        grad_accum=train_cfg.total_batch_size // (B * T),
                        device=state.model.device)
    x, y = loader.next_batch(step=100)
    step(state, x, y)
    torch.cuda.synchronize()
    n = 2
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, x, y)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, x, y)
        torch.cuda.synchronize()

    ev, dev_ms = device_kernels(prof, n)
    print(f"  train step (B {B} x T {T} x accum 2, loss "
          f"{model_cfg.loss_impl}): host wall "
          f"{wall_ms:.3f} ms, device {dev_ms:.3f} ms (kernels), device busy "
          f"{100 * dev_ms / wall_ms:.1f}%", flush=True)
    split = {"flash attention kernels": 0.0, "fused CE kernels": 0.0,
             "grouped-mm kernels": 0.0, "matmuls (cuBLAS)": 0.0,
             "everything else": 0.0}
    flash = dict.fromkeys(FLASH_KERNEL_NAMES, 0.0)
    grouped = dict.fromkeys(GMM_MODES.values(), 0.0)
    for e in ev:
        kname = flash_kernel_of(e.key)
        if "fce::" in e.key:
            split["fused CE kernels"] += _dev_us(e)
        elif "gmm::" in e.key:
            split["grouped-mm kernels"] += _dev_us(e)
            gname = gmm_kernel_of(e.key)
            if gname is not None:
                grouped[gname] += _dev_us(e)
        elif kname is not None:
            split["flash attention kernels"] += _dev_us(e)
            flash[kname] += _dev_us(e)
        elif any(m in e.key.lower() for m in ("gemm", "nvjet", "xmma",
                                              "cutlass")):
            split["matmuls (cuBLAS)"] += _dev_us(e)
        else:
            split["everything else"] += _dev_us(e)
    print("  split: " + ", ".join(f"{k} {v / n / 1e3:.3f} ms"
                                  for k, v in split.items()), flush=True)
    # an upper bound on the MoE token gathers and combines: the embedding
    # and MLA's concatenations run these kernels too
    gathers = sum(_dev_us(e) for e in ev
                  if "indexSelect" in e.key or "CatArrayBatchedCopy" in e.key)
    print(f"  index_select and cat kernels (the MoE gathers and combines, "
          f"the embedding, concatenations): {gathers / n / 1e3:.3f} ms a "
          f"step", flush=True)
    print("  flash a step: " + ", ".join(
        f"{k} {v / n / 1e3:.3f} ms" for k, v in flash.items()), flush=True)
    if split["grouped-mm kernels"]:
        print("  grouped a step: " + ", ".join(
            f"{k} {v / n / 1e3:.3f} ms" for k, v in grouped.items()),
            flush=True)
    top = print_kernels(ev, n, 12)
    return {"host_wall_ms": wall_ms, "device_ms": dev_ms, "top": top,
            "flash_kernels": sorted({kernel_name(e.key) for e in ev
                                     if flash_kernel_of(e.key)}),
            "gathers_ms": gathers / n / 1e3,
            **{k: v / n / 1e3 for k, v in split.items()},
            **{k: v / n / 1e3 for k, v in flash.items()},
            **{k: v / n / 1e3 for k, v in grouped.items()}}


def run_parity(torch, dev, cfg=None, what: str = "parity") -> None:
    """One train step's loss and gradients at full width in fp32, B 2:
    through the flash kernels against attn_impl='naive'; `cfg` defaults to
    the flagship (phase 6)."""
    from distributed_pytorch_tpu_torch.config import (TrainConfig,
                                                      flagship_gpt124m)
    from distributed_pytorch_tpu_torch.train.state import build_model

    cfg = cfg or flagship_gpt124m()
    rng = np.random.default_rng(5)
    shape = (2, cfg.block_size)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    res = {}
    for impl in ("pallas", "naive"):
        model = build_model(cfg, TrainConfig(compute_dtype="float32",
                                             attn_impl=impl), dev)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        model.init_weights(g)
        model.train()
        reset_counts()
        _, loss = model(x, y)
        loss.backward()
        launches, _ = counts()
        res[impl] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()}, launches)
        del model
    (l_k, g_k, n_k), (l_n, g_n, n_n) = res["pallas"], res["naive"]
    check(all(n_k[k] == cfg.n_layer for k in FLASH_SOURCE)
          and all(n_n[k] == 0 for k in FLASH_SOURCE),
          f"{what}: kernel routes {n_k}, naive routes {n_n}")
    # per parameter: max |grad diff| / max |grad| (0 / 0 counts as 0)
    rel = {}
    for name, b in g_n.items():
        err = (g_k[name] - b).abs().max().item()
        mag = b.abs().max().item()
        rel[name] = err / mag if mag > 0 else (0.0 if err == 0 else np.inf)
    worst = max(rel, key=rel.get)
    attn = max((n for n in rel if ".attn." in n), key=rel.get)
    print(f"  fp32 {what}, B 2 x T {cfg.block_size}: loss {l_k:.6f} "
          f"(kernels, head size {flash_head_size(cfg)}) vs {l_n:.6f} "
          f"(naive), |diff| {abs(l_k - l_n):.3e} (tol "
          f"{PARITY_TOL['loss']:.0e}); max |grad diff| / max |grad| per "
          f"parameter: worst {rel[worst]:.3e} ({worst}), worst attention "
          f"{rel[attn]:.3e} ({attn}) (tol {PARITY_TOL['grad']:.0e})",
          flush=True)
    check(abs(l_k - l_n) <= PARITY_TOL["loss"], f"{what}: losses differ")
    check(rel[worst] <= PARITY_TOL["grad"],
          f"{what}: gradients of {worst} differ by {rel[worst]:.3e} of "
          f"their largest")
    del res, g_k, g_n
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: train with the fused CE kernels, then sample and serve
# ---------------------------------------------------------------------------

CE_ARGV = TRAIN_ARGV + ["--loss_impl", "pallas", "--eval",
                        "--eval_interval", "10", "--eval_iters", "2",
                        "--save_model", "--file_name", "chip_smoke_ce"]


def run_train_ce(torch, dev, card: str, loss0_fused: float, tmp: str
                 ) -> dict:
    """The trainer's own train() with `--loss_impl pallas` and eval, in
    `tmp` (the checkpoint stays there for sampling and serving). Returns
    the CE kernels' launches and the run's numbers."""
    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.ops import fused_ce as ce
    from distributed_pytorch_tpu_torch.train.loop import train

    model_cfg, train_cfg = parse_train_argv(
        CE_ARGV + ["--data_dir", os.path.join(tmp, "data")])
    L = model_cfg.n_layer
    accum = train_cfg.total_batch_size // (
        train_cfg.batch_size * model_cfg.block_size)
    iters = train_cfg.max_iters + 1
    evals = len(range(0, iters, train_cfg.eval_interval))
    eval_fwd = evals * 2 * train_cfg.eval_iters     # 2 splits
    micro = accum * iters
    reset_counts()
    stats = train(model_cfg, train_cfg,
                  log=lambda line: print(f"  {line}", flush=True))
    launches = _counted(
        {"fused_ce_fwd": micro + eval_fwd, "fused_ce_bwd_dx": micro,
         "fused_ce_bwd_dw": micro, "flash_attn_fwd": L * (micro + eval_fwd),
         "flash_attn_bwd_dq": L * micro, "flash_attn_bwd_dkv": L * micro},
        "train with loss_impl='pallas'")
    check(ce.DEGRADED["chunked"] == 0,
          f"train: the pallas loss degraded {ce.DEGRADED} times")
    losses = stats["train_losses"]
    check(len(losses) == iters and all(np.isfinite(losses)),
          f"train ce: losses {losses}")
    last = float(np.mean(losses[-3:]))
    check(last <= losses[0] - TRAIN_DROP,
          f"train ce: loss fell from {losses[0]:.4f} to {last:.4f}, less "
          f"than {TRAIN_DROP}")
    d0 = abs(losses[0] - loss0_fused)
    check(d0 <= ITER0_TOL,
          f"train ce: iteration 0's loss {losses[0]:.6f} differs from "
          f"phase 6's {loss0_fused:.6f} by {d0:.3e} > {ITER0_TOL}")
    vals = [v for _, v in stats["val_losses"]]
    check(len(vals) == evals and all(np.isfinite(vals)),
          f"train ce: eval losses {stats['val_losses']}")
    split = profile_train(torch, stats["state"], train_cfg, model_cfg)
    out = dict(launches={k: launches[k] for k in CE_SOURCE},
               loss0=losses[0], loss_last3=last, iter0_diff=d0,
               val_losses=stats["val_losses"],
               step_ms=stats["median_step_time"] * 1e3,
               tok_s=stats["median_tokens_per_sec"],
               mfu=stats["median_mfu"], peak_gb=stats["peak_mem_gb"],
               split=split)
    print(f"  {iters} iterations x {accum} micro-steps, loss_impl pallas: "
          f"loss {losses[0]:.4f} -> {last:.4f} (mean of the last 3); "
          f"iteration 0 vs phase 6 (chunked loss) |diff| {d0:.3e} (tol "
          f"{ITER0_TOL:.0e}); val {vals}; step ms p50 {out['step_ms']:.3f}, "
          f"tok/s {out['tok_s']:.1f}, MFU {out['mfu']:.4f}, peak memory "
          f"{out['peak_gb']:.3f} GB; CE launches {out['launches']}, "
          f"degraded 0, plain calls 0; card {card}", flush=True)
    del stats
    torch.cuda.empty_cache()
    return out


def run_parity_ce(torch, dev) -> None:
    """One fp32 forward and backward at full width, B 2: the loss through
    the fused CE kernels against `loss_impl='unchunked'` (full logits),
    both over the flash kernels."""
    import dataclasses

    from distributed_pytorch_tpu_torch.config import (TrainConfig,
                                                      flagship_gpt124m)
    from distributed_pytorch_tpu_torch.train.state import build_model

    cfg = flagship_gpt124m()
    rng = np.random.default_rng(6)
    shape = (2, cfg.block_size)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    y[0, :17] = -1                                   # ignored targets
    res = {}
    for impl in ("pallas", "unchunked"):
        model = build_model(dataclasses.replace(cfg, loss_impl=impl),
                            TrainConfig(compute_dtype="float32",
                                        attn_impl="pallas"), dev)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        model.init_weights(g)
        model.train()
        reset_counts()
        _, loss = model(x, y)
        loss.backward()
        launches, plain = counts()
        res[impl] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()}, launches)
        del model
    (l_k, g_k, n_k), (l_u, g_u, n_u) = res["pallas"], res["unchunked"]
    check(all(n_k[k] == 1 for k in CE_SOURCE)
          and all(n_u[k] == 0 for k in CE_SOURCE),
          f"parity ce: kernel routes {n_k}, unchunked routes {n_u}")
    rel = {}
    for name, b in g_u.items():
        err = (g_k[name] - b).abs().max().item()
        mag = b.abs().max().item()
        rel[name] = err / mag if mag > 0 else (0.0 if err == 0 else np.inf)
    worst = max(rel, key=rel.get)
    print(f"  fp32 parity, B 2 x T {cfg.block_size}: loss {l_k:.6f} (CE "
          f"kernels) vs {l_u:.6f} (unchunked), |diff| {abs(l_k - l_u):.3e} "
          f"(tol {PARITY_TOL['loss']:.0e}); max |grad diff| / max |grad| "
          f"per parameter: worst {rel[worst]:.3e} ({worst}), tkn_emb.weight "
          f"{rel['tkn_emb.weight']:.3e} (tol {PARITY_TOL['grad']:.0e})",
          flush=True)
    check(abs(l_k - l_u) <= PARITY_TOL["loss"], "parity ce: losses differ")
    check(rel[worst] <= PARITY_TOL["grad"],
          f"parity ce: gradients of {worst} differ by {rel[worst]:.3e} of "
          f"their largest")
    del res, g_k, g_u
    torch.cuda.empty_cache()


def run_sample_serve(torch, dev, card: str, root: str) -> dict:
    """Sample the checkpoint under `root` (the CLI, greedy, through
    `generate`) and serve it (`serve --ckpt`'s engine, in bf16 and in
    fp32): the engine's tokens equal `generate`'s on the same loaded model
    wherever that path's top-2 margin exceeds LOGIT_TOL, and the
    weights_version rides the payloads and /metrics."""
    from distributed_pytorch_tpu_torch import sample
    from distributed_pytorch_tpu_torch.models.generate import generate
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)
    from distributed_pytorch_tpu_torch.train import checkpoint as ckpt

    step_dir = ckpt.latest_step_dir(root)
    version = ckpt.weights_version(step_dir)
    L = ckpt.load_configs(step_dir)[0].n_layer
    prompt = [int(t) for t in np.random.default_rng(8).integers(0, 50304, 9)]
    n_new = 16
    reset_counts()
    outs = sample.main(["--ckpt", root, "--prompt",
                        ",".join(map(str, prompt)), "--temperature", "0",
                        "--max_new_tokens", str(n_new)])
    check(len(outs) == 1 and len(outs[0]) == len(prompt) + n_new
          and outs[0][:len(prompt)] == prompt, f"sample: {outs}")
    s_launch = _counted({"paged_decode_attn": L * (n_new - 1),
                         "flash_attn_fwd": L}, "sample")

    rng = np.random.default_rng(9)
    prompts = [prompt] + [rng.integers(0, 50304, k).tolist()
                          for k in (3, 40, 200)]
    budgets = [n_new, 24, 32, 20]
    agree = {}
    for dn in ("bfloat16", "float32"):
        eng, _, wv, _ = build_engine(build_args(
            ["--ckpt", root, "--slots", "8", "--kv-block", "16",
             "--temperature", "0", "--port", "0", "--dtype", dn]))
        check(wv == version and version and version.startswith(
            os.path.basename(step_dir) + "-"),
              f"serve: weights_version {wv}, checkpoint {version}")
        steps0, admits0 = eng.n_steps, eng.n_admitted
        reset_counts()
        res, wall, metrics = asyncio.run(asyncio.wait_for(
            _serve(eng, prompts, budgets, weights_version=version), 600))
        launches, plain = counts()
        steps, admits = eng.n_steps - steps0, eng.n_admitted - admits0
        check(plain == {k: 0 for k in plain},
              f"serve ckpt {dn}: plain ran {plain}")
        check(launches["paged_decode_attn"] == L * steps
              and launches["paged_prefill_attn"] == L * admits,
              f"serve ckpt {dn}: launches {launches} for {steps} steps, "
              f"{admits} admissions x {L} layers")
        check(f'version="{version}"' in metrics,
              f"serve ckpt {dn}: /metrics lacks the weights_version")
        # the engine's tokens against `generate` on the same loaded model,
        # wherever generate's path has a top-2 margin above LOGIT_TOL
        agree[dn] = []
        for i, (r, p, b) in enumerate(zip(res, prompts, budgets)):
            check(r["status"] == 200 and r["done"] is not None
                  and r["done"].get("weights_version") == version
                  and len(r["tokens"]) == b,
                  f"serve ckpt {dn} stream {i}: {r['status']} {r['done']}")
            ref = generate(eng.model, p, b, temperature=0.0)[0].tolist()
            agree[dn].append(_agree_upto_margin(
                torch, eng.model, dev, p, r["tokens"], ref[len(p):],
                LOGIT_TOL[dn], f"serve ckpt {dn} stream {i} vs generate"))
        if dn == "bfloat16":
            check(outs[0] == generate(eng.model, prompt, n_new,
                                      temperature=0.0)[0].tolist(),
                  "sample CLI tokens differ from generate on the served "
                  "model")
        print(f"  serve --ckpt {dn}: 4/4 streams on budget in {wall:.3f} s, "
              f"tokens equal generate's for {agree[dn]} of {budgets} (up to "
              f"the first top-2 margin <= {LOGIT_TOL[dn]}); "
              f"weights_version on payloads and /metrics; {steps} steps, "
              f"{admits} admissions", flush=True)
        del eng
        torch.cuda.empty_cache()
    print(f"  checkpoint {step_dir} [{version}]: sample.main greedy "
          f"{outs[0][len(prompt):]}; launches {s_launch['flash_attn_fwd']} "
          f"flash_attn_fwd, {s_launch['paged_decode_attn']} "
          f"paged_decode_attn; card {card}", flush=True)
    return {"agree": agree, "budgets": budgets}


# ---------------------------------------------------------------------------
# phase 9: train the flagship MoE through the grouped kernels, then serve it
# ---------------------------------------------------------------------------

MOE_ARGV = ["--preset", "gpt2_124m", "--moe", "--n_exp", "8", "--n_shared",
            "1", "--n_act", "3", "--up_dim", "1024", "--moe_impl", "grouped",
            "--attn_impl", "pallas", "--compute_dtype", "bfloat16",
            "--dataset", "synthetic", "--batch_size", "8",
            "--total_batch_size_str", "2**14", "--max_iters", "19",
            "--warmup_steps", "5", "--learning_rate", "1e-3",
            "--ckpt_interval", "10", "--save_model", "--file_name",
            "chip_smoke_moe", "--seed", "0"]


def weights_sha(torch, model) -> str:
    """sha256 (first 16 hex digits) of the model's parameters and buffers,
    taken as the trainer saved them, to compare runs."""
    import hashlib

    h = hashlib.sha256()
    for t in list(model.parameters()) + list(model.buffers()):
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def moe_repeats(torch, model, what: str, digest: str) -> None:
    """Two bf16 forward + backward calls of the trained model's first MoE
    layer on one seeded (8, block_size, n_embd) input must give the same
    bytes: the output, the input's gradient and every parameter's (the
    token gather and combine sum each token's rows in a fixed order).
    Runs after the main path's counts were read and leaves the layer's
    gradients and routing state as they were; prints `digest`, the
    saved weights' sha256, beside."""
    layer = model.moe_layers()[0]
    cfg = model.config
    g = torch.Generator(device=model.device).manual_seed(5)
    shape = (8, cfg.block_size, cfg.n_embd)
    x = torch.randn(shape, generator=g, device=model.device).bfloat16()
    dy = torch.randn(shape, generator=g, device=model.device).bfloat16()
    params = list(layer.parameters())
    saved = [p.grad for p in params]
    res = []
    for _ in range(2):
        for p in params:
            p.grad = None
        xs = x.clone().requires_grad_()
        y, aux = layer(xs)
        (y.float() * dy.float()).sum().add(aux).backward()
        res.append([y.detach(), xs.grad] + [p.grad for p in params])
    layer.pending_state = None
    for p, gr in zip(params, saved):
        p.grad = gr
    torch.cuda.synchronize()
    names = ["y", "dx"] + [n for n, _ in layer.named_parameters()]
    differ = [n for n, a, b in zip(names, *res) if not torch.equal(a, b)]
    check(not differ, f"{what}: two forward + backward calls of MoE layer 0 "
          f"({cfg.moe_impl}) differ in {differ}")
    print(f"  {what}: MoE layer 0 ({cfg.moe_impl}, bf16, B 8 x T "
          f"{cfg.block_size}): two forward + backward calls give the same "
          f"bytes (output, dx and {len(params)} parameter gradients); "
          f"saved weights sha256 {digest}", flush=True)


def run_train_moe(torch, dev, card: str, tmp: str) -> dict:
    """The trainer's own train() on the flagship MoE with the grouped
    dispatch, in `tmp` (the checkpoint stays there for serving). Returns
    the grouped kernels' launches and the run's numbers."""
    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
    from distributed_pytorch_tpu_torch.train import metrics as M
    from distributed_pytorch_tpu_torch.train.loop import train

    model_cfg, train_cfg = parse_train_argv(
        MOE_ARGV + ["--data_dir", os.path.join(tmp, "data")])
    L = model_cfg.n_layer
    accum = train_cfg.total_batch_size // (
        train_cfg.batch_size * model_cfg.block_size)
    iters = train_cfg.max_iters + 1
    micro = accum * iters
    reset_counts()
    stats = train(model_cfg, train_cfg,
                  log=lambda line: print(f"  {line}", flush=True))
    # fc, proj, and proj again in the backward (the gate cotangent's
    # recomputed unscaled product); dx and dW of both
    launches = _counted(
        {"grouped_mm_fwd": 3 * L * micro, "grouped_mm_bwd_dx": 2 * L * micro,
         "grouped_mm_bwd_dw": 2 * L * micro, "flash_attn_fwd": L * micro,
         "flash_attn_bwd_dq": L * micro, "flash_attn_bwd_dkv": L * micro},
        "train the MoE")
    check(gm.DEGRADED["dense"] == 0 and stats["moe_degraded_dense"] == 0,
          f"train moe: {gm.DEGRADED['dense']} layers took the dense path")
    losses = stats["train_losses"]
    check(len(losses) == iters and all(np.isfinite(losses)),
          f"train moe: losses {losses}")
    last = float(np.mean(losses[-3:]))
    check(last <= losses[0] - TRAIN_DROP,
          f"train moe: loss fell from {losses[0]:.4f} to {last:.4f}, less "
          f"than {TRAIN_DROP}")
    drops = stats["moe_dropped_frac"]
    check(len(drops) == iters and not any(drops),
          f"train moe: dropped fractions {drops}")
    state = stats["state"]
    bias = torch.stack([m.expert_bias for m in state.model.moe_layers()])
    check(bool(torch.isfinite(bias).all()) and float(bias.abs().max()) > 0,
          f"train moe: expert_bias {bias.tolist()}")
    digest = weights_sha(torch, state.model)
    split = profile_train(torch, state, train_cfg, model_cfg)
    moe_repeats(torch, state.model, "train moe", digest)
    out = dict(launches={k: launches[k] for k in GMM_SOURCE}, sha=digest,
               loss0=losses[0], loss_last3=last,
               step_ms=stats["median_step_time"] * 1e3,
               tok_s=stats["median_tokens_per_sec"],
               mfu=stats["median_mfu"], peak_gb=stats["peak_mem_gb"],
               params=(stats["params_total"], stats["params_active"]),
               overcompute=M.moe_overcompute_factor(model_cfg),
               bias_absmax=float(bias.abs().max()), split=split)
    print(f"  {iters} iterations x {accum} micro-steps of "
          f"{train_cfg.batch_size} x {model_cfg.block_size}, "
          f"{out['params'][0] / 1e6:.2f}M params ({out['params'][1] / 1e6:.2f}M "
          f"active): loss {losses[0]:.4f} -> {last:.4f} (mean of the last "
          f"3); step ms p50 {out['step_ms']:.3f}, tok/s {out['tok_s']:.1f}, "
          f"MFU {out['mfu']:.4f} (active-expert FLOPs; over-compute factor "
          f"{out['overcompute']:.2f}), peak memory {out['peak_gb']:.3f} GB; "
          f"expert_bias |max| {out['bias_absmax']:.4f}; moe_dropped_frac 0; "
          f"launches {out['launches']}, degraded 0, plain calls 0; card "
          f"{card}", flush=True)
    del stats, state
    torch.cuda.empty_cache()
    return out


def run_parity_moe(torch, dev) -> None:
    """One fp32 forward and backward of the flagship MoE at B 2: through
    the grouped kernels against `moe_impl='dense'` (the same dropless
    routing, every routed expert on every token, no grouped kernel), both
    over the flash kernels; the loss and every gradient, the router and
    the expert stacks included, per parameter."""
    import dataclasses

    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.config import TrainConfig
    from distributed_pytorch_tpu_torch.train.state import build_model

    cfg, _ = parse_train_argv(MOE_ARGV)
    L = cfg.n_layer
    rng = np.random.default_rng(12)
    shape = (2, cfg.block_size)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    res = {}
    for impl in ("grouped", "dense"):
        model = build_model(dataclasses.replace(cfg, moe_impl=impl),
                            TrainConfig(compute_dtype="float32",
                                        attn_impl="pallas"), dev)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        model.init_weights(g)
        model.train()
        reset_counts()
        _, loss = model(x, y)
        loss.backward()
        launches, plain = counts()
        check(not any(plain.values()), f"parity moe {impl}: plain {plain}")
        res[impl] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()}, launches)
        del model
    (l_k, g_k, n_k), (l_d, g_d, n_d) = res["grouped"], res["dense"]
    want = {"grouped_mm_fwd": 3 * L, "grouped_mm_bwd_dx": 2 * L,
            "grouped_mm_bwd_dw": 2 * L}
    check({k: n_k[k] for k in want} == want
          and all(n_d[k] == 0 for k in want),
          f"parity moe: grouped routes {n_k}, dense routes {n_d}")
    rel = {}
    for name, b in g_d.items():
        err = (g_k[name] - b).abs().max().item()
        mag = b.abs().max().item()
        rel[name] = err / mag if mag > 0 else (0.0 if err == 0 else np.inf)
    worst = max(rel, key=rel.get)
    moe = {k: max((n for n in rel if n.endswith(k)), key=rel.get)
           for k in ("gate", "experts_fc", "experts_proj")}
    print(f"  fp32 parity, B 2 x T {cfg.block_size}: loss {l_k:.6f} (grouped "
          f"kernels) vs {l_d:.6f} (dense), |diff| {abs(l_k - l_d):.3e} (tol "
          f"{PARITY_TOL['loss']:.0e}); max |grad diff| / max |grad| per "
          f"parameter: worst {rel[worst]:.3e} ({worst}); worst "
          + ", ".join(f"{k} {rel[n]:.3e}" for k, n in moe.items())
          + f" (tol {PARITY_TOL['grad']:.0e})", flush=True)
    check(abs(l_k - l_d) <= PARITY_TOL["loss"], "parity moe: losses differ")
    check(rel[worst] <= PARITY_TOL["grad"],
          f"parity moe: gradients of {worst} differ by {rel[worst]:.3e} of "
          f"their largest")
    del res, g_k, g_d
    torch.cuda.empty_cache()


def run_serve_moe(torch, dev, card: str, root: str) -> dict:
    """Serve phase 9's checkpoint: `sample.main` (greedy, through
    `generate`), the `serve --ckpt` engine with phase 5's traffic of 8
    streams (the wave, bf16 and fp32) and the serve CLI answering one
    completion. Tokens are held at every position against the uncached
    naive-attention, dense-dispatch forward (NEAR_TOP); the grouped
    forward launches 2 x layers per forward (decode step, admission,
    prompt pass); the bias never moves."""
    from distributed_pytorch_tpu_torch import sample
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)
    from distributed_pytorch_tpu_torch.train import checkpoint as ckpt

    step_dir = ckpt.latest_step_dir(root)
    version = ckpt.weights_version(step_dir)
    L = ckpt.load_configs(step_dir)[0].n_layer
    prompt = [int(t) for t in np.random.default_rng(13).integers(0, 50304, 9)]
    n_new = 16
    reset_counts()
    outs = sample.main(["--ckpt", root, "--prompt",
                        ",".join(map(str, prompt)), "--temperature", "0",
                        "--max_new_tokens", str(n_new)])
    check(len(outs) == 1 and len(outs[0]) == len(prompt) + n_new
          and outs[0][:len(prompt)] == prompt, f"sample moe: {outs}")
    s_launch = _counted({"paged_decode_attn": L * (n_new - 1),
                         "flash_attn_fwd": L, "grouped_mm_fwd": 2 * L * n_new},
                        "sample moe")
    out = {"sample_launches": s_launch["grouped_mm_fwd"], "legs": {}}
    for dn in ("bfloat16", "float32"):
        eng, _, wv, _ = build_engine(build_args(
            ["--ckpt", root, "--slots", "8", "--kv-block", "16",
             "--temperature", "0", "--port", "0", "--dtype", dn]))
        check(wv == version and version, f"serve moe: weights_version {wv}")
        if dn == "bfloat16":
            s_model = sample.load_for_inference(root)[0]
            lg = uncached_logits(torch, s_model, dev, prompt,
                                 outs[0][len(prompt):])
            n_s, gap_s = held_near_top(torch, lg, outs[0][len(prompt):],
                                       LOGIT_TOL[dn], 0, "sample moe")
            del s_model
        bias = [m.expert_bias.clone() for m in eng.model.moe_layers()]
        prompts, budgets = serve_traffic(eng.cfg.vocab_size)
        r = serve_leg(torch, eng, prompts, budgets, f"serve moe {dn}")
        launches, steps, admits = r["launches"], r["steps"], r["admits"]
        want = {"paged_decode_attn": L * steps,
                "paged_prefill_attn": L * admits,
                "grouped_mm_fwd": 2 * L * (steps + admits)}
        check(launches == {k: want.get(k, 0) for k in launches},
              f"serve moe {dn}: launches {launches} for {steps} steps, "
              f"{admits} admissions x {L} layers (want {want})")
        check(all(torch.equal(b, m.expert_bias) for b, m in
                  zip(bias, eng.model.moe_layers())),
              f"serve moe {dn}: the engine moved the expert bias")
        checked, gap = [], 0.0
        for i, (x, p, b) in enumerate(zip(r["res"], prompts, budgets)):
            lg = uncached_logits(torch, eng.model, dev, p, x["tokens"])
            # bf16: every position is held (NEAR_TOP) and no margin
            # share is required; fp32 keeps MIN_CHECKED's share
            least = int(MIN_CHECKED[dn] * b) if dn == "float32" else 0
            n, g = held_near_top(torch, lg, x["tokens"], LOGIT_TOL[dn],
                                 least, f"serve moe {dn} stream {i}")
            checked.append(n)
            gap = max(gap, g)
        prof = profile_decode(torch, eng, prompts)
        out["legs"][dn] = dict(launches=launches, steps=steps, admits=admits,
                               checked=checked, gap=gap,
                               numbers=r["numbers"],
                               profile=prof)
        print(f"  serve --ckpt {dn} (wave, 8 streams): "
              f"{_numbers_line(r['numbers'], prof)}; tokens held to the "
              f"naive dense forward at all {budgets} positions within "
              f"{LOGIT_TOL[dn]} of its largest logit (largest gap "
              f"{gap:.4g}), its argmax at {checked} (top-2 margin > "
              f"{LOGIT_TOL[dn]}); {steps} steps, {admits} "
              f"admissions; launches {launches}; card {card}", flush=True)
        del eng
        torch.cuda.empty_cache()
    run_serve_cli(torch, ["--ckpt", root, "--slots", "8", "--kv-block", "16",
                          "--temperature", "0", "--port", "0"],
                  startup=("slots=8", "cache=native"))
    print(f"  checkpoint {step_dir} [{version}]: sample.main greedy "
          f"{outs[0][len(prompt):]} (held at all {n_new} positions within "
          f"{LOGIT_TOL['bfloat16']} of the naive forward's largest logit "
          f"(largest gap {gap_s:.4g}), its argmax at {n_s}); "
          f"launches {s_launch['grouped_mm_fwd']} grouped_mm_fwd, "
          f"{s_launch['flash_attn_fwd']} flash_attn_fwd, "
          f"{s_launch['paged_decode_attn']} paged_decode_attn; card {card}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: MLA (the launcher's model)
# ---------------------------------------------------------------------------

# scripts/train.sh's Model configuration as it stands (12 x 1024, MLA with
# 8 heads of 128, latents 256 / 256, rope head 128, DeepSeekMoE 16 experts
# through the scatter dispatch, attention recomputation) with phase 6's
# optimizer, data and batch flags; one checkpoint, the final one (phase 6
# checks an interval save and its restore)
MLA_ARGV = ["--n_layer", "12", "--n_embd", "1024", "--vocab_size", "50304",
            "--block_size", "1024", "--dropout", "0.0", "--pos_emb", "rope",
            "--up_dim", "768", "--non_linearity", "swiglu", "--attn", "mla",
            "--n_head", "8", "--n_kv_heads", "4", "--q_latent_dim", "256",
            "--kv_latent_dim", "256", "--rope_head_dim", "128", "--moe",
            "--moe_impl", "scatter", "--n_exp", "16", "--n_shared", "1",
            "--n_act", "4", "--aux_free", "--alpha", "0.0001", "--gamma",
            "0.001", "--coeff", "0.01", "--act_recomp", "--act_recomp_policy",
            "attn", "--attn_impl", "pallas", "--compute_dtype", "bfloat16",
            "--dataset", "synthetic", "--batch_size", "8",
            "--total_batch_size_str", "2**14", "--max_iters", "19",
            "--warmup_steps", "5", "--learning_rate", "1e-3",
            "--save_model", "--file_name", "chip_smoke_mla", "--seed", "0"]


def flash_launches(cfg, micro: int) -> dict:
    """The flash kernels' launches in `micro` training micro-steps of a
    model of `cfg`: one forward, dq and dkv per layer, and the forward
    again where 'attn' recomputation re-runs the sublayer in the
    backward."""
    L = cfg.n_layer
    again = cfg.act_recomp and cfg.act_recomp_policy == "attn"
    return {"flash_attn_fwd": (2 if again else 1) * L * micro,
            "flash_attn_bwd_dq": L * micro, "flash_attn_bwd_dkv": L * micro}


def run_train_mla(torch, dev, card: str, tmp: str) -> dict:
    """The trainer's own train() on the launcher's MLA model, in `tmp`
    (the checkpoint stays there for serving). FullMLA's training forward
    sends q_c | q_r, k_c | k_r and v padded by the rope head through the
    flash kernels at head size 256. Returns the flash launches and the
    run's numbers."""
    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.train.loop import train

    model_cfg, train_cfg = parse_train_argv(
        MLA_ARGV + ["--data_dir", os.path.join(tmp, "data")])
    check(model_cfg.head_size + model_cfg.rope_head_dim == 256,
          f"train mla: flash head size "
          f"{model_cfg.head_size + model_cfg.rope_head_dim}")
    accum = train_cfg.total_batch_size // (
        train_cfg.batch_size * model_cfg.block_size)
    iters = train_cfg.max_iters + 1
    reset_counts()
    stats = train(model_cfg, train_cfg,
                  log=lambda line: print(f"  {line}", flush=True))
    launches = _counted(flash_launches(model_cfg, accum * iters),
                        "train mla")
    losses = stats["train_losses"]
    check(len(losses) == iters and all(np.isfinite(losses)),
          f"train mla: losses {losses}")
    last = float(np.mean(losses[-3:]))
    check(last <= losses[0] - TRAIN_DROP,
          f"train mla: loss fell from {losses[0]:.4f} to {last:.4f}, less "
          f"than {TRAIN_DROP}")
    state = stats["state"]
    check(type(state.model.blocks[0].attn).__name__ == "FullMLA",
          f"train mla: attention {type(state.model.blocks[0].attn)}")
    digest = weights_sha(torch, state.model)
    split = profile_train(torch, state, train_cfg, model_cfg)
    moe_repeats(torch, state.model, "train mla", digest)
    drops = stats["moe_dropped_frac"]
    out = dict(launches={k: launches[k] for k in FLASH_SOURCE}, sha=digest,
               loss0=losses[0], loss_last3=last,
               step_ms=stats["median_step_time"] * 1e3,
               tok_s=stats["median_tokens_per_sec"],
               mfu=stats["median_mfu"], peak_gb=stats["peak_mem_gb"],
               params=(stats["params_total"], stats["params_active"]),
               moe_drop=(float(np.mean(drops)), float(np.max(drops))),
               split=split)
    print(f"  {iters} iterations x {accum} micro-steps of "
          f"{train_cfg.batch_size} x {model_cfg.block_size}, "
          f"{out['params'][0] / 1e6:.2f}M params ({out['params'][1] / 1e6:.2f}M "
          f"active): loss {losses[0]:.4f} -> {last:.4f} (mean of the last "
          f"3); step ms p50 {out['step_ms']:.3f}, tok/s {out['tok_s']:.1f}, "
          f"MFU {out['mfu']:.4f} (MLA FLOP count), peak memory "
          f"{out['peak_gb']:.3f} GB; moe_drop mean "
          f"{100 * out['moe_drop'][0]:.2f}%, max "
          f"{100 * out['moe_drop'][1]:.2f}%; launches {out['launches']} "
          f"(the forward twice a layer: 'attn' recomputation), plain calls "
          f"0; card {card}", flush=True)
    del stats, state
    torch.cuda.empty_cache()
    return out


def run_parity_mla(torch, dev) -> None:
    """One fp32 forward and backward of the launcher's MLA model at B 2:
    through the flash kernels at head size 256 against
    `attn_impl='naive'`; the loss and every gradient, per parameter."""
    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.config import TrainConfig
    from distributed_pytorch_tpu_torch.train.state import build_model

    cfg, _ = parse_train_argv(MLA_ARGV)
    rng = np.random.default_rng(14)
    shape = (2, cfg.block_size)
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    res = {}
    for impl in ("pallas", "naive"):
        model = build_model(cfg, TrainConfig(compute_dtype="float32",
                                             attn_impl=impl), dev)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        model.init_weights(g)
        model.train()
        reset_counts()
        _, loss = model(x, y)
        loss.backward()
        launches, plain = counts()
        check(not any(plain.values()), f"parity mla {impl}: plain {plain}")
        res[impl] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()}, launches)
        if impl == "naive":
            absorbed_gap = absorbed_vs_materialized(torch, model, dev, x[:1])
        del model
    (l_k, g_k, n_k), (l_n, g_n, n_n) = res["pallas"], res["naive"]
    want = flash_launches(cfg, 1)
    check({k: n_k[k] for k in want} == want
          and all(n_n[k] == 0 for k in want),
          f"parity mla: kernel routes {n_k}, naive routes {n_n}")
    rel = {}
    for name, b in g_n.items():
        err = (g_k[name] - b).abs().max().item()
        mag = b.abs().max().item()
        rel[name] = err / mag if mag > 0 else (0.0 if err == 0 else np.inf)
    worst = max(rel, key=rel.get)
    mla = {k: max((n for n in rel if n.endswith(k)), key=rel.get)
           for k in ("W_uq", "W_qr", "W_uk", "W_uv", "W_kr")}
    print(f"  fp32 parity, B 2 x T {cfg.block_size}: loss {l_k:.6f} (flash "
          f"kernels, D 256) vs {l_n:.6f} (naive), |diff| "
          f"{abs(l_k - l_n):.3e} (tol {PARITY_TOL['loss']:.0e}); max |grad "
          f"diff| / max |grad| per parameter: worst {rel[worst]:.3e} "
          f"({worst}); worst " + ", ".join(f"{k} {rel[n]:.3e}"
                                          for k, n in mla.items())
          + f" (tol {PARITY_TOL['grad']:.0e}); absorbed (cached) against "
          f"materialized logits, fp32: max |diff| {absorbed_gap:.3e} (tol "
          f"{LOGIT_TOL['float32']:.0e})", flush=True)
    check(abs(l_k - l_n) <= PARITY_TOL["loss"], "parity mla: losses differ")
    check(absorbed_gap <= LOGIT_TOL["float32"],
          f"parity mla: absorbed logits differ from the materialized by "
          f"{absorbed_gap:.3e}")
    check(rel[worst] <= PARITY_TOL["grad"],
          f"parity mla: gradients of {worst} differ by {rel[worst]:.3e} of "
          f"their largest")
    del res, g_k, g_n
    torch.cuda.empty_cache()


def absorbed_vs_materialized(torch, model, dev, idx) -> float:
    """The largest |logit| difference, fp32, between `model`'s uncached
    forward over `idx` (1, T) (materialized K and V, naive attention) and
    its cached one (a 300-token prompt into a contiguous latent cache,
    then the rest one forward at a time: MLA's absorbed attention), every
    position. Both kernel-free and dropless (`naive_forward`)."""
    from distributed_pytorch_tpu_torch.models.gpt import init_cache

    model.eval()
    T, P = idx.shape[1], 300
    with torch.no_grad():
        full = naive_forward(model, idx, all_logits=True)[0]
        caches = init_cache(model.config, 1, T, dtype=model.dtype, device=dev)
        rows = [naive_forward(model, idx[:, :P], caches=caches, pos=0,
                              all_logits=True)[0]]
        rows += [naive_forward(model, idx[:, t:t + 1], caches=caches,
                               pos=torch.tensor(t, device=dev))[0]
                 for t in range(P, P + 16)]
        rows.append(naive_forward(model, idx[:, P + 16:], caches=caches,
                                  pos=P + 16, all_logits=True)[0])
    model.train()
    return (torch.cat(rows) - full).abs().max().item()


def dropless(model) -> None:
    """Switch `model`'s MoE layers to the dense dispatch: the same weights
    and routing with no capacity (models/mlp.py). The scatter dispatch's
    capacity is set by each forward's token count, so an engine's 8-row
    decode step and a one-sequence forward drop different assignments, and
    no kernel-free forward of one sequence could hold a scatter engine's
    tokens; wherever scatter drops nothing, the two dispatches agree."""
    import dataclasses
    for m in model.moe_layers():
        m.config = dataclasses.replace(m.config, moe_impl="dense")


def run_serve_mla(torch, dev, card: str, root: str) -> dict:
    """Serve phase 10's checkpoint. MLA attends over its latent cache by
    weight absorption (einsums; the reference runs no Pallas kernel
    there), so no kernel launches on these paths: `sample.main` (greedy,
    `generate`), then the `serve --ckpt` engine with phase 5's traffic,
    (w) the bf16 wave, (a) prefill_chunk CHUNK, (b) chunked with
    `--cache-dtype int8 --quant-weights`, whose int8 cache request MLA
    declines (the engine keeps a bf16 latent cache and int8 weights), and
    the serve CLI answering one completion. Tokens are held at every
    position by NEAR_TOP, as in phase 9: the checkpoint is 20 steps into
    training and its bf16 leaders tie along whole streams, where phase 8's
    margin share would check too few positions. The reference is the
    served arithmetic without the engine and without a kernel
    (`mirror_logits`: the prompt into a contiguous latent cache, then the
    tokens teacher-forced, absorbed, on the engine's weights), not the
    uncached materialized forward: in bf16 the two attention forms round
    at different points (the absorbed query q W_uk against the
    materialized keys c_kv W_uk): on the H100 leg (a) served two tokens
    whose materialized-forward logits lay 0.0938 below that forward's
    largest, 1.5 bf16 steps at |logit| 8-16. Phase 10's
    parity step holds the two forms to each other in fp32 at full width
    (`absorbed_vs_materialized`). The engines serve with the dropless
    dispatch (`dropless`); sample's 1-token prompt makes every forward of
    its scatter model carry one token, which drops nothing."""
    from distributed_pytorch_tpu_torch import sample
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)
    from distributed_pytorch_tpu_torch.train import checkpoint as ckpt

    step_dir = ckpt.latest_step_dir(root)
    version = ckpt.weights_version(step_dir)
    lim = LOGIT_TOL["bfloat16"]
    prompt = [int(np.random.default_rng(15).integers(0, 50304))]
    n_new = 16
    reset_counts()
    outs = sample.main(["--ckpt", root, "--prompt", str(prompt[0]),
                        "--temperature", "0", "--max_new_tokens",
                        str(n_new)])
    check(len(outs) == 1 and len(outs[0]) == len(prompt) + n_new
          and outs[0][:len(prompt)] == prompt, f"sample mla: {outs}")
    _counted({}, "sample mla")
    # sample.main's load deep-verified the step dir; the five loads after
    # it (the sample's reference, three engines, the serve CLI) read the
    # same bytes, so they skip the blake2b pass over the 537.76M model's
    # weights and moments, which held this script past 700 s
    verify = os.environ.get("CKPT_VERIFY")
    os.environ["CKPT_VERIFY"] = "off"
    s_model = sample.load_for_inference(root)[0]
    lg = mirror_logits(torch, s_model, dev, prompt, outs[0][len(prompt):],
                       cache_dtype=s_model.dtype)
    n_s, gap_s = held_near_top(torch, lg, outs[0][len(prompt):], lim, 0,
                               "sample mla")
    del s_model
    print(f"  checkpoint {step_dir} [{version}]: sample.main greedy "
          f"{outs[0][len(prompt):]} (held at all {n_new} positions within "
          f"{lim} of the engine-free forward's largest logit (largest gap "
          f"{gap_s:.4g}), its argmax at {n_s}); launches 0, plain calls 0; "
          f"card {card}", flush=True)

    base = ["--ckpt", root, "--slots", "8", "--kv-block", "16",
            "--temperature", "0", "--seed", "0", "--port", "0", "--dtype",
            "bfloat16"]
    chunked = ["--prefill-chunk", str(CHUNK)]
    out = {"sample_checked": n_s, "legs": {}}
    for leg, extra in (("w", []), ("a", chunked),
                       ("b", chunked + ["--cache-dtype", "int8",
                                        "--quant-weights"])):
        eng, _, wv, _ = build_engine(build_args(base + extra))
        q8 = leg == "b"
        check(wv == version and eng.prefill_chunk == (0 if leg == "w"
                                                      else CHUNK)
              and eng.cache_dtype == torch.bfloat16 and not eng.kv_quantized
              and eng.weights_quantized == q8
              and set(eng.caches[0]) == {"c_kv", "k_r"},
              f"mla leg {leg}: weights_version {wv}, engine "
              f"{eng.cache_dtype}, quant_w {eng.weights_quantized}, chunk "
              f"{eng.prefill_chunk}, cache {sorted(eng.caches[0])}")
        dropless(eng.model)
        prompts, budgets = serve_traffic(eng.cfg.vocab_size)
        r = serve_leg(torch, eng, prompts, budgets, f"serve mla {leg}")
        check(r["launches"] == {k: 0 for k in r["launches"]},
              f"serve mla {leg}: launches {r['launches']} (MLA's decode "
              f"and prefill attend by absorption)")
        if leg != "w":
            info = [ln for ln in r["metrics"].splitlines()
                    if ln.startswith("serve_build_info{")]
            labels = [f'prefill_chunk="{CHUNK}"', 'cache_dtype="bfloat16"',
                      f'quant_weights="{q8}"']
            check(info and all(lb in info[0] for lb in labels),
                  f"mla leg {leg}: /metrics lacks {labels}: {info}")
        checked, gap = [], 0.0
        for i, (x, p) in enumerate(zip(r["res"], prompts)):
            t = x["tokens"]
            lg = mirror_logits(torch, eng.model, dev, p, t, eng._qparams,
                               cache_dtype=eng.model.dtype)
            n, g = held_near_top(torch, lg, t, lim, 0,
                                 f"serve mla {leg} stream {i}")
            checked.append(n)
            gap = max(gap, g)
        prof = profile_decode(torch, eng, prompts)
        out["legs"][leg] = dict(numbers=r["numbers"], profile=prof,
                                steps=r["steps"],
                                chunk_steps=r["chunk_steps"],
                                checked=checked, gap=gap)
        what = {"w": "bf16, wave", "a": f"bf16, prefill_chunk {CHUNK}",
                "b": f"int8 requested: bf16 latent cache + int8 weights, "
                     f"prefill_chunk {CHUNK}"}
        print(f"  mla leg {leg} ({what[leg]}): 8/8 streams on budget; "
              f"{_numbers_line(r['numbers'], prof)}; {r['steps']} steps, "
              f"{r['chunk_steps']} with a chunk; launches 0, plain calls 0; "
              f"tokens held at all {budgets} positions within {lim} of the "
              f"engine-free forward's largest logit "
              f"(largest gap {gap:.4g}), its argmax at {checked}; card "
              f"{card}", flush=True)
        del eng
        torch.cuda.empty_cache()
    run_serve_cli(torch, ["--ckpt", root, "--slots", "8", "--kv-block", "16",
                          "--temperature", "0", "--port", "0",
                          "--cache-dtype", "int8", "--quant-weights",
                          "--prefill-chunk", str(CHUNK)],
                  startup=("slots=8", "cache=native", "quant_w=True",
                           f"prefill_chunk={CHUNK}"))
    if verify is None:
        del os.environ["CKPT_VERIFY"]
    else:
        os.environ["CKPT_VERIFY"] = verify
    return out


# ---------------------------------------------------------------------------
# phase 12: the parallel recipes at world size 1 over NCCL
# ---------------------------------------------------------------------------

RECIPE_ARGV = ["--preset", "gpt2_124m", "--attn_impl", "pallas",
               "--loss_impl", "pallas", "--compute_dtype", "bfloat16",
               "--dataset", "synthetic", "--batch_size", "8",
               "--total_batch_size_str", "2**14", "--max_iters", "5",
               "--warmup_steps", "5", "--learning_rate", "1e-3",
               "--no-save_stats", "--file_name", "chip_smoke_recipes",
               "--seed", "0"]
RECIPES = ("single", "dp", "zero1", "zero2", "fsdp", "tp", "fsdp_tp", "sp",
           "fsdp_sp1", "pp")
#: the trainer flags of a phase 12 leg that is not a recipe's name alone
RECIPE_FLAGS = {"fsdp_sp1": ["--parallelism", "fsdp", "--sp_size", "1"]}
#: the legs held bit for bit to single (a 'seq' axis of one rank)
RECIPES_EXACT = ("sp", "fsdp_sp1")
# every recipe's loss against single's at each iteration: one card runs
# the same arithmetic under every recipe, but for the collectives of one
# rank and the zero / fsdp update's order of operations
RECIPE_RTOL = 1e-3
# tp and fsdp_tp at world 1 (a 'model' axis of one rank, the 'data' axis
# of one) against single
TP_RTOL = 1e-5
MOE_RECIPE_ARGV = MOE_ARGV + ["--parallelism", "fsdp", "--max_iters", "3",
                              "--ckpt_interval", "0", "--no-save_stats",
                              "--file_name", "chip_smoke_moe_fsdp"]
#: phase 9's MoE under single and the recipes of an 'expert' axis of one
#: rank: `ep` and fsdp --ep_size 1, held bit for bit to single
MOE_RECIPE_FLAGS = {
    "fsdp": [],
    "single": ["--parallelism", "single", "--file_name",
               "chip_smoke_moe_single"],
    "ep": ["--parallelism", "ep", "--ep_size", "1", "--file_name",
           "chip_smoke_moe_ep"],
    "fsdp_ep1": ["--parallelism", "fsdp", "--ep_size", "1", "--file_name",
                 "chip_smoke_moe_fsdp_ep1"]}
#: the leg that writes and verifies its final checkpoint (3.5 GB of
#: weights and moments a save)
MOE_RECIPE_SAVES = "fsdp"
MOE_RECIPES_EXACT = ("ep", "fsdp_ep1")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_one_rank(model_cfg, train_cfg):
    """train() with torchrun's environment set for a world of one rank
    (restored afterwards)."""
    from distributed_pytorch_tpu_torch.train.loop import train

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return train(model_cfg, train_cfg,
                     log=lambda line: print(f"  {line}", flush=True))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_recipe(torch, tmp: str, recipe: str, card: str) -> dict:
    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv

    model_cfg, train_cfg = parse_train_argv(
        RECIPE_ARGV + RECIPE_FLAGS.get(recipe, ["--parallelism", recipe])
        + ["--data_dir", os.path.join(tmp, "data")])
    L = model_cfg.n_layer
    micro = train_cfg.total_batch_size // (
        train_cfg.batch_size * model_cfg.block_size) * (
        train_cfg.max_iters + 1)
    reset_counts()
    stats = train_one_rank(model_cfg, train_cfg)
    launches = _counted(
        {"fused_ce_fwd": micro, "fused_ce_bwd_dx": micro,
         "fused_ce_bwd_dw": micro, "flash_attn_fwd": L * micro,
         "flash_attn_bwd_dq": L * micro, "flash_attn_bwd_dkv": L * micro},
        f"train under {recipe}")
    want = ("none", 1, 1, 1) if recipe == "single" else ("nccl", 1, 1, 1)
    check((stats["backend"], stats["world"], stats["tp"], stats["sp"])
          == want and stats["recipe"] == train_cfg.parallelism,
          f"{recipe}: ran as {stats['recipe']} over {stats['backend']}, "
          f"world {stats['world']}, tp {stats['tp']}, sp {stats['sp']}")
    losses = stats["train_losses"]
    check(len(losses) == train_cfg.max_iters + 1
          and all(np.isfinite(losses)), f"{recipe}: losses {losses}")
    out = dict(losses=losses, launches=launches,
               step_ms=stats["median_step_time"] * 1e3,
               tok_s=stats["median_tokens_per_sec"],
               mfu=stats["median_mfu"], peak_gb=stats["peak_mem_gb"])
    print(f"  {recipe}: world 1 over {stats['backend']}; step ms p50 "
          f"{out['step_ms']:.3f}, tok/s {out['tok_s']:.1f}, MFU "
          f"{out['mfu']:.4f}, peak memory {out['peak_gb']:.3f} GB; losses "
          f"{[round(x, 6) for x in losses]}; card {card}", flush=True)
    del stats
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_recipe_cli(tmp: str) -> None:
    """fsdp through torch.distributed.run, one process on the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1", "-m", "distributed_pytorch_tpu_torch"] \
        + RECIPE_ARGV + ["--parallelism", "fsdp", "--max_iters", "2",
                         "--data_dir", os.path.join(tmp, "data")]
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=tmp, env=env, capture_output=True,
                       text=True, timeout=400)
    out = r.stdout + r.stderr
    check(r.returncode == 0,
          f"torch.distributed.run fsdp exited {r.returncode}: {out[-3000:]}")
    check("recipe=fsdp world=1 backend=nccl" in r.stdout
          and "device cuda:0" in r.stdout,
          f"torch.distributed.run fsdp: no recipe line: {r.stdout[-2000:]}")
    iters = [line for line in r.stdout.splitlines()
             if line.startswith("iter ") and "| loss" in line]
    check(len(iters) == 3, f"torch.distributed.run fsdp: {iters}")
    head = next(line for line in r.stdout.splitlines()
                if "recipe=fsdp" in line)
    print(f"  torch.distributed.run --nproc_per_node 1 ... --parallelism "
          f"fsdp: exit 0 in {time.perf_counter() - t0:.1f} s; {head}; "
          f"{iters[-1]}", flush=True)


def run_recipe_moe(torch, tmp: str, card: str, leg: str = "fsdp") -> dict:
    import dataclasses

    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.train import checkpoint as ckpt

    model_cfg, train_cfg = parse_train_argv(
        MOE_RECIPE_ARGV + MOE_RECIPE_FLAGS[leg]
        + ["--data_dir", os.path.join(tmp, "data")])
    train_cfg = dataclasses.replace(train_cfg,
                                    save_model=leg == MOE_RECIPE_SAVES)
    L = model_cfg.n_layer
    micro = train_cfg.total_batch_size // (
        train_cfg.batch_size * model_cfg.block_size) * (
        train_cfg.max_iters + 1)
    reset_counts()
    t0 = time.perf_counter()
    stats = train_one_rank(model_cfg, train_cfg)
    launches = _counted(
        {"grouped_mm_fwd": 3 * L * micro, "grouped_mm_bwd_dx": 2 * L * micro,
         "grouped_mm_bwd_dw": 2 * L * micro, "flash_attn_fwd": L * micro,
         "flash_attn_bwd_dq": L * micro, "flash_attn_bwd_dkv": L * micro},
        f"train the MoE under {leg}")
    want = ("none" if leg == "single" else "nccl", 1, 1, 1)
    check((stats["backend"], stats["world"], stats["ep"], stats["tp"])
          == want and stats["recipe"] == train_cfg.parallelism
          and stats["moe_degraded_dense"] == 0,
          f"moe {leg}: ran as {stats['recipe']} over {stats['backend']}, "
          f"world {stats['world']}, ep {stats['ep']}, degraded "
          f"{stats['moe_degraded_dense']}")
    losses = stats["train_losses"]
    check(len(losses) == train_cfg.max_iters + 1
          and all(np.isfinite(losses)), f"moe {leg}: losses {losses}")
    bias = torch.stack([m.expert_bias for m in
                        stats["state"].model.moe_layers()])
    check(bool(torch.isfinite(bias).all()) and float(bias.abs().max()) > 0,
          f"moe {leg}: expert_bias {bias.tolist()}")
    saved = ""
    if train_cfg.save_model:
        step_dir = os.path.join("checkpoints", train_cfg.file_name,
                                f"step_{train_cfg.max_iters + 1}")
        check(ckpt.verify_manifest(step_dir) == [],
              f"moe {leg}: checkpoint {step_dir} does not verify")
        saved = f"checkpoint {step_dir} verified; "
    out = dict(launches={k: launches[k] for k in GMM_SOURCE},
               losses=losses, bias_absmax=float(bias.abs().max()),
               step_ms=stats["median_step_time"] * 1e3,
               peak_gb=stats["peak_mem_gb"])
    print(f"  MoE under {leg}: losses {[round(x, 4) for x in losses]}; "
          f"expert_bias |max| {out['bias_absmax']:.4f}; step ms p50 "
          f"{out['step_ms']:.3f}, peak memory {out['peak_gb']:.3f} GB; "
          f"{saved}launches {out['launches']}, plain calls 0; leg "
          f"{time.perf_counter() - t0:.1f} s; card {card}", flush=True)
    del stats, bias
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_recipes(torch, card: str) -> dict:
    cwd = os.getcwd()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for recipe in RECIPES:
                runs[recipe] = run_recipe(torch, tmp, recipe, card)
            base = np.asarray(runs["single"]["losses"])
            for recipe in RECIPES[1:]:
                got = np.asarray(runs[recipe]["losses"])
                rel = float(np.max(np.abs(got - base) / np.abs(base)))
                tol = 0.0 if recipe in RECIPES_EXACT else TP_RTOL \
                    if recipe in ("tp", "fsdp_tp") else RECIPE_RTOL
                check(rel <= tol,
                      f"{recipe}: losses {got.tolist()} differ from "
                      f"single's {base.tolist()} by {rel:.3e} relative")
                print(f"  {recipe} vs single: max relative loss difference "
                      f"{rel:.3e} (tol {tol:.0e}); bit-equal "
                      f"{bool((got == base).all())}", flush=True)
            run_recipe_cli(tmp)
            for leg in MOE_RECIPE_FLAGS:
                runs[f"moe_{leg}"] = run_recipe_moe(torch, tmp, card, leg)
            base = runs["moe_single"]["losses"]
            for leg in MOE_RECIPES_EXACT:
                got = runs[f"moe_{leg}"]["losses"]
                check(got == base, f"moe {leg}: losses {got} are not "
                      f"single's {base} bit for bit")
                print(f"  MoE {leg} vs single: losses bit-equal", flush=True)
        finally:
            os.chdir(cwd)
    runs["hops"] = run_ring_hops(torch, card)
    runs["expert_cut"] = run_expert_cut(torch, card)
    return runs


#: the one-process expert cut: |sum of the slices - whole| <= atol x the
#: whole's largest magnitude. Every packed row's products are the whole
#: dispatch's bit for bit (the same row against the same expert), so dW and
#: the gates' gradient sum the same terms in the same order; the output
#: and dx sum a token's n_shared + k rows in bf16, in one sum on the whole
#: and in a sum a slice then an fp32 sum over the slices: two bf16
#: roundings of partial sums of up to three rows on each side, each half
#: an ulp (2^-9) of a partial at most 3 x the largest row
EXPERT_CUT_ATOL = 2 ** -6
EXPERT_CUT_EP = (2, 4)


def run_expert_cut(torch, card: str) -> dict:
    """Phase 9's MoE layer's grouped dispatch at its training shape (B 8 x
    T 1024, bf16, seeded weights and tokens, the router's top-k) whole and
    cut into EXPERT_CUT_EP expert slices in one process: each slice's
    local dispatch (ops/grouped_matmul.py, `ep` = (rank, ep)) forward and
    backward on the three grouped kernels (launches exact, no plain call);
    the slices' outputs, input and gate gradients summed, and each slice's
    dW, held to the whole's (EXPERT_CUT_ATOL). A slice whose experts get
    no row (routing restricted to the other slices' experts) launches and
    gives zeros. Returns {(kernel, 'ep<ep>'): launches a slice}."""
    import functools

    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.models.mlp import activate
    from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm

    cfg, _ = parse_train_argv(MOE_ARGV)
    dev, bf16 = torch.device(DEVICE), torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    N, C, up = 8 * cfg.block_size, cfg.n_embd, cfg.up_dim
    E, n_sh, k = cfg.n_exp, cfg.n_shared, cfg.n_act_routed
    fc_out = 2 * up if cfg.non_linearity.lower() in ("swiglu", "glu") \
        else up

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(bf16)

    x, dy = rnd(N, C), rnd(N, C)
    fc, proj = rnd(E, C, fc_out, scale=0.02), rnd(E, up, C, scale=0.02)
    gate = 0.02 * torch.randn(C, E - n_sh, generator=g, device=dev)
    act = functools.partial(activate, non_linearity=cfg.non_linearity)

    def route(logits):
        vals, idx = logits.topk(k, dim=1)
        return idx, torch.softmax(vals, dim=1)

    def dispatch(idx, gts, rank, ep, what):
        n = E // ep
        xs, gs = x.clone().requires_grad_(), gts.clone().requires_grad_()
        a = fc[rank * n:(rank + 1) * n].clone().requires_grad_()
        b = proj[rank * n:(rank + 1) * n].clone().requires_grad_()
        reset_counts()
        y = gm.grouped_dispatch(xs, idx, gs, a, b, act=act, n_shared=n_sh,
                                ep=(rank, ep))
        y.backward(dy)
        torch.cuda.synchronize()
        launches = _counted({"grouped_mm_fwd": 3, "grouped_mm_bwd_dx": 2,
                             "grouped_mm_bwd_dw": 2}, what)
        return dict(y=y.detach(), dx=xs.grad, dg=gs.grad, dfc=a.grad,
                    dproj=b.grad, launches=launches)

    def limit(name, got, want, what):
        d = (got.float() - want.float()).abs().max().item()
        mag = want.float().abs().max().item()
        check(d <= EXPERT_CUT_ATOL * mag,
              f"expert cut {what}: {name} differs by {d:.3e} (limit "
              f"{EXPERT_CUT_ATOL * mag:.3e})")
        return d

    idx, gts = route(x.float() @ gate)
    whole = dispatch(idx, gts, 0, 1, "whole dispatch")
    out = {}
    for ep in EXPERT_CUT_EP:
        n = E // ep
        parts = [dispatch(idx, gts, r, ep, f"ep {ep} slice {r}")
                 for r in range(ep)]
        errs, exact = {}, True
        for name in ("y", "dx", "dg"):
            got = sum(p[name].float() for p in parts)
            errs[name] = limit(name, got, whole[name], f"ep {ep}")
        for name in ("dfc", "dproj"):
            for r, p in enumerate(parts):
                want = whole[name][r * n:(r + 1) * n]
                errs[name] = max(errs.get(name, 0.0), limit(
                    name, p[name], want, f"ep {ep} slice {r}"))
                exact &= torch.equal(p[name], want)
        rows = [int((idx + n_sh >= r * n).logical_and(
            idx + n_sh < (r + 1) * n).sum()) + N * max(
            0, min(n_sh, (r + 1) * n) - r * n) for r in range(ep)]
        for kname in GMM_SOURCE:
            out[(kname, f"ep{ep}")] = parts[0]["launches"][kname]
        print(f"  expert cut, ep {ep} (bf16, {N} tokens, {E} experts, "
              f"{n} a slice; rows a slice {rows}): sum of the slices vs "
              f"the whole, max |diff| " + ", ".join(
                  f"{nm} {e:.3e}" for nm, e in errs.items())
              + f" (limit {EXPERT_CUT_ATOL:.4g} x the whole's largest); "
              f"dW bit-equal {exact}; launches a slice "
              f"{ {k: parts[0]['launches'][k] for k in GMM_SOURCE} }; "
              f"card {card}", flush=True)
        del parts
    # the last slice of 4 holds routed ids E - n_sh - 2 .. : route to the
    # others only
    ep = EXPERT_CUT_EP[-1]
    n_other = E - n_sh - E // ep
    idx, gts = route((x.float() @ gate)[:, :n_other])
    empty = dispatch(idx, gts, ep - 1, ep, "empty slice")
    check(all(not t.any() for t in (empty["y"], empty["dx"], empty["dg"],
                                    empty["dfc"], empty["dproj"])),
          "expert cut: a slice with no rows gave nonzero output or "
          "gradients")
    print(f"  expert cut, an empty slice (ep {ep}, slice {ep - 1}, no "
          f"row): launches "
          f"{ {k: empty['launches'][k] for k in GMM_SOURCE} }, zero "
          f"output and "
          f"gradients; card {card}", flush=True)
    del whole, empty
    torch.cuda.empty_cache()
    return out


#: the one-process ring check: (head size, B, T, heads, kv heads) of the
#: flagship's and the default config's attention, cut over RING_SP ranks
RING_HOPS = ((64, 2, 2048, 12, 12), (32, 2, 2048, 8, 4))
RING_SP = 4


def run_ring_hops(torch, card: str) -> dict:
    """Ring attention's hops and merge on the card in one process: RING_SP
    chunks of one sequence (contiguous and zig-zag) through
    `ring_attention.ring_fwd` / `ring_bwd` over a `LocalRing` (a list
    rotation in place of the permute), bf16, causal, at dropout 0 and
    0.2: out, dq, dk and dv held against the plain versions of one whole
    flash call under FLASH_TOL's bf16 limit with its atol times RING_SP:
    each hop's out, dq, dk and dv leave the kernels rounded to bf16 and a
    row sums up to RING_SP of them, where the whole call rounds once.
    Returns {(kernel, D): max_abs_err}."""
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa
    from distributed_pytorch_tpu_torch.ops import ring_attention as ra

    dev = torch.device(DEVICE)
    res = {}
    atol, rtol = FLASH_TOL["bfloat16"]
    atol *= RING_SP
    for D, B, T, nh, nkv in RING_HOPS:
        g = torch.Generator(device=dev)
        g.manual_seed(6)

        def rnd(n):
            return torch.randn(B, T, n, D, generator=g,
                               device=dev).to(torch.bfloat16)

        q, k, v, dout = rnd(nh), rnd(nkv), rnd(nkv), rnd(nh)
        seed = torch.tensor([31, -7], dtype=torch.int32, device=dev)
        for rate in (0.0, 0.2):
            kw = dict(scale=D ** -0.5, causal=True, dropout_rate=rate)
            out, lse = fa.flash_attn_fwd_plain(q, k, v, seed, **kw)
            delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
            bw = (q, k, v, dout, lse, delta, seed)
            want = {"flash_attn_fwd": out,
                    "flash_attn_bwd_dq": fa.flash_attn_bwd_dq_plain(*bw, **kw)}
            want["dk"], want["dv"] = fa.flash_attn_bwd_dkv_plain(*bw, **kw)
            for layout in ("contiguous", "zigzag"):
                cols = [torch.as_tensor(ra.local_positions(
                    T, RING_SP, r, layout), device=dev)
                    for r in range(RING_SP)]
                kvs = [torch.stack([k[:, c], v[:, c]]) for c in cols]
                accs, got = {}, {}
                hk = dict(scale=D ** -0.5, layout=layout, rate=rate,
                          seed=seed)
                for r, c in enumerate(cols):
                    o, l_ = ra.ring_fwd(q[:, c], kvs[r],
                                        ra.LocalRing(kvs, r, accs), **hk)
                    got.setdefault("flash_attn_fwd", []).append((c, o))
                    got.setdefault("flash_attn_bwd_dq", []).append(
                        (c, ra.ring_bwd(q[:, c], kvs[r], o, l_,
                                        dout[:, c].contiguous(),
                                        ra.LocalRing(kvs, r, accs), **hk)))
                got["dk"] = [(c, accs[r][0]) for r, c in enumerate(cols)]
                got["dv"] = [(c, accs[r][1]) for r, c in enumerate(cols)]
                torch.cuda.synchronize()
                errs = {}
                for name, parts in got.items():
                    for c, a in parts:
                        e = _elementwise(a, want[name][:, c], atol, rtol)
                        check(e["frac"] <= 1.0,
                              f"ring hops D {D} {layout} rate {rate}: "
                              f"{name} beyond its limit ({e['frac']:.3f})")
                        errs[name] = max(errs.get(name, 0.0), e["err"])
                kn = {"dk": "flash_attn_bwd_dkv", "dv": "flash_attn_bwd_dkv"}
                for name, e in errs.items():
                    key = (kn.get(name, name), D)
                    res[key] = max(res.get(key, 0.0), e)
                print(f"  ring hops, sp {RING_SP}, {layout}, D {D} ({nh} / "
                      f"{nkv} heads, B {B}, T {T}), bf16, causal, dropout "
                      f"{rate}: against one whole call's plain version "
                      f"max_abs_err " + ", ".join(
                          f"{n} {e:.3e}" for n, e in errs.items())
                      + f"; card {card}", flush=True)
            del want, out, lse, delta
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 11: the default config and the flagship with MLA (head sizes 32, 80)
# ---------------------------------------------------------------------------

# phase 6's batch, optimizer and data flags, with the trainer's default
# attention route ('auto', which sends every uncached T > 1 call on the
# card to the flash kernels)
SMALL_D_FLAGS = ["--compute_dtype", "bfloat16", "--dataset", "synthetic",
                 "--batch_size", "8", "--total_batch_size_str", "2**14",
                 "--max_iters", "19", "--warmup_steps", "5",
                 "--learning_rate", "1e-3", "--seed", "0"]
# (a) the default LLMConfig as the CLI builds it with no preset: 6 x 256,
# GQA 8 / 4 heads of 32, swiglu 384, vocab 50304, block 1024; a final
# checkpoint, which is sampled and served
DEFAULT_ARGV = SMALL_D_FLAGS + ["--save_model", "--file_name",
                                "chip_smoke_default"]
# (b) the flagship with `--attn mla` and the CLI's latents (32 / 32, rope
# 16): FullMLA's q_c | q_r at 12 heads of 64 + 16 = 80, MHA
FLAGSHIP_MLA_ARGV = (["--preset", "gpt2_124m", "--attn", "mla"]
                     + SMALL_D_FLAGS + ["--file_name",
                                        "chip_smoke_flagship_mla"])
#: the flash head size each phase 11 run trains at
SMALL_D = {"default": 32, "flagship_mla": 80}


def flash_head_size(cfg) -> int:
    """The head size of the flash kernels' q, k, v in a model of `cfg`:
    FullMLA (RoPE) concatenates its rotary features to each head."""
    if cfg.attn == "mla" and cfg.pos_emb == "rope":
        return cfg.head_size + cfg.rope_head_dim
    return cfg.head_size


def run_train_small(torch, dev, card: str, argv: list, what: str,
                    tmp: str) -> dict:
    """The trainer's own train() on `argv` in `tmp`, at full width: the
    loss finite and falling by TRAIN_DROP, the flash kernels launched
    exactly (forward, dq and dkv once a layer a micro-step) at head size
    SMALL_D[what], no plain call; then profiled (`profile_train`: two
    steady steps, flash ms a step per kernel). Returns the launches and
    the run's numbers."""
    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa
    from distributed_pytorch_tpu_torch.train.loop import train

    model_cfg, train_cfg = parse_train_argv(
        argv + ["--data_dir", os.path.join(tmp, "data")])
    d = flash_head_size(model_cfg)
    check(d == SMALL_D[what] and train_cfg.attn_impl == "auto"
          and not model_cfg.act_recomp,
          f"train {what}: head size {d}, attn_impl {train_cfg.attn_impl}")
    accum = train_cfg.total_batch_size // (
        train_cfg.batch_size * model_cfg.block_size)
    iters = train_cfg.max_iters + 1
    reset_counts()
    stats = train(model_cfg, train_cfg,
                  log=lambda line: print(f"  {line}", flush=True))
    launches = _counted(flash_launches(model_cfg, accum * iters),
                        f"train {what}")
    losses = stats["train_losses"]
    check(len(losses) == iters and all(np.isfinite(losses)),
          f"train {what}: losses {losses}")
    last = float(np.mean(losses[-3:]))
    check(last <= losses[0] - TRAIN_DROP,
          f"train {what}: loss fell from {losses[0]:.4f} to {last:.4f}, "
          f"less than {TRAIN_DROP}")
    dtype = getattr(torch, train_cfg.compute_dtype)
    out = dict(launches={k: launches[k] for k in FLASH_SOURCE}, head_size=d,
               width={k: fa.padded_width(d, k, dtype) for k in FLASH_SOURCE},
               loss0=losses[0], loss_last3=last,
               step_ms=stats["median_step_time"] * 1e3,
               tok_s=stats["median_tokens_per_sec"],
               mfu=stats["median_mfu"], peak_gb=stats["peak_mem_gb"])
    out["split"] = profile_train(torch, stats["state"], train_cfg,
                                 model_cfg)
    # each kernel ran the instance built at its width for this head size
    names = out["split"]["flash_kernels"]
    for kname, w in out["width"].items():
        inst = f"_kernel_sm90<{w}, {'false' if d == w else 'true'}>"
        mine = [k for k in names if flash_kernel_of("::" + k) == kname]
        check(mine and all(inst in k for k in mine),
              f"train {what}: {kname} ran {mine}, not *{inst}")
    print(f"  {what}: flash fwd {out['split']['flash_attn_fwd']:.3f} ms, dq "
          f"{out['split']['flash_attn_bwd_dq']:.3f} ms, dkv "
          f"{out['split']['flash_attn_bwd_dkv']:.3f} ms a step (device, "
          f"at widths {out['width']}: {names}); step p50 "
          f"{stats['median_step_time'] * 1e3:.3f} ms", flush=True)
    print(f"  {what}: {model_cfg.n_layer} x {model_cfg.n_embd}, "
          f"{model_cfg.attn} {model_cfg.n_head} / {model_cfg.n_kv_heads} "
          f"heads, flash head size {d} (run at width {out['width']}); "
          f"{iters} iterations x {accum} micro-steps of "
          f"{train_cfg.batch_size} x {model_cfg.block_size}: loss "
          f"{losses[0]:.4f} -> {last:.4f} (mean of the last 3; drop >= "
          f"{TRAIN_DROP}); step ms p50 {out['step_ms']:.3f}, tok/s "
          f"{out['tok_s']:.1f}, MFU {out['mfu']:.4f}, peak memory "
          f"{out['peak_gb']:.3f} GB; launches {out['launches']}, plain "
          f"calls 0; card {card}", flush=True)
    del stats
    torch.cuda.empty_cache()
    return out


def run_serve_default(torch, dev, card: str, root: str) -> dict:
    """Phase 11 (a)'s checkpoint through `sample.main` (greedy; its prompt
    pass is `flash_attn_fwd` at head size 32) and `serve --ckpt`'s engine
    with phase 5's traffic in bf16 and fp32 (the paged decode and prefill
    at head size 32): every stream on its budget, exact launches, no plain
    call, tokens held at every position within LOGIT_TOL of the uncached
    naive forward's largest logit (NEAR_TOP, as in phase 9: a checkpoint
    20 steps into training has near-ties along whole streams); the bf16
    engine's prefill kernel read by `prefill_route`."""
    from distributed_pytorch_tpu_torch import sample
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)
    from distributed_pytorch_tpu_torch.train import checkpoint as ckpt

    step_dir = ckpt.latest_step_dir(root)
    version = ckpt.weights_version(step_dir)
    L = ckpt.load_configs(step_dir)[0].n_layer
    prompt = [int(t) for t in np.random.default_rng(17).integers(0, 50304, 9)]
    n_new = 16
    reset_counts()
    outs = sample.main(["--ckpt", root, "--prompt",
                        ",".join(map(str, prompt)), "--temperature", "0",
                        "--max_new_tokens", str(n_new)])
    check(len(outs) == 1 and len(outs[0]) == len(prompt) + n_new
          and outs[0][:len(prompt)] == prompt, f"sample default: {outs}")
    s_launch = _counted({"paged_decode_attn": L * (n_new - 1),
                         "flash_attn_fwd": L}, "sample default")
    s_model = sample.load_for_inference(root)[0]
    lg = uncached_logits(torch, s_model, dev, prompt, outs[0][len(prompt):])
    n_s, gap_s = held_near_top(torch, lg, outs[0][len(prompt):],
                               LOGIT_TOL["bfloat16"], 0, "sample default")
    del s_model
    print(f"  checkpoint {step_dir} [{version}]: sample.main greedy "
          f"{outs[0][len(prompt):]} (held at all {n_new} positions within "
          f"{LOGIT_TOL['bfloat16']} of the naive forward's largest logit "
          f"(largest gap {gap_s:.4g}), its argmax at {n_s}); launches "
          f"{s_launch['flash_attn_fwd']} flash_attn_fwd (head size 32), "
          f"{s_launch['paged_decode_attn']} paged_decode_attn; card {card}",
          flush=True)
    out = {"sample_launches": s_launch, "legs": {}}
    for dn in ("bfloat16", "float32"):
        eng, _, wv, _ = build_engine(build_args(
            ["--ckpt", root, "--slots", "8", "--kv-block", "16",
             "--temperature", "0", "--port", "0", "--dtype", dn]))
        check(wv == version and version and eng.cfg.head_size == 32,
              f"serve default: weights_version {wv}, head size "
              f"{eng.cfg.head_size}")
        prompts, budgets = serve_traffic(eng.cfg.vocab_size)
        r = serve_leg(torch, eng, prompts, budgets, f"serve default {dn}")
        launches, steps, admits = r["launches"], r["steps"], r["admits"]
        want = {"paged_decode_attn": L * steps,
                "paged_prefill_attn": L * admits}
        check(launches == {k: want.get(k, 0) for k in launches},
              f"serve default {dn}: launches {launches} for {steps} steps, "
              f"{admits} admissions x {L} layers")
        checked, gap = [], 0.0
        for i, (x, p, b) in enumerate(zip(r["res"], prompts, budgets)):
            lg = uncached_logits(torch, eng.model, dev, p, x["tokens"])
            least = int(MIN_CHECKED[dn] * b) if dn == "float32" else 0
            n, g = held_near_top(torch, lg, x["tokens"], LOGIT_TOL[dn],
                                 least, f"serve default {dn} stream {i}")
            checked.append(n)
            gap = max(gap, g)
        out["legs"][dn] = dict(launches=launches, steps=steps,
                               admits=admits, checked=checked, gap=gap,
                               numbers=r["numbers"])
        if dn == "bfloat16":
            out["legs"][dn]["route"] = prefill_route(torch, eng, L, card)
        n = r["numbers"]
        print(f"  serve --ckpt {dn} (wave, 8 streams, head size 32): "
              f"{n['tokens']} tokens in {n['wall_s']:.3f} s = "
              f"{n['tok_s']:.1f} tok/s; tokens held to the naive forward at "
              f"all {budgets} positions within {LOGIT_TOL[dn]} of its "
              f"largest logit (largest gap {gap:.4g}), its argmax at "
              f"{checked}; {steps} steps, {admits} admissions; launches "
              f"{launches}; card {card}", flush=True)
        del eng
        torch.cuda.empty_cache()
    return out


def prefill_route(torch, eng, L: int, card: str) -> dict:
    """Two fresh prompts (no prefix hit) through the bf16 engine `eng`
    of phase 11 (a), under torch.profiler (device events only): every
    paged prefill its admissions launch must be the wgmma kernel built
    at head size 32 (`prefill_kernel_sm90<32>`, with `prefill_combine<32>`
    where its key tiles split), layers x admissions of them by the
    counters. Returns the kernel names, the profiled launches and the
    prefill's device ms a launch (both kernels of a split one)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, eng.cfg.vocab_size, n).tolist()
               for n in (300, 520)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = serve_leg(torch, eng, prompts, [4, 4], "prefill route")
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "prefill_kernel" in e.key]
    merge = [e for e in prof.key_averages() if "prefill_combine" in e.key]
    names = sorted({kernel_name(e.key) for e in ev + merge})
    n = sum(e.count for e in ev)
    want = L * r["admits"]
    check(r["launches"]["paged_prefill_attn"] == want and 0 < n <= want
          and all("prefill_kernel_sm90<32>" in k
                  or "prefill_combine<32>" in k for k in names),
          f"prefill route: {names} x {n} in the profile, counters "
          f"{r['launches']}, {r['admits']} admissions x {L} layers")
    ms = sum(_dev_us(e) for e in ev + merge) / n / 1e3
    print(f"  serve --ckpt bfloat16, two fresh prompts (300, 520 tokens): "
          f"the paged prefill ran {names} ({n} launches profiled, "
          f"{sum(e.count for e in merge)} of them split, {want} counted), "
          f"{ms:.4f} ms of device time a launch; card {card}", flush=True)
    return dict(kernels=names, launches=want, device_ms=ms)


def run_small_head_sizes(torch, dev, card: str) -> dict:
    """Phase 11: (a) the default config trained, its parity step, then
    sampled and served; (b) the flagship with MLA trained and its parity
    step. Each in a temp dir of its own."""
    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    cwd = os.getcwd()
    out = {}
    for what, argv in (("default", DEFAULT_ARGV),
                       ("flagship_mla", FLAGSHIP_MLA_ARGV)):
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                out[what] = run_train_small(torch, dev, card, argv, what,
                                            tmp)
                run_parity(torch, dev, parse_train_argv(argv)[0],
                           f"parity {what}")
                if what == "default":
                    out[what]["serve"] = run_serve_default(
                        torch, dev, card, os.path.join(
                            tmp, "checkpoints", "chip_smoke_default"))
            finally:
                os.chdir(cwd)
    return out


T0 = time.perf_counter()


# ---------------------------------------------------------------------------
# phase 12 (5): pipeline stages on one card
# ---------------------------------------------------------------------------

#: the flagship at full width with phase 7's flags (RECIPE_ARGV) and phase
#: 9's MoE, through the pipeline executor: S stages in this process over
#: the in-process transport, M microbatches of one row a micro-step, on
#: the synthetic dataset's batches (which the model learns, so that a
#: wrong gradient or update moves the loss), weight decay 0 (the stages
#: decay every block parameter, as the reference's rank rule does on its
#: stacked blocks, and single does not)
PP_STAGES = 4
PP_MICRO = 8
PP_ITERS = 4
PP_FLAGS = ["--weight_decay", "0"]
PP_LEGS = {
    "1f1b_vpp3": (RECIPE_ARGV, ["--pp_schedule", "1f1b", "--pp_vpp", "3"],
                  "1f1b"),
    "carry": (RECIPE_ARGV, ["--pp_schedule", "carry"], "carry"),
    "moe_carry": (MOE_ARGV, ["--pp_schedule", "carry"], "carry"),
}
#: the gradient norm (before clipping) against single's, (at step 0, at
#: every step): the dense legs' gaps measured on an H100 were 6.6e-6 and
#: 2.2e-4 (bf16 activations, rounding that drifts with the updates); the
#: MoE's 1.4e-4 and 2.6e-3, since its routing statistics are a
#: microbatch's and its bias moves once a (layer, microbatch), so it is
#: not single's arithmetic even at step 0
PP_NORM_RTOL = {"dense": (1e-4, 1e-3), "moe": (1e-3, 1e-2)}
#: single's loss must fall over the PP_ITERS steps by this many times the
#: loss limit, so that the loss check can see a wrong update
PP_LEARNS = 10
#: the flash kernels at a pipeline microbatch's shape (b 1 x T 1024 x 12
#: heads of 64), bf16, beside phase 3's B 8
PP_FLASH_B1 = (1, 1024, 12, 12, 64)


def _pp_batches(torch, dev, model_cfg, train_cfg, accum: int, B: int):
    """PP_ITERS steps' (x, y), each (accum, B, T), of the synthetic
    dataset's loader."""
    from distributed_pytorch_tpu_torch.data.loader import DataLoader
    from distributed_pytorch_tpu_torch.train.loop import data_paths

    loader = DataLoader(data_paths(train_cfg, model_cfg.vocab_size)[0], B,
                        model_cfg.block_size, grad_accum=accum,
                        seed=train_cfg.seed, device=dev)
    return [loader.next_batch(step=i) for i in range(PP_ITERS)]


def _pp_run(torch, step, state, batches) -> tuple[list, list, list]:
    """(losses, gradient norms, step ms) of `state` (a TrainState or an
    in-process pipeline's list of them) over `batches`."""
    losses, norms, times = [], [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, x, y)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, norms, times


def run_pipeline_leg(torch, dev, card: str, tmp: str, leg: str) -> dict:
    """One leg of phase 12 (5): the single model, then its S in-process
    stages (train/state.py `create_pipeline_states`) from the same seeded
    init, PP_ITERS steps each on the same batches of the synthetic
    dataset under `tmp`. Holds each step's loss to single's within
    RECIPE_RTOL and its gradient norm within PP_NORM_RTOL (single's loss
    falling by PP_LEARNS times the loss limit), the kernels' launches to
    the counts the schedule implies, and the tied embedding's two copies
    (and their moments) to each other bit for bit."""
    import dataclasses

    from distributed_pytorch_tpu_torch.__main__ import parse_train_argv
    from distributed_pytorch_tpu_torch.models import pipeline as pipe_mod
    from distributed_pytorch_tpu_torch.train.state import (
        create_pipeline_states, create_train_state)
    from distributed_pytorch_tpu_torch.train.step import make_train_step

    base, flags, want_sched = PP_LEGS[leg]
    model_cfg, train_cfg = parse_train_argv(
        base + flags + PP_FLAGS + [
            "--pp_stages", str(PP_STAGES), "--pp_microbatches",
            str(PP_MICRO), "--data_dir", os.path.join(tmp, "data")])
    L, B, T = model_cfg.n_layer, train_cfg.batch_size, model_cfg.block_size
    accum = train_cfg.total_batch_size // (B * T)
    step = make_train_step(train_cfg)
    batches = _pp_batches(torch, dev, model_cfg, train_cfg, accum, B)
    single = create_train_state(dataclasses.replace(model_cfg, pp_stages=1),
                                train_cfg, dev)
    base_losses, base_norms, _ = _pp_run(torch, step, single, batches)
    del single
    gc.collect()
    torch.cuda.empty_cache()

    states = create_pipeline_states(model_cfg, train_cfg, dev)
    sched = pipe_mod.resolve_schedule(model_cfg)
    vpp = pipe_mod.chunk_vpp(model_cfg)
    check(sched == want_sched, f"pipeline {leg}: schedule {sched}")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, norms, times = _pp_run(torch, step, states, batches)
    n = L * PP_MICRO * accum * PP_ITERS       # (layer, microbatch) passes
    want = {"flash_attn_fwd": n, "flash_attn_bwd_dq": n,
            "flash_attn_bwd_dkv": n}
    if model_cfg.moe:
        want.update(grouped_mm_fwd=3 * n, grouped_mm_bwd_dx=2 * n,
                    grouped_mm_bwd_dw=2 * n)
    else:
        c = accum * PP_ITERS                  # one loss call a micro-step
        want.update(fused_ce_fwd=c, fused_ce_bwd_dx=c, fused_ce_bwd_dw=c)
    launches = _counted(want, f"pipeline {leg}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    rel = float(np.max(np.abs(np.asarray(losses) - base_losses)
                       / np.abs(base_losses)))
    norm_rels = np.abs(np.asarray(norms) - base_norms) / np.abs(base_norms)
    norm_rel = float(np.max(norm_rels))
    lim0, lim = PP_NORM_RTOL["moe" if model_cfg.moe else "dense"]
    fall = base_losses[0] - base_losses[-1]
    check(fall > PP_LEARNS * RECIPE_RTOL * base_losses[0],
          f"pipeline {leg}: single's loss fell by {fall:.4f} only, too "
          f"little to hold the pipeline's update")
    check(all(np.isfinite(losses)) and rel <= RECIPE_RTOL,
          f"pipeline {leg}: losses {losses} against single's {base_losses}"
          f" ({rel:.3e} relative)")
    check(all(np.isfinite(norms)) and norm_rels[0] <= lim0
          and norm_rel <= lim,
          f"pipeline {leg}: gradient norms {norms} against single's "
          f"{base_norms} ({norm_rels.tolist()} relative, limits {lim0:.0e}"
          f" at step 0, {lim:.0e})")
    first, last = states[0], states[-1]
    w0, w1 = first.model.tkn_emb.weight, last.model.tkn_emb.weight
    tied = torch.equal(w0, w1) and all(
        torch.equal(first.optimizer.state[w0][k],
                    last.optimizer.state[w1][k])
        for k in ("exp_avg", "exp_avg_sq"))
    check(tied, f"pipeline {leg}: the tied embedding's copies differ")
    p50 = float(np.median(times))
    tokens = accum * B * T
    out = dict(schedule=sched, vpp=vpp, losses=losses,
               single_losses=base_losses, max_rel=rel, grad_norms=norms,
               single_grad_norms=base_norms, norm_max_rel=norm_rel,
               launches=launches,
               step_ms=p50, tok_s=tokens / p50 * 1e3, peak_gb=peak,
               stage_layers=[pipe_mod.stage_layers(model_cfg, s)
                             for s in range(PP_STAGES)])
    print(f"  pipeline {leg}: {sched} S {PP_STAGES} vpp {vpp} M {PP_MICRO}, "
          f"{accum} micro-steps of {B} x {T}; losses "
          f"{[round(x, 5) for x in losses]} vs single's "
          f"{[round(x, 5) for x in base_losses]} (max rel {rel:.3e}, tol "
          f"{RECIPE_RTOL:.0e}); grad norms {[round(x, 5) for x in norms]} "
          f"vs single's {[round(x, 5) for x in base_norms]} (rel "
          f"{norm_rels[0]:.3e} at step 0, tol {lim0:.0e}; max "
          f"{norm_rel:.3e}, tol {lim:.0e}); tied copies equal; "
          f"step ms p50 {p50:.3f}, "
          f"tok/s {out['tok_s']:.1f}, peak memory {peak:.3f} GB; launches "
          f"{ {k: v for k, v in launches.items() if v} }, plain calls 0; "
          f"card {card}", flush=True)
    del states, first, last
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_flash_b1(torch, dev, card: str) -> dict:
    """The flash kernels at a pipeline microbatch's shape (PP_FLASH_B1,
    bf16), held to their plain versions (FLASH_TOL) and timed beside
    phase 3's B 8."""
    res = {}
    for dn, name, D, fk, fp, fl, n_bytes, flops in _flash_cases_at(
            torch, dev, *PP_FLASH_B1):
        if dn != "bfloat16":
            continue
        out, ref = fk(), fp()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        errs = []
        for oname, a, b in zip(FLASH_OUTPUTS[name], outs, refs):
            atol, rtol = FLASH_TOL["float32" if oname == "lse" else dn]
            e = _elementwise(a, b, atol, rtol)
            check(e["frac"] <= 1.0, f"{name} at b 1: {oname} beyond its "
                  f"limit ({e['frac']:.3f})")
            if oname != "lse":
                errs.append(e["err"])
        b_ms, b_by = bound(n_bytes, flops, dn)
        ms, spread = time_windows(fk, iters=10)
        res[name] = dict(shape="B1_T1024_H12/12x64_causal",
                         max_abs_err=max(errs), ms=ms, ms_spread=spread,
                         device_ms=device_ms(fk),
                         library_device_ms=device_ms(fl), bound_ms=b_ms,
                         bound_by=b_by)
        r = res[name]
        print(f"  {name} at b 1: kernel {_timed(r, 'ms')}, library device "
              f"{r['library_device_ms']} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"max_abs_err {r['max_abs_err']:.3e}; card {card}",
              flush=True)
    torch.cuda.empty_cache()
    return res


def run_pipelines(torch, dev, card: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = {leg: run_pipeline_leg(torch, dev, card, tmp, leg)
               for leg in PP_LEGS}
    out["flash_b1"] = run_flash_b1(torch, dev, card)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    phase("2 build")
    from distributed_pytorch_tpu_torch.ops import cuda_build
    from distributed_pytorch_tpu_torch.ops import flash_decode as fd
    t0 = time.perf_counter()
    took = cuda_build.build(verbose=True)
    print(f"  built {sorted(took)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    check_sass(sass_inventory())

    phase("3 kernels vs plain versions")
    kres = run_kernels(torch, fd, dev)
    fres = run_flash_kernels(torch, dev)
    offsets = run_flash_offsets(torch, dev)
    positions = run_flash_positions(torch, dev)
    run_flash_widths(torch, dev)
    cres = run_ce_kernels(torch, dev)
    gres = run_gmm_kernels(torch, dev)

    phase("4 flagship model at full width")
    contiguous, contiguous_q8 = run_model(torch, fd, dev)

    phase("5 serve")
    wave = run_serve(torch, fd, card)
    launches = wave["launches"]

    phase("6 train")
    train_launches, loss0 = run_train(torch, dev, card)
    run_parity(torch, dev)

    phase("7 train with the fused CE kernels, then sample and serve")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            ce_run = run_train_ce(torch, dev, card, loss0, tmp)
            run_parity_ce(torch, dev)
            root = os.path.join(tmp, "checkpoints", "chip_smoke_ce")
            run_sample_serve(torch, dev, card, root)

            phase("8 int8 and chunked serving")
            q8_run = run_int8_chunked(torch, dev, card, wave, root)
        finally:
            os.chdir(cwd)

    phase("9 train the flagship MoE through the grouped kernels, then "
          "serve it")
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            moe_run = run_train_moe(torch, dev, card, tmp)
            run_parity_moe(torch, dev)
            run_serve_moe(torch, dev, card,
                          os.path.join(tmp, "checkpoints", "chip_smoke_moe"))
        finally:
            os.chdir(cwd)

    phase("10 train the launcher's MLA model through the flash kernels at "
          "head size 256, then serve it")
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            mla_run = run_train_mla(torch, dev, card, tmp)
            run_parity_mla(torch, dev)
            run_serve_mla(torch, dev, card,
                          os.path.join(tmp, "checkpoints", "chip_smoke_mla"))
        finally:
            os.chdir(cwd)

    phase("11 train the default config and the flagship with MLA at head "
          "sizes 32 and 80, then sample and serve the default")
    small = run_small_head_sizes(torch, dev, card)

    phase("12 parallel recipes at world size 1 over NCCL")
    recipes = run_recipes(torch, card)
    print(f"  (5) pipeline stages in one process at full width "
          f"(at {time.perf_counter() - T0:.1f} s)", flush=True)
    pipes = run_pipelines(torch, dev, card)

    rows = []
    for case, kname in (("paged", "paged_decode_attn"),
                        ("contiguous", "paged_decode_attn"),
                        ("prefill_off0", "paged_prefill_attn"),
                        ("prefill_off256", "paged_prefill_attn")):
        r = kres[(case, "bfloat16")]
        r32 = kres[(case, "float32")]
        rows.append({
            "name": kname, "case": case, "dtype": "bfloat16",
            "route": "cuda", "source": SOURCE.format(kname),
            "replaces": REPLACES[case.split("_")[0]],
            "launches": (contiguous["bfloat16"] if case == "contiguous"
                         else launches[kname]),
            "launches_path": "generate" if case == "contiguous" else "serve",
            "max_abs_err": r["max_abs_err"], "tol": r["tol"],
            "kernels": r["kernels"], "kernels_fp32": r32["kernels"],
            "launches_fp32": (contiguous["float32"] if case == "contiguous"
                              else None),
            "max_abs_err_fp32": r32["max_abs_err"], "tol_fp32": r32["tol"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "ms_spread": r["ms_spread"],
            "library_spread": r["library_spread"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "ms_fp32": r32["ms"], "plain_ms_fp32": r32["plain_ms"],
            "bound_ms_fp32": r32["bound_ms"],
            "library_ms_fp32": r32["library_ms"]})
    for case, kname in (("paged_q8", "paged_decode_attn_q8"),
                        ("contiguous_q8", "paged_decode_attn_q8"),
                        ("prefill_q8_off0", "paged_prefill_attn_q8"),
                        ("prefill_q8_off256", "paged_prefill_attn_q8")):
        r = kres[(case, "bfloat16")]
        r32 = kres[(case, "float32")]
        contig = case == "contiguous_q8"
        rows.append({
            "name": kname, "case": case, "dtype": "bfloat16",
            "route": "cuda",
            "source": SOURCE.format(kname.removesuffix("_q8")),
            "replaces": REPLACES[case.split("_off")[0]],
            "launches": (contiguous_q8["bfloat16"] if contig
                         else q8_run["b"]["launches"][kname]),
            "launches_path": ("generate_int8" if contig
                              else "serve_int8_chunked"),
            "max_abs_err": r["max_abs_err"], "tol": r["tol"],
            "kernels": r["kernels"], "kernels_fp32": r32["kernels"],
            "launches_fp32": contiguous_q8["float32"] if contig else None,
            "max_abs_err_fp32": r32["max_abs_err"], "tol_fp32": r32["tol"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "library_call": "none: no PyTorch call takes int8 codes with "
                            "row scales",
            # run_kernels timed the yardstick under 'library_ms'
            "replaced_path": "the gathered int8 rows dequantized to the "
                             "activations' dtype, then "
                             "scaled_dot_product_attention",
            "replaced_path_ms": r["library_ms"], "ms_spread": r["ms_spread"],
            "device_ms": r["device_ms"],
            "replaced_path_device_ms": r["library_device_ms"],
            "ms_fp32": r32["ms"], "plain_ms_fp32": r32["plain_ms"],
            "bound_ms_fp32": r32["bound_ms"], "library_ms_fp32": None,
            "device_ms_fp32": r32["device_ms"],
            "replaced_path_ms_fp32": r32["library_ms"]})
    serve32 = small["default"]["serve"]["legs"]["bfloat16"]
    for case in ("prefill_hs32_off0", "prefill_hs32_off256"):
        r = kres[(case, "bfloat16")]
        rows.append({
            "name": "paged_prefill_attn", "case": case, "dtype": "bfloat16",
            "route": "cuda", "source": SOURCE.format("paged_prefill_attn"),
            "replaces": REPLACES["prefill"], "head_size": 32,
            "launches": serve32["launches"]["paged_prefill_attn"],
            "launches_path": "serve_default",
            "kernels_path": serve32["route"]["kernels"],
            "device_ms_path": serve32["route"]["device_ms"],
            "max_abs_err": r["max_abs_err"], "tol": r["tol"],
            "kernels": r["kernels"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_call": "scaled_dot_product_attention over the "
                            "gathered rows (enable_gqa)",
            "ms_spread": r["ms_spread"],
            "library_spread": r["library_spread"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"]})
    from distributed_pytorch_tpu_torch.ops import flash_attention as fa
    flash_runs = {64: ("train", train_launches),
                  256: ("train_mla", mla_run["launches"]),
                  32: ("train_default", small["default"]["launches"]),
                  80: ("train_flagship_mla",
                       small["flagship_mla"]["launches"])}
    for kname, D in ((k, D) for D in FLASH_SHAPES for k in FLASH_SOURCE):
        r, r32 = fres[(kname, "bfloat16", D)], fres[(kname, "float32", D)]
        B, T, nh, nkv = FLASH_SHAPES[D]
        path, path_launches = flash_runs[D]
        rows.append({
            "name": kname, "case": f"B{B}_T{T}_H{nh}/{nkv}x{D}_causal",
            "dtype": "bfloat16", "route": "cuda",
            "source": SOURCE.format(FLASH_SOURCE[kname]),
            "replaces": REPLACES[kname], "head_size": D,
            "built_width": fa.padded_width(D, kname, torch.bfloat16),
            "launches": path_launches[kname], "launches_path": path,
            "launches_recipes": ({k: recipes[k]["launches"][kname]
                                  for k in RECIPES} if D == 64 else None),
            "launches_pipeline": ({leg: pipes[leg]["launches"][kname]
                                   for leg in PP_LEGS} if D == 64 else None),
            "pipeline_b1": pipes["flash_b1"][kname] if D == 64 else None,
            "head_offset_max_abs_err": (
                {dn: offsets[(kname, dn, D)] for dn in ("bfloat16",
                                                         "float32")}
                if any(o[0] == D for o in FLASH_OFFSETS) else None),
            "positions_max_abs_err": (
                {dn: positions[(kname, dn, D)] for dn in ("bfloat16",
                                                          "float32")}
                if any(o[0] == D for o in FLASH_POSITIONS) else None),
            "ring_hops_max_abs_err": recipes["hops"].get((kname, D)),
            "max_abs_err": r["max_abs_err"], "tol": r["tol"],
            "lse_max_abs_err": r["lse_max_abs_err"], "launches_fp32": None,
            "max_abs_err_fp32": r32["max_abs_err"], "tol_fp32": r32["tol"],
            "lse_max_abs_err_fp32": r32["lse_max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "ms_spread": r["ms_spread"],
            "library_spread": r["library_spread"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "library_call": ("scaled_dot_product_attention"
                             if kname == "flash_attn_fwd" else
                             "scaled_dot_product_attention backward "
                             "(dq, dk, dv together)"),
            "ms_fp32": r32["ms"], "plain_ms_fp32": r32["plain_ms"],
            "bound_ms_fp32": r32["bound_ms"],
            "library_ms_fp32": r32["library_ms"]})
    for kname in CE_SOURCE:
        r, r32 = cres[(kname, "bfloat16")], cres[(kname, "float32")]
        y, y32 = cres[("yardsticks", "bfloat16")], \
            cres[("yardsticks", "float32")]
        rep = "replaced_fwd" if kname == "fused_ce_fwd" else \
            "replaced_fwd_bwd"
        rows.append({
            "name": kname, "case": "n8192_C768_V50304", "dtype": "bfloat16",
            "route": "cuda", "source": SOURCE.format(CE_SOURCE[kname]),
            "replaces": REPLACES[kname],
            "launches": ce_run["launches"][kname],
            "launches_path": "train_ce",
            "launches_recipes": {k: recipes[k]["launches"][kname]
                                 for k in RECIPES},
            "launches_pipeline": {leg: pipes[leg]["launches"][kname]
                                  for leg in PP_LEGS},
            "max_abs_err": r["max_abs_err"], "tol": r["tol"],
            "errs": {o: e["err"] for o, e in r["errs"].items()},
            "launches_fp32": None,
            "max_abs_err_fp32": r32["max_abs_err"], "tol_fp32": r32["tol"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "ms_spread": r["ms_spread"], "device_ms": r["device_ms"],
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes a fused "
                            "lm-head + cross-entropy",
            "replaced_path": "the chunked fused_cross_entropy (ops/"
                             "losses.py) on the same x, W, targets: "
                             + ("forward" if rep == "replaced_fwd" else
                                "forward and backward (dx, dW)"),
            "replaced_path_ms": y[rep], "mm_ms": y["mm"],
            "ms_fp32": r32["ms"], "plain_ms_fp32": r32["plain_ms"],
            "bound_ms_fp32": r32["bound_ms"], "library_ms_fp32": None,
            "device_ms_fp32": r32["device_ms"],
            "replaced_path_ms_fp32": y32[rep], "mm_ms_fp32": y32["mm"]})
    for kname in GMM_SOURCE:
        r, r32 = gres[(kname, "fc_ragged", "bfloat16")], \
            gres[(kname, "fc_ragged", "float32")]
        p, p32 = gres[(kname, "proj_ragged", "bfloat16")], \
            gres[(kname, "proj_ragged", "float32")]
        one_call = r["library_call"].startswith("torch._grouped_mm")
        rows.append({
            "name": kname, "case": "fc: P 25600, K 768, N 2048",
            "dtype": "bfloat16", "route": "cuda",
            "source": SOURCE.format(GMM_SOURCE[kname]),
            "replaces": REPLACES[kname],
            "launches": moe_run["launches"][kname],
            "launches_path": "train_moe",
            "launches_recipes": dict(
                {leg: recipes[f"moe_{leg}"]["launches"][kname]
                 for leg in MOE_RECIPE_FLAGS},
                **{cut: recipes["expert_cut"][(kname, cut)]
                   for cut in (f"ep{e}" for e in EXPERT_CUT_EP)}),
            "launches_pipeline": {leg: pipes[leg]["launches"][kname]
                                  for leg in PP_LEGS},
            "max_abs_err": r["max_abs_err"], "tol": r["tol"],
            "launches_fp32": None,
            "max_abs_err_fp32": r32["max_abs_err"], "tol_fp32": r32["tol"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_rows": r["bound_rows"], "ms_spread": r["ms_spread"],
            "library_spread": r["library_spread"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"] if one_call else None,
            "library_ms": r["library_ms"] if one_call else None,
            "library_call": r["library_call"],
            "library_loop_ms": None if one_call else r["library_ms"],
            "ms_fp32": r32["ms"], "plain_ms_fp32": r32["plain_ms"],
            "bound_ms_fp32": r32["bound_ms"],
            "library_ms_fp32": None,
            "library_loop_ms_fp32": r32["library_ms"],
            "proj": {"case": "proj, gate-scaled: P 25600, K 1024, N 768",
                     "max_abs_err": p["max_abs_err"], "ms": p["ms"],
                     "ms_spread": p["ms_spread"],
                     "ms_without_gate": (
                         gres[(kname, "proj_ragged_nogate", "bfloat16")]
                         ["ms"] if kname == "grouped_mm_bwd_dx" else None),
                     "library_spread": p["library_spread"],
                     "device_ms": p["device_ms"],
                     "library_device_ms": p["library_device_ms"],
                     "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
                     "bound_by": p["bound_by"],
                     "library_ms": p["library_ms"],
                     "library_call": p["library_call"],
                     "max_abs_err_fp32": p32["max_abs_err"],
                     "ms_fp32": p32["ms"], "plain_ms_fp32": p32["plain_ms"],
                     "bound_ms_fp32": p32["bound_ms"],
                     "library_loop_ms_fp32": p32["library_ms"]}})
    print("  phase 10's top kernels a step (two steady steps, "
          "torch.profiler):", flush=True)
    for line in mla_run["split"]["top"]:
        print(line, flush=True)
    print(f"  total {time.perf_counter() - T0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
