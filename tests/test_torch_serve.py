"""The port's serving stack on the CPU: the serve CLI's `--demo --cpu`
engine behind the copied Scheduler and ServeApp, over loopback. Concurrent
SSE completions with a shared prompt prefix and a mid-stream disconnect
must match the offline engine's greedy output; /healthz, /metrics and the
429 backpressure path behave as in the reference; the engine-side gauges
the port does not have yet (traces, AOT store, host tier) read 0. The
CLI's `--cache-dtype int8 --quant-weights --prefill-chunk N` engine serves
the offline engine's tokens and names its options on /metrics."""

import asyncio
import json

import numpy as np

from distributed_pytorch_tpu_torch.engine import DecodeEngine
from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                          build_engine)
from distributed_pytorch_tpu_torch.serve.scheduler import Scheduler
from distributed_pytorch_tpu_torch.serve.server import ServeApp


def run_async(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def http_get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body.decode()


async def sse_client(port, prompt, max_tokens, cancel_after=None):
    """POST a streaming completion; return (status, tokens, done event)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens}).encode()
    writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split(b" ")[1])
    if status != 200:
        writer.close()
        return status, [], None
    while (await reader.readline()).strip():
        pass
    tokens, done = [], None
    while True:
        line = (await reader.readline()).decode().strip()
        if not line:
            continue
        payload = line[len("data: "):]
        if payload == "[DONE]":
            break
        ev = json.loads(payload)
        if "token" in ev:
            tokens.append(ev["token"])
            if cancel_after is not None and len(tokens) >= cancel_after:
                writer.close()
                return status, tokens, {"cancelled_by_client": True}
        else:
            done = ev
            if "error" in ev:
                break
    writer.close()
    return status, tokens, done


def _engine():
    eng, *_ = build_engine(build_args(
        ["--demo", "--cpu", "--temperature", "0", "--port", "0",
         "--slots", "3", "--kv-block", "16"]))
    return eng


def test_sse_streams_match_offline_engine_with_prefix_and_cancel():
    eng = _engine()
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(1, 1024, 40)]
    prompts = [prefix + [int(t) for t in rng.integers(1, 1024, n)]
               for n in (2, 7, 30)]
    prompts += [[int(t) for t in rng.integers(1, 1024, n)]
                for n in (1, 5, 19, 64)]
    budgets = [6, 9, 4, 12, 3, 8, 30]
    cancel = len(prompts) - 1                  # disconnects after 2 tokens

    async def main():
        sched = Scheduler(eng, max_queue=32)
        app = ServeApp(sched, port=0)
        await sched.start()
        await app.start()
        results = await asyncio.gather(*(
            sse_client(app.port, p, b, cancel_after=2 if i == cancel
                       else None)
            for i, (p, b) in enumerate(zip(prompts, budgets))))
        deadline = asyncio.get_running_loop().time() + 30
        while eng.n_live and asyncio.get_running_loop().time() < deadline:
            await asyncio.sleep(0.02)
        health = await http_get(app.port, "/healthz")
        metrics = await http_get(app.port, "/metrics")
        await app.stop()
        await sched.stop()
        return sched, results, health, metrics

    sched, results, (h_status, h_body), (m_status, m_body) = \
        run_async(main())
    ref = DecodeEngine(eng.model, n_slots=3, temperature=0.0,
                       block_size=16).run(prompts, budgets)
    for i, ((status, tokens, done), p, r) in enumerate(
            zip(results, prompts, ref)):
        assert status == 200
        if i == cancel:
            assert tokens == r[len(p):len(p) + 2]
        else:
            assert tokens == r[len(p):], f"stream {i} diverged"
            assert done["done"] and done["reason"] == "budget"
            assert done["n_tokens"] == budgets[i]
    assert eng.n_live == 0 and eng.retire_counts["cancelled"] == 1
    assert eng.prefix_hit_rate > 0
    assert h_status == 200 and json.loads(h_body)["ok"]
    assert m_status == 200
    lines = dict(l.rsplit(" ", 1) for l in m_body.splitlines()
                 if l and not l.startswith("#"))
    assert float(lines["serve_ttft_seconds_count"]) == len(prompts)
    assert float(lines["serve_prefix_hit_rate"]) > 0
    assert float(lines["serve_engine_traces_total"]) == 0
    assert float(lines["serve_engine_retrace_excess"]) == 0
    assert float(lines["serve_aot_store_compile_ms"]) == 0
    info = [l for l in m_body.splitlines()
            if l.startswith("serve_build_info{")]
    assert info and 'torch="' in info[0] and 'cache_dtype="float32"' in \
        info[0]


def test_queue_full_is_429_and_unknown_routes():
    eng = _engine()

    async def main():
        sched = Scheduler(eng, max_queue=1)
        app = ServeApp(sched, port=0)
        await sched.start()
        await app.start()
        # one slot group busy + one queued; the rest must shed as 429
        outs = await asyncio.gather(*(sse_client(app.port, [1, 2, 3], 40)
                                      for _ in range(8)))
        prof = await http_get(app.port, "/admin/profile")
        await app.stop()
        await sched.stop()
        return outs, prof

    outs, (p_status, _) = run_async(main())
    statuses = [s for s, _, _ in outs]
    assert 429 in statuses and statuses.count(200) >= 1
    assert p_status == 404          # the profiler endpoint waits


def test_int8_and_chunked_flags_serve_the_offline_engines_tokens():
    """`--cache-dtype int8 --quant-weights --prefill-chunk 32` reach the
    engine; its SSE streams equal an offline engine with the same options,
    every step's chunk use lands in `prefill_tokens_per_step`, and the
    build info names the options."""
    eng, *_ = build_engine(build_args(
        ["--demo", "--cpu", "--temperature", "0", "--port", "0",
         "--slots", "3", "--kv-block", "16", "--cache-dtype", "int8",
         "--quant-weights", "--prefill-chunk", "32"]))
    assert eng.kv_quantized and eng.weights_quantized
    assert eng.prefill_chunk == 32 and eng.caches[0]["k"].dtype.itemsize == 1
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, 1024, n)]
               for n in (3, 70, 20, 45)]
    budgets = [5, 7, 4, 6]

    async def main():
        sched = Scheduler(eng, max_queue=8)
        app = ServeApp(sched, port=0)
        await sched.start()
        await app.start()
        res = await asyncio.gather(*(sse_client(app.port, p, b)
                                     for p, b in zip(prompts, budgets)))
        metrics = await http_get(app.port, "/metrics")
        await app.stop()
        await sched.stop()
        return res, metrics

    res, (m_status, m_body) = run_async(main())
    ref = DecodeEngine(eng.model, n_slots=3, temperature=0.0, block_size=16,
                       cache_dtype="int8", quantize_weights=True,
                       prefill_chunk=32).run(prompts, budgets)
    for (status, tokens, done), p, r in zip(res, prompts, ref):
        assert status == 200 and done["reason"] == "budget"
        assert tokens == r[len(p):]
    lines = dict(l.rsplit(" ", 1) for l in m_body.splitlines()
                 if l and not l.startswith("#"))
    assert m_status == 200
    assert float(lines["serve_prefill_tokens_per_step_count"]) == \
        eng.n_steps
    assert float(lines["serve_prefill_tokens_per_step_sum"]) == \
        sum(map(len, prompts))
    info = [l for l in m_body.splitlines()
            if l.startswith("serve_build_info{")][0]
    for label in ('cache_dtype="int8"', 'quant_weights="True"',
                  'prefill_chunk="32"'):
        assert label in info
