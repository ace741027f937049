"""Sampling and serving a checkpoint the port's trainer wrote, on the CPU:
`load_for_inference` restores the weights alone and decodes the live
model's greedy tokens; converted reference weights saved as a port
checkpoint decode the reference's greedy tokens; `serve --ckpt` streams
the same tokens and carries the checkpoint's `weights_version` on
/metrics and on every completion payload; a flipped byte raises
`CheckpointCorrupt`; `--cache-dtype int8`, `--quant-weights` and
`--prefill-chunk` decode through the DecodeEngine with those options;
`--shard` refuses, naming its slice."""

import asyncio
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pytorch_tpu.config import LLMConfig as JConfig
from distributed_pytorch_tpu.models.generate import generate as jgenerate
from distributed_pytorch_tpu.models.gpt import LLM as JLLM
from distributed_pytorch_tpu_torch import sample
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.convert import params_from_jax
from distributed_pytorch_tpu_torch.engine import DecodeEngine
from distributed_pytorch_tpu_torch.models.generate import generate
from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                          build_engine)
from distributed_pytorch_tpu_torch.serve.scheduler import Scheduler
from distributed_pytorch_tpu_torch.serve.server import ServeApp
from distributed_pytorch_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_tpu_torch.train.loop import train
from distributed_pytorch_tpu_torch.train.state import (TrainState,
                                                       build_model,
                                                       make_optimizer)
from test_torch_serve import http_get, run_async, sse_client

TINY = dict(vocab_size=97, block_size=64, n_embd=64, n_head=4, n_kv_heads=2,
            attn="gqa", n_layer=2, up_dim=96, non_linearity="swiglu",
            pos_emb="rope")
PROMPT = [5, 17, 3, 88, 41, 9, 60]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny model trained 2 steps on the CPU and saved (`save_model`):
    (run root, the live train state)."""
    tmp = tmp_path_factory.mktemp("run")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        stats = train(LLMConfig(**TINY), TrainConfig(
            dataset="synthetic", data_dir=str(tmp / "data"), batch_size=2,
            total_batch_size=2 * 64, max_iters=1, warmup_steps=1,
            platform="cpu", compute_dtype="float32", save_model=True,
            save_stats=False, learning_rate=1e-2), log=lambda s: None)
    finally:
        os.chdir(cwd)
    return str(tmp / "checkpoints" / "llm_model"), stats["state"]


def test_load_for_inference_decodes_the_live_models_tokens(trained):
    """The restored model's greedy tokens equal the live model's, and its
    weights equal the live fp32 masters bit for bit."""
    root, state = trained
    model, cfg, tc, step, version = sample.load_for_inference(
        root, device="cpu", log=lambda s: None)
    assert step == 2 and cfg == LLMConfig(**TINY)
    assert re.fullmatch(r"step_2-[0-9a-f]{8}", version)
    live = state.model.state_dict()
    assert all(torch.equal(t, live[k]) for k, t in model.state_dict().items())
    want = generate(state.model, PROMPT, 12, temperature=0.0)
    got = sample.main(["--ckpt", root, "--prompt",
                       ",".join(map(str, PROMPT)), "--temperature", "0",
                       "--max_new_tokens", "12", "--cpu"])
    assert got == want.tolist()
    # the engine route (paged kernels' plain versions) decodes the same
    eng = sample.main(["--ckpt", os.path.join(root, "step_2"), "--prompt",
                       ",".join(map(str, PROMPT)), "--temperature", "0",
                       "--max_new_tokens", "12", "--cpu",
                       "--cache-dtype", "float32"])
    assert eng == got


def test_converted_reference_checkpoint_decodes_reference_tokens(tmp_path):
    """Reference weights, converted and saved as a port checkpoint, decode
    the reference's greedy tokens through `sample.main` (fp32; every top-2
    margin on the reference's path is checked to exceed 1e-4)."""
    jm = JLLM(JConfig(**TINY), attn_impl="naive")
    x = jnp.zeros((1, 64), jnp.int32)
    key = jax.random.PRNGKey(7)
    var = dict(jm.init({"params": key, "dropout": key}, x, x))
    prompt = np.asarray([PROMPT], np.int32)
    ref = np.asarray(jgenerate(jm, var, jnp.asarray(prompt), 10,
                               temperature=0.0))
    logits, _, _ = jm.apply(var, jnp.asarray(ref[:, :-1]), all_logits=True)
    top2 = np.sort(np.asarray(logits)[:, len(PROMPT) - 1:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4
    cfg, tc = LLMConfig(**TINY), TrainConfig(compute_dtype="float32")
    model = build_model(cfg, tc, "cpu")
    model.load_state_dict(params_from_jax(jax.device_get(var["params"]), cfg))
    path = str(tmp_path / "step_0")
    ckpt.save_checkpoint(path, TrainState(step=0, model=model,
                                          optimizer=make_optimizer(model, tc)),
                         cfg, tc)
    got = sample.main(["--ckpt", path, "--prompt",
                       ",".join(map(str, PROMPT)), "--temperature", "0",
                       "--max_new_tokens", "10", "--cpu"])
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_serve_ckpt_streams_the_tokens_with_its_weights_version(trained):
    """`serve --ckpt` builds its engine from the checkpoint: 3 concurrent
    greedy streams equal `generate` on the restored model, and the
    checkpoint's weights_version rides every done event and /metrics."""
    root, _ = trained
    eng, _, version, _ = build_engine(build_args(
        ["--ckpt", root, "--cpu", "--temperature", "0", "--port", "0",
         "--slots", "3", "--kv-block", "16"]))
    assert version == ckpt.weights_version(os.path.join(root, "step_2"))
    prompts = [PROMPT, PROMPT[:3], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]]

    async def main():
        sched = Scheduler(eng, max_queue=8)
        sched.metrics.set_weights_version(version)
        app = ServeApp(sched, port=0)
        await sched.start()
        await app.start()
        res = await asyncio.gather(*(sse_client(app.port, p, 9)
                                     for p in prompts))
        metrics = await http_get(app.port, "/metrics")
        await app.stop()
        await sched.stop()
        return res, metrics

    res, (m_status, m_body) = run_async(main())
    for (status, tokens, done), p in zip(res, prompts):
        assert status == 200
        want = generate(eng.model, p, 9, temperature=0.0)[0, len(p):]
        assert tokens == want.tolist()
        assert done["weights_version"] == version
    assert m_status == 200 and f'version="{version}"' in m_body


def test_corrupt_checkpoint_raises(trained, tmp_path):
    root, _ = trained
    bad = tmp_path / "step_2"
    bad.mkdir()
    for name in os.listdir(os.path.join(root, "step_2")):
        data = open(os.path.join(root, "step_2", name), "rb").read()
        if name == ckpt.STATE:
            data = bytearray(data)
            data[len(data) // 2] ^= 0xFF
        (bad / name).write_bytes(bytes(data))
    with pytest.raises(ckpt.CheckpointCorrupt):
        sample.load_for_inference(str(bad), device="cpu", log=lambda s: None)


@pytest.mark.parametrize("flags,match", [(["--shard"], "slice 6")])
def test_later_slice_options_refuse(trained, flags, match):
    root, _ = trained
    with pytest.raises(NotImplementedError, match=match):
        sample.main(["--ckpt", root, "--cpu", "--max_new_tokens", "2"]
                    + flags)
    if flags == ["--shard"]:
        with pytest.raises(NotImplementedError, match=match):
            build_engine(build_args(["--ckpt", root, "--cpu", "--shard"]))


@pytest.mark.parametrize("flags,engine_kw", [
    (["--cache-dtype", "int8"], dict(cache_dtype="int8")),
    (["--quant-weights"], dict(quantize_weights=True)),
    (["--prefill-chunk", "16"], dict(prefill_chunk=16)),
    (["--cache-dtype", "int8", "--quant-weights", "--prefill-chunk", "32"],
     dict(cache_dtype="int8", quantize_weights=True, prefill_chunk=32))],
    ids=["int8-cache", "int8-weights", "chunked", "all-three"])
def test_int8_and_chunk_flags_decode_through_the_engine(trained, flags,
                                                        engine_kw, capsys):
    """Each flag reaches the DecodeEngine (the printed route names it) and
    the CLI's tokens equal an engine built with the same options on the
    restored model; chunked prefill alone gives `generate`'s tokens."""
    root, _ = trained
    argv = ["--ckpt", root, "--prompt", ",".join(map(str, PROMPT)),
            "--temperature", "0", "--max_new_tokens", "8", "--cpu"]
    got = sample.main(argv + flags)
    route = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("decode:")][0]
    assert "engine, cache=" + ("int8" if "cache_dtype" in engine_kw
                               else "float32") in route
    assert f"quant_w={bool(engine_kw.get('quantize_weights'))}" in route
    assert f"prefill_chunk={engine_kw.get('prefill_chunk') or 'wave'}" \
        in route
    model = sample.load_for_inference(root, device="cpu",
                                      log=lambda s: None)[0]
    want = DecodeEngine(model, n_slots=1, temperature=0.0, seed=1729,
                        **engine_kw).run([PROMPT], 8)
    assert got == want and len(got[0]) == len(PROMPT) + 8
    if flags == ["--prefill-chunk", "16"]:
        assert got[0] == generate(model, PROMPT, 8,
                                  temperature=0.0)[0].tolist()
