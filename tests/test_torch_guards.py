"""Guards of the PyTorch port: no file of `distributed_pytorch_tpu_torch`,
and not `chip_smoke.py`, imports JAX, its libraries or the reference
package (matched on the exact top-level module name — the port's own name
starts with the reference's); and the entry points refuse to fall back to
the CPU quietly when no CUDA device is visible."""

import ast
import pathlib

import pytest
import torch

import distributed_pytorch_tpu_torch as port
from distributed_pytorch_tpu_torch.config import LLMConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax",
          "distributed_pytorch_tpu"}
SOURCES = sorted((ROOT / "distributed_pytorch_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = BANNED.intersection(_imported_tops(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_guard_matches_exact_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import distributed_pytorch_tpu_torch.ops\n"
                 "from distributed_pytorch_tpu.ops import rope\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert BANNED.intersection(_imported_tops(f)) == \
        {"distributed_pytorch_tpu", "jax"}


def test_entry_points_raise_without_cuda(monkeypatch):
    from distributed_pytorch_tpu_torch.models.gpt import LLM
    from distributed_pytorch_tpu_torch.serve.__main__ import (build_args,
                                                              build_engine)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLMConfig(vocab_size=32, block_size=16, n_embd=16, n_head=2,
                    n_kv_heads=2, attn="mha", n_layer=1, up_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(build_args(["--demo"]))
    # an explicit CPU request is honored
    assert port.resolve_device("cpu").type == "cpu"
    assert LLM(cfg, device="cpu").device.type == "cpu"
    eng, *_ = build_engine(build_args(["--demo", "--cpu"]))
    assert eng.device.type == "cpu"


def test_kernel_wrappers_refuse_non_cuda_non_cpu_tensors():
    """A wrapper takes the plain version only for CPU tensors; anything
    else must be a CUDA tensor the kernel takes, or it raises."""
    from distributed_pytorch_tpu_torch.ops import flash_decode as fd
    q = torch.zeros(1, 2, 8, device="meta")
    pool = torch.zeros(3, 4, 2, 8, device="meta")
    bt = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fd.paged_flash_decode(q, pool, pool, bt,
                              torch.ones(1, dtype=torch.int32, device="meta"),
                              scale=1.0)
