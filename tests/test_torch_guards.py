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


CUDA_SOURCES = sorted((ROOT / "distributed_pytorch_tpu_torch" / "csrc")
                      .glob("*.cu*"))
# what a hand-written kernel may include: the port's own headers, the CUDA
# runtime's and the C++ library's own, and the driver API's types
# (cuda.h: `CUtensorMap` and the signature of `cuTensorMapEncodeTiled`,
# which the bf16 flash kernels reach through the runtime's driver entry
# point, without linking the driver library)
CUDA_HEADERS = {"cuda_runtime.h", "cuda_bf16.h", "stdint.h", "cstdint",
                "type_traits", "cuda.h"}


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


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_kernel_sources_include_no_library(path):
    """Every CUDA source includes only the port's own headers and the CUDA
    runtime's: no PyTorch header, cuBLAS, CUTLASS or other library of
    finished kernels (the grouped-matmul kernels among them)."""
    import re
    text = path.read_text()
    local = {p.name for p in CUDA_SOURCES}
    for inc in re.findall(r'#include\s*[<"]([^>"]+)[>"]', text):
        assert inc in local or inc in CUDA_HEADERS, f"{path.name}: {inc}"
    assert not re.search(r"cublas|cutlass|cute::|_grouped_mm", text,
                         re.IGNORECASE), path.name


def test_grouped_kernels_have_sources_and_guarded_module():
    """The grouped-matmul module and its kernels are among the guarded
    files: the module is a source of the import guard above, and each of
    its kernels is registered to a source under csrc/ that the include
    guard reads."""
    from distributed_pytorch_tpu_torch.ops import cuda_build
    from distributed_pytorch_tpu_torch.ops import grouped_matmul as gm
    assert ROOT / "distributed_pytorch_tpu_torch" / "ops" / \
        "grouped_matmul.py" in SOURCES
    for name in gm.LAUNCHES:
        src = cuda_build.CSRC / cuda_build.KERNELS[name][0]
        assert src in CUDA_SOURCES, name


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


def test_trainer_raises_without_cuda(monkeypatch, tmp_path):
    """`python -m distributed_pytorch_tpu_torch` and the training model
    raise without a card unless the CPU is asked for (--platform cpu)."""
    from distributed_pytorch_tpu_torch import __main__ as trainer
    from distributed_pytorch_tpu_torch.config import TrainConfig
    from distributed_pytorch_tpu_torch.train.state import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "synthetic", "--data_dir", str(tmp_path),
            "--vocab_size", "32", "--block_size", "16", "--n_embd", "16",
            "--n_head", "2", "--attn", "mha", "--n_layer", "1", "--up_dim",
            "16", "--batch_size", "1", "--total_batch_size_str", "16",
            "--max_iters", "1", "--no-save_stats"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.main(argv)
    cfg = LLMConfig(vocab_size=32, block_size=16, n_embd=16, n_head=2,
                    n_kv_heads=2, attn="mha", n_layer=1, up_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, TrainConfig())
    assert build_model(cfg, TrainConfig(), "cpu").device.type == "cpu"
    trainer.main(argv + ["--platform", "cpu"])


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


@pytest.mark.parametrize("route", ["paged", "contiguous", "prefill"])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.float16],
                         ids=["taken", "declined"])
def test_q8_wrappers_refuse_non_cpu_calls_they_cannot_launch(route,
                                                             scale_dtype):
    """The int8 wrappers, like the others, run the plain version only for
    CPU tensors: a call on another device raises whether the kernel would
    take it (no card here to launch on) or its gate declines it (fp16
    scales) — it never falls back to the plain version."""
    from distributed_pytorch_tpu_torch.ops import flash_decode as fd
    meta = dict(device="meta")
    codes = torch.zeros(3, 4, 2, 8, dtype=torch.int8, **meta)
    sc = torch.zeros(3, 4, 2, 1, dtype=scale_dtype, **meta)
    kw = dict(scale=1.0, k_scale=sc, v_scale=sc)
    bt = torch.zeros(1, 2, dtype=torch.int32, **meta)
    cl = torch.ones(1, dtype=torch.int32, **meta)
    fd.reset_counts()
    with pytest.raises(ValueError):
        if route == "paged":
            fd.paged_flash_decode(torch.zeros(1, 2, 8, **meta), codes, codes,
                                  bt, cl, **kw)
        elif route == "contiguous":
            fd.flash_decode(torch.zeros(3, 2, 8, **meta), codes, codes,
                            torch.ones(3, dtype=torch.int32, **meta), **kw)
        else:
            fd.paged_flash_prefill(torch.zeros(1, 8, 2, 8, **meta), codes,
                                   codes, bt, 0, **kw)
    assert fd.PLAIN_CALLS == dict.fromkeys(fd.PLAIN_CALLS, 0)
    assert fd.LAUNCHES == dict.fromkeys(fd.LAUNCHES, 0)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# a phase 2 inventory as `cuobjdump -sass` names the kernels: the bf16
# wgmma kernels (flash fwd, dq, dkv and the paged prefill at D 64 and 128,
# grouped fwd, dx and dW unscaled and scaled, the fused CE forward, dx and
# dW, the int8-cache paged prefill at D 64 and 128, flash fwd, dq, dkv at
# D 256, the flash dq at D 192, the flash forward, dq and dkv at width 80,
# the flash dq and dkv at width 32 (pipelined, `flash_pipe`), every flash
# kernel's instance for head sizes under its width, then the flash forward
# at width 32 (`flash_pipe`) and the paged prefill at D 32) and some of
# the others (fp32 flash, fp32 grouped forward, dx and
# dW, the FMA prefill, the tile decode, the split-KV decode's split (bf16
# and int8 caches) and combine kernels, the fused CE's mma.sync and fp32
# kernels, the fp32 flash kernels at D 256, and the merge of the bf16
# prefill's split halves at D 32)
SASS_SM90 = [
    f"_ZN12_GLOBAL__N_110flash_sm90{len(k)}{k}ILi{d}ELb0EEEvNS0_4MapsEN5flash"
    "6ParamsE"
    for k in ("fwd_kernel_sm90", "dq_kernel_sm90", "dkv_kernel_sm90")
    for d in (64, 128)] + [
    f"_ZN3gmm{len(k)}{k}ILb{b}EEEvNS_{len(m)}{m}ENS_6ParamsE"
    for k, m in (("dw_kernel_sm90", "DwMaps"), ("dx_kernel_sm90", "DxMaps"),
                 ("fwd_kernel_sm90", "FwdMaps"))
    for b in (0, 1)] + [
    f"_ZN12_GLOBAL__N_112prefill_sm9019prefill_kernel_sm90ILi{d}EEEvPK13"
    "__nv_bfloat16S4_S4_PKiPS2_iiiiiiif" for d in (64, 128)] + [
    f"_ZN3fce14ce_kernel_sm90ILi{m}EEEvNS_3s904MapsENS_6ParamsEi"
    for m in (0, 1, 2)] + [
    f"_ZN12_GLOBAL__N_112prefill_sm9022prefill_kernel_sm90_q8ILi{d}EEEvPK13"
    "__nv_bfloat16PKaPKfS6_S8_PKiPS2_iiiiiif" for d in (64, 128)] + [
    # the forward, dq and dkv at D 256, warp-specialized (their own namespace)
    "_ZN12_GLOBAL__N_18flash_ws15fwd_kernel_sm90ILi256ELb0EEEv14CUtensorMap_st"
    "S2_S2_N5flash6ParamsE",
    "_ZN12_GLOBAL__N_18flash_ws14dq_kernel_sm90ILi256ELb0EEEvNS_10flash_sm906"
    "DqMapsEN5flash6ParamsE",
    "_ZN12_GLOBAL__N_18flash_ws15dkv_kernel_sm90ILi256ELb0EEEvNS_10flash_sm904"
    "MapsEN5flash6ParamsE",
    # the dq at D 192, warp-specialized too
    "_ZN12_GLOBAL__N_18flash_ws14dq_kernel_sm90ILi192ELb0EEEvNS_10flash_sm906"
    "DqMapsEN5flash6ParamsE"] + [
    # each flash kernel's instance for head sizes under its width (masked)
    f"_ZN12_GLOBAL__N_110flash_sm90{len(k)}{k}ILi{d}ELb1EEEvNS0_4MapsEN5flash"
    "6ParamsE"
    for k in ("fwd_kernel_sm90", "dq_kernel_sm90", "dkv_kernel_sm90")
    for d in (64, 128)] + [
    "_ZN12_GLOBAL__N_18flash_ws15fwd_kernel_sm90ILi256ELb1EEEv14CUtensorMap_st"
    "S2_S2_N5flash6ParamsE",
    "_ZN12_GLOBAL__N_18flash_ws15dkv_kernel_sm90ILi256ELb1EEEvNS_10flash_sm904"
    "MapsEN5flash6ParamsE"] + [
    f"_ZN12_GLOBAL__N_18flash_ws14dq_kernel_sm90ILi{d}ELb1EEEvNS_10flash_sm906"
    "DqMapsEN5flash6ParamsE" for d in (192, 256)] + [
    # the forward and dkv at width 80, for d == 80 and d < 80
    "_ZN12_GLOBAL__N_110flash_sm9015fwd_kernel_sm90ILi80ELb0EEEvN4sm905Map80ES3_"
    "S3_N5flash6ParamsE",
    "_ZN12_GLOBAL__N_110flash_sm9015dkv_kernel_sm90ILi80ELb0EEEvNS0_6MapsOfIN4sm9"
    "05Map80EEEN5flash6ParamsE",
    "_ZN12_GLOBAL__N_110flash_sm9015fwd_kernel_sm90ILi80ELb1EEEvN4sm905Map80ES3_"
    "S3_N5flash6ParamsE",
    "_ZN12_GLOBAL__N_110flash_sm9015dkv_kernel_sm90ILi80ELb1EEEvNS0_6MapsOfIN4sm9"
    "05Map80EEEN5flash6ParamsE"] + [
    # the dq at width 80, for d == 80 and d < 80
    f"_ZN12_GLOBAL__N_110flash_sm9014dq_kernel_sm90ILi80ELb{b}EEEvNS0_6DqMaps"
    "IXT_EEEN5flash6ParamsE" for b in (0, 1)] + [
    # the dq and dkv at width 32, for d == 32 and d < 32
    f"_ZN12_GLOBAL__N_110flash_pipe14dq_kernel_sm90ILi32ELb{b}EEEvNS_10flash_"
    "sm906DqMapsIXT_EEEN5flash6ParamsE" for b in (0, 1)] + [
    f"_ZN12_GLOBAL__N_110flash_pipe15dkv_kernel_sm90ILi32ELb{b}EEEvNS_10flash_"
    "sm906MapsOfINSt11conditionalIXeqT_Li80EEN4sm905Map80E14CUtensorMap_stE4"
    "typeEEEN5flash6ParamsE" for b in (0, 1)] + [
    # the forward at width 32, for d == 32 and d < 32
    f"_ZN12_GLOBAL__N_110flash_pipe15fwd_kernel_sm90ILi32ELb{b}EEEvNSt11"
    "conditionalIXeqT_Li80EEN4sm905Map80E14CUtensorMap_stE4typeES7_S7_N5flash"
    "6ParamsE" for b in (0, 1)] + [
    # the paged prefill at D 32 over a bf16 cache
    "_ZN12_GLOBAL__N_112prefill_sm9019prefill_kernel_sm90ILi32EEEvPK13"
    "__nv_bfloat16S4_S4_PKiPS2_iiiiiiif"]
SASS_OTHER = ["_ZN12_GLOBAL__N_19dq_kernelIfLi64EEEvN5flash6ParamsE",
              "_ZN3gmm10gmm_kernelIfLi0EEEvNS_6ParamsE",
              "_ZN3gmm10gmm_kernelIfLi1EEEvNS_6ParamsE",
              "_ZN3gmm10gmm_kernelIfLi2EEEvNS_6ParamsE",
              "_ZN12_GLOBAL__N_120paged_prefill_kernelI13__nv_bfloat16aEEvPKT_"
              "PKT0_S7_PKfS9_PKiPS2_iiiiiiif",
              "_ZN12_GLOBAL__N_119paged_decode_kernelIfEEvPKT_PKaS5_PKfS7_"
              "PKiS9_PS1_iiiiiif",
              "_ZN12_GLOBAL__N_119decode_split_kernelI13__nv_bfloat16S1_Li1EEEvP"
              "KT_PKT0_S8_PKfSA_PKiSC_Pfiiiiiiif",
              "_ZN12_GLOBAL__N_119decode_split_kernelI13__nv_bfloat16aLi4EEEvPKT_"
              "PKT0_S7_PKfS9_PKiSB_Pfiiiiiiif",
              "_ZN12_GLOBAL__N_121decode_combine_kernelIfEEvPKfPKiPT_iiii",
              "_ZN3fce9ce_kernelI13__nv_bfloat16Li1EEEvNS_6ParamsE",
              "_ZN3fce9ce_kernelIfLi2EEEvNS_6ParamsE",
              "_ZN3fce9ce_kernelI13__nv_bfloat16Li0EEEvNS_6ParamsE"] + [
    f"_ZN12_GLOBAL__N_1{len(k)}{k}IfLi256EEEvN5flash6ParamsE"
    for k in ("fwd_kernel", "dq_kernel", "dkv_kernel")] + [
    # the merge of the bf16 prefill's split halves at D 32 (CUDA cores)
    "_ZN12_GLOBAL__N_112prefill_sm9015prefill_combineILi32EEEvPKfP13"
    "__nv_bfloat16iii"]
# each broken inventory: (kernel, op, count; op None drops the kernel),
# and the name the failure must print
BROKEN = {"complete": None,
          "dq_without_hgmma": ((SASS_SM90[2], "HGMMA", 0), "dq_kernel_sm90"),
          "prefill_without_hgmma": ((SASS_SM90[12], "HGMMA", 0),
                                    "prefill_kernel_sm90"),
          "prefill_with_tma": ((SASS_SM90[13], "UTMALDG", 2),
                               "prefill_kernel_sm90"),
          "dx_without_tma": ((SASS_SM90[8], "UTMALDG", 0), "dx_kernel_sm90"),
          "fma_prefill_with_hgmma": ((SASS_OTHER[4], "HGMMA", 4),
                                     "paged_prefill_kernel"),
          "gmm_fwd_without_tma": ((SASS_SM90[10], "UTMALDG", 0),
                                  "gmm15fwd_kernel_sm90"),
          "gmm_fwd_without_hgmma": ((SASS_SM90[11], "HGMMA", 0),
                                    "gmm15fwd_kernel_sm90"),
          "decode_with_hgmma": ((SASS_OTHER[6], "HGMMA", 4),
                                "decode_split_kernel"),
          "decode_split_missing": ((SASS_OTHER[6], None, 0),
                                   "decode_split_kernel"),
          "ce_bwd_without_hgmma": ((SASS_SM90[15], "HGMMA", 0),
                                   "ce_kernel_sm90"),
          "ce_bwd_without_tma": ((SASS_SM90[16], "UTMALDG", 0),
                                 "ce_kernel_sm90"),
          "ce_fwd_without_hgmma": ((SASS_SM90[14], "HGMMA", 0),
                                   "ce_kernel_sm90"),
          "ce_fwd_without_tma": ((SASS_SM90[14], "UTMALDG", 0),
                                 "ce_kernel_sm90"),
          "ce_mma_sync_with_hgmma": ((SASS_OTHER[9], "HGMMA", 4),
                                     "ce_kernel"),
          "ce_fwd_mma_sync_with_hgmma": ((SASS_OTHER[11], "HGMMA", 4),
                                         "ce_kernel"),
          "q8_decode_split_with_hgmma": ((SASS_OTHER[7], "HGMMA", 4),
                                         "decode_split_kernel"),
          "q8_prefill_without_hgmma": ((SASS_SM90[17], "HGMMA", 0),
                                       "prefill_kernel_sm90_q8"),
          "q8_prefill_with_tma": ((SASS_SM90[18], "UTMALDG", 2),
                                  "prefill_kernel_sm90_q8"),
          "q8_prefill_without_cp_async": ((SASS_SM90[17], "LDGSTS", 0),
                                          "prefill_kernel_sm90_q8"),
          "q8_prefill_missing": ((SASS_SM90[18], None, 0),
                                 "prefill_kernel_sm90_q8"),
          "fwd_256_without_hgmma": ((SASS_SM90[19], "HGMMA", 0),
                                    "fwd_kernel_sm90"),
          "dkv_256_without_tma": ((SASS_SM90[21], "UTMALDG", 0),
                                  "dkv_kernel_sm90"),
          "dq_256_missing": ((SASS_SM90[20], None, 0),
                             "dq_kernel_sm90ILi256E"),
          "fp32_dkv_256_missing": ((SASS_OTHER[14], None, 0),
                                   "dkv_kernelIfLi256E"),
          "fp32_fwd_256_with_hgmma": ((SASS_OTHER[12], "HGMMA", 4),
                                      "fwd_kernelIfLi256E"),
          "fwd_256_without_setmaxnreg": ((SASS_SM90[19], "USETMAXREG", 0),
                                         "fwd_kernel_sm90"),
          "dkv_256_without_setmaxnreg": ((SASS_SM90[21], "USETMAXREG", 0),
                                         "dkv_kernel_sm90"),
          "fwd_256_with_spill": ((SASS_SM90[19], "STL", 6), "fwd_kernel_sm90"),
          "dkv_256_with_spill": ((SASS_SM90[21], "STL", 6), "dkv_kernel_sm90"),
          "dq_192_missing": ((SASS_SM90[22], None, 0),
                             "dq_kernel_sm90ILi192E"),
          "dq_192_without_hgmma": ((SASS_SM90[22], "HGMMA", 0),
                                   "dq_kernel_sm90"),
          "masked_fwd_without_tma": ((SASS_SM90[23], "UTMALDG", 0),
                                     "fwd_kernel_sm90"),
          "masked_ws_dkv_without_setmaxnreg": ((SASS_SM90[30], "USETMAXREG",
                                                0), "dkv_kernel_sm90"),
          "dq_256_without_setmaxnreg": ((SASS_SM90[20], "USETMAXREG", 0),
                                        "dq_kernel_sm90"),
          "dq_256_spills": ((SASS_SM90[20], "STL", 6), "dq_kernel_sm90"),
          "masked_dq_192_without_setmaxnreg": ((SASS_SM90[31], "USETMAXREG",
                                                0), "dq_kernel_sm90"),
          "fwd_80_missing": ((SASS_SM90[33], None, 0),
                             "fwd_kernel_sm90ILi80E"),
          "dkv_80_missing": ((SASS_SM90[34], None, 0),
                             "dkv_kernel_sm90ILi80E"),
          "fwd_80_with_spill": ((SASS_SM90[33], "STL", 6), "fwd_kernel_sm90"),
          "masked_dkv_80_with_spill": ((SASS_SM90[36], "STL", 6),
                                       "dkv_kernel_sm90"),
          "masked_fwd_80_without_tma": ((SASS_SM90[35], "UTMALDG", 0),
                                        "fwd_kernel_sm90"),
          "dkv_80_without_hgmma": ((SASS_SM90[34], "HGMMA", 0),
                                   "dkv_kernel_sm90"),
          "dq_80_missing": ((SASS_SM90[37], None, 0),
                            "dq_kernel_sm90ILi80E"),
          "dq_80_without_hgmma": ((SASS_SM90[37], "HGMMA", 0),
                                  "dq_kernel_sm90"),
          "masked_dq_80_with_spill": ((SASS_SM90[38], "STL", 6),
                                      "dq_kernel_sm90"),
          "dq_32_missing": ((SASS_SM90[39], None, 0),
                            "dq_kernel_sm90ILi32E"),
          "dkv_32_missing": ((SASS_SM90[41], None, 0),
                             "dkv_kernel_sm90ILi32E"),
          "dq_32_without_hgmma": ((SASS_SM90[39], "HGMMA", 0),
                                  "dq_kernel_sm90"),
          "dkv_32_without_tma": ((SASS_SM90[41], "UTMALDG", 0),
                                 "dkv_kernel_sm90"),
          "masked_dkv_32_with_spill": ((SASS_SM90[42], "STL", 6),
                                       "dkv_kernel_sm90"),
          "fwd_32_missing": ((SASS_SM90[43], None, 0),
                             "fwd_kernel_sm90ILi32E"),
          "fwd_32_without_hgmma": ((SASS_SM90[43], "HGMMA", 0),
                                   "fwd_kernel_sm90"),
          "fwd_32_without_tma": ((SASS_SM90[43], "UTMALDG", 0),
                                 "fwd_kernel_sm90"),
          "masked_fwd_32_with_spill": ((SASS_SM90[44], "STL", 6),
                                       "fwd_kernel_sm90"),
          "prefill_32_missing": ((SASS_SM90[45], None, 0),
                                 "prefill_kernel_sm90ILi32E"),
          "prefill_32_without_hgmma": ((SASS_SM90[45], "HGMMA", 0),
                                       "prefill_kernel_sm90"),
          "prefill_32_with_tma": ((SASS_SM90[45], "UTMALDG", 2),
                                  "prefill_kernel_sm90"),
          "prefill_32_without_cp_async": ((SASS_SM90[45], "LDGSTS", 0),
                                          "prefill_kernel_sm90"),
          "prefill_32_with_spill": ((SASS_SM90[45], "STL", 6),
                                    "prefill_kernel_sm90"),
          "prefill_combine_32_missing": ((SASS_OTHER[15], None, 0),
                                         "prefill_combineILi32E"),
          "prefill_combine_32_with_hgmma": ((SASS_OTHER[15], "HGMMA", 4),
                                            "prefill_combine")}


@pytest.mark.parametrize("broken", BROKEN)
def test_check_sass_reads_a_synthetic_inventory(broken, capsys):
    """Phase 2's check passes an inventory in which every bf16 wgmma
    kernel holds HGMMA and its loads (TMA; cp.async and no TMA in the
    paged prefills over bf16 and int8 caches), the split-KV decode's
    split and combine kernels are there, and no other kernel holds HGMMA
    or a TMA load; and exits non-zero when one kernel breaks that: the
    bf16 dq, the prefill, the grouped forward or the CE backward without
    HGMMA, the prefill with a TMA load, the dx, the grouped forward or the
    CE backward without one, the FMA prefill, the decode split (bf16 or
    int8 cache) or the CE forward's or backward's mma.sync kernel with
    HGMMA, the decode split missing; the CE forward (its sm90 kernel)
    without HGMMA or without a TMA load; the int8-cache prefill without
    HGMMA, with a TMA load, without cp.async, or missing; the flash
    kernels at D 256: the bf16 forward without HGMMA, the bf16 dkv without
    a TMA load, the bf16 dq or the fp32 dkv missing, the fp32 forward with
    HGMMA, the bf16 forward, dq or dkv (warp-specialized) without
    setmaxnreg or with a register spill (local-memory stores); the bf16 dq
    at D 192 missing, without HGMMA or (masked) without setmaxnreg; the
    masked forward (head sizes under 64) without a TMA load; the masked
    warp-specialized dkv without setmaxnreg; the forward or dkv at width
    80 missing, with a register spill or without HGMMA, and its masked
    forward without a TMA load; the dq at width 80 missing, without HGMMA,
    or (masked) with a register spill; the dq or dkv at width 32 missing,
    the dq without HGMMA, the dkv without a TMA load, or the masked dkv
    with a register spill; the forward at width 32 missing, without HGMMA
    or a TMA load, or (masked) with a register spill; the bf16 prefill at
    D 32 missing, without HGMMA or cp.async, with a TMA load or with a
    register spill; the merge of its split halves missing or with
    HGMMA."""
    cs = _chip_smoke()
    inv = {fn: {"HGMMA": 8, "UTMALDG": 4, "LDGSTS": 0} for fn in SASS_SM90}
    for fn in SASS_SM90[12:14] + SASS_SM90[17:19] + SASS_SM90[45:]:
        # the paged prefills
        inv[fn] = {"HGMMA": 8, "UTMALDG": 0, "LDGSTS": 16}
    inv.update({fn: {"HGMMA": 0, "UTMALDG": 0, "LDGSTS": 4}
                for fn in SASS_OTHER})
    # warp-specialized: the forward and dkv at D 256 and the dq at D 192
    # and 256, each for d == D and d < D
    for fn in [f for f in SASS_SM90 if "flash_ws" in f]:
        inv[fn].update(USETMAXREG=2, STL=0)
    assert len(SASS_SM90) == cs.SASS_WGMMA_KERNELS
    if BROKEN[broken] is None:
        cs.check_sass(inv)
        return
    (fn, op, n), name = BROKEN[broken]
    if op is None:                              # every instantiation
        for f in [f for f in inv if name in f]:
            del inv[f]
    else:
        inv[fn][op] = n
    with pytest.raises(SystemExit) as exc:
        cs.check_sass(inv)
    assert exc.value.code != 0
    assert name in capsys.readouterr().out


# profiler event names (demangled) of the grouped kernels, and the kernel
# each belongs to in the profile's per-kernel split
PROFILE_NAMES = {
    "void gmm::gmm_kernel<__nv_bfloat16, 0>(gmm::Params)": "grouped_mm_fwd",
    "void gmm::gmm_kernel<float, 1>(gmm::Params)": "grouped_mm_bwd_dx",
    "void gmm::gmm_kernel<float, 2>(gmm::Params)": "grouped_mm_bwd_dw",
    "void gmm::dx_kernel_sm90<true>(gmm::DxMaps, gmm::Params)":
        "grouped_mm_bwd_dx",
    "void gmm::dw_kernel_sm90<false>(gmm::DwMaps, gmm::Params)":
        "grouped_mm_bwd_dw",
    "void gmm::fwd_kernel_sm90<true>(gmm::FwdMaps, gmm::Params)":
        "grouped_mm_fwd",
    "void gmm::gmm_kernel<float, 0>(gmm::Params)": "grouped_mm_fwd",
    "void (anonymous namespace)::flash_sm90::fwd_kernel_sm90<64>("
    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, flash::Params)": None}


@pytest.mark.parametrize("key", PROFILE_NAMES)
def test_profile_split_names_every_grouped_kernel(key):
    """The training profile's grouped split (`gmm_kernel_of`) finds each
    grouped kernel by its profiler name, the bf16 wgmma forward, dx and dW
    among them, and no other kernel (the flash forward's name also ends
    in `fwd_kernel_sm90`)."""
    assert _chip_smoke().gmm_kernel_of(key) == PROFILE_NAMES[key]


def _events(*rows):
    """Profiler key averages as `device_kernels` returns them: (name,
    launches, device us in all)."""
    from types import SimpleNamespace
    return [SimpleNamespace(key=k, count=n, self_device_time_total=us)
            for k, n, us in rows]


SPLIT = ("void (anonymous namespace)::decode_split_kernel<__nv_bfloat16, 1>"
         "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
         "int const*, int const*, float*, int, int, int, int, int, int, int, "
         "float)")
COMBINE = ("void (anonymous namespace)::decode_combine_kernel<__nv_bfloat16>"
           "(float const*, int const*, __nv_bfloat16*, int, int, int, int)")
SPLIT_Q8 = SPLIT.replace("__nv_bfloat16, 1>", "__nv_bfloat16, signed char, 4>") \
    .replace("__nv_bfloat16 const*, __nv_bfloat16 const*, int const*",
             "signed char const*, signed char const*, float const*, float "
             "const*, int const*")
TILE = ("void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, "
        "signed char>(__nv_bfloat16 const*, signed char const*, signed char "
        "const*, float const*, float const*, int const*, int const*, "
        "__nv_bfloat16*, int, int, int, int, int, int, float)")
# (events, device ms per decode launch)
DECODE_EVENTS = {
    "split_kv": (_events((SPLIT, 120, 720.0), (COMBINE, 120, 240.0),
                         ("void gemv_kernel<float>()", 240, 999.0)), 0.008),
    "int8": (_events((SPLIT_Q8, 120, 1200.0), (COMBINE, 120, 240.0),
                     ("void gemv_kernel<float>()", 240, 999.0)), 0.012),
    "tile": (_events((TILE, 120, 6000.0), (COMBINE, 3, 30.0)), 0.05),
    "split_kv_two_rows": (_events((SPLIT, 60, 300.0),
                                  (SPLIT.replace(", 1>", ", 2>"), 60, 420.0),
                                  (COMBINE, 120, 120.0)), 0.007)}


@pytest.mark.parametrize("case", DECODE_EVENTS)
def test_decode_ms_per_launch_reads_split_and_combine(case):
    """The serving profile's decode time per launch is split plus combine
    over the split kernel's launches for the split-KV pair (over a bf16 or
    an int8 cache; its row-count instantiations together), and the tile
    kernel `paged_decode_kernel` alone where no split kernel ran (rows
    past a warp's 32 vectors); other kernels do not count."""
    ev, want = DECODE_EVENTS[case]
    assert _chip_smoke().decode_ms_per_launch(ev) == pytest.approx(want)


@pytest.mark.parametrize("key,name", [
    (SPLIT, "decode_split_kernel<__nv_bfloat16, 1>"),
    (SPLIT_Q8, "decode_split_kernel<__nv_bfloat16, signed char, 4>"),
    ("void fce::ce_kernel_sm90<0>(fce::s90::Maps, fce::Params, int)",
     "fce::ce_kernel_sm90<0>"),
    ("Memset (Device)", "Memset (Device)")])
def test_kernel_name_drops_the_signature(key, name):
    """Phase 3 prints the kernels a case's device profile saw by name:
    without the return type, the anonymous namespace and the parameters
    (whose list opens with a parenthesis, as the namespace does)."""
    assert _chip_smoke().kernel_name(key) == name


def test_decode_ms_per_launch_without_decode_events_is_nan():
    import math
    assert math.isnan(_chip_smoke().decode_ms_per_launch(
        _events(("void gemv_kernel<float>()", 4, 10.0))))


@pytest.mark.parametrize("n_max,bs,splits", [(64, 16, 8), (1, 1024, 8),
                                             (1, 1, 1), (3, 43, 2),
                                             (2, 64, 1), (2, 65, 2)])
def test_decode_split_count_and_workspace_shape(n_max, bs, splits):
    """The decode wrapper's split count comes from the table's capacity
    (n_max * bs keys, 128 a split), and its workspace holds per (sequence,
    head, split) an fp32 accumulator row and the split's max and sum."""
    from distributed_pytorch_tpu_torch.ops import flash_decode as fd
    assert fd.decode_splits(n_max * bs) == splits
    ws = fd.decode_workspace(3, 12, 64, n_max * bs, "cpu")
    assert ws.shape == (3, 12, splits, 66) and ws.dtype == torch.float32
