"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<source>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface, at first use, for `sm_90a` (Hopper), and loaded
with `ctypes` — no PyTorch headers in the sources, so a build takes
seconds, not the minutes `torch.utils.cpp_extension` needs. A source may
export several kernels' entries (paged_decode_attn.cu and
paged_prefill_attn.cu: the bf16/fp32 cache and the int8 one;
flash_attn_bwd.cu: dq and dkv; fused_ce_bwd.cu and grouped_mm_bwd.cu: dx
and dW). Libraries
are keyed by a hash of their sources and flags, under
`build/torch_kernels/` at the repo root (git-ignored); a stale key simply
builds anew. `build()` compiles every missing library at once, one `nvcc`
process per source, all started together.

Every C entry returns the launch's `cudaGetLastError()`; the wrappers in
ops/flash_decode.py, ops/flash_attention.py, ops/fused_ce.py and
ops/grouped_matmul.py raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# -fno-gnu-unique: a function-static of a template (the kernels' cached
# shared-memory caps) stays private to its library, so two builds of one
# source can be loaded side by side (an in-process A/B of two csrc trees)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xcompiler", "-fno-gnu-unique")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint

#: kernel name -> (source file, C argument types); every entry returns int
KERNELS = {
    "paged_decode_attn": (
        "paged_decode_attn.cu",
        # dtype, q, k, v, tables, cache_len, out, ws, B, nh, nkv, hs, bs,
        # n_max, n_split, scale, stream
        (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
         _P)),
    "paged_prefill_attn": (
        "paged_prefill_attn.cu",
        # dtype, q, k, v, table, out, n_tok, nh, nkv, hs, bs, n_max, off,
        # scale, ws, n_split, stream
        (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _I,
         _P)),
    "paged_decode_attn_q8": (
        "paged_decode_attn.cu",
        # dtype, q, k, k_scale, v, v_scale, tables, cache_len, out, ws, B,
        # nh, nkv, hs, bs, n_max, n_split, scale, stream
        (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         _F, _P)),
    "paged_prefill_attn_q8": (
        "paged_prefill_attn.cu",
        # dtype, q, k, k_scale, v, v_scale, table, out, n_tok, nh, nkv, hs,
        # bs, n_max, off, scale, stream
        (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
         _P)),
    # dims (host int[9]) = B, T, S, nh, nkv, causal, dropout, nh_all, h0;
    # strides (host int64[8]) = q, k, v, dout (batch, time) element strides
    "flash_attn_fwd": (
        "flash_attn_fwd.cu",
        # dtype, built width, head size, q, k, v, out, lse, seed, dims,
        # strides, scale, thresh, keep_scale, stream
        (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _U, _F, _P)),
    "flash_attn_bwd_dq": (
        "flash_attn_bwd.cu",
        # dtype, built width, head size, q, k, v, dout, lse, delta, dq,
        # seed, dims, strides, scale, thresh, keep_scale, stream
        (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _U, _F,
         _P)),
    "flash_attn_bwd_dkv": (
        "flash_attn_bwd.cu",
        # dtype, built width, head size, q, k, v, dout, lse, delta, dk, dv,
        # seed, dims, strides, scale, thresh, keep_scale, stream
        (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _U,
         _F, _P)),
    "fused_ce_fwd": (
        "fused_ce_fwd.cu",
        # dtype, x, w, t, nll, lse, n, V, C, stream
        (_I, _P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "fused_ce_bwd_dx": (
        "fused_ce_bwd.cu",
        # dtype, x, w, t, lse, coef, dx, n, V, C, stream
        (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "fused_ce_bwd_dw": (
        "fused_ce_bwd.cu",
        # dtype, x, w, t, lse, coef, dw, n, V, C, stream
        (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "grouped_mm_fwd": (
        "grouped_mm_fwd.cu",
        # dtype, x, w, scale, tile_group, y, P, K, N, E, bm, stream
        (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "grouped_mm_bwd_dx": (
        "grouped_mm_bwd.cu",
        # dtype, dy, w, scale, tile_group, dx, P, K, N, E, bm, stream
        (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "grouped_mm_bwd_dw": (
        "grouped_mm_bwd.cu",
        # dtype, x, dy, scale, counts, gstart, dw, P, K, N, E, bm, stream
        (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def lib_path(name: str) -> Path:
    """Where the library holding kernel `name` lives for the current
    sources (one library per source file)."""
    src = KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted([src] + [p.name for p in CSRC.glob("*.cuh")]):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build(names=None, *, verbose: bool = False) -> dict:
    """Compile the libraries of `names` (default: all) that are missing,
    one `nvcc` per source, all at once. Returns {name: seconds} for the
    ones built (0.0 for those already present); with `verbose` the
    compiler's resource report (`-Xptxas -v`) is printed. Raises
    RuntimeError with the compiler's output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        if any(o == out for _, _, o in procs.values()):
            continue                    # its source is already building
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        for other in names:             # every kernel of the source
            if lib_path(other) == out:
                took[other] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(f"[{name}] {log.strip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for other, (src, argtypes) in KERNELS.items():
                if src == KERNELS[name][0]:
                    fn = getattr(lib, other)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                    _LIBS[other] = lib
    return _LIBS[name]
