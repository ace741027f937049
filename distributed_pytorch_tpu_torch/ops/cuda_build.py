"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface, at first use, for `sm_90a` (Hopper), and loaded
with `ctypes` — no PyTorch headers in the sources, so a build takes
seconds, not the minutes `torch.utils.cpp_extension` needs. Libraries are
keyed by a hash of their sources and flags, under `build/torch_kernels/`
at the repo root (git-ignored); a stale key simply builds anew.
`build()` compiles every missing library at once, one `nvcc` process per
source, all started together.

Every C entry returns the launch's `cudaGetLastError()`; the wrappers in
ops/flash_decode.py raise when it is not 0.
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

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: kernel name -> (source file, C argument types); every entry returns int
KERNELS = {
    "paged_decode_attn": (
        "paged_decode_attn.cu",
        # dtype, q, k, v, tables, cache_len, out, B, nh, nkv, hs, bs,
        # n_max, scale, stream
        (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P)),
    "paged_prefill_attn": (
        "paged_prefill_attn.cu",
        # dtype, q, k, v, table, out, n_tok, nh, nkv, hs, bs, n_max, off,
        # scale, stream
        (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P)),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def lib_path(name: str) -> Path:
    """Where the library of `name` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted([KERNELS[name][0]] + [p.name for p in
                                          CSRC.glob("*.cuh")]):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
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
            fn = getattr(lib, name)
            fn.argtypes = list(KERNELS[name][1])
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]
