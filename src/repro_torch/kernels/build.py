"""Build the CUDA sources under kernels/csrc/ at first use and bind them.

Each source compiles with nvcc into a shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes seconds).
Libraries are cached under kernels/_build/ (listed in .gitignore), named by a
hash of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing is built at import time: the first wrapper
call on a CUDA tensor triggers the build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each C entry point: pointers and the stream as c_void_p.
SIGNATURES = {
    "noma_rates": {
        "noma_cell_intra": [_P] * 8 + [_I] * 8 + [_P],
        "noma_cell_intra_dense": [_P] * 6 + [_I] * 8 + [_P],
        "noma_per_ap": [_P] * 4 + [_I] * 8 + [_P],
        "noma_ap_contract": [_P] * 4 + [_I] * 6 + [_P],
    },
    "flash_attention": {
        "flash_attention": [_P] * 5 + [_I] * 9 + [_F, _I, _P],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd": [_P] * 10 + [_I] * 9 + [_F, _I, _P],
        "flash_attention_bwd_smem": [_I] * 3,
    },
    "rg_lru": {
        "rg_lru": [_P] * 4 + [_I] * 5 + [_P],
    },
    "rg_lru_bwd": {
        "rg_lru_bwd": [_P] * 7 + [_I] * 5 + [_P],
    },
}
# The compiler log (ptxas register and shared-memory report) and the wall
# seconds of each source's build, for chip_smoke.py to print; a library
# found already built reads its log back and reports 0 s.
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built from source at first use")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library for this source exists.
    Writes to a temporary file and renames, so concurrent processes never
    load a half-written library."""
    out = _library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        if name not in BUILD_INFO and log.exists():
            BUILD_INFO[name] = {"seconds": 0.0, "log": log.read_text()}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    log.write_text(BUILD_INFO[name]["log"])
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, Path]:
    """Build every source at once, one nvcc process each (they run in
    parallel threads), and return the libraries by name."""
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        return dict(zip(SIGNATURES, pool.map(build, SIGNATURES)))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The bound library for csrc/<name>.cu, built on first use."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


# -- launching through the bound libraries -------------------------------------
def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless t is a contiguous tensor of this dtype, shape and device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's data pointer for a C entry point; None is the null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")
