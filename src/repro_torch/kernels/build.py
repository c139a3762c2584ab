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
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each C entry point: pointers and the stream as c_void_p.
SIGNATURES = {
    "noma_rates": {
        "noma_cell_intra": [_P] * 8 + [_I] * 8 + [_P],
        "noma_per_ap": [_P] * 4 + [_I] * 5 + [_P],
        "noma_ap_contract": [_P] * 4 + [_I] * 5 + [_P],
    },
}
# The last build's compiler log (ptxas register and shared-memory report)
# and wall seconds, per source, for chip_smoke.py to print.
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
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return out


@functools.cache
def load(name: str = "noma_rates") -> ctypes.CDLL:
    """The bound library for csrc/<name>.cu, built on first use."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
