"""Build and load the hand-written CUDA kernels under demo2_tpu_torch/csrc/.

The sources are compiled at first use with nvcc for Hopper (sm_90a) into one
shared library with a plain C interface, loaded with ctypes.  The library
lands in demo2_tpu_torch/_build/<hash of sources and flags>/, so a changed
source builds anew and an unchanged one loads at once.  Nothing here runs at
import time; a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("fused_attention_block.cu", "fused_mlp_block.cu")
HEADERS = ("gemm.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libdemo2_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "demo2_fused_attention_block": [_P] * 11 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_fused_mlp_block": [_P] * 10 + [_I] * 3 + [_P],
    "demo2_attention_head_dim": [],
    "demo2_attention_max_seq": [],
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    build_log: str        # nvcc / ptxas -v output of the build


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then /usr/local/cuda, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the CUDA kernels of demo2_tpu_torch cannot be built"
    )


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> tuple[float, str]:
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp_", suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
           *(str(CSRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, out_dir / LIB_NAME)  # atomic: two processes building at once both succeed
    return seconds, log


@functools.cache
def kernel_library() -> KernelLibrary:
    """The kernel library, built on the first call of the process if needed."""
    out_dir = BUILD_DIR / source_hash()
    path = out_dir / LIB_NAME
    if path.is_file():
        seconds, log = 0.0, (out_dir / "build.log").read_text()
    else:
        seconds, log = _build(out_dir)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.demo2_error_string.argtypes = [_I]
    lib.demo2_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds, build_log=log)


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error from its launches."""
    if err != 0:
        name = kernel_library().lib.demo2_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
