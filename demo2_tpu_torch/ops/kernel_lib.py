"""Build and load the hand-written CUDA kernels under demo2_tpu_torch/csrc/.

The sources are compiled at first use with nvcc for Hopper (sm_90a), one
nvcc process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes.  The library
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
SOURCES = ("fused_attention_block.cu", "fused_mlp_block.cu", "attention_bwd.cu",
           "packed_attention.cu", "packed_attention_wide.cu", "flash_attention.cu",
           "layernorm_bwd.cu", "jaccard_min_sum.cu", "attention_ablate.cu")
HEADERS = ("gemm.cuh", "gemm_sm90.cuh", "attention_fwd.cuh", "attention_regs_fwd.cuh",
           "attention_regs_bwd.cuh", "attention_wide.cuh", "attention_wide_block.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libdemo2_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "demo2_fused_attention_block": [_P] * 11 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_fused_attention_block_train": [_P] * 12 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_fused_attention_block_wide": [_P] * 11 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_fused_attention_block_train_wide": [_P] * 12 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_attention_bwd_saved_db": [_P] * 6 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_attention_bwd_saved": [_P] * 4 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_attention_bwd_saved_db_wide": [_P] * 6 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_attention_bwd_saved_wide": [_P] * 4 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_attention_bwd_fused_dw": [_P] * 11 + [_I] * 5 + [ctypes.c_float, _P],
    "demo2_fused_mlp_block": [_P] * 10 + [_I] * 3 + [_P],
    "demo2_fused_mlp_block_train": [_P] * 11 + [_I] * 3 + [_P],
    "demo2_packed_attention": [_P] * 2 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_packed_attention_bwd": [_P] * 3 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_packed_attention_wide": [_P] * 2 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_packed_attention_wide_bwd": [_P] * 3 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_packed_attention_wide_max_seq": [],
    "demo2_packed_attention_wide_takes_head": [_I],
    "demo2_flash_attention": [_P] * 4 + [_I] * 3 + [ctypes.c_float, _P],
    "demo2_flash_attention_bwd": [_P] * 7 + [_I] * 3 + [ctypes.c_float, _P],
    "demo2_layernorm_bwd": [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P],
    "demo2_jaccard_min_sum": [_P] * 4 + [_I] * 3 + [_P],
    "demo2_jaccard_tile": [],
    "demo2_attention_ablate": [_P] * 2 + [_I] * 6 + [_P],
    "demo2_attention_head_dim": [],
    "demo2_attention_max_seq": [],
    "demo2_block_attention_max_seq": [],
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
    work = Path(tempfile.mkdtemp(prefix=".tmp_", dir=out_dir))
    t0 = time.perf_counter()
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(work / f"{src}.o"),
             str(CSRC_DIR / src)] for src in SOURCES]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
            str(work / LIB_NAME), *(str(work / f"{src}.o") for src in SOURCES)]
    failed = [c for c, proc in zip(cmds, procs) if proc.returncode != 0]
    if not failed:
        linked = subprocess.run(link, capture_output=True, text=True)
        outs.append(linked.stdout + linked.stderr)
        if linked.returncode != 0:
            failed.append(link)
    seconds = time.perf_counter() - t0
    log = "".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds + [link], outs))
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed ({' '.join(failed[0])}):\n{log}")
    (out_dir / "build.log").write_text(log)
    os.replace(work / LIB_NAME, out_dir / LIB_NAME)  # atomic: concurrent builds both succeed
    shutil.rmtree(work, ignore_errors=True)
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


def expect(t, name: str, shape, dtype, device) -> None:
    """Raise unless `t` is what a kernel takes: device, dtype, shape, and
    contiguous 16-byte aligned storage."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel runs on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
