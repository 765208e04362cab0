"""ctypes bindings of the port's native data-loader core
(demo2_tpu_torch/native/dataloader.cpp; the counterpart of
demo2_tpu/data/native.py).

The C++ core decodes, resizes and augments a batch of JPEGs on a thread
pool.  Python decides every augmentation parameter (`sample_train_params`
draws them in TrainTransform's order), so the (seed, epoch) schedule is the
PIL path's; erase noise comes from the C++ side's own stream.

The library is built from the repo's source at first use, into
demo2_tpu_torch/_build/host-<hash>/, the hash over the source, the compile
command and what `-march=native` means on this machine, so a build made on
another CPU is never loaded.  The decoder is chosen there: libjpeg where its
header is installed, else nvJPEG from the CUDA toolkit (which decodes on the
GPU).  The JAX package's prebuilt native/libd2tloader.so is never loaded.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "dataloader.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libd2tloader.so"
DECODERS = ("libjpeg", "nvjpeg")  # d2t_decoder()'s 0 and 1


class TransformParams(ctypes.Structure):
    _fields_ = [
        ("flip", ctypes.c_int32),
        ("pad", ctypes.c_int32),
        ("crop_top", ctypes.c_int32),
        ("crop_left", ctypes.c_int32),
        ("erase", ctypes.c_int32),
        ("erase_top", ctypes.c_int32),
        ("erase_left", ctypes.c_int32),
        ("erase_h", ctypes.c_int32),
        ("erase_w", ctypes.c_int32),
        ("noise_seed", ctypes.c_uint64),
        ("crop_x0", ctypes.c_int32),
        ("crop_y0", ctypes.c_int32),
        ("crop_x1", ctypes.c_int32),
        ("crop_y1", ctypes.c_int32),
        ("interp", ctypes.c_int32),  # 0 = cubic (train), 1 = bilinear (eval)
    ]


INTERP_CUBIC = 0
INTERP_BILINEAR = 1


@dataclass
class NativeLibrary:
    lib: Optional[ctypes.CDLL]  # None where it could not be built
    path: Optional[Path]
    decoder: Optional[str]      # "libjpeg" or "nvjpeg"
    error: str = ""             # why it could not be built


def _run(cmd, **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, **kw)


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _has_libjpeg_header(cxx: str) -> bool:
    return _run([cxx, "-E", "-x", "c++", "-"], input="#include <cstdio>\n#include <jpeglib.h>\n"
                ).returncode == 0


def _build_command(cxx: str, out: Path) -> tuple[str, list]:
    """(decoder, the compile command); raises naming what is missing."""
    if _has_libjpeg_header(cxx):
        return "libjpeg", [cxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                           str(SOURCE), "-o", str(out), "-ljpeg", "-lpthread"]
    nvcc = _cuda_home() / "bin" / "nvcc"
    if (_cuda_home() / "include" / "nvjpeg.h").is_file() and nvcc.is_file():
        return "nvjpeg", [str(nvcc), "-O3", "-std=c++17", "-shared", "-Xcompiler",
                          "-fPIC,-march=native", "-DD2T_NVJPEG", str(SOURCE), "-o", str(out),
                          "-lnvjpeg", "-lpthread"]
    raise RuntimeError(
        f"no JPEG decoder to build the native loader with: libjpeg's header jpeglib.h is not "
        f"on {cxx}'s include path, and nvJPEG (nvjpeg.h, bin/nvcc) is not under "
        f"{_cuda_home()}")


def _march(cxx: str) -> str:
    """What -march=native resolves to here (the build's CPU)."""
    out = _run([cxx, "-march=native", "-Q", "--help=target"]).stdout
    return " ".join(line.split()[-1] for line in out.splitlines()
                    if line.strip().startswith("-march="))


@functools.cache
def native_library() -> NativeLibrary:
    """The loader library, built on the first call of the process if needed.
    A failed build is returned with its reason, not raised."""
    cxx = shutil.which("g++")
    if cxx is None:
        return NativeLibrary(None, None, None, "g++ not found on PATH")
    try:
        decoder, cmd = _build_command(cxx, Path("OUT"))
    except RuntimeError as e:
        return NativeLibrary(None, None, None, str(e))
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(cmd).encode())
    h.update(_march(cxx).encode())
    out_dir = BUILD_DIR / f"host-{h.hexdigest()[:16]}"
    path = out_dir / LIB_NAME
    if not path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(prefix=".tmp_", dir=out_dir))
        try:
            _, cmd = _build_command(cxx, work / LIB_NAME)
            done = _run(cmd)
            if done.returncode != 0:
                return NativeLibrary(None, None, decoder, f"building the native loader with "
                                     f"{decoder} failed ({' '.join(cmd)}):\n{done.stderr}")
            os.replace(work / LIB_NAME, path)  # atomic: concurrent builds both succeed
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(str(path))
    lib.d2t_load_batch.restype = ctypes.c_int
    lib.d2t_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(TransformParams), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.d2t_encode_jpeg.restype = ctypes.c_int
    lib.d2t_encode_jpeg.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    lib.d2t_decoder.restype = ctypes.c_int
    lib.d2t_decoder.argtypes = []
    return NativeLibrary(lib, path, DECODERS[lib.d2t_decoder()])


def native_available() -> bool:
    return native_library().lib is not None


def get_lib() -> ctypes.CDLL:
    """The loaded library; raises with the reason where it could not be built."""
    nl = native_library()
    if nl.lib is None:
        raise RuntimeError(f"native loader unavailable: {nl.error}")
    return nl.lib


def sample_train_params(
    rng: np.random.Generator,
    size,
    flip_prob: float = 0.5,
    padding: int = 10,
    re_prob: float = 0.5,
    strip: Optional[Sequence[int]] = None,
) -> TransformParams:
    """Draw augmentation parameters with the SAME rng consumption order as
    the PIL TrainTransform (data/transforms.py)."""
    h, w = size
    p = TransformParams()
    p.flip = 1 if rng.random() < flip_prob else 0
    p.pad = padding
    p.crop_top = int(rng.integers(0, 2 * padding + 1))
    p.crop_left = int(rng.integers(0, 2 * padding + 1))
    p.erase = 0
    if rng.random() <= re_prob:
        area = h * w
        log_ratio = (math.log(0.3), math.log(1.0 / 0.3))
        for _ in range(10):
            target = rng.uniform(0.02, 1.0 / 3.0) * area
            aspect = math.exp(rng.uniform(*log_ratio))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                p.erase = 1
                p.erase_top = int(rng.integers(0, h - eh + 1))
                p.erase_left = int(rng.integers(0, w - ew + 1))
                p.erase_h = eh
                p.erase_w = ew
                break
    p.noise_seed = int(rng.integers(0, 2 ** 63 - 1))
    if strip is not None:
        p.crop_x0, p.crop_y0, p.crop_x1, p.crop_y1 = strip
    return p


def eval_params(strip: Optional[Sequence[int]] = None,
                interp: int = INTERP_BILINEAR) -> TransformParams:
    """Identity-augmentation params, bilinear by default (EvalTransform's
    resize); INTERP_CUBIC for train-cache decodes (TrainTransform's)."""
    p = TransformParams()
    if strip is not None:
        p.crop_x0, p.crop_y0, p.crop_x1, p.crop_y1 = strip
    p.interp = interp
    return p


def load_batch_native(paths: List[str], params: List[TransformParams], out_h: int, out_w: int,
                      mean, std, num_threads: int = 4) -> np.ndarray:
    """Decode + transform a batch -> (N, out_h, out_w, 3) float32."""
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_params = (TransformParams * n)(*params)
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    failures = lib.d2t_load_batch(
        c_paths, c_params, n, out_h, out_w,
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if failures:
        raise IOError(f"native loader: {failures} image(s) failed to decode")
    return out


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """Write an (H, W, 3) uint8 array to a JPEG file.  Test support, not a
    feature of the loader: the tests and chip_smoke.py write JPEG trees with
    it where no PIL is installed."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_jpeg takes (H, W, 3) uint8, got {rgb.shape}")
    err = get_lib().d2t_encode_jpeg(path.encode(), rgb.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), rgb.shape[0], rgb.shape[1], int(quality))
    if err:
        raise IOError(f"native loader: cannot write {path}")
