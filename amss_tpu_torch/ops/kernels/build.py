"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All ``csrc/*.cu`` files are compiled in one ``nvcc`` command into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds).  The library lands in ``build/amss_tpu_torch/<hash>/`` under the
repository root, keyed by a hash of the sources (``*.cu`` and the ``*.cuh``
they include) and flags, and is built at first use, with the compiler's
report (``-Xptxas=-v``: registers and spills) kept beside it as ``nvcc.log``.
Every C entry point returns ``cudaGetLastError()`` after its launch.

``build_native`` compiles the host batch fill (``csrc/amss_data.cc``) with
``g++`` into ``build/amss_tpu_torch/native-<hash>/``, apart from the ``nvcc``
build, so that a machine without a card builds it too.
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

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "amss_tpu_torch"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers and the stream as void*, ints as
# int, floats as float)
SIGNATURES = {
    # x, basis, out, batch, t, win, hop, k, nf, stream
    "amss_framed_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # codes, basis, out, batch, nf, k, win, hop, length, stream
    "amss_decode_ola": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # plan, pointers, partials, tensors, chunks, stream
    "amss_multi_adam_norm": [_P, _P, _P, _I, _I, _P],
    # plan, pointers, partials, tensors, chunks, max_norm, 1 - b1, b1, 1 - b2, b2,
    # 1 / bc1, 1 / bc2, eps, -lr, stream
    "amss_multi_adam_update": [_P, _P, _P, _I, _I, *[_F] * 9, _P],
}


def find_nvcc() -> str:
    """``nvcc`` from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built with it at first use"
    )


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(src.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(src: Path = CSRC) -> tuple[Path, float, str]:
    """Compile the ``*.cu`` files of ``src`` unless this source hash is built
    already.

    Returns (library path, seconds spent compiling, compiler output)."""
    src = Path(src)
    out_dir = BUILD_ROOT / _digest(src)
    lib = out_dir / "libamss_kernels.so"
    log_path = out_dir / "nvcc.log"
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libamss_kernels.{os.getpid()}.so"
    cmd = [nvcc, *FLAGS, "-o", str(tmp), *map(str, sorted(src.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, seconds, log


NATIVE_SRC = CSRC / "amss_data.cc"
NATIVE_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]


def build_native(src: Path = NATIVE_SRC) -> tuple[Path, float]:
    """Compile the host library ``src`` with ``g++`` unless this source hash
    is built already; returns (library path, seconds spent compiling).  A
    missing compiler or a failed build raises with the compiler's output."""
    src = Path(src)
    h = hashlib.sha256(" ".join(NATIVE_FLAGS).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{src.stem}.so"
    if lib.exists():
        return lib, 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH; {src.name} is built with it at first use")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{src.stem}.{os.getpid()}.so"
    cmd = [gxx, *NATIVE_FLAGS, str(src), "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and set its entry points' signatures."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.amss_error_string.argtypes = [ctypes.c_int]
    lib.amss_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with its signatures set."""
    return open_library(build()[0])


def c_ints(*vals: int) -> tuple[int, ...]:
    """The sizes a C entry point takes as ``int``: raise rather than wrap."""
    if any(not 0 <= v < 2**31 for v in vals):
        raise ValueError(f"kernel sizes must fit a 32-bit int, got {vals}")
    return vals


def check_device(device: torch.device, name: str) -> None:
    """A kernel wrapper runs its plain version on the CPU and its kernel on
    CUDA; it raises for any other device, and for CUDA without a card."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} got a CUDA tensor but CUDA is not available")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {device}")


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.amss_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
