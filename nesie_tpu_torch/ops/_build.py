"""Build and bind the port's CUDA kernels.

The sources under ``nesie_tpu_torch/csrc/`` are compiled on first use with
``nvcc`` into one shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/nesie_tpu_torch/`` at the root of
the checkout, named by a hash of the sources, so an edit rebuilds it and an
unchanged tree reuses it. Each C entry point takes device pointers, sizes
and a stream, launches on that stream and returns ``cudaGetLastError()``.

Every wrapper counts its launches in ``_LAUNCHES``: one per kernel launch,
and nowhere else, so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nesie_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: argtypes (every entry point returns a cudaError_t as int)
    "nesie_fps": [_P, _I, _I, _I, _P, _P, _P],
    "nesie_ball_query": [_P, _P, _I, _I, _I, _I, _F, _F, _P, _P],
    "nesie_three_nn": [_P, _P, _I, _I, _I, _P, _P],
}

KERNELS = ("fps", "ball_query", "three_nn")
_LAUNCHES = dict.fromkeys(KERNELS, 0)

_lib = None
build_seconds = None  # wall time of the nvcc build in this process, if any


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cu*")):  # the .cu files and headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libnesie_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, entry: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a launch
    error and count the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    _LAUNCHES[kernel] += 1


def check_cuda_input(name: str, t: torch.Tensor) -> None:
    """Every kernel takes contiguous (B, n, 3) float32 coordinates on the
    card; raise on anything else."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name} has shape {tuple(t.shape)}; the kernel "
                         "takes (B, n, 3)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
