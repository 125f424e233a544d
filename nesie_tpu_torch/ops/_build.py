"""Build and bind the port's CUDA kernels.

The sources under ``nesie_tpu_torch/csrc/`` make two shared libraries
(``LIBRARIES``): ``kernels``, the program's, which every eval, training
and serving path loads through ``library()``, and ``fps_lab``, the FPS
step-variant lab's (``ops.fps_variants``), built only when the lab is
called. Each is compiled on first use, one ``nvcc`` process per source,
all started together, and linked into a library with a plain C
interface, loaded with ``ctypes``. A library lands in
``build/nesie_tpu_torch/`` at the root of the checkout, named by a hash
of its own sources, the headers and the flags, so an edit rebuilds the
libraries it reaches and an unchanged tree reuses them. Each C entry
point takes device pointers, sizes and a stream, launches on that stream
and returns ``cudaGetLastError()``.

Every wrapper counts its launches as ``launch.<kernel>`` in the program's
counts (``utils.count``): one per entry-point call, and nowhere else, so
a run can show that it went through the kernels. An entry point launches
one kernel, but for ``nesie_sa_mlp``, whose one count stands for two
launches (``KERNELS``' note). ``launch_counts`` and
``reset_launch_counts`` read and clear those.
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

from nesie_tpu_torch import utils

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nesie_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

# each library and the csrc/*.cu it is built from; a source is in one
LIBRARIES = {
    "kernels": ("fps_onchip.cu", "ball_query.cu", "three_nn.cu",
                "decode_nms.cu", "sa_mlp.cu"),
    "fps_lab": ("fps_variants.cu",),
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # the program library's entry points: argtypes (every entry point
    # returns a cudaError_t as int)
    "nesie_fps_onchip": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "nesie_fps_onchip_plan": [_I, _I, _I, _I, _I, _I, _P],
    "nesie_fps_onchip_timed": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "nesie_ball_query": [_P, _P, _I, _I, _I, _I, _F, _F, _P, _P],
    "nesie_three_nn": [_P, _P, _I, _I, _I, _I, _P, _P],
    "nesie_three_nn_plan": [_I, _I, _I, _P],
    "nesie_decode_nms_counts": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P],
    "nesie_decode_nms_keep": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P],
    "nesie_sa_mlp": [_P, _L, _L, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _F,
                     _I, _I, _I, _I, _P, _P, _P, _P, _P],
}

# fps_onchip counts the batches of more than 16 rows, fps_onchip_small
# the others (ops.fps.fps_launch_name), fps_onchip_timed the
# instrumented kernel's launches; decode_nms counts both launches of the
# eval decode's keep mask (point counts, then NMS); fps_variant the FPS
# lab's (ops.fps_variants); sa_mlp an eval set abstraction's fused
# gather, MLP and pool (ops.sa_mlp): one a call, which is two launches on
# the stream, W1's padding and then the kernel
KERNELS = ("fps_onchip", "fps_onchip_small", "fps_onchip_timed",
           "ball_query", "three_nn", "fps_variant", "decode_nms", "sa_mlp")

_lib = None  # the program's library, once loaded
build_seconds = {}  # wall time of each library's nvcc build in this process


def reset_launch_counts() -> None:
    utils.reset_counts("launch.")


def launch_counts() -> dict:
    """Launches of each of ``KERNELS`` since the last reset."""
    done = utils.counts("launch.")
    return {name: done.get(f"launch.{name}", 0) for name in KERNELS}


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


def sources(lib: str = "kernels") -> list[Path]:
    return [_CSRC / name for name in LIBRARIES[lib]]


def library_path(lib: str = "kernels") -> Path:
    digest = hashlib.sha256()
    for src in sorted([*sources(lib), *_CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libnesie_{lib}_{digest.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs: list[tuple[list[str], subprocess.Popen]],
          verbose: bool) -> None:
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
        elif verbose and log.strip():
            print(log)
    if failed:
        raise RuntimeError("\n".join(failed))


def build(verbose: bool = False, lib: str = "kernels") -> Path:
    """Compile library ``lib`` unless one of the same sources exists: one
    ``nvcc -c`` per source in parallel, then one link."""
    out = library_path(lib)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    compiles, objects = [], []
    for src in sources(lib):
        obj = out.parent / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        compiles.append((cmd, _run(cmd)))
        objects.append(obj)
    _wait(compiles, verbose)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp),
            *map(str, objects)]
    _wait([(link, _run(link))], verbose)
    for obj in objects:
        obj.unlink()
    os.replace(tmp, out)
    build_seconds[lib] = time.perf_counter() - t0
    return out


def load(lib: str, signatures: dict) -> ctypes.CDLL:
    """Library ``lib``, built unless it exists, with the argtypes of
    ``signatures`` (entry point: argtypes) set and an int result."""
    handle = ctypes.CDLL(str(build(lib=lib)))
    for name, argtypes in signatures.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def library() -> ctypes.CDLL:
    """The program's kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = load("kernels", _SIGNATURES)
    return _lib


def launch(kernel: str, entry: str, *args, device: torch.device,
           lib: ctypes.CDLL | None = None) -> None:
    """Call one C entry point of ``lib`` (default: the program's library)
    with ``device`` (the inputs' card) current, on that card's current
    stream; raise on a launch error and count the launch. A process may
    hold tensors on a card other than its current one (a rank of a
    data-parallel run), and the kernel must land on the card its pointers
    belong to."""
    fn = getattr(library() if lib is None else lib, entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    utils.count(f"launch.{kernel}")


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
