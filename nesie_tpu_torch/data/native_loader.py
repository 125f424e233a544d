"""ctypes bridge to the native data-loading core (``native/dataio.cpp``,
a copy of ``nesie_tpu/native/dataio.cpp``).

The library is built on first use with ``g++`` into
``build/nesie_tpu_torch/`` at the root of the checkout, named by a hash of
the source, with the JAX package's flags, so that both libraries compute
the same bytes. ``load_scene_native`` returns ``None`` when the library
cannot be built or loaded, and the caller takes the Python pipeline.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "dataio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nesie_tpu_torch"
_CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_lib = None


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libdataio_{digest}.so"


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, path)  # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(path))
    lib.load_scene.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.load_scene.restype = ctypes.c_int
    lib.scene_num_points.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.scene_num_points.restype = ctypes.c_long
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def load_scene_native(path, axis_align, num_points: int, seed: int,
                      load_dim: int = 6):
    """One-pass load + align + height + sample -> (num_points, 4) float32.

    Returns None when the native library is unavailable (the caller falls
    back to the Python pipeline).
    """
    lib = _load_lib()
    if lib is None:
        return None
    out = np.empty((num_points, 4), np.float32)
    aam = None
    if axis_align is not None:
        aam_arr = np.ascontiguousarray(axis_align, np.float32).reshape(16)
        aam = aam_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.load_scene(
        str(path).encode(),
        load_dim,
        aam,
        num_points,
        ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise IOError(f"native load_scene({path}) failed with code {rc}")
    return out
