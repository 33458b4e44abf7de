"""ctypes binding to the native preprocessing library (`native/preprocess.cpp`),
the port's counterpart of `sednet_tpu/data/native.py`.

The library fuses mean-centre -> max-extent normalise -> augment -> PCA
alignment for each item of a batch on a C++ thread pool, and writes the
txt dumps in one formatted buffer (`savetxt_fast`). It is compiled from the
repository's source with g++ at first use into the port's own directory,
`build/sednet_tpu_torch/native/<hash>/`, keyed on the source and the flags;
nothing is written into `native/`.

Where the JAX package silently takes numpy when its library is missing,
a caller here asks for the native route by calling these functions (or
`use_native=True` in the datasets), and they raise when the library cannot
be built. The numpy route stays the default elsewhere; it gives the same
bytes (`savetxt_fast` formats floats from float32, as np.savetxt of the
float32 array does).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "preprocess.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build" / "sednet_tpu_torch"
              / "native")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")

_lib = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsednet_preprocess.so"


def build() -> Path:
    """Compile the library (if this source and these flags are not built
    yet) and return its path. Raises RuntimeError with the compiler's
    output when g++ is missing or fails."""
    path = _so_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("native preprocessing: no C++ compiler (g++) to "
                           f"build {SOURCE}")
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        out = Path(tmp) / path.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE),
                               "-lpthread"], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native preprocessing: g++ failed on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(out, path)   # atomic for concurrent builds
    return path


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        handle.sednet_preprocess_batch.argtypes = [
            f32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int]
        handle.sednet_preprocess_batch.restype = None
        handle.sednet_dump_f32.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char, ctypes.c_int]
        handle.sednet_dump_f32.restype = ctypes.c_int
        handle.sednet_dump_i64.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_char]
        handle.sednet_dump_i64.restype = ctypes.c_int
        _lib = handle
    return _lib


def available() -> bool:
    """Whether the library is built or can be built here."""
    try:
        lib()
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return False
    return True


def preprocess_batch(points: np.ndarray, normals: np.ndarray | None, *,
                     augment: bool = False, seed: int = 0, threads: int = 8):
    """Fused preprocessing of (B, N, 3) float32 arrays, in place on
    contiguous float32 copies. Returns (points, normals)."""
    handle = lib()
    f32p = ctypes.POINTER(ctypes.c_float)
    points = np.ascontiguousarray(points, np.float32)
    b, n, _ = points.shape
    if normals is not None:
        normals = np.ascontiguousarray(normals, np.float32)
        nrm_ptr = normals.ctypes.data_as(f32p)
    else:
        nrm_ptr = f32p()
    handle.sednet_preprocess_batch(points.ctypes.data_as(f32p), nrm_ptr, b, n,
                                   int(augment), seed, threads)
    return points, normals


def savetxt_fast(path: str, arr: np.ndarray, *, fmt: str = "%0.4f",
                 delimiter: str = " ") -> None:
    """np.savetxt for the dump vocabulary, formatted in C++ and written in
    one call: "%d" (int64 values) and "%0.<k>f" / "%.<k>f" (float32
    values, the bytes np.savetxt writes for the float32 array), a
    one-character delimiter, 1-d or 2-d arrays. Raises ValueError on
    another format and RuntimeError when the write fails."""
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[:, None]
    if a.ndim != 2 or len(delimiter) != 1:
        raise ValueError("savetxt_fast: a 1-d or 2-d array and a "
                         "one-character delimiter")
    handle = lib()
    d = delimiter.encode()
    if fmt == "%d":
        ai = np.ascontiguousarray(a, np.int64)
        rc = handle.sednet_dump_i64(
            path.encode(), ai.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ai.shape[0], ai.shape[1], d)
    else:
        # the dot is required: "%04f" is a width, not a precision
        m = re.fullmatch(r"%0?\.(\d+)f", fmt)
        if m is None:
            raise ValueError(f"savetxt_fast: format {fmt!r} is neither %d "
                             "nor %0.<k>f")
        af = np.ascontiguousarray(a, np.float32)
        rc = handle.sednet_dump_f32(
            path.encode(), af.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            af.shape[0], af.shape[1], d, int(m.group(1)))
    if rc != 0:
        raise RuntimeError(f"savetxt_fast: writing {path} failed")
