"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources in `sednet_tpu_torch/csrc/` are compiled at first use for
`sm_90a`, one nvcc process per source, all started together, then linked
into one shared library with a plain C interface. The library lands in
`build/sednet_tpu_torch/<hash>/` beside the package, keyed on a hash of the
sources and flags, so an unchanged checkout builds once.

Every C entry point returns a `cudaError_t` (0 on success); `check` turns
anything else into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sednet_tpu_torch"
SOURCES = ("colmax.cu", "errors.cu", "flash_topk.cu", "mean_shift.cu")
# -fmad=false keeps every product and sum that the sources write apart
# as written (the dot products use explicit fmaf), so the arithmetic
# follows the plain PyTorch versions step for step.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "sednet_topk": (_P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P),
    "sednet_mean_shift_step": (_P, _P, _P, _I, _I, _P, _P),
    "sednet_colmax": (_P, _P, _P, _I, _I, _F, _F, _P, _P, _P),
}

_lib = None
build_info: dict = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this hash is not built yet) and return the
    path of the shared library. Raises with nvcc's output on failure."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libsednet_kernels.so"
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        log = out_dir / "build.log"
        build_info.setdefault("log", log.read_text() if log.exists() else "")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [exe, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs = [], []
        for name, obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                for _, _, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
            objs.append(str(obj))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [exe, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic for concurrent builds
    build_info["seconds"] = time.time() - t0
    build_info["log"] = "\n".join(logs)
    (out_dir / "build.log").write_text(build_info["log"])
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        handle.sednet_error_string.argtypes = [ctypes.c_int]
        handle.sednet_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().sednet_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_f32(name: str, t) -> None:
    """Raise unless `t` is a contiguous float32 CUDA tensor."""
    import torch

    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 CUDA tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
