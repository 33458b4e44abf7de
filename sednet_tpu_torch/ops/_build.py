"""Build the CUDA kernels with nvcc and bind them with ctypes.

The sources in `sednet_tpu_torch/csrc/` are compiled at first use for
`sm_90a`, one nvcc process per source, all started together, then linked
into one shared library with a plain C interface. The library lands in
`build/sednet_tpu_torch/<hash>/` beside the package, keyed on a hash of the
files under `csrc/` (headers included) and the flags, so an unchanged
checkout builds once.

Every C entry point but the scratch-size queries (`_RESTYPES`,
`sednet_segsum_chunks`) returns a `cudaError_t` (0 on success); `check`
turns anything else into an exception.
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
SOURCES = ("colmax.cu", "errors.cu", "flash_topk.cu", "fused_edgeconv.cu",
           "gather_reduce.cu", "gather_reduce_bwd.cu", "mean_shift.cu",
           "mean_shift_bf16.cu", "segsum.cu")
# -fmad=false keeps every product and sum that the sources write apart
# as written (the dot products use explicit fmaf), so the arithmetic
# follows the plain PyTorch versions step for step.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "sednet_topk": (_P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _F, _I, _P, _L,
                    _P, _P, _P),
    "sednet_mean_shift_step": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    "sednet_mean_shift_step_bf16": (_P, _P, _P, _I, _I, _I, _P, _P),
    "sednet_colmax": (_P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P),
    "sednet_fused_edge_reductions": (_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _F, _P, _P, _P, _P, _P, _P, _P, _P),
    "sednet_gather_reduce": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "sednet_gather_reduce_backward": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _P, _P, _P, _P),
    "sednet_graph_transpose": (_P, _I, _I, _I, _P, _L, _P, _P, _P),
    "sednet_graph_transpose_scratch": (_L, _I),
    "sednet_segsum_sorted": (_P, _P, _I, _L, _I, _P, _P, _P, _P),
    "sednet_segsum_chunks": (_L,),
}
# entry points that return a size, not a cudaError_t
_RESTYPES = {"sednet_graph_transpose_scratch": ctypes.c_longlong}

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
    """Hash of the flags and of every file under csrc/, the headers that
    the sources include as well as the sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(path.relative_to(CSRC).as_posix().encode())
        h.update(path.read_bytes())
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
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
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


WIDTH_STEP, WIDTH_MAX = 32, 256   # row widths the kernels are compiled for
BF16_WIDTH_STEP = 16   # the bf16 mean-shift step's: wgmma is 16 deep


def pad_width(t, step: int = WIDTH_STEP):
    """t (..., E) zero-padded on its last axis to the next multiple of
    `step` (contiguous), as the row-width templates of the kernels take it
    (32; the bf16 mean-shift step 16); zero columns change neither a dot
    product nor a norm. Raises above 256."""
    import torch.nn.functional as F

    e = t.shape[-1]
    if not 1 <= e <= WIDTH_MAX:
        raise ValueError(f"row width {e} outside the kernels' [1, {WIDTH_MAX}]")
    ep = -(-e // step) * step
    return t if e == ep else F.pad(t, (0, ep - e)).contiguous()


def require_cuda_f32(name: str, t) -> None:
    """Raise unless `t` is a contiguous float32 CUDA tensor."""
    import torch

    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 CUDA tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def require_row_offsets(name: str, t) -> None:
    """Raise unless the rows of one shape of t (..., N, C) are addressed by
    32-bit offsets, N * C < 2^32, as K6's loop keeps them."""
    if t.shape[-2] * t.shape[-1] > 0xFFFFFFFF:
        raise ValueError(f"{name}: {t.shape[-2]} rows of width "
                         f"{t.shape[-1]} exceed 2^32 elements a shape")
