"""Profiling annotations and numeric guards.

Counterpart of `sednet_tpu/utils/tracing.py:23-66`. A pipeline stage wrapped
in `trace` is a `torch.profiler.record_function` range (visible in a
profile of the card, where its device time is attributed to it) and a
wall-clock stopwatch; `start_profile` / `stop_profile` bracket a
`torch.profiler` run that writes a Chrome trace; the finiteness guards make
silent numeric corruption loud. `kernel_launches` reads the launch counts
of the port's kernel wrappers, so that a process (the server) can report
which kernels its work went through.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict

import torch

logger = logging.getLogger("sednet_tpu_torch.trace")

_profile = None   # the torch.profiler run between start_ and stop_profile


@contextlib.contextmanager
def trace(name: str, timings: Dict[str, float] | None = None,
          log: bool = False):
    """torch.profiler.record_function(name) + wall clock. Accumulates the
    seconds into `timings[name]` when given. The wall clock reads the host:
    it includes the device's work only where the body waits for it."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    if timings is not None:
        timings[name] = timings.get(name, 0.0) + dt
    if log:
        logger.info("%s: %.1fms", name, dt * 1e3)


def start_profile(log_dir: str) -> None:
    """Start a torch.profiler run over the host and, where there is one,
    the card; `stop_profile` writes its Chrome trace under log_dir."""
    global _profile
    if _profile is not None:
        raise RuntimeError("a profile is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _profile = (prof, log_dir)


def stop_profile() -> str:
    """Stop the run of `start_profile` and write its Chrome trace; returns
    the trace's path."""
    global _profile
    if _profile is None:
        raise RuntimeError("no profile is running")
    prof, log_dir = _profile
    _profile = None
    prof.stop()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree, name: str = "tree") -> None:
    """Host-side NaN/Inf guard over nested dicts, lists and tuples of
    tensors (or numbers, or numpy arrays); raises FloatingPointError with
    the leaf's path and its nan and inf counts."""
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if not t.is_floating_point():
            continue
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"non-finite values in {name}{path}: "
                f"nan={int(torch.isnan(t).sum())}, "
                f"inf={int(torch.isinf(t).sum())}")


def debug_assert_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Log an error when x holds non-finite values; never raises. Unlike
    JAX's in-jit callback, this reads the count back to the host, so it
    waits for the device: keep it out of timed loops. Returns x."""
    count = int((~torch.isfinite(x)).sum())
    if count > 0:
        logger.error("non-finite values in %s: %d", name, count)
    return x


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count in this process, by the kernel's
    name (K1 ... K6b)."""
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.fused_edgeconv import fused_edge_reductions
    from sednet_tpu_torch.ops.graph import (gather_reduce,
                                            gather_reduce_backward)

    return {"K1": flash_topk.launches, "K2": ck.mean_shift_step.launches,
            "K2b": ck.mean_shift_step_batched.launches,
            "K3": ck.colmax.launches,
            "K4": fused_edge_reductions.launches,
            "K5": ck.segsum_sorted_scan.launches,
            "K6": gather_reduce.launches,
            "K6b": gather_reduce_backward.launches}
