"""Profiling annotations and numeric guards.

Counterpart of `sednet_tpu/utils/tracing.py:23-66`. A `span` is a
`torch.profiler.record_function` range, entered only while a profiler
runs on the calling thread: a profile of the card attributes the device
time (and the idle gaps) to it, and without a profiler it costs one flag
check. A `count` is a zero-length range named `name=value`, since the
Chrome export drops a range's arguments. Both are lost on a thread that
was started after the profiler, which does not profile it: a worker
hands its numbers to the thread that drives the work. `trace` adds a
wall-clock stopwatch to a span. The finiteness guards make silent
numeric corruption loud. `kernel_launches` reads the launch counts of
the port's kernel wrappers, so that a process (the server) can report
which kernels its work went through.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict

import torch

logger = logging.getLogger("sednet_tpu_torch.trace")

_OFF = contextlib.nullcontext()
# whether a profiler runs on the calling thread: the condition of `span`
# and `count`, and of any counting the program does only for them
tracing_on = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager: `torch.profiler.record_function(name)` while a
    profiler runs on this thread, else nothing."""
    if not tracing_on():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """While a profiler runs on this thread, a zero-length range named
    f"{name}={int(value)}"; else nothing."""
    if tracing_on():
        with torch.profiler.record_function(f"{name}={int(value)}"):
            pass


@contextlib.contextmanager
def trace(name: str, timings: Dict[str, float] | None = None,
          log: bool = False):
    """`span(name)` and, where `timings` is given or `log` set, a wall
    clock: accumulates the seconds into `timings[name]`. The wall clock
    reads the host: it includes the device's work only where the body
    waits for it."""
    if timings is None and not log:
        with span(name):
            yield
        return
    t0 = time.perf_counter()
    with span(name):
        yield
    dt = time.perf_counter() - t0
    if timings is not None:
        timings[name] = timings.get(name, 0.0) + dt
    if log:
        logger.info("%s: %.1fms", name, dt * 1e3)


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
    name (K1 ... K6b; K2 and K2b's bf16 kernel as "K2 bf16", "K2b bf16")."""
    from sednet_tpu_torch.ops import cuda_kernels as ck
    from sednet_tpu_torch.ops.flash_topk import flash_topk
    from sednet_tpu_torch.ops.fused_edgeconv import fused_edge_reductions
    from sednet_tpu_torch.ops.graph import (gather_reduce,
                                            gather_reduce_backward)

    return {"K1": flash_topk.launches, "K2": ck.mean_shift_step.launches,
            "K2b": ck.mean_shift_step_batched.launches,
            "K2 bf16": ck.mean_shift_step.launches_bf16,
            "K2b bf16": ck.mean_shift_step_batched.launches_bf16,
            "K3": ck.colmax.launches,
            "K4": fused_edge_reductions.launches,
            "K5": ck.segsum_sorted_scan.launches,
            "K6": gather_reduce.launches,
            "K6b": gather_reduce_backward.launches}
