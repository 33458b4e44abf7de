"""Process groups over cards: batch data parallelism and the point axis.

Counterpart of `sednet_tpu/parallel/mesh.py`. Where JAX builds a 1-D
device mesh inside one process, the port runs one process a card (or, on
the CPU, a process a rank) in an explicit `torch.distributed` process
group: NCCL between cards, gloo on the CPU, started from a `FileStore` in
a directory every rank can read, so that no rank opens a network socket.
`Mesh` carries the group, the rank, the world size and the rank's device:

  * `shard_batch` is a rank's slice of the batch axis (JAX's data
    sharding), `replicate` a broadcast of rank 0's parameters (JAX's
    replicated sharding);
  * `spawn` starts the ranks of a mesh as processes and returns rank 0's
    result, killing every child when one fails or the time runs out.
"""
from __future__ import annotations

import importlib
import os
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from sednet_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this process's rank of `size` in `group` (None: the
    default group), on `device`."""
    rank: int
    size: int
    device: torch.device
    group: object = None


def init_mesh(rank: int, world_size: int, store_dir: str, device=None) -> Mesh:
    """Join the process group of `world_size` ranks as `rank`, through a
    FileStore under store_dir (no network). device None (or "cuda" without
    an index): card `rank`, and without CUDA it raises; "cpu" runs the
    rank on the CPU. NCCL on a card, gloo on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world_size)
    return Mesh(rank, world_size, device)


def make_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the initialised default process group (JAX's
    `make_mesh`): num_devices, where given, must be its world size. device
    None: the current card, and without CUDA it raises; "cpu" for a gloo
    group on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks "
                           "with parallel.spawn or init_mesh")
    size = dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"make_mesh: {num_devices} devices asked for, the "
                         f"process group has {size}")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.get_rank(), size, device)


# The collectives the helpers below have issued, by kind: a one-rank
# group runs each one too (a copy), so a caller can tell a sharded path
# from the one-process code it equals.
COLLECTIVES = {"broadcast": 0, "all_gather": 0, "all_reduce": 0,
               "all_gather_object": 0}


def _collective(kind: str):
    COLLECTIVES[kind] += 1


def check_divisible(b: int, mesh_size: int, what: str = "batch_size"):
    """JAX's error for a batch the mesh does not divide."""
    if b % mesh_size:
        raise ValueError(f"{what} {b} not divisible by mesh size {mesh_size}")


def local_rows(n: int, mesh: Mesh) -> slice:
    """The rows of an axis of n that `mesh.rank` holds (n divisible)."""
    check_divisible(n, mesh.size, "N")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch, mesh: Mesh):
    """This rank's shapes of a dict of (B, ...) arrays or tensors (B
    divisible by the mesh size), tensors moved to the rank's device."""
    b = next(iter(batch.values())).shape[0]
    check_divisible(b, mesh.size)
    sl = local_rows(b, mesh)

    def take(v):
        v = v[sl]
        return v.to(mesh.device) if isinstance(v, torch.Tensor) else v

    return {k: take(v) for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of `module` set to rank 0's, in place
    (one broadcast of them flattened together). Returns the module."""
    tensors = list(module.parameters()) + list(module.buffers())
    if not tensors:
        return module
    # one tensor of their promoted dtype (float32 for a float32 model)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _collective("broadcast")
    dist.broadcast(flat, 0, group=mesh.group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return module


def all_gather_rows(t, mesh: Mesh):
    """The rank-ordered concatenation of every rank's t along axis 0 (each
    rank's t of the same shape), no gradient."""
    _collective("all_gather")
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts, 0)


def all_gather_into(t, mesh: Mesh, dim: int = 0):
    """`all_gather_rows` along `dim` with this rank's own part left as t
    itself, so that a gradient of the whole flows into t (and only into
    t: the other ranks' parts are constants here)."""
    _collective("all_gather")
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=mesh.group)
    parts[mesh.rank] = t
    return torch.cat(parts, dim)


def all_reduce_sum(t, mesh: Mesh):
    """t summed over the ranks (in place and returned)."""
    _collective("all_reduce")
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_max(t, mesh: Mesh):
    _collective("all_reduce")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t


def gather_objects(obj, mesh: Mesh):
    """Every rank's picklable obj, in rank order, on every rank."""
    _collective("all_gather_object")
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


@torch.no_grad()
def all_reduce_grads(params, mesh: Mesh):
    """Sum the gradients of `params` over the ranks: one all-reduce of
    them flattened in parameter order, so that every run adds the same
    numbers in the same order (the same bits on gloo)."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    _collective("all_reduce")
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].reshape(g.shape))
        off += g.numel()


def _to_host(obj):
    """Tensors in obj as numpy arrays (what crosses the process queue)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _child(rank, world_size, store_dir, target, args, device, threads,
           results):
    try:
        if device == "cpu":
            # ranks on the host's cores share out the caller's threads
            torch.set_num_threads(threads)
        mod, name = target.split(":")
        fn = getattr(importlib.import_module(mod), name)
        mesh = init_mesh(rank, world_size, store_dir,
                         torch.device(device, rank) if device == "cuda"
                         else device)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", _to_host(out) if rank == 0 else None))
    except BaseException:   # the parent reports it and stops the others
        results.put((rank, "error", traceback.format_exc()))


def spawn(target: str, world_size: int, *args, device=None,
          timeout: float = 600.0):
    """Run `target` ("module:function", called as fn(mesh, *args)) on a
    mesh of `world_size` new processes (device None: card r for rank r,
    and without CUDA it raises before starting any; "cpu": gloo ranks on
    the CPU, each taking an equal share of this process's torch threads) and
    return rank 0's result, its tensors as numpy arrays. Raises
    RuntimeError with the failing rank's traceback; kills every child when
    one fails or after `timeout` seconds."""
    device = resolve_device(device).type
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="sednet_mesh_") as store_dir:
        threads = max(1, torch.get_num_threads() // world_size)
        procs = [ctx.Process(target=_child, args=(
            r, world_size, store_dir, target, args, device, threads,
            results), daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        out, done = None, 0
        try:
            deadline = time.monotonic() + timeout
            while done < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: {target} on {world_size} "
                                       f"ranks exceeded {timeout} s")
                try:
                    rank, status, value = results.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    dead = [p for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"spawn: a rank of {target} died (exit "
                            f"{dead[0].exitcode})")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {target}:\n{value}")
                done += 1
                if rank == 0:
                    out = value
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return out
