"""Dataset loaders for the two h5 schemas and the batch loaders.

A copy of `sednet_tpu/data/datasets.py` (`_H5Dataset`, `ParseNetDataset`,
`EdgeDataset`, `MixedDataset`, `BatchLoader`, `PrefetchLoader`). Items take
the numpy route by default; `use_native=True` takes the C++ preprocessing
of `data/native.py` for items without an edge cloud, as the JAX package
does, and raises where that library cannot be built (JAX silently takes
numpy there).

Reference schemas:
  * ParseNet: data_parsenet/{train,test}_data.h5 with keys points/labels/
    normals/prim (reference: src/dataset_segments.py:362-375).
  * SED-Net edge set: data/{train,test}_data_withEdge.h5 (same keys) plus
    data/{split}_My_Edge.h5 with keys label (per-point edge 0/1) and W
    (per-point BCE weight) (reference: src/dataset_segments_my.py:385-416).

Per-item pipeline: mean-centre (at load) -> max-extent normalise ->
[train] augment -> PCA canonical alignment -> optional noise
(reference: src/dataset_segments.py:390-463).

Each item is a dict of numpy arrays: points (N,3) f32, normals (N,3) f32,
labels (N,) i32 canonical instance ids, prim (N,) i32 raw type labels,
edges (N,) i32, edges_w (N,) f32. Datasets without edge supervision return
zero edges/edges_w (reference: dataset_segments.py:458-459).

Reading an h5 file needs `h5py`, imported where a file is read, so that
the package imports without it; `_H5Dataset` takes arrays in memory.
"""
from __future__ import annotations

import os
import time
from typing import Iterator, Sequence

import numpy as np

from sednet_tpu_torch.data.augment import (Augmentor, along_normal_noise,
                                           gaussian_noise)
from sednet_tpu_torch.data.geometry import EPS, pca_align
from sednet_tpu_torch.data.labels import canonicalize_instance_labels
from sednet_tpu_torch.utils.tracing import count, span


class _H5Dataset:
    """Shared per-item pipeline over in-memory arrays."""

    def __init__(self, points, labels, normals, prim, edges=None, edges_w=None,
                 edges1w=None, *, train=False, augment=True, noise=False,
                 noise_level=0, num_points=10000, max_segments=50, seed=0,
                 use_native=False):
        self.points = points.astype(np.float32)
        means = self.points.mean(1, keepdims=True)
        self.points -= means
        # the optional "edge" channel is a separate edge cloud, centred
        # with the same per-shape mean as the points
        # (reference: src/dataset_segments_my.py:395-410)
        self.edges1w = (None if edges1w is None
                        else edges1w.astype(np.float32) - means)
        self.labels = labels
        self.normals = None if normals is None else normals.astype(np.float32)
        self.prim = prim
        self.edges = edges
        self.edges_w = edges_w
        self.train = train
        self.augment = augment and train
        self.noise = noise
        self.noise_level = noise_level
        self.num_points = num_points
        self.max_segments = max_segments
        self.rng = np.random.RandomState(seed)
        self.augmentor = Augmentor(self.rng)
        self.use_native = use_native
        if use_native:
            from sednet_tpu_torch.data import native

            native.lib()   # raises where the library cannot be built

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, index: int) -> dict:
        pts = self.points[index].copy()
        nrm = None if self.normals is None else self.normals[index].copy()
        e1w = (None if self.edges1w is None
               else self.edges1w[index].copy())
        if self.use_native and e1w is None:
            # the fused C++ route: normalise, augment, PCA align
            from sednet_tpu_torch.data import native

            p, n2 = native.preprocess_batch(
                pts[None], None if nrm is None else nrm[None],
                augment=self.augment,
                seed=int(self.rng.randint(0, 2 ** 31)), threads=1)
            pts, nrm = p[0], None if n2 is None else n2[0]
        else:
            extent = pts.max(0) - pts.min(0)
            pts = pts / (extent.max() + EPS)
            if e1w is not None:
                # the edge cloud rides the same frame as the points:
                # extent scale, augmentation draws and PCA rotation
                # (reference: src/dataset_segments_my.py:430-462)
                e1w = e1w / (extent.max() + EPS)
            if self.augment:
                if e1w is not None:
                    pts, nrm, e1w = self.augmentor(pts, nrm, e1w)
                else:
                    pts, nrm = self.augmentor(pts, nrm)
            pts, nrm, r = pca_align(pts, nrm)
            if e1w is not None:
                e1w = (e1w @ r.T).astype(np.float32)

        if self.noise:
            if self.noise_level == -1:
                pts, nrm = along_normal_noise(pts, nrm, self.rng)
            else:
                pts = gaussian_noise(pts, self.noise_level, self.rng)

        n = pts.shape[0]
        item = {
            "points": pts.astype(np.float32),
            "normals": (np.zeros((n, 3), np.float32) if nrm is None
                        else nrm.astype(np.float32)),
            "labels": canonicalize_instance_labels(
                self.labels[index], self.max_segments),
            "prim": self.prim[index].astype(np.int32),
            "edges": (np.zeros((n,), np.int32) if self.edges is None
                      else self.edges[index].astype(np.int32)),
            "edges_w": (np.zeros((n,), np.float32) if self.edges_w is None
                        else self.edges_w[index].astype(np.float32)),
        }
        if self.train and self.num_points < n:
            sel = self.rng.permutation(n)[: self.num_points]
            item = {k: v[sel] for k, v in item.items()}
        elif self.train:
            sel = self.rng.permutation(n)
            item = {k: v[sel] for k, v in item.items()}
        if e1w is not None:
            # a separate cloud: its rows are not the shape's points, so the
            # per-point shuffle leaves it alone
            item["edges1w"] = e1w
        return item


def _h5_arrays(path: str, keys: Sequence[str]):
    import h5py

    with h5py.File(path, "r") as hf:
        return [np.array(hf.get(k)) if hf.get(k) is not None else None
                for k in keys]


class ParseNetDataset(_H5Dataset):
    """data_parsenet/{split}_data.h5 (reference: src/dataset_segments.py:331)."""

    def __init__(self, prefix: str, *, train: bool, normals: bool = True,
                 **kw):
        split = "train" if train else "test"
        path = os.path.join(prefix, "data_parsenet", f"{split}_data.h5")
        pts, labels, nrm, prim = _h5_arrays(
            path, ["points", "labels", "normals", "prim"])
        super().__init__(pts, labels, nrm if normals else None, prim,
                         train=train, **kw)


class EdgeDataset(_H5Dataset):
    """data/{split}_data_withEdge.h5 + data/{split}_My_Edge.h5
    (reference: src/dataset_segments_my.py:360). ret_edges1w also loads
    the optional "edge" edge-cloud channel (reference :394-397,409-410)."""

    def __init__(self, prefix: str, *, train: bool, normals: bool = True,
                 ret_edges1w: bool = False, **kw):
        split = "train" if train else "test"
        path = os.path.join(prefix, "data", f"{split}_data_withEdge.h5")
        keys = ["points", "labels", "normals", "prim"]
        if ret_edges1w:
            keys.append("edge")
        arrays = _h5_arrays(path, keys)
        pts, labels, nrm, prim = arrays[:4]
        edges1w = arrays[4] if ret_edges1w else None
        # the test split may lack its edge labels (zero placeholders on an
        # eval-only machine); a train split without them fails loudly
        edge_path = os.path.join(prefix, "data", f"{split}_My_Edge.h5")
        if os.path.exists(edge_path) or train:
            edges, edges_w = _h5_arrays(edge_path, ["label", "W"])
        else:
            edges = edges_w = None
        super().__init__(pts, labels, nrm if normals else None, prim,
                         edges=edges, edges_w=edges_w, edges1w=edges1w,
                         train=train, **kw)


class MixedDataset:
    """Index concatenation (reference: src/dataset_mix.py:9-24)."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def __len__(self):
        return len(self.first) + len(self.second)

    def __getitem__(self, index: int) -> dict:
        if index < len(self.first):
            return self.first[index]
        return self.second[index - len(self.first)]


class BatchLoader:
    """Batch iterator producing stacked numpy dicts, shuffled or in order
    (reference: the DataLoader of train_sed_net.py:185-187)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, starts: int = 0):
        """starts: skip the first `starts` items (sequential eval resume,
        reference: generate_predictions_aug.py:69,176)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.starts = starts
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset) - self.starts
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(self.starts, len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start: start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            items = [self.dataset[int(i)] for i in idx]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class PrefetchLoader:
    """Background-thread prefetch around any batch iterable, the host-side
    counterpart of the reference's DataLoader(num_workers=8,
    persistent_workers=True) (reference: train_sed_net.py:185-187): batch
    assembly (h5 reads, augmentation, PCA alignment) overlaps the step.
    Order-preserving; `depth` batches at most wait in the queue.

    The consumer's wait on the queue is the span `data/prefetch_wait`;
    the worker times each batch's assembly, and the consumer records it
    as the count `data/assemble_us` when it takes the batch (a profiler
    does not see the worker's thread)."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        err: list = []
        stop = threading.Event()

        def put(item):
            # a bounded put that re-checks stop: a consumer that abandons
            # the iteration (train hitting max_steps) must not leave this
            # thread blocked on a full queue, holding `depth` batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                batches = iter(self.loader)
                while True:
                    t0 = time.perf_counter()
                    batch = next(batches, end)
                    if batch is end:
                        return
                    if not put((batch, time.perf_counter() - t0)):
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                with span("data/prefetch_wait"):
                    item = q.get()
                if item is end:
                    break
                batch, seconds = item
                count("data/assemble_us", seconds * 1e6)
                yield batch
            t.join()
            if err:
                raise err[0]
        finally:
            stop.set()
