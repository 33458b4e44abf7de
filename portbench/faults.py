"""Faults planted in the timed path, for the tests and for reading each
fault on the card (`control.py --faults`): the `correct` check has to come
out false under each fault the cell can have. TRAIN wraps the train
step, EVAL edits each completed eval batch's results, CLUSTER edits each
eval batch's clustering as it is launched, before its NMS."""
from __future__ import annotations


def unchanged(step):
    """A train step that returns its state unchanged: it runs, and every
    parameter it held is put back."""
    import torch

    def wrapped(batch, draws=None, generator=None):
        params = [p for c in step.__closure__ or ()
                  if isinstance(c.cell_contents, list)
                  for p in c.cell_contents if isinstance(p, torch.nn.Parameter)]
        before = [p.detach().clone() for p in params]
        m = step(batch, draws, generator)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return m
    return wrapped


def half_batch(step):
    """A train step that leaves out half of the batch and takes the mean
    over the rest."""
    def wrapped(batch, draws=None, generator=None):
        return step({k: v[: v.shape[0] // 2] for k, v in batch.items()},
                    draws, generator)
    return wrapped


def altered_labels(cap, j, results):
    """An answer altered where it is produced: a tenth of each cloud's
    points moved to another cluster in the eval's results."""
    for r in results:
        ids = r["cluster_ids"]
        n = ids.shape[0] // 10
        ids[:n] = (ids[:n] + 1) % (ids.max() + 1)


def unshifted_half(p):
    """Half of the batch left out of the shift: its clouds come back from
    the shift steps where they started, and go on to NMS and the metrics
    so."""
    b = p.shifted.shape[0]
    p.shifted[: max(b // 2, 1)].copy_(p.x[: max(b // 2, 1)])


def unshifted_cloud(p):
    """One cloud left out of the shift (the batch's last)."""
    p.shifted[-1].copy_(p.x[-1])


def unshifted_tail(p):
    """A tail tile of rows left out of the shift: every cloud's last 128
    points come back where they started."""
    p.shifted[:, -128:].copy_(p.x[:, -128:])


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
EVAL = {"altered_labels": altered_labels}
CLUSTER = {"unshifted_half": unshifted_half,
           "unshifted_cloud": unshifted_cloud,
           "unshifted_tail": unshifted_tail}
