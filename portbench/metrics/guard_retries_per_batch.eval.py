"""Attempts the mean-shift guard ran after the batch pass, a batch: the
count `cluster/guard_retries` that `cluster_batch_finalize` records a
batch, over the batches that recorded it."""
from portbench.program_trace import mean_count


def read(ctx):
    return mean_count(ctx, "cluster/guard_retries")
