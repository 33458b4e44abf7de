"""Milliseconds the prefetch worker takes to assemble a batch, the mean
of the count `data/assemble_us` that `PrefetchLoader` records as the
loop takes the batch."""
from portbench.program_trace import mean_count


def read(ctx):
    us = mean_count(ctx, "data/assemble_us")
    return None if us is None else us / 1000.0
