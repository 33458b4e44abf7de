"""Iterations a LOBPCG solve took, the mean of the count
`lobpcg/iterations` that `cluster.spectral.top_eigvecs` records a solve."""
from portbench.program_trace import mean_count


def read(ctx):
    return mean_count(ctx, "lobpcg/iterations")
