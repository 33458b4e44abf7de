"""Share of the LOBPCG iterations in the window that ran as CUDA-graph
replays: the counts `lobpcg/replayed` that `cluster.lobpcg.lobpcg_standard`
records a solve over the counts `lobpcg/iterations` that
`cluster.spectral.top_eigvecs` records, %. None where the program records
no `lobpcg/replayed`."""
from portbench.program_trace import counts


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    replayed = counts(t, "lobpcg/replayed")
    run = sum(counts(t, "lobpcg/iterations"))
    if not replayed or not run:
        return None
    return 100.0 * sum(replayed) / run
