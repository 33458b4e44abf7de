"""Share of the mean-shift steps launched in the window that the
batch-global tol exit needed: the counts `cluster/ms_steps_needed` over
`cluster/ms_steps_run` that `cluster_batch_finalize` records a batch, %."""
from portbench.program_trace import counts


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    run = sum(counts(t, "cluster/ms_steps_run"))
    if not run:
        return None
    return 100.0 * sum(counts(t, "cluster/ms_steps_needed")) / run
