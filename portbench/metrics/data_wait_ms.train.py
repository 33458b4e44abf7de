"""Host milliseconds a step that the train loop waits on the prefetch
queue, the span `data/prefetch_wait` of `PrefetchLoader`."""
from portbench.program_trace import host_s, ranges


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx["steps"] or not ranges(t, "data/prefetch_wait"):
        return None
    return 1000.0 * host_s(t, "data/prefetch_wait") / ctx["steps"]
