"""Host milliseconds a batch in `predict_shapes/lobpcg`, the spectral
solve that reads back to the host."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx["pulled"] or not t.count("predict_shapes/lobpcg"):
        return None
    return 1000.0 * t.host_s("predict_shapes/lobpcg") / ctx["pulled"]
