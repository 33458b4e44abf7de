"""Kernels launched in the window per train step, a count of the host's
dispatch work."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx["steps"]:
        return None
    return t.launches() / ctx["steps"]
