"""Device milliseconds a batch of the kernels launched inside
`predict_shapes/type_forward` and `predict_shapes/inst_forward`."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx["pulled"]:
        return None
    dev = t.device_s_in(["predict_shapes/type_forward",
                         "predict_shapes/inst_forward"])
    return 1000.0 * dev / ctx["pulled"] if dev > 0 else None
