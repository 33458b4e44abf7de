"""The roofline time of each step's three kNN graphs
(`counts.train_knn_roofline_s`) over the device time of the kernels
launched inside the `sednet::topk` op (K1)."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx["steps"]:
        return None
    dev = t.device_s_in(["sednet::topk"])
    return 100.0 * ctx["knn_roofline_s"] * ctx["steps"] / dev if dev > 0 else None
