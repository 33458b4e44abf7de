"""The roofline time of the clustering work of the window's batches
(`counts.cluster_work`: the bandwidth and the shift steps of every batch
launched, the NMS of every batch completed) over the device time of the
kernels launched inside `predict_shapes/cluster_batch`."""


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    busy = t.device_s_in(["predict_shapes/cluster_batch"])
    return 100.0 * ctx["cluster_roofline_s"] / busy if busy > 0 else None
