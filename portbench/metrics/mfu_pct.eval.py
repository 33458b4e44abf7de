"""The eval's dense operations over the window (`counts.eval_batch_flops`
for each batch completed) as a share of the configuration's peak rate."""


def read(ctx):
    if ctx["window_s"] <= 0 or not ctx["batches"]:
        return None
    return (100.0 * ctx["batch_flops"] * ctx["batches"]
            / ctx["window_s"] / ctx["peak_flops"])
