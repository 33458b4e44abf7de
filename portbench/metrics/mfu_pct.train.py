"""The train step's dense operations over the window
(`counts.train_step_flops` for each step) as a share of the
configuration's peak rate."""


def read(ctx):
    if ctx["window_s"] <= 0 or not ctx["steps"]:
        return None
    return (100.0 * ctx["step_flops"] * ctx["steps"]
            / ctx["window_s"] / ctx["peak_flops"])
