"""What more than one runner or metric reader of the benchmark uses."""
from __future__ import annotations


def port_config(config: dict, traffic: dict):
    """The port's Config for a configuration file and a traffic mix."""
    from sednet_tpu_torch.config import Config

    return Config(**{**config["config"], "num_points": traffic["points"],
                     "batch_size": traffic["batch"]})


def idle_pct(ctx):
    """Share of the traced window in which no operation ran on the
    device, %."""
    t = ctx.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_gib(ctx):
    """The device's peak allocated memory over the window
    (`torch.cuda.max_memory_allocated` after a reset at its start), GiB."""
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
