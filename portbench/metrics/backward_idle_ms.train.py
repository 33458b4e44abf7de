"""Device-idle milliseconds a step under `train_step/backward`, a phase of
`train.make_train_step`."""
from portbench.program_trace import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx, "train_step/backward", "steps")
