"""Device-idle milliseconds a batch under `predict_shapes/lobpcg`, the
spectral solve that reads back to the host."""
from portbench.program_trace import idle_ms_per


def read(ctx):
    return idle_ms_per(ctx, "predict_shapes/lobpcg", "pulled")
