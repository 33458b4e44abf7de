"""Share of the traced window in which no operation ran on the device."""
from portbench.shared import idle_pct as read  # noqa: F401
