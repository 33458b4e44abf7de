"""The device's peak allocated memory over the window, GiB."""
from portbench.shared import peak_gib as read  # noqa: F401
