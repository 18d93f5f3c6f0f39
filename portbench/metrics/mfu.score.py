"""The whole forward's model FLOPs over the window at the peak."""

from portbench.readers import mfu as read  # noqa: F401
