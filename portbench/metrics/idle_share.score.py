"""The device's idle share of a traced scoring window."""

from portbench.readers import idle_share as read  # noqa: F401
