"""The device's idle share of a traced training window."""

from portbench.readers import idle_share as read  # noqa: F401
