"""Telemetry: trace spans (a copy of the reference's ``repro.observability.trace``).

Metrics and the step-time probe arrive with the observability slice.
"""

from repro_torch.observability.trace import (  # noqa: F401
    disable,
    enable,
    enabled,
    get_buffer,
)

__all__ = ["enable", "disable", "enabled", "get_buffer"]
