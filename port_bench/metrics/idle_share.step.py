"""The device's idle share of the profiled part of the window, in %."""

from readers import idle_share as read  # noqa: F401
