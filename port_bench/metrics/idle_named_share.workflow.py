"""The share of the card's idle time in the profiled run during which a
named host event was open: 1 - (gaps ``no torch op on the host`` + gaps
under 10 us) over (``window_s`` - ``busy_s``), in %."""

from idle_gaps import named_share as read  # noqa: F401
