"""Host milliseconds per well that the runner spends turning read-back
columns into tables (its own `assemble_s` counter), over the window."""

from benchmark.readers import assemble_ms as read  # noqa: F401
