"""Share of the traced plate in which no kernel, memcpy or memset ran on
the card: 1 - the union of their intervals / the window."""

from benchmark.readers import idle_share as read  # noqa: F401
