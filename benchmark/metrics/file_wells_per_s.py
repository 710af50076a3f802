"""Wells read from ND2 files whose tables came back, over the whole window:
from its start to the end of the last plate, plates back to back."""

from benchmark.readers import rate as read  # noqa: F401
