"""Images whose masks came back, over the whole window: from its start to
the end of the last `batch_segment` call, calls back to back."""

from benchmark.readers import rate as read  # noqa: F401
