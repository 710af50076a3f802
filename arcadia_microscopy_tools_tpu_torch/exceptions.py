"""Warning taxonomy.

The two typed warnings are the framework's observability channel, with the
same semantics as the reference (`src/arcadia_microscopy_tools/exceptions.py`):
``MetadataWarning`` whenever a parser falls back to a synthesized/placeholder
value, ``SegmentationWarning`` whenever a segmentation step produces a degraded
or missing result (e.g. one well of a plate failed but the run continued).
"""


class MetadataWarning(UserWarning):
    """Metadata was incomplete or ambiguous; a fallback value was used."""


class SegmentationWarning(UserWarning):
    """A segmentation step produced a degraded or missing result."""
