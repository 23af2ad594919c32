"""Device milliseconds a batch under the span ``encode_image`` (``models/graph_shape.encode_image``)."""
from zsbench.readers import encode_ms as value  # noqa: F401
