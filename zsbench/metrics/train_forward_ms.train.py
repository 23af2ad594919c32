"""Device milliseconds a step under the span ``train_forward`` (``parallel/train.train_step``)."""
from zsbench.readers import train_forward_ms as value  # noqa: F401
