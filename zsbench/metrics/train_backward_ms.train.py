"""Device milliseconds a step under the span ``train_backward`` (``parallel/train.train_step``)."""
from zsbench.readers import train_backward_ms as value  # noqa: F401
