"""Device milliseconds a step under the span ``optimizer_step`` (``parallel/train.TrainOptimizer``)."""
from zsbench.readers import optimizer_ms as value  # noqa: F401
