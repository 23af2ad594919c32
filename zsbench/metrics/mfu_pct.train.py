"""A step's forward and backward FLOPs (counted on the reference at the step's
shapes) over the traced window's time a step, at the bf16 peak."""
from zsbench.readers import train_mfu_pct as value  # noqa: F401
