"""Device operations (kernels, copies, memsets) a step in the traced window."""
from zsbench.readers import kernels_per_step as value  # noqa: F401
