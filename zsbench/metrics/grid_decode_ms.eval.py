"""Device milliseconds a batch under the span ``grid_decode`` (``metrics/eval3d.occupancy_grid``, the dense
grid, with ``recon.decode_points``)."""
from zsbench.readers import grid_decode_ms as value  # noqa: F401
