"""K2's share of its roofline: the point pairs the exhaustive search compares
(6,912 rotations, both directions, 10,000 x 10,000 points a sample) at one
comparison a pair at 33.5e12 a second, over the device time of ``nn_kernel``."""
from zsbench.readers import k2_roofline_pct as value  # noqa: F401
