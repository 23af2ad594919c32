"""K1's share of its roofline: the least time the decoder points the inputs need
(the 33^3 coarse lattice and 125 points an active cell, active cells found by the
reference) could take at the bf16 peak or the HBM rate, over K1's device time."""
from zsbench.readers import k1_roofline_pct as value  # noqa: F401
