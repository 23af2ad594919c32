"""The reconstruction's model FLOPs the inputs need (encoder and latent trunk counted
on the reference, the needed decoder points at the configuration's widths) over the
traced window at the bf16 peak."""
from zsbench.readers import recon_mfu_pct as value  # noqa: F401
