"""The yardstick's arithmetic: the card's peaks, the work the inputs need,
and FLOPs counted on the plain reference.

The work is counted from the configuration's shapes and the reference,
never from the program's launch arguments, tiles or padding, so it reads
the same whatever implements it.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA's data sheet, H100 SXM, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# one fp32 comparison a pair and lane: the rate the Chamfer search's
# nearest-neighbour step can reach (an assumption, stated with the number)
PEAK_COMPARISONS = 33.5e12


def decoder_flops(P, L, C=256, n_blocks=2, hidden=1024, n_linears=9, skip_in=(2, 4, 6)):
    """Operations the implicit decoder needs for P points against L latent
    keys: the point projection, each block's qkv, scores and weighted values
    against the L keys and the point's own key, projection and MLP, then the
    skip MLP's linears."""
    per = 2 * 3 * C
    per += n_blocks * (2 * C * 3 * C + 2 * (2 * C * L) + 2 * C * C + 2 * (2 * C * hidden))
    for l in range(n_linears):
        fan_in = 3 + C if l == 0 else C + (3 + C if l in skip_in else 0)
        per += 2 * fan_in * (1 if l == n_linears - 1 else C)
    return P * per


def config_decoder_flops(P, cfg, L):
    """:func:`decoder_flops` at configuration ``cfg``'s decoder widths (its file's ``options``)."""
    impl = cfg["arch"]["impl"]
    C = impl["n_channels"]
    return decoder_flops(P, L, C, impl["att_blocks"], int(C * impl["mlp_ratio"]), impl["mlp_layers"] + 1,
                         tuple(impl["skip_in"]))


def hier_points(n_active, vox=128, factor=4, capacity=4096):
    """Decoder points that a coarse-to-fine decode needs: the coarse lattice
    and the fine lattice of each active cell (up to the capacity)."""
    return (vox // factor + 1) ** 3 + (factor + 1) ** 3 * min(n_active, capacity)


def chamfer_comparisons(rotations, n_pred, n_gt):
    """Point pairs the exhaustive best-of-rotations search compares: both
    directions of the nearest-neighbour search at every rotation."""
    return rotations * 2 * n_pred * n_gt


def roofline_pct(flops, bytes_, seconds, peak_flops=PEAK_BF16_FLOPS):
    """The least time the card could take, over ``seconds``, in percent."""
    return 100.0 * max(flops / peak_flops, bytes_ / PEAK_HBM_BYTES) / seconds


def count_flops(fn, *args, **kwargs):
    """``(FLOPs, result)`` of one call as ``FlopCounterMode`` counts them."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return counter.get_total_flops(), out


def no_grad_flops(fn, *args):
    with torch.no_grad():
        return count_flops(fn, *args)
