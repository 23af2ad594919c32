"""One module a kind of entry point of the program; a traffic mix names its runner."""

import torch


def sync(device):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fold(worst, row):
    """Fold one sample's or step's compared numbers into the worst so far; a
    number that is not a number (NaN) reads as an infinite gap."""
    for k, v in row.items():
        v = float("inf") if v != v else float(v)
        worst[k] = max(worst.get(k, 0.0), v)
    return worst
