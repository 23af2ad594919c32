"""What the measurement tools (``time_train``, ``time_recon``) share: host
clocks that end in a sync, CUDA-event times, the card's name and power
limit, and the JSON line each tool prints last.

On a CUDA device every time is the card's; on the CPU (the tests, at tiny
sizes) the host clock times the CPU and the JSON line says ``"card": "cpu"``.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from zeroshape_tpu_torch.recon import sync


def host_ms(fn, device, reps=5, warmup=1):
    """Milliseconds of each of ``reps`` calls of ``fn()`` on the host clock,
    each ending in a sync, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def event_ms(fn, device, reps=10, warmup=2):
    """Mean milliseconds a call of ``fn()`` over ``reps`` calls on the card,
    timed with CUDA events (the host's queueing stays out while the queue
    is full)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def median(xs):
    return float(np.median(xs))


def card(device):
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from zeroshape_tpu_torch.bench import card as smi

    return smi()


def finite_numbers(record):
    """Every number in ``record`` (nested dicts and lists), for the check that
    none is missing or non-finite; booleans are not numbers here."""
    if isinstance(record, dict):
        return [x for v in record.values() for x in finite_numbers(v)]
    if isinstance(record, (list, tuple)):
        return [x for v in record for x in finite_numbers(v)]
    if isinstance(record, (int, float)) and not isinstance(record, bool):
        return [record]
    return []


def emit(tool, sub, device, **numbers):
    """Print the tool's last line: ``{"tool", "sub", **numbers, "card"}``.
    Raises if a number is not finite (a failed measurement is not a result)."""
    line = {"tool": tool, "sub": sub, **numbers, "card": card(device)}
    bad = [x for x in finite_numbers(numbers) if not math.isfinite(x)]
    if bad:
        raise RuntimeError(f"{tool} {sub}: non-finite numbers {bad[:5]} in {line}")
    print(json.dumps(line), flush=True)
    return line
