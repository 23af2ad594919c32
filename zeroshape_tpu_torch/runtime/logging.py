"""Windowed meters and console logging (counterpart of ``zeroshape_tpu/runtime/logging.py``,
the reference's ``utils/util.py:12-138``): :class:`SmoothedValue`,
:class:`MetricLogger`, and :func:`log_print`, which prints on rank 0 only.
"""

from __future__ import annotations

import datetime
from collections import defaultdict, deque

from zeroshape_tpu_torch.parallel import dist


class SmoothedValue:
    """A series with a smoothing window and a global average."""

    def __init__(self, window_size=20, fmt="{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[(len(d) - 1) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, delimiter="  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())


def log_print(*args, **kwargs):
    """``print`` with a timestamp, on rank 0 only."""
    if dist.is_main():
        print(f"[{datetime.datetime.now().time()}] ", end="")
        print(*args, **kwargs)
