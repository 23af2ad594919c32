"""Where one full-size 128^3 reconstruction spends its time on the card.

    python -m zeroshape_tpu_torch.profile_recon [--arch.depth.encoder=transformer --arch.rgb.encoder=transformer ...]

Sets up the main path as chip_smoke.py does (``recon.synthetic_setup``:
seeded weights, a seeded synthetic image, the calibrated random field, one
warm-up; dotted options go over ``config.full_opt()``, as on the CLIs), then
traces a few reconstructions with ``torch.profiler``.
Prints, per reconstruction: the host-clock median, the device time under
each stage span of ``recon.reconstruct`` (encode_image, latent_trunk,
grid_decode, surface_sample), the device's busy and idle share, and the
device kernels that take the most time.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from zeroshape_tpu_torch import config, recon

STAGES = ("encode_image", "latent_trunk", "grid_decode", "surface_sample")


def main(argv=None, reps=5):
    overrides = config.parse_arguments(sys.argv[1:] if argv is None else argv)
    opt = config.override_options(config.full_opt(), overrides)
    model, batch, gen, (_, _, n_active) = recon.synthetic_setup(opt=opt)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = recon.time_reconstructions(model, batch, gen, reps)
    events = prof.key_averages()
    wall_ms = float(np.median(wall)) * 1e3
    print(f"profile: {reps} reconstructions, host-clock median {wall_ms:.2f} ms (traced); "
          f"n_active {n_active} / capacity {recon.CAPACITY}")
    cuda = torch.autograd.DeviceType.CUDA
    # a span appears twice: on the host (its kernels' summed time) and on the
    # device timeline (first kernel start to last kernel end)
    spans = {(e.key, e.device_type == cuda): e for e in events if e.key in STAGES}
    for name in STAGES:
        host, dev = spans.get((name, False)), spans.get((name, True))
        if host is None:
            continue
        span = f"{dev.device_time_total / reps / 1e3:8.3f}" if dev is not None else "     n/a"
        print(f"  stage {name:15s} kernels {host.device_time_total / reps / 1e3:8.3f} ms, "
              f"device span {span} ms, host {host.cpu_time_total / reps / 1e3:8.3f} ms")
    kernels = [e for e in events if e.device_type == cuda and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    traced_ms = sum(wall) / reps * 1e3
    n_kernels = sum(e.count for e in kernels) / reps
    print(f"  device busy {busy_ms:.2f} ms of {traced_ms:.2f} ms per reconstruction "
          f"(idle share {1 - busy_ms / traced_ms:.3f}), {n_kernels:.0f} device kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  kernel {e.self_device_time_total / reps / 1e3:8.3f} ms x{e.count // reps:4d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
