"""What the per-layer metrics' readers share: device time under a span, the
idle share, a kernel's time, and the FLOPs the inputs need, from the context
a run hands them (the trace's summary under ``summary``, the runner's counts
beside it). A reader that finds nothing to read returns None."""

import re

from zsbench import work


def span_ms(ctx, span, per):
    """Device milliseconds under ``span`` for each ``ctx[per]`` (a batch, a step)."""
    s = ctx["summary"]["span_s"].get(span)
    return 1e3 * s / ctx[per] if s and ctx.get(per) else None


def idle_pct(ctx):
    s = ctx["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s["window_s"] > 0 else None


def kernel_name(op):
    """A device operation's function name: without its return type, template
    arguments and argument list (``void f<3>(float*)`` -> ``f``)."""
    m = re.search(r"([A-Za-z_][A-Za-z0-9_:]*)\s*(?:<.*)?\(", op)
    return m.group(1) if m else op


def kernel_s(ctx, name):
    """Device seconds of the kernels named ``name``."""
    t = sum(v for k, v in ctx["summary"]["op_s"].items() if kernel_name(k) == name)
    return t or None


def mfu_pct(ctx, flops):
    """``flops`` over the traced window at the bf16 peak, in percent."""
    return 100.0 * flops / (ctx["summary"]["window_s"] * work.PEAK_BF16_FLOPS) if flops else None


def recon_decoder_flops(ctx):
    pts = ctx.get("needed_points")
    return sum(pts) * ctx["decoder_flops_per_point"] if pts else None


# -- the readers that the files under metrics/ name ----------------------------

def encode_ms(ctx):
    return span_ms(ctx, "encode_image", "calls")


def grid_decode_ms(ctx):
    return span_ms(ctx, "grid_decode", "calls")


def train_forward_ms(ctx):
    return span_ms(ctx, "train_forward", "steps")


def train_backward_ms(ctx):
    return span_ms(ctx, "train_backward", "steps")


def optimizer_ms(ctx):
    return span_ms(ctx, "optimizer_step", "steps")


def kernels_per_step(ctx):
    n = ctx["summary"]["kernels"]
    return n / ctx["steps"] if n and ctx.get("steps") else None


def recon_mfu_pct(ctx):
    """The decoder points the inputs need and the encoder's and latent trunk's FLOPs, at the bf16 peak."""
    dec = recon_decoder_flops(ctx)
    return mfu_pct(ctx, dec + ctx["encoder_flops_per_image"] * ctx["images"]) if dec else None


def train_mfu_pct(ctx):
    return mfu_pct(ctx, ctx["step_flops"] * ctx["steps"]) if ctx.get("step_flops") else None


def k1_roofline_pct(ctx):
    """The needed points' least time at the bf16 peak or the HBM rate (12 bytes
    in and 4 out a point), over the device time of ``implicit_decoder_kernel``."""
    flops, t = recon_decoder_flops(ctx), kernel_s(ctx, "implicit_decoder_kernel")
    return work.roofline_pct(flops, 16 * sum(ctx["needed_points"]), t) if flops and t else None


def k2_roofline_pct(ctx):
    """The exhaustive search's point pairs at ``PEAK_COMPARISONS``, over the device time of ``nn_kernel``."""
    t = kernel_s(ctx, "nn_kernel")
    return 100.0 * ctx["k2_comparisons"] / work.PEAK_COMPARISONS / t if t else None
