"""Whole step: the forward's operations per segment (counted from the
frozen generator's graph, ``harness.roofline.forward_flops``) times the
segments of the profiled stretch, over its length times the card's
published bfloat16 peak, in percent."""

from benchmark.harness.roofline import PEAK_OPS_PER_S


def read(ctx):
    t = ctx.traced
    s = t.stretch
    if s.window_s <= 0 or not t.stretch_segments:
        return None
    return 100.0 * t.flops_per_segment * t.stretch_segments / (s.window_s * PEAK_OPS_PER_S["bf16"])
