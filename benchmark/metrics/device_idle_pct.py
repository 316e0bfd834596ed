"""Device layer: the share of the profiled stretch in which no kernel, copy
or set ran on the card, in percent."""


def read(ctx):
    s = ctx.traced.stretch
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 and s.busy_s > 0 else None
