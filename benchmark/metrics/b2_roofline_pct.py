"""Kernels layer, B2 (``csrc/frontend.cu`` ``filterbank_logpower``): the
least time the card could take for its work at the tile's shape
(``harness.roofline.b2_work``), times the tiles of the profiled stretch,
over its kernel's device time there, in percent."""

from benchmark.harness.roofline import b2_work, bound_s


def read(ctx):
    t = ctx.traced
    tiles = t.stretch_calls.get("replay", 0)
    spent = t.stretch.kernel_s("filterbank_logpower")
    if not tiles or not t.rows or spent <= 0:
        return None
    return 100.0 * tiles * bound_s(*b2_work(ctx.cfg, t.rows))[0] / spent
