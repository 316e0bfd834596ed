"""Kernels layer, B4 (``csrc/stage_prefix.cu``: the stem and the first
``b4_blocks`` MBConv blocks): the least time the card could take for its
work at the tile's shape (``harness.roofline.b4_work``), times the tiles of
the profiled stretch, over its kernels' device time there, in percent."""

from benchmark.harness.roofline import b4_work, bound_s

KERNELS = ("stem_kernel", "expand_dw", "se_gate_kernel", "se_project")


def read(ctx):
    t = ctx.traced
    tiles = t.stretch_calls.get("replay", 0)
    spent = t.stretch.kernel_s(*KERNELS)
    if "b4_blocks" not in ctx.cfg or not tiles or not t.rows or spent <= 0:
        return None
    return 100.0 * tiles * bound_s(*b4_work(ctx.cfg, t.rows))[0] / spent
