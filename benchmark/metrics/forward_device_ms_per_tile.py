"""Model forward layer: device ms of kernels (not copies or sets) per tile
over the profiled stretch; each tile is one graph replay of framing,
forward and top-K."""


def read(ctx):
    t = ctx.traced
    tiles = t.stretch_calls.get("replay", 0)
    busy = t.stretch.kernel_s()
    return 1e3 * busy / tiles if tiles and busy > 0 else None
