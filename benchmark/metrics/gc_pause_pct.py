"""Classifier layer: the share of the window in which the interpreter's
cyclic garbage collector ran (``gc.callbacks`` around the window), in
percent. The per-segment result objects each call builds set it off."""


def read(ctx):
    w = ctx.window
    return 100.0 * w.gc_pause_s / w.seconds if w.seconds > 0 else None
