"""Segments of the recordings completed in the window, over the window's
whole time (first call to the return of the last); host clock."""


def read(ctx):
    w = ctx.window
    return w.segments / w.seconds if w.seconds > 0 and w.segments else None
