"""torch.cuda.max_memory_allocated() over the program's set-up and the
window, in MiB: what a deployment must leave free on the card."""


def read(ctx):
    return ctx.window.peak_bytes / 2**20 if ctx.window.peak_bytes else None
