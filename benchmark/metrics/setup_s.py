"""Process start to the first timed call: imports, CUDA, the seeded model
and audio, the program's build (and in a checkout's first run its kernel
build, which the result's ``window.kernels_built`` marks) and the warm
calls. The plain reference's pass that sets the batch norms' statistics is
left out (``window.calibration_s``)."""


def read(ctx):
    return ctx.window.setup_s
