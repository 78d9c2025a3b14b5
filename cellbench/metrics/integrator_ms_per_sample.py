"""Device milliseconds a sample of the render stage's kernels that are none
of the hand-written kernels B1-B5: the integrator's and the shading's
elementwise and library kernels (and the accumulation's adds), from the
device trace of the traced segment."""


def read(ctx):
    return ctx.trace_ms("render", "other")
