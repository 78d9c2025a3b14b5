"""Device milliseconds a sample of the traversal kernel the cell's
accelerator launches (B1 under brute force, B2 under the wide BVH, B3,
B4), from the device trace of the traced segment."""

from cellbench.trace import TRAVERSAL


def read(ctx):
    return ctx.trace_ms("render", *TRAVERSAL)
