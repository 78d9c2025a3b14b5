"""Device milliseconds a sample of the traversal kernel the cell's
accelerator launches (B1 under brute force, B4 under the binary BVH,
which `auto` picks above 2048 triangles; B2 and B3 where a configuration
names the wide or the compressed wide BVH), from the device trace of the
traced segment."""

from cellbench.trace import TRAVERSAL


def read(ctx):
    return ctx.trace_ms("render", *TRAVERSAL)
