"""Kernel B1's share of its roofline, in percent: the least time the work
of one sample's brute-force queries needs (cellbench.roofline.mt_bound
over the rays the reference traces for sample 0 of every pixel) over B1's
device time a sample in the traced segment; nothing where B1 did not run."""

from cellbench import roofline


def read(ctx):
    ms = ctx.trace_ms("render", "b1")
    if not ms:
        return None
    ref, queries = ctx.sample_queries()
    tris9 = ref.geo.tris9
    bound = 0.0
    for q in queries:
        if q[0] == "closest":
            nbytes, ops = roofline.mt_bound(q[1], q[2], q[3], tris9)
        else:
            nbytes, ops = roofline.mt_bound(q[1], q[2], q[4], tris9, t_max=q[3])
        bound += roofline.bound_ms(nbytes, ops)
    return 100.0 * bound / ms
