"""Nodes of the captured CUDA graph a sample: the node count of the
program's `graph_capture` record (read through libcuda) over the samples
the graph holds; nothing where no graph was captured."""


def read(ctx):
    if not ctx.records:
        return None
    rec = ctx.records[-1]
    return rec["nodes"] / rec["spp"]
