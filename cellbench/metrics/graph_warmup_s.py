"""Seconds of the warm-up sample the program runs before each CUDA-graph
capture (each kernel's first load among them), ended by synchronizing its
stream, as the program's `graph_capture` records give them (`warmup_s`);
nothing where no graph was captured or the records carry no such time."""


def read(ctx):
    seconds = [r["warmup_s"] for r in ctx.records if "warmup_s" in r]
    return sum(seconds) if seconds else None
