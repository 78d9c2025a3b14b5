"""Seconds the program spent capturing and instantiating its CUDA graphs,
as its own `graph_capture` records give them; nothing where no graph was
captured (one sample a launch runs eagerly)."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r["capture_s"] + r["instantiate_s"] for r in ctx.records)
