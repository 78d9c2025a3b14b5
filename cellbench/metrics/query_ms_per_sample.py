"""Device milliseconds a sample in the program's phase group `query`
(each bounce's `closest` and `anyhit`: the traversal kernel and the glue
around it), every kernel class, from the device trace of the traced
segment attributed by the program's phase maps; nothing where no
operation fell in the group."""


def read(ctx):
    return ctx.phase_ms("query")
