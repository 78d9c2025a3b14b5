"""Device milliseconds a sample in the program's phase group `raygen`
(`caitlyn.launch.*`, `caitlyn.sample.*` and `caitlyn.raygen`: a launch's
buffer writes and output copy, the keys, the sampler B5, the camera rays,
the path state and the accumulation), every kernel class, from the
device trace of the traced segment attributed by the program's phase
maps; nothing where no operation fell in the group."""


def read(ctx):
    return ctx.phase_ms("raygen")
