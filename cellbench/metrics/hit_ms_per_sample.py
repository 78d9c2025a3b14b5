"""Device milliseconds a sample in the program's phase group `hit` (each
bounce's `hit` on the torch shading path: the hit triangle's rows, the
refined hit and its frame, the surface's albedo and masks, the emissive
hit's MIS weight; the Disney parameters apart, in `bsdf`), every kernel
class, from the device trace of the traced segment attributed by the
program's phase maps; nothing where no operation fell in the group (the
fused path, kernel B6)."""


def read(ctx):
    return ctx.phase_ms("hit")
