"""Device milliseconds a sample in the program's phase group `bsdf` (each
bounce's `bsdf` on the torch shading path: the Disney BRDF's mask and
parameters, its value and pdf toward the light sample, its sampled
continuation and the selects that merge them with the Lambert lanes'),
every kernel class, from the device trace of the traced segment
attributed by the program's phase maps; nothing where no operation fell
in the group (a scene without Disney materials, or a program without the
span)."""


def read(ctx):
    return ctx.phase_ms("bsdf")
