"""Device milliseconds a sample in the program's phase group `nee` (each
bounce's `nee` on the torch shading path less its any-hit query and its
`bsdf`: the light sample, its pdf, the Lambert value toward the light
and the contribution), every kernel class, from the device trace of the
traced segment attributed by the program's phase maps; nothing where no
operation fell in the group (the fused path, kernel B6)."""


def read(ctx):
    return ctx.phase_ms("nee")
