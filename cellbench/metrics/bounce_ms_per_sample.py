"""Device milliseconds a sample in the program's phase group `bounce`
(each bounce's `rr` and `bounce` on the torch shading path less its
`bsdf`: Russian roulette, the Lambert continuation, the throughput),
every kernel class, from the device trace of the traced segment
attributed by the program's phase maps; nothing where no operation fell
in the group (the fused path, kernel B6)."""


def read(ctx):
    return ctx.phase_ms("bounce")
