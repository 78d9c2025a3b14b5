"""Device milliseconds a sample in the program's phase group `shade`
(each bounce's `shade`: kernel B6 on the fused Lambert path, with the
last bounce's finishing add), every kernel class, from the device trace
of the traced segment attributed by the program's phase maps; nothing
where no operation fell in the group (the torch shading path, whose
bounces fall in `hit`, `nee` and `bounce`)."""


def read(ctx):
    return ctx.phase_ms("shade")
