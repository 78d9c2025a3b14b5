"""Device milliseconds a sample in the program's phase group `texture`
(each bounce's `texture`: the texture atlas's lookup of the hit's albedo,
inside the plain shading step's hit), every kernel class, from the device
trace of the traced segment attributed by the program's phase maps;
nothing where no operation fell in the group (a scene without an atlas,
or a program without the span)."""


def read(ctx):
    return ctx.phase_ms("texture")
