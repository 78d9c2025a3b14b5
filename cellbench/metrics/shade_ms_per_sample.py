"""Device milliseconds a sample in the program's phase group `shade`
(each bounce's `shade`: kernel B6, in the instantiation the scene's
shading families pick, with the last bounce's finishing add), every
kernel class, from the device trace of the traced segment attributed by
the program's phase maps; nothing where no operation fell in the group
(the plain shading step, taken on the card by a scene with a texture, an
environment map or no light, whose operations fall in the groups of its
own spans: `hit`, `nee`, `bounce`, `bsdf`, `specular`)."""


def read(ctx):
    return ctx.phase_ms("shade")
