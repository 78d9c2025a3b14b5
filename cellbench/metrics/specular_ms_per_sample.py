"""Device milliseconds a sample in the program's phase group `specular`
(each bounce's `specular` on the torch shading path: the mirror and glass
masks of the hit, the mirror's reflection, the glass's Fresnel term, its
choice between reflection and refraction, the refracted direction and
origin, and the selects that merge them with the other lanes'), every
kernel class, from the device trace of the traced segment attributed by
the program's phase maps; nothing where no operation fell in the group (a
scene without mirror or glass, or a program without the span)."""


def read(ctx):
    return ctx.phase_ms("specular")
