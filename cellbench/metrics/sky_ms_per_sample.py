"""Device milliseconds a sample in the program's phase group `sky` (each
bounce's `sky`: the environment map's lookup and add for the live lanes
that missed, inside the plain shading step's hit), every kernel class,
from the device trace of the traced segment attributed by the program's
phase maps; nothing where no operation fell in the group (a scene without
an environment map, or a program without the span)."""


def read(ctx):
    return ctx.phase_ms("sky")
