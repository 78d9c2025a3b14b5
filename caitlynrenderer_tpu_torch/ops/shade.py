"""One bounce's shading on the card: kernel B6 (csrc/shade.cu).

No Pallas kernel stands behind it: it is the bounce body that XLA fuses in
caitlynrenderer_tpu/render/integrator.py:336-694 (hit frame, emissive MIS,
NEE set-up and contribution, continuation), for the no-grad render path
of a scene of the Lambert family with any of the Disney, mirror and glass
families, with no texture and no environment
(`render/integrator.fused_shading`).  The families a bounce is handed
pick the kernel's instantiation `shade_bounce_kernel<kDisney, kDelta>`:
kDisney where they hold "disney" (a lane of a type that is neither
Lambert nor specular takes the Disney BRDF of ops/bsdf.py), kDelta where
they hold "mirror" or "glass" (a lane of a specular type takes no NEE; a
MIRROR lane reflects where they hold "mirror", a glass lane reflects or
refracts by Fresnel where they hold "glass").  An instantiation without
one of them has none of its code.

`shade_bounce` launches `shade_bounce_kernel` once a bounce, between the
closest-hit and the any-hit query; it first adds the previous bounce's NEE
contribution where its any-hit found the light visible.  `shade_finish`
launches `shade_finish_kernel`, which adds the last bounce's.  Both take
CUDA tensors only and raise on anything else, with no fallback: every
other case, CPU tensors included, runs their plain twins
`shade_bounce_plain` and `shade_finish_plain` of render/integrator.py,
`trace_paths`' shading step for every family.  Where the kernel runs, the
twin evaluates its expressions in its order, one rounding an op, so the
two agree bit for bit on every output the path loop reads.

The kernel updates the path state in place (alive, T, L, prev_pdf and,
under kDelta, the specular flag that marks a delta lobe for the next
bounce's emissive MIS) and returns the state it was given as
`Shaded.state`; o_out and d_out may be the input rays' own tensors.  The
twin returns new tensors.

`launches` counts the kernels' launches: under `bounce_key(families)`
("bounce" the Lambert instantiation, "bounce_disney" the Disney one,
"bounce_delta" and "bounce_disney_delta" those with the delta lobes) and
"finish"; its twin keys, which every kernel module's counter has, stay 0:
the twins are the integrator's own step, not counted.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from caitlynrenderer_tpu_torch.ops import _build

SOURCE = "caitlynrenderer_tpu_torch/csrc/shade.cu"
REPLACES = "caitlynrenderer_tpu/render/integrator.py:336-694 (XLA-fused, no Pallas kernel)"

launches = _build.launch_counter("shade", {
    "bounce": "shade_bounce_kernelILb0ELb0E", "bounce_disney": "shade_bounce_kernelILb1ELb0E",
    "bounce_delta": "shade_bounce_kernelILb0ELb1E",
    "bounce_disney_delta": "shade_bounce_kernelILb1ELb1E", "finish": "shade_finish_kernel"})
# The keys of the bounce kernel's instantiations.
BOUNCE_KEYS = ("bounce", "bounce_disney", "bounce_delta", "bounce_disney_delta")

SHADE_COLS, LIGHT_COLS = 50, 17
UNIFORMS_A_BOUNCE = 7
# The shading families the kernel takes.
FAMILIES = ("lambert", "disney", "mirror", "glass")


def has_delta(families) -> bool:
    """Whether `families` hold a delta lobe: the kDelta instantiation,
    which reads and writes PathState.specular."""
    return "mirror" in families or "glass" in families


def bounce_key(families) -> str:
    """The launch key of the instantiation that shades `families`."""
    return ("bounce" + ("_disney" if "disney" in families else "")
            + ("_delta" if has_delta(families) else ""))


class _Args(ctypes.Structure):
    """The C entry's `ShadeArgs` struct (csrc/shade.cu), field for field."""

    _fields_ = [("n", ctypes.c_longlong), ("n_u", ctypes.c_int), ("u_base", ctypes.c_int),
                ("first", ctypes.c_int), ("exact_nee", ctypes.c_int),
                ("num_lights", ctypes.c_int), ("pdf_select", ctypes.c_float)] + [
        (name, ctypes.c_void_p) for name in (
            "o_in", "d_in", "tri", "uniforms", "shade_tab", "light_tab", "prev_cand",
            "prev_shadowed", "prev_pending", "alive", "T", "L", "prev_pdf", "o_out", "d_out",
            "ldir", "t_max", "cand", "pending", "specular")] + [
        ("mirror", ctypes.c_int), ("glass", ctypes.c_int)]


_SIGNATURES = {
    # args, disney, device, stream
    "shade_bounce": (ctypes.c_int, [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]),
    # n, cand, shadowed, pending, L, device, stream
    "shade_finish": (ctypes.c_int, [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                     + [ctypes.c_int, ctypes.c_void_p]),
    "shade_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


class PathState(NamedTuple):
    """The per-lane path state a bounce carries on: alive (N,) bool, T and
    L (N, 3) f32, prev_pdf (N,) f32 (the continuation's pdf, read at the
    next emissive hit), and specular (N,) bool, where the continuation was
    a delta lobe (None where no lane's can be: only the kDelta
    instantiation reads and writes it)."""

    alive: torch.Tensor
    T: torch.Tensor
    L: torch.Tensor
    prev_pdf: torch.Tensor
    specular: Optional[torch.Tensor] = None


class Shaded(NamedTuple):
    """What a bounce leaves for the any-hit query and the next bounce: the
    next rays (o, d), the shadow rays' directions `ldir` and `t_max`, their
    lanes `cand`, the contribution `pending` (defined where cand) that a
    visible light adds, and the path state after the bounce."""

    o: torch.Tensor
    d: torch.Tensor
    ldir: torch.Tensor
    t_max: torch.Tensor
    cand: torch.Tensor
    pending: torch.Tensor
    state: PathState


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _require_cuda(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the shading kernel runs on CUDA tensors only, got {dev}")


def _check_nee(n, nee, dev) -> None:
    cand, shadowed, pending = nee
    _build.check_tensor("cand", cand, torch.bool, (n,), dev)
    _build.check_tensor("shadowed", shadowed, torch.bool, (n,), dev)
    _build.check_tensor("pending", pending, torch.float32, (n, 3), dev)


def shade_bounce(shade_tab, light_tab, o, d, tri, uniforms, bounce: int, state: PathState,
                 prev: Optional[tuple] = None, exact_nee: bool = False,
                 out: Optional[tuple] = None, families=("lambert",)) -> Shaded:
    """Bounce `bounce` of every lane: `prev` is the previous bounce's
    (cand, shadowed, pending), None on the first bounce.  o, d: (N, 3) f32
    rays of this bounce's closest-hit query; tri: (N,) int32, its answer;
    uniforms: (N, 4 + 7 * max_depth) f32; shade_tab (T, 50) and light_tab
    (L >= 1, 17) f32.  `out` = (o_out, d_out) receives the next rays (new
    tensors where it is None; it may be (o, d) themselves).  `families`,
    the scene's shading families (of FAMILIES), picks the instantiation
    (`bounce_key`); where they hold "mirror" or "glass", state.specular is
    the (N,) bool flag of a delta lobe, read where a lane hits a light
    after bounce 0 and written where it goes on."""
    dev = o.device
    _require_cuda(dev)
    if not set(families) <= set(FAMILIES):
        raise ValueError(f"the shading kernel shades the families {FAMILIES}, got "
                         f"{tuple(families)}")
    disney, delta = "disney" in families, has_delta(families)
    n = o.shape[0]
    f32 = torch.float32
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("T", state.T, (n, 3)),
                           ("L", state.L, (n, 3)), ("prev_pdf", state.prev_pdf, (n,))):
        _build.check_tensor(name, x, f32, shape, dev)
    _build.check_tensor("tri", tri, torch.int32, (n,), dev)
    _build.check_tensor("alive", state.alive, torch.bool, (n,), dev)
    if delta:
        if state.specular is None:
            raise ValueError(f"the families {tuple(families)} hold a delta lobe: the path "
                             "state needs its specular flag")
        _build.check_tensor("specular", state.specular, torch.bool, (n,), dev)
    if uniforms.dim() != 2 or uniforms.shape[1] < 4 + UNIFORMS_A_BOUNCE * (bounce + 1):
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)} hold no bounce {bounce}")
    _build.check_tensor("uniforms", uniforms, f32, (n, uniforms.shape[1]), dev)
    _build.check_tensor("shade_tab", shade_tab, f32, (shade_tab.shape[0], SHADE_COLS), dev)
    num_lights = light_tab.shape[0]
    if num_lights < 1:
        raise ValueError("the shading kernel needs at least one light")
    _build.check_tensor("light_tab", light_tab, f32, (num_lights, LIGHT_COLS), dev)
    if prev is not None:
        _check_nee(n, prev, dev)
    o_out, d_out = out if out is not None else (torch.empty_like(o), torch.empty_like(d))
    _build.check_tensor("o_out", o_out, f32, (n, 3), dev)
    _build.check_tensor("d_out", d_out, f32, (n, 3), dev)
    res = Shaded(o_out, d_out, torch.empty_like(o), torch.empty(n, dtype=f32, device=dev),
                 torch.empty(n, dtype=torch.bool, device=dev), torch.empty_like(o), state)
    if n == 0:
        return res
    prev_ptrs = [x.data_ptr() for x in prev] if prev is not None else [None] * 3
    args = _Args(n, uniforms.shape[1], 4 + UNIFORMS_A_BOUNCE * bounce, int(bounce == 0),
                 int(bool(exact_nee)), num_lights, 1.0 / num_lights,
                 o.data_ptr(), d.data_ptr(), tri.data_ptr(), uniforms.data_ptr(),
                 shade_tab.data_ptr(), light_tab.data_ptr(), *prev_ptrs,
                 state.alive.data_ptr(), state.T.data_ptr(), state.L.data_ptr(),
                 state.prev_pdf.data_ptr(), o_out.data_ptr(), d_out.data_ptr(),
                 res.ldir.data_ptr(), res.t_max.data_ptr(), res.cand.data_ptr(),
                 res.pending.data_ptr(), state.specular.data_ptr() if delta else None,
                 int("mirror" in families), int("glass" in families))
    lib = _build.load("shade", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.shade_bounce(ctypes.byref(args), int(disney), dev.index,
                              torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(rc, lib.shade_error_string, "shade_bounce")
    launches[bounce_key(families)] += 1
    return res


def shade_finish(L, cand, shadowed, pending):
    """L += pending where cand & ~shadowed, in place: the last bounce's NEE.
    Returns L."""
    dev = L.device
    _require_cuda(dev)
    n = L.shape[0]
    _build.check_tensor("L", L, torch.float32, (n, 3), dev)
    _check_nee(n, (cand, shadowed, pending), dev)
    if n == 0:
        return L
    lib = _build.load("shade", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.shade_finish(n, cand.data_ptr(), shadowed.data_ptr(), pending.data_ptr(),
                              L.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(rc, lib.shade_error_string, "shade_finish")
    launches["finish"] += 1
    return L
