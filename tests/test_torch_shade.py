"""Kernel B6 (ops/shade.py, csrc/shade.cu): one bounce's shading (Lambert,
Disney, mirror and glass) on the no-grad render path, and the predicate
that chooses it.

CPU: `fused_shading` on stand-in scenes whose tensors say cuda:0 (true for
the Lambert cornell and for Lambert with any of Disney, mirror and glass;
false for each case the plain bounce keeps: CPU tensors, families without
Lambert, a texture, the environment, the ray-count stats, a scene tensor
requiring grad under grad mode, no light, with and without the delta
families); `trace_paths` on CPU tensors in those cases runs the plain
bounce and never calls B6's wrapper; the loop on the fused path with B6's
wrapper played by its twin, which carries the delta flag in place;
FUSED_CASES, the scenes B6 shades on the card, which
tests/test_torch_render.py also holds against the JAX package on the CPU
(the Lambert scenes, the Disney-floor cornell and a Disney floor with
every lobe weighted, some of whose lanes end where a sample has no pdf,
the mirror and the glass floor, the benchmark's box with a mirror and a
glass sphere, and the Disney floor with a glass and a CONDUCTOR box); the
wrapper's checks; the C struct and constants against their Python
counterparts; the "shade" phase group and the four instantiations'
launch keys.

Card (marked `cuda`, skipped without a card): B6 against its twin on one
bounce of the 700x700 cornell, of the 700x700 Disney-floor cornell (the
Disney instantiation), of the mirror and the glass floor, of the
benchmark's specular box and of the Disney floor with a glass and a
CONDUCTOR box (the delta instantiations), every output bit for bit; the
fused path against the torch path (`fused_shading` patched false) bit for
bit on the accumulation, eager and through a 16-sample CUDA graph, on the
cornell, the Disney-floor cornell, displaced_grid(224) under wide and
bvh2, the specular box at 64x64 and 8 bounces and the delta scenes, for
both values of exact_reference_nee and with Russian roulette from bounce
0; B6's launches and the graph's "shade" nodes; tiled and sharded renders
through B6.  Tolerance on the card: none, every comparison is bit for bit
(the kernel rounds each torch op once, in its order, under --fmad=false).
This file imports neither jax nor the reference package.
"""

import ctypes
import importlib.util
import json
import math
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from caitlynrenderer_tpu_torch.cli import render_setup
from caitlynrenderer_tpu_torch.core import math as cm
from caitlynrenderer_tpu_torch.core.camera import generate_rays
from caitlynrenderer_tpu_torch.core.types import MaterialType, RenderOptions, make_camera
from caitlynrenderer_tpu_torch.io.builtin_scenes import cornell_box, displaced_grid, procedural_sky
from caitlynrenderer_tpu_torch.io.obj import load_obj
from caitlynrenderer_tpu_torch.ops import shade
from caitlynrenderer_tpu_torch.render import integrator, progressive, sampling
from caitlynrenderer_tpu_torch.scene import required_stack, scene_families, upload_scene
from caitlynrenderer_tpu_torch.utils import config, metrics

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")
DISNEY_TOML = os.path.join(ROOT, "scenes", "cornell_disney.toml")
with open(os.path.join(ROOT, shade.SOURCE)) as _f:
    SOURCE = _f.read()
W, H = 16, 12


def _cornell_scene(accel="brute", width=W, height=H, toml=TOML, **overrides):
    cfg = config.load_config(toml)
    scene, camera, options = render_setup(cfg, os.path.dirname(toml), width=width,
                                          height=height, accel=accel)
    return scene, camera, options._replace(**overrides)


def _cornell(accel="brute", width=W, height=H, dev="cpu", toml=TOML, **overrides):
    scene, camera, options = _cornell_scene(accel, width, height, toml, **overrides)
    return upload_scene(scene, accel, dev), camera, options


# A Disney floor whose every lobe carries weight: roughness, metallic,
# spec_tint, sheen (disney), clearcoat, clearcoat_gloss, subsurface
# (disney2).  At roughness 0.3 and metallic 0.6 many GGX samples fall under
# the surface, where the sample has no pdf and the path ends.
LOBES = {"disney": (0.3, 0.6, 0.5, 0.7), "disney2": (0.8, 0.4, 0.5)}


def _disney(accel="brute", width=W, height=H, dev="cpu", lobes=False, **overrides):
    scene, camera, options = _disney_scene(accel, width, height, lobes, **overrides)
    return upload_scene(scene, accel, dev), camera, options


def _disney_scene(accel="brute", width=W, height=H, lobes=False, **overrides):
    """The Disney-floor cornell at 4 bounces (the cornell_disney700 cell's
    scene and depth); with `lobes`, its floor's parameters set to LOBES."""
    cfg = config.load_config(DISNEY_TOML)
    scene, camera, options = render_setup(cfg, os.path.dirname(DISNEY_TOML), width=width,
                                          height=height, accel=accel, max_depth=4)
    if lobes:
        m = scene.materials
        floor = np.nonzero(m.albedo[:, 3] == int(MaterialType.DISNEY))[0]
        disney, disney2 = m.disney.copy(), m.disney2.copy()
        disney[floor] = LOBES["disney"]
        disney2[floor, :3] = LOBES["disney2"]
        scene = scene._replace(materials=m._replace(disney=disney, disney2=disney2))
    assert options.families == ("lambert", "disney")
    return scene, camera, options._replace(**overrides)


def _grid_scene(accel, resolution, width, height, **overrides):
    scene = displaced_grid(resolution)[0]
    camera = make_camera([5.0, 9.0, 11.0], [5.0, 2.0, 5.0], 50.0)
    return scene, camera, RenderOptions(width=width, height=height, max_depth=4, accel=accel,
                                        families=scene_families(scene), **overrides)


def _floor_scene(floor, accel="brute", width=W, height=H, **overrides):
    """The built-in cornell with its floor of material type `floor`
    (MaterialType), the camera of scenes/cornell.toml, options traced for
    the scene's families."""
    _, camera, options = _cornell_scene(accel, width, height, **overrides)
    scene = cornell_box(floor_type=int(floor))[0]
    return scene, camera, options._replace(families=scene_families(scene))


def _specular_scene(accel="bvh2", width=W, height=H, **overrides):
    """The benchmark's cornell_specular700 scene (cellbench/scenes/
    cornell_specular.py: a MIRROR and a GLASS UV sphere with interpolated
    vertex normals, 7,948 triangles) and camera, 8 bounces."""
    from cellbench.program import camera as bench_camera
    from cellbench.program import scene_arrays
    from cellbench.scenes import builtin, cornell_specular

    with open(os.path.join(ROOT, "cellbench", "configs", "cornell_specular700.json")) as f:
        cam = json.load(f)["camera"]
    scene = scene_arrays(cornell_specular.make())
    options = RenderOptions(width=width, height=height, max_depth=8, accel=accel,
                            families=scene_families(scene), **overrides)
    assert options.families == ("lambert", "mirror", "glass")
    return scene, bench_camera(builtin.make_camera(**cam)), options


def _disney_delta_scene(accel="brute", width=W, height=H, **overrides):
    """The Disney-floor cornell at 4 bounces with its tall box GLASS (ior
    1.5) and its short box CONDUCTOR, both of albedo 0.9: every family,
    and a specular type (CONDUCTOR) that takes no NEE yet scatters as
    Lambert."""
    scene, camera, options = _disney_scene(accel, width, height, **overrides)
    m = scene.materials
    k = m.count
    mats = {f: np.concatenate([getattr(m, f), getattr(m, f)[:2]]) for f in m._fields}
    mats["albedo"][k:, :3] = 0.9
    mats["albedo"][k:, 3] = (int(MaterialType.GLASS), int(MaterialType.CONDUCTOR))
    mats["specular"][k:, 3] = 1.5
    tri_v = scene.tri_v.copy()
    tri_v[BOX_TRIANGLES[0], 3] = k  # the tall box
    tri_v[BOX_TRIANGLES[1], 3] = k + 1  # the short box
    scene = scene._replace(materials=type(m)(**mats), tri_v=tri_v)
    options = options._replace(families=scene_families(scene))
    assert options.families == ("lambert", "disney", "mirror", "glass")
    return scene, camera, options


# The built-in cornell's triangles of its tall and its short box (after the
# walls' and the light's 12).
BOX_TRIANGLES = (slice(12, 24), slice(24, 36))


def _inputs(ds, camera, options, key=(7, 11)):
    """A sample's camera rays and uniforms on the scene's device."""
    w, h = options.width, options.height
    ids = torch.arange(w * h, dtype=torch.int32, device=ds.device)
    uni = sampling.pixel_uniforms(key, ids, options.max_depth)
    o, d = generate_rays(camera, w, h, uni)
    return o, d, uni


def _no_launches():
    return all(v == 0 for v in shade.launches.values())


def count_plain_steps(monkeypatch):
    """Count the calls of the plain bounce and finishing step: the returned
    dict's "bounce" and "finish"."""
    calls = {"bounce": 0, "finish": 0}
    for key, name in (("bounce", "shade_bounce_plain"), ("finish", "shade_finish_plain")):
        def counted(*a, _key=key, _fn=getattr(integrator, name), **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(integrator, name, counted)
    return calls


# --------------------------------------------------------------------------
# CPU: the predicate, the torch path's cases, the twins, the wrapper
# --------------------------------------------------------------------------


class _SaysCuda(torch.Tensor):
    """A CPU tensor whose `device` says cuda:0: the predicate and the
    wrapper's checks see it as a card's tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(x):
    return x.as_subclass(_SaysCuda)


def _stand_in(case):
    """(ds, o, d, uniforms, options, with_stats) of a predicate case on the
    Lambert cornell whose tensors say cuda:0."""
    ds, camera, options = _cornell()
    o, d, uni = _inputs(ds, camera, options)
    ds = ds._replace(shade_tab=_cuda(ds.shade_tab), light_tab=_cuda(ds.light_tab))
    o, d, uni = _cuda(o), _cuda(d), _cuda(uni)
    with_stats = case == "with_stats"
    if case == "cpu":
        o = o.as_subclass(torch.Tensor)
    elif case in ("disney", "mirror", "glass"):
        options = options._replace(families=("lambert", case))
    elif case == "disney_mirror":
        options = options._replace(families=("lambert", "disney", "mirror"))
    elif case == "mirror_glass":
        options = options._replace(families=("lambert", "mirror", "glass"))
    elif case == "disney_glass":
        options = options._replace(families=("lambert", "disney", "glass"))
    elif case in ("disney_alone", "mirror_alone"):
        options = options._replace(families=(case.split("_")[0],))
    elif case.startswith("glass_"):
        # The delta families with a case the plain bounce keeps.
        ds, o, d, uni, options, with_stats = _stand_in(case[len("glass_"):])
        return ds, o, d, uni, options._replace(families=("lambert", "mirror", "glass")), with_stats
    elif case == "textured":
        sc = ds.scene._replace(textures=torch.zeros((1, 2, 2, 3)), texcoords=torch.zeros((3, 2)))
        ds = ds._replace(scene=sc)
    elif case == "use_env_map":
        options = options._replace(use_env_map=True)
    elif case in ("grad", "grad_without_grad_mode"):
        ds = ds._replace(shade_tab=_cuda(ds.shade_tab.as_subclass(torch.Tensor).clone()
                                         .requires_grad_()))
    elif case == "no_light":
        ds = ds._replace(light_tab=_cuda(ds.light_tab.as_subclass(torch.Tensor)[:0]))
    return ds, o, d, uni, options, with_stats


PREDICATE_CASES = {"lambert": True, "grad_without_grad_mode": True, "cpu": False,
                   "disney": True, "mirror": True, "glass": True, "disney_mirror": True,
                   "mirror_glass": True, "disney_glass": True, "disney_alone": False,
                   "mirror_alone": False, "textured": False, "use_env_map": False,
                   "with_stats": False, "grad": False, "no_light": False,
                   "glass_grad_without_grad_mode": True, "glass_cpu": False,
                   "glass_textured": False, "glass_use_env_map": False,
                   "glass_with_stats": False, "glass_grad": False, "glass_no_light": False}


@pytest.mark.parametrize("case", list(PREDICATE_CASES))
def test_fused_shading_predicate(case):
    """The fused path is taken on the card for the Lambert cornell and for
    Lambert with any of Disney, mirror and glass, also when a scene tensor
    requires grad outside grad mode, and not in each case the torch path
    keeps, with or without the delta families ("glass_..." cases: Lambert,
    mirror and glass, the specular cell's families)."""
    ds, o, d, uni, options, with_stats = _stand_in(case)
    if case.endswith("grad_without_grad_mode"):
        with torch.no_grad():
            assert integrator.fused_shading(ds, o, d, uni, options, with_stats)
        assert not integrator.fused_shading(ds, o, d, uni, options, with_stats)
        return
    assert integrator.fused_shading(ds, o, d, uni, options, with_stats) is PREDICATE_CASES[case]


def _torch_path_case(case, textured_dir):
    """(ds, camera, options) of a CPU render the torch path keeps."""
    ds, camera, options = _cornell()
    if case in ("disney", "mirror", "glass"):
        floor = {"disney": MaterialType.DISNEY, "mirror": MaterialType.MIRROR,
                 "glass": MaterialType.GLASS}[case]
        scene = cornell_box(floor_type=int(floor))[0]
        ds = upload_scene(scene, "brute", "cpu")
        options = options._replace(families=scene_families(scene))
        assert case in options.families
    elif case == "textured":
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      os.path.join(ROOT, "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        scene, translation = load_obj(smoke.write_textured_scene(str(textured_dir)), tex_size=16)
        pos = np.array([0.0, 1.0, 4.0], np.float32) + translation
        camera = make_camera(pos, pos + np.array([0, 0, -1], np.float32), 40.0)
        ds = upload_scene(scene, "brute", "cpu")
        options = options._replace(families=scene_families(scene))
        assert ds.scene.textures is not None and ds.scene.texcoords.shape[0] > 0
    elif case == "use_env_map":
        scene = cornell_box()[0]._replace(env_map=procedural_sky(16, 32))
        ds = upload_scene(scene, "brute", "cpu")
        options = options._replace(use_env_map=True)
    return ds, camera, options


@pytest.mark.parametrize("case", ["lambert", "disney", "mirror", "glass", "textured",
                                  "use_env_map", "with_stats", "grad"])
def test_trace_paths_on_cpu_runs_the_torch_path(case, tmp_path, monkeypatch):
    """On CPU tensors `trace_paths` shades with the plain bounce in every
    case, once a bounce, and adds each bounce's NEE with the plain
    finishing step (the next bounce's, or the loop's after the last): B6's
    wrappers are not called and launch nothing, and the caller's rays are
    left as they were."""
    for name in ("shade_bounce", "shade_finish"):
        monkeypatch.setattr(shade, name,
                            lambda *a, **k: pytest.fail("B6's wrapper ran on CPU tensors"))
    calls = count_plain_steps(monkeypatch)
    ds, camera, options = _torch_path_case(case, tmp_path)
    o, d, uni = _inputs(ds, camera, options)
    o0, d0 = o.clone(), d.clone()
    shade.reset_launches()
    if case == "grad":
        table = ds.shade_tab.clone().requires_grad_()
        L = integrator.trace_paths(ds._replace(shade_tab=table), o, d, uni, options)
        L.sum().backward()
        assert table.grad is not None and bool(torch.isfinite(table.grad).all())
    else:
        out = integrator.trace_paths(ds, o, d, uni, options, with_stats=case == "with_stats")
        L = out[0] if case == "with_stats" else out
    L = L.detach()
    assert bool(torch.isfinite(L).all()) and float(L.sum()) > 0
    assert _no_launches()
    assert calls == {"bounce": options.max_depth, "finish": options.max_depth}
    assert torch.equal(o, o0) and torch.equal(d, d0)


FUSED_CASES = {
    "specular_box": ("specular", "bvh2", {}),
    "specular_box_exact_nee": ("specular", "bvh2", {"exact_reference_nee": True}),
    "mirror_floor": ("mirror", "brute", {}),
    "glass_floor_rr_from_1": ("glass", "brute", {"rr_start": 1}),
    "disney_delta": ("disney_delta", "brute", {}),
    "disney_delta_exact_nee_rr_from_1": ("disney_delta", "brute",
                                         {"exact_reference_nee": True, "rr_start": 1}),
    "disney": ("disney", "brute", {}),
    "disney_exact_nee": ("disney", "brute", {"exact_reference_nee": True}),
    "disney_lobes": ("disney_lobes", "brute", {}),
    "disney_lobes_exact_nee_rr_from_1": ("disney_lobes", "brute",
                                         {"exact_reference_nee": True, "rr_start": 1}),
    "cornell_brute": ("cornell", "brute", {}),
    "cornell_wide": ("cornell", "wide", {}),
    "cornell_cwbvh": ("cornell", "cwbvh", {}),
    "cornell_bvh2": ("cornell", "bvh2", {}),
    "cornell_exact_nee": ("cornell", "brute", {"exact_reference_nee": True}),
    "cornell_rr_from_0": ("cornell", "brute", {"rr_start": 0}),
    "grid_wide": ("grid", "wide", {}),
    "grid_bvh2_rr_from_1": ("grid", "bvh2", {"rr_start": 1}),
}


def _fused_setup(name, dev="cpu", width=W, height=H, resolution=24):
    """(scene arrays, ds, camera, options) of a FUSED_CASES case."""
    kind, accel, overrides = FUSED_CASES[name]
    if kind == "disney_delta":
        scene, camera, options = _disney_delta_scene(accel, width, height, **overrides)
    elif kind.startswith("disney"):
        scene, camera, options = _disney_scene(accel, width, height, kind == "disney_lobes",
                                               **overrides)
    elif kind == "specular":
        scene, camera, options = _specular_scene(accel, width, height, **overrides)
    elif kind in ("mirror", "glass"):
        floor = MaterialType.MIRROR if kind == "mirror" else MaterialType.GLASS
        scene, camera, options = _floor_scene(floor, accel, width, height, **overrides)
    elif kind == "cornell":
        scene, camera, options = _cornell_scene(accel, width, height, **overrides)
    else:
        scene, camera, options = _grid_scene(accel, resolution, width, height, **overrides)
    ds = upload_scene(scene, accel, dev)
    if accel == "bvh2":
        options = options._replace(max_stack=required_stack(ds))
    return scene, ds, camera, options


def _fused_case(name, dev="cpu", width=W, height=H, resolution=24):
    return _fused_setup(name, dev, width, height, resolution)[1:]


def lambert_case(name) -> bool:
    """Whether FUSED_CASES[name] is a scene of the Lambert family alone."""
    return FUSED_CASES[name][0] in ("cornell", "grid")


def _twin_in_place(ds, options, seen):
    """B6's wrapper played by its plain twin on CPU tensors, with the
    kernel's contract: the path state (the delta flag included) updated in
    place, the next rays written to `out` where it is given.  `seen` gets
    each call's (bounce, state.specular, families)."""
    def bounce_step(shade_tab, light_tab, o, d, tri, uniforms, bounce, state, prev=None,
                    exact_nee=False, out=None, families=("lambert",)):
        seen.append((bounce, state.specular, families))
        sh = integrator.shade_bounce_plain(
            ds, o, d, tri, uniforms, bounce, state,
            options._replace(exact_reference_nee=exact_nee, families=families), prev)
        for x, y in zip(state, sh.state):
            if x is not None:
                x.copy_(y)
        o_out, d_out = out if out is not None else (torch.empty_like(o), torch.empty_like(d))
        o_out.copy_(sh.o)
        d_out.copy_(sh.d)
        shade.launches[shade.bounce_key(families)] += 1
        return shade.Shaded(o_out, d_out, sh.ldir, sh.t_max, sh.cand, sh.pending, state)

    def finish(L, cand, shadowed, pending):
        shade.launches["finish"] += 1
        return L.copy_(integrator.shade_finish_plain(L, cand, shadowed, pending))

    return bounce_step, finish


@pytest.mark.parametrize("name", ["cornell_brute", "disney_lobes_exact_nee_rr_from_1",
                                  "mirror_floor", "glass_floor_rr_from_1", "specular_box",
                                  "disney_delta_exact_nee_rr_from_1"])
def test_fused_loop_carries_the_delta_flag(name, monkeypatch):
    """`trace_paths` on the fused path, B6's wrapper played on the CPU by
    its twin with the kernel's in-place contract: where the families hold
    mirror or glass the loop allocates the (N,) bool delta flag once, in
    raygen, and hands the same tensor to every bounce, and None elsewhere;
    one launch of the families' instantiation a bounce and one finishing
    add; the radiance is the torch path's bit for bit, so what the kernel
    writes in place (the flag included) is all the next bounce reads."""
    ds, camera, options = _fused_case(name)
    o, d, uni = _inputs(ds, camera, options)
    want = integrator.trace_paths(ds, o, d, uni, options)
    seen = []
    bounce_step, finish = _twin_in_place(ds, options, seen)
    monkeypatch.setattr(integrator, "fused_shading", lambda *a, **k: True)
    monkeypatch.setattr(shade, "shade_bounce", bounce_step)
    monkeypatch.setattr(shade, "shade_finish", finish)
    shade.reset_launches()
    got = integrator.trace_paths(ds, o, d, uni, options)
    assert torch.equal(got, want) and float(want.sum()) > 0
    depth = options.max_depth
    assert [b for b, _, _ in seen] == list(range(depth))
    assert all(f == options.families for _, _, f in seen)
    flags = {id(flag) for _, flag, _ in seen}
    if shade.has_delta(options.families):
        flag = seen[0][1]
        assert len(flags) == 1 and flag.dtype == torch.bool and flag.shape == (o.shape[0],)
    else:
        assert all(flag is None for _, flag, _ in seen)
    want_launches = dict.fromkeys(shade.launches, 0)
    want_launches[shade.bounce_key(options.families)] = depth
    want_launches["finish"] = 1
    assert shade.launches == want_launches


def test_disney_stand_in_samples_every_lobe_and_ends_lanes():
    """On the Disney floor of LOBES the twin's bounce 0 samples each of the
    diffuse, GGX and clearcoat lobes on some live Disney lane, and some
    Disney lanes end there (the sample has no pdf); the cell's own floor
    (metallic, sheen, clearcoat 0) samples diffuse and GGX.  The lobe
    weights are the twin's (`bsdf._lobe_weights`)."""
    from caitlynrenderer_tpu_torch.ops import bsdf

    for lobes, want_cc in ((True, True), (False, False)):
        ds, camera, options = _disney(width=48, height=40, lobes=lobes)
        o, d, uni = _inputs(ds, camera, options)
        n = o.shape[0]
        tri = integrator._closest_hit_raw(ds, o, d, torch.ones(n, dtype=torch.bool), options)[1]
        hf = integrator.hit_frame(ds, o, d, torch.zeros(n), tri, torch.zeros(n), torch.zeros(n))
        surf = integrator.surface(ds, hf, options.families)
        state = shade.PathState(torch.ones(n, dtype=torch.bool), torch.ones((n, 3)),
                                torch.zeros((n, 3)), torch.ones(n))
        state = integrator.shade_bounce_plain(ds, o, d, tri, uni, 0, state, options).state
        live = hf.keep & (hf.rows[:, 33] == -1)
        dis = live & surf.disney
        w_diff, w_spec, _ = bsdf._lobe_weights(surf.dis_p)
        u_lobe = integrator.bounce_uniforms(uni, 0)[5]
        picks = [u_lobe < w_diff, (u_lobe >= w_diff) & (u_lobe < w_diff + w_spec),
                 u_lobe >= w_diff + w_spec]
        counts = [int((dis & p).sum()) for p in picks]
        assert counts[0] > 0 and counts[1] > 0 and (counts[2] > 0) is want_cc, counts
        ended = int((dis & ~state.alive).sum())
        assert bool(state.alive[live & ~surf.disney].all())
        if lobes:
            assert 0 < ended < int(dis.sum())


def test_phase_group_of_shade():
    """A bounce's `shade` span (B6) is the "shade" group, beside the torch
    path's hit, nee and bounce."""
    assert "shade" in metrics.GROUPS
    assert metrics.phase_group("b2.shade") == "shade"
    assert metrics.phase_group("b0.shade") == "shade"
    assert metrics.kernel_family("_ZN12_GLOBAL__N_119shade_bounce_kernelENS_4ArgsE") == (
        "shade_bounce_kernel")


def test_launch_keys_of_the_two_instantiations():
    """The instantiations of shade_bounce_kernel<kDisney, kDelta> (two
    before the delta lobes, four now), by
    their mangled names (a graph's nodes) and as the profiler names them:
    one kernel family, counted under "bounce", "bounce_disney",
    "bounce_delta" and "bounce_disney_delta", the keys `bounce_key` gives
    the families each shades."""
    from caitlynrenderer_tpu_torch.ops import _build

    name = "_ZN12_GLOBAL__N_119shade_bounce_kernelILb{}ELb{}EEEv9ShadeArgs".format
    lam, dis, delta, both = name(0, 0), name(1, 0), name(0, 1), name(1, 1)
    fin = "_ZN12_GLOBAL__N_119shade_finish_kernelExPKbS1_PKfPf"
    for n in (lam, dis, delta, both,
              "void (anonymous namespace)::shade_bounce_kernel<true, true>(ShadeArgs)"):
        assert metrics.kernel_family(n) == "shade_bounce_kernel"
    counts = _build.count_kernels([lam, lam, dis, delta, delta, delta, both, fin])["shade"]
    assert counts == {"bounce": 2, "bounce_disney": 1, "bounce_delta": 3,
                      "bounce_disney_delta": 1, "finish": 1,
                      **{f"{k}_twin": 0 for k in (*shade.BOUNCE_KEYS, "finish")}}
    assert [shade.bounce_key(f) for f in (("lambert",), ("lambert", "disney"),
                                          ("lambert", "mirror"), ("lambert", "glass"),
                                          ("lambert", "disney", "mirror", "glass"))] == [
        "bounce", "bounce_disney", "bounce_delta", "bounce_delta", "bounce_disney_delta"]
    assert set(shade.BOUNCE_KEYS) | {"finish"} == {k for k in shade.launches
                                                   if not k.endswith("_twin")}


def test_args_struct_is_the_sources():
    """ctypes' _Args lists the C struct's fields in its order, with its
    types."""
    body = re.search(r"struct ShadeArgs \{(.*?)\n\};", SOURCE, re.S).group(1)
    fields = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    ctype = {"long long": ctypes.c_longlong, "int": ctypes.c_int, "float": ctypes.c_float}
    want = [(name, ctypes.c_void_p if t.endswith("*") else ctype[t]) for t, name in fields]
    assert shade._Args._fields_ == want and len(want) == 29


def _constant(name):
    return float(re.search(rf"constexpr float {name} = static_cast<float>\(([^)]+)\);",
                           SOURCE).group(1))


def test_disney_constants_are_the_twins():
    """The Disney branch's constants are Python scalars of the twins'
    code (ops/bsdf.py, core/math.py, the integrator), and its Lambert mask
    is core/types.LAMBERT_TYPES."""
    from caitlynrenderer_tpu_torch.core.types import LAMBERT_TYPES
    from caitlynrenderer_tpu_torch.ops import bsdf

    twins = "".join(pathlib.Path(m.__file__).read_text() for m in (bsdf, cm, integrator))
    block = SOURCE[SOURCE.index("ops/bsdf.py's Python scalars"):]
    block = block[:block.index("\n\n")]
    found = re.findall(r"constexpr float (\w+) = static_cast<float>\(([^;]+)\);", block)
    assert len(found) == 19
    for name, expr in found:
        if name != "kPi":
            assert expr in twins, name
    assert _constant("kPi") == math.pi
    bits = re.search(r"kLambertTypes = \(1ull << (\d+)\) \| \(1ull << (\d+)\);", SOURCE)
    mask = sum(1 << int(b) for b in bits.groups())
    assert mask == sum(1 << int(t) for t in LAMBERT_TYPES)


def test_kernel_constants_are_the_twins():
    """The kernel's constants are the twins' Python scalars (rounded to
    float as torch rounds them) and the tables' widths."""
    assert _constant("kEps") == integrator.EPS == cm.EPS
    assert _constant("kRayOffset") == integrator.RAY_OFFSET
    assert int(re.search(r"constexpr int kRow = (\d+);", SOURCE).group(1)) == shade.SHADE_COLS
    assert int(re.search(r"constexpr int kLightRow = (\d+);", SOURCE).group(1)) == (
        shade.LIGHT_COLS)
    ds, _, _ = _cornell()
    assert ds.shade_tab.shape[1] == shade.SHADE_COLS and ds.light_tab.shape[1] == shade.LIGHT_COLS


def test_delta_constants_are_the_twins():
    """The delta lobes' masks are core/types.SPECULAR_TYPES, the
    integrator's _GLASS_IDS and MIRROR; their constants the twin's Python
    scalars (`1.0 / torch.clamp(ior, min=1e-6)`, the glass's 1e-12 floors,
    the refracted origin's -2.0 * RAY_OFFSET)."""
    from caitlynrenderer_tpu_torch.core.types import SPECULAR_TYPES

    def mask(name):
        body = re.search(rf"constexpr unsigned long long {name} = ([^;]+);", SOURCE).group(1)
        return sum(1 << int(b) for b in re.findall(r"1ull << (\d+)", body))

    assert mask("kSpecularTypes") == sum(1 << int(t) for t in SPECULAR_TYPES)
    assert mask("kGlassTypes") == sum(1 << t for t in integrator._GLASS_IDS)
    mirror = re.search(r"constexpr int kMirrorType = (\d+);", SOURCE).group(1)
    assert int(mirror) == int(MaterialType.MIRROR)
    twin = pathlib.Path(integrator.__file__).read_text()
    assert "torch.clamp(ior, min=1e-6)" in twin and _constant("kIorFloor") == 1e-6
    assert twin.count("min=1e-12)") == 3 and _constant("kFresnelFloor") == 1e-12
    assert "-2.0 * RAY_OFFSET * n_flip" in twin
    offset = re.search(r"kRefractOffset = static_cast<float>\(-2\.0 \* ([\d.e-]+)\)", SOURCE)
    assert float(offset.group(1)) == integrator.RAY_OFFSET


def _wrapper_args(n=8, n_u=25):
    f32 = torch.float32
    tabs = (_cuda(torch.zeros((4, 50))), _cuda(torch.zeros((2, 17))))
    rays = (_cuda(torch.zeros((n, 3))), _cuda(torch.zeros((n, 3))),
            _cuda(torch.zeros(n, dtype=torch.int32)), _cuda(torch.zeros((n, n_u))))
    state = shade.PathState(_cuda(torch.ones(n, dtype=torch.bool)), _cuda(torch.ones((n, 3))),
                            _cuda(torch.zeros((n, 3))), _cuda(torch.zeros(n, dtype=f32)))
    return tabs, rays, state


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "CUDA tensors only"),
    ("tri dtype", TypeError, "tri has dtype"),
    ("T shape", ValueError, "T has shape"),
    ("uniforms too short", ValueError, "hold no bounce 3"),
    ("uniforms not contiguous", ValueError, "uniforms must be contiguous"),
    ("no light", ValueError, "at least one light"),
    ("prev pending dtype", TypeError, "pending has dtype"),
    ("a family it does not take", ValueError, "shades the families"),
    ("no specular flag", ValueError, "needs its specular flag"),
    ("specular flag dtype", TypeError, "specular has dtype"),
])
def test_shade_bounce_refuses_bad_inputs(case, error, match):
    """The wrapper raises before any launch on what the kernel does not
    take: among them a delta family without the path state's specular
    flag."""
    (shade_tab, light_tab), (o, d, tri, uni), state = _wrapper_args()
    bounce, prev, families = 1, None, ("lambert",)
    if case == "cpu":
        o = o.as_subclass(torch.Tensor)
    elif case == "tri dtype":
        tri = _cuda(torch.zeros(8, dtype=torch.int64))
    elif case == "T shape":
        state = state._replace(T=_cuda(torch.ones((8, 4))))
    elif case == "uniforms too short":
        bounce = 3
    elif case == "uniforms not contiguous":
        uni = _cuda(torch.zeros((25, 8))).t()
    elif case == "no light":
        light_tab = light_tab[:0]
    elif case == "prev pending dtype":
        prev = (_cuda(torch.ones(8, dtype=torch.bool)), _cuda(torch.zeros(8, dtype=torch.bool)),
                _cuda(torch.zeros((8, 3), dtype=torch.float64)))
    elif case == "a family it does not take":
        families = ("lambert", "plastic")
    elif case == "no specular flag":
        families = ("lambert", "glass")
    elif case == "specular flag dtype":
        families = ("lambert", "mirror")
        state = state._replace(specular=_cuda(torch.zeros(8)))
    shade.reset_launches()
    with pytest.raises(error, match=match):
        shade.shade_bounce(shade_tab, light_tab, o, d, tri, uni, bounce, state, prev,
                           families=families)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        shade.shade_finish(torch.zeros((8, 3)), torch.ones(8, dtype=torch.bool),
                           torch.zeros(8, dtype=torch.bool), torch.zeros((8, 3)))
    assert _no_launches()


# --------------------------------------------------------------------------
# Card
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel B6 has no CPU mode)")
    return torch.device("cuda", 0)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _torch_path(monkeypatch):
    monkeypatch.setattr(integrator, "fused_shading", lambda *a, **k: False)


BOUNCE_CASES = [("cornell", 0, False), ("cornell", 1, False), ("cornell", 1, True),
                ("disney", 0, False), ("disney", 1, False), ("disney_lobes", 1, True),
                ("specular", 0, False), ("specular", 1, False), ("specular", 1, True),
                ("mirror", 1, False), ("glass", 1, False), ("disney_delta", 0, False),
                ("disney_delta", 1, True)]


def _bounce_scene(scene, dev):
    """(ds, camera, options) of a BOUNCE_CASES scene at 700x700."""
    if scene == "cornell":
        return _cornell("brute", 700, 700, dev)
    if scene in ("disney", "disney_lobes"):
        return _disney("brute", 700, 700, dev, scene == "disney_lobes")
    if scene == "specular":
        sc, camera, options = _specular_scene("bvh2", 700, 700)
    elif scene == "disney_delta":
        sc, camera, options = _disney_delta_scene("brute", 700, 700)
    else:
        floor = MaterialType.MIRROR if scene == "mirror" else MaterialType.GLASS
        sc, camera, options = _floor_scene(floor, "brute", 700, 700)
    ds = upload_scene(sc, options.accel, dev)
    return ds, camera, options._replace(max_stack=required_stack(ds))


@pytest.mark.cuda
@pytest.mark.parametrize("scene,bounce,exact", BOUNCE_CASES)
def test_b6_bounce_equals_twin_on_the_card(dev, scene, bounce, exact):
    """One launch of B6 against its plain twin on the card (torch's CUDA
    ops) on the primary rays of the 700x700 cornell (the Lambert
    instantiation), of the Disney-floor cornell (the cornell_disney700
    cell's scene; the Disney one), of the LOBES floor, of the mirror and
    the glass floor and of the benchmark's specular box (the delta one),
    and of the Disney floor with a glass and a CONDUCTOR box (Disney and
    delta), with a random state (the delta flag included) and a random
    previous NEE: every output bit for bit where the loop reads it (alive,
    T, L, cand and t_max on every lane; ldir and pending where cand; o, d
    and prev_pdf where the lane went on shading; the delta flag where it
    goes on)."""
    ds, camera, options = _bounce_scene(scene, dev)
    fams = options.families
    delta = shade.has_delta(fams)
    o, d, uni = _inputs(ds, camera, options)
    n = o.shape[0]
    tri = integrator._closest_hit_raw(ds, o, d, torch.ones(n, dtype=torch.bool, device=dev),
                                      options)[1]
    g = torch.Generator().manual_seed(5)
    state = shade.PathState(torch.rand(n, generator=g) < 0.9, torch.rand((n, 3), generator=g),
                            torch.rand((n, 3), generator=g), torch.rand(n, generator=g),
                            (torch.rand(n, generator=g) < 0.5) if delta else None)
    prev = (torch.rand(n, generator=g) < 0.5, torch.rand(n, generator=g) < 0.3,
            torch.rand((n, 3), generator=g)) if bounce else None
    state = shade.PathState(*(x.to(dev) if x is not None else None for x in state))
    prev = tuple(x.to(dev) for x in prev) if prev else None
    twin_state = shade.PathState(*(x.clone() if x is not None else None for x in state))
    alive_in = twin_state.alive
    shade.reset_launches()
    got = shade.shade_bounce(ds.shade_tab, ds.light_tab, o, d, tri, uni, bounce, state, prev,
                             exact, families=fams)
    want = integrator.shade_bounce_plain(ds, o, d, tri, uni, bounce, twin_state,
                                         options._replace(exact_reference_nee=exact), prev)
    twin_state = want.state
    torch.cuda.synchronize()
    assert got.state is state
    assert shade.launches[shade.bounce_key(fams)] == 1
    assert torch.equal(state.alive, twin_state.alive) and torch.equal(got.cand, want.cand)
    for name in ("T", "L"):
        assert _bits_equal(getattr(state, name), getattr(twin_state, name)), name
    assert _bits_equal(got.t_max, want.t_max)
    # The lanes that went on shading: alive, a hit, not emissive.
    went_on = alive_in & (tri >= 0) & (ds.shade_tab[tri.clamp(min=0).long(), 33] == -1)
    assert _bits_equal(state.prev_pdf[went_on], twin_state.prev_pdf[went_on])
    for name, lanes in (("o", went_on), ("d", went_on), ("ldir", got.cand),
                        ("pending", got.cand)):
        assert _bits_equal(getattr(got, name)[lanes], getattr(want, name)[lanes]), name
    assert 0 < int(got.cand.sum()) < int(state.alive.sum()) < n and bool(went_on.any())
    if delta:
        # The delta flag where the path goes on; some lanes took a delta lobe.
        on = twin_state.alive
        assert torch.equal(state.specular[on], twin_state.specular[on])
        assert bool(twin_state.specular[on].any()) and not bool(twin_state.specular[on].all())
    if scene == "disney_delta":
        # CONDUCTOR lanes: no shadow ray, a Lambert bounce, no delta flag.
        rows = ds.shade_tab[tri.clamp(min=0).long()]
        conductor = went_on & (torch.round(rows[:, 29]) == int(MaterialType.CONDUCTOR))
        assert bool(conductor.any()) and not bool(got.cand[conductor].any())
        assert not bool(state.specular[conductor & state.alive].any())


CARD_CASES = ["cornell_brute", "cornell_exact_nee", "cornell_rr_from_0", "grid_wide",
              "grid_bvh2_rr_from_1", "disney", "disney_lobes_exact_nee_rr_from_1",
              "specular_box", "specular_box_exact_nee", "mirror_floor", "glass_floor_rr_from_1",
              "disney_delta", "disney_delta_exact_nee_rr_from_1"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_fused_render_equals_torch_path_on_the_card(dev, name, monkeypatch):
    """Four eager samples through B6 ≡ four through the torch path, bit for
    bit on the accumulation (700x700 cornell, Disney-floor cornell, mirror
    and glass floors and the Disney floor with glass and CONDUCTOR boxes;
    displaced_grid(224) at 256x256 under wide and bvh2; the specular box
    at 64x64 and 8 bounces): max_depth B6 launches of the scene's
    instantiation and one finishing launch a sample, none on the torch
    path; `trace_paths` leaves the caller's rays as they were."""
    w = {"grid": 256, "specular": 64}.get(FUSED_CASES[name][0], 700)
    ds, camera, options = _fused_case(name, dev, w, w, resolution=224)
    depth, spp = options.max_depth, 4

    def render():
        st = progressive.init_state(w, w, 3, dev)
        for _ in range(spp):
            st = progressive.render_step(ds, camera, st, w, w, options)
        return st.accum

    shade.reset_launches()
    got = render()
    want_launches = dict.fromkeys(shade.launches, 0)
    want_launches[shade.bounce_key(options.families)] = depth * spp
    want_launches["finish"] = spp
    assert shade.launches == want_launches
    with monkeypatch.context() as m:
        _torch_path(m)
        shade.reset_launches()
        want = render()
        assert _no_launches()
    assert _bits_equal(got, want) and float(want.sum()) > 0
    # One trace of camera rays: B6 writes its next rays into the loop's own
    # buffers, never into the caller's, and the last NEE takes one finishing
    # launch.
    o, d, uni = _inputs(ds, camera, options)
    o0, d0 = o.clone(), d.clone()
    shade.reset_launches()
    L = integrator.trace_paths(ds, o, d, uni, options)
    torch.cuda.synchronize()
    assert shade.launches["finish"] == 1 and float(L.sum()) > 0
    assert _bits_equal(o, o0) and _bits_equal(d, d0)


@pytest.mark.cuda
def test_fused_graph_equals_torch_path_on_the_card(dev, monkeypatch):
    """A 16-sample CUDA graph of the 700x700 cornell through B6 ≡ 16 eager
    torch-path samples bit for bit.  The graph holds max_depth B6 nodes
    and one finishing node a sample, all in the "shade" group, and no node
    in hit, nee or bounce; its record says fused_shading."""
    ds, camera, options = _cornell("brute", 700, 700, dev)
    w = h = 700
    depth, spp = options.max_depth, 16
    progressive.clear_graphs()
    with monkeypatch.context() as m:
        _torch_path(m)
        eager = progressive.init_state(w, h, 9, dev)
        for _ in range(spp):
            eager = progressive.render_step(ds, camera, eager, w, h, options)
    shade.reset_launches()
    graph = progressive.render_steps(ds, camera, progressive.init_state(w, h, 9, dev), w, h,
                                     options, spp)
    torch.cuda.synchronize()
    assert _bits_equal(graph.accum, eager.accum)
    (g,) = progressive._graphs.values()
    assert g.fused_shading and metrics.last_records["graph_capture"]["fused_shading"] is True
    want_launches = dict.fromkeys(shade.launches, 0)
    want_launches.update(bounce=depth * spp, finish=spp)
    assert g.launches["shade"] == want_launches
    assert g.phase_nodes["shade"] == (depth + 1) * spp
    assert not {"hit", "nee", "bounce"} & set(g.phase_nodes)
    # The replay adds the graph's launches; the capture's warm-up sample its own.
    assert shade.launches["bounce"] == depth * (spp + 1)
    progressive.clear_graphs()


@pytest.mark.cuda
def test_tiled_and_sharded_renders_take_b6_on_the_card(dev, monkeypatch):
    """A 2x3-tiled render and the 1x1 sharded step run the same no-grad
    trace_paths: through B6, each ≡ the torch path's untiled render bit for
    bit."""
    from caitlynrenderer_tpu_torch.parallel.mesh import SINGLE
    from caitlynrenderer_tpu_torch.parallel.render import init_sharded_state, sharded_render_step
    from caitlynrenderer_tpu_torch.render.tiled import accumulate_tiled

    ds, camera, options = _cornell("brute", 120, 90, dev)
    w, h, spp = options.width, options.height, 2
    with monkeypatch.context() as m:
        _torch_path(m)
        want = progressive.init_state(w, h, 0, dev)
        for _ in range(spp):
            want = progressive.render_step(ds, camera, want, w, h, options)
    shade.reset_launches()
    tiled = accumulate_tiled(ds, camera, options._replace(num_tiles_x=2, num_tiles_y=3), spp, 0)
    assert shade.launches["bounce"] == options.max_depth * spp * 6
    assert _bits_equal(tiled, want.accum)
    shade.reset_launches()
    state = init_sharded_state(SINGLE, w, h, 0, dev)
    for _ in range(spp):
        state = sharded_render_step(ds, camera, state, SINGLE, w, h, options)
    assert shade.launches["bounce"] == options.max_depth * spp
    assert _bits_equal(state.accum, want.accum)
