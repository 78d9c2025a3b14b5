"""Gradients of the port ≡ the reference's `jax.value_and_grad`.

The same numpy parameters (every group grad/inverse.apply_params takes),
the same target and the same uniforms (both packages' `draw_uniforms`
are bitwise equal) go through the reference's `make_loss` under
`jax.value_and_grad` (compiled under bvh2, whose walk is a while loop;
op by op under brute, where one compile of the Disney pass takes a
minute), and through the port's loss and `backward`.  Cases: the reference's `_setup` of tests/test_grad.py
(cornell without boxes, 12², 2 bounces) under bvh2 and brute; the Disney
floor at 12², 3 bounces, with Russian roulette from bounce 1 (pins the
detached survival probability); the glass floor lit by the sky (miss
lanes, refraction).  Tolerances: the loss rtol 1e-5; each gradient entry
rtol 1e-4, atol 1e-6 · max|g_ref|, and for vertices rtol 1e-3, atol
1e-5 · max|g_ref|, as XLA on the CPU contracts multiply-adds and torch
does not.  Every gradient is finite.

Also: the port's albedo gradient against central differences (as
tests/test_grad.py does for the reference), the ray queries detached at
the dispatch, and apply_params' rebuilt shading table and brute-force
slab against the reference's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu.core.types import MaterialType, RenderOptions, make_camera
from caitlynrenderer_tpu.grad import inverse as j_inverse
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box, procedural_sky
from caitlynrenderer_tpu.render import integrator as j_integrator
from caitlynrenderer_tpu.scene import scene_families, upload_scene as j_upload
from caitlynrenderer_tpu_torch import convert
from caitlynrenderer_tpu_torch.core.camera import generate_rays
from caitlynrenderer_tpu_torch.grad import inverse as t_inverse
from caitlynrenderer_tpu_torch.ops.intersect import pack_tris
from caitlynrenderer_tpu_torch.render import integrator as t_integrator
from caitlynrenderer_tpu_torch.render import sampling
from caitlynrenderer_tpu_torch.scene import required_stack, upload_scene as t_upload

KEYS = ("albedo", "disney", "emission", "vertices", "cam_position", "cam_fov")


def _camera(pos, tilt=0.0):
    pos = np.asarray(pos, np.float32)
    return make_camera(pos, pos + np.array([0.0, -tilt, -1.0], np.float32), 40.0)


def _case(name):
    """(scene, camera, options) of a parity case."""
    if name in ("bvh2", "brute"):  # tests/test_grad.py:_setup
        scene, _ = cornell_box(with_boxes=False)
        return scene, _camera([2.78, 2.73, 7.5]), RenderOptions(
            width=12, height=12, max_depth=2, accel=name, families=scene_families(scene))
    camera = _camera([2.8, 2.75, 13.18])  # scenes/cornell.toml's
    if name == "disney_rr":
        scene = cornell_box(floor_type=int(MaterialType.DISNEY))[0]
        options = RenderOptions(width=12, height=12, max_depth=3, accel="brute", rr_start=1)
    else:
        scene = cornell_box(floor_type=int(MaterialType.GLASS))[0]
        scene = scene._replace(env_map=procedural_sky(16, 32))
        options = RenderOptions(width=12, height=12, max_depth=3, accel="brute",
                                use_env_map=True)
    return scene, camera, options._replace(families=scene_families(scene))


def _params(scene, camera):
    m = scene.materials
    p = {"albedo": m.albedo, "disney": m.disney, "emission": m.emission,
         "vertices": scene.vertices, "cam_position": camera.position, "cam_fov": camera.fov}
    return {k: np.asarray(p[k], np.float32) for k in KEYS}


def _port(scene, accel):
    ds = t_upload(scene, accel, "cpu")
    return ds, required_stack(ds)


def assert_grad_close(got, want, key):
    rtol, k = (1e-3, 1e-5) if key == "vertices" else (1e-4, 1e-6)
    assert np.isfinite(got).all() and np.isfinite(want).all(), key
    np.testing.assert_allclose(got, want, rtol=rtol, atol=k * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("name", ["bvh2", "brute", "disney_rr", "glass_sky"])
def test_loss_and_gradients_match_reference(name):
    scene, camera, options = _case(name)
    w, h = options.width, options.height
    params = _params(scene, camera)
    target = np.random.default_rng(0).uniform(0.0, 0.5, (w * h, 3)).astype(np.float32)

    j_loss = jax.value_and_grad(j_inverse.make_loss(j_upload(scene, accel=options.accel), camera,
                                                    jnp.asarray(target), w, h, options))
    j_args = ({k: jnp.asarray(v) for k, v in params.items()}, jax.random.PRNGKey(3))
    if options.accel == "bvh2":
        want_loss, want = jax.jit(j_loss)(*j_args)
    else:  # op by op: compiling the whole Disney pass takes a minute
        with jax.disable_jit():
            want_loss, want = j_loss(*j_args)

    ds, stack = _port(scene, options.accel)
    leaves = {k: v.requires_grad_(True) for k, v in convert.params_from_numpy(params, "cpu").items()}
    loss = t_inverse.make_loss(ds, camera, torch.from_numpy(target), w, h,
                               options._replace(max_stack=stack))(leaves, sampling.prng_key(3))
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key in KEYS:
        assert_grad_close(leaves[key].grad.numpy(), np.asarray(want[key]), key)
    # Every group but the Lambert scenes' Disney rows has a gradient.
    assert np.abs(leaves["albedo"].grad.numpy()).max() > 0
    assert np.abs(leaves["vertices"].grad.numpy()).max() > 0
    assert np.abs(leaves["cam_position"].grad.numpy()).max() > 0
    if name == "disney_rr":
        assert np.abs(leaves["disney"].grad.numpy()).max() > 0


def test_albedo_gradient_finite_difference():
    """d(mean radiance)/d(albedo) of the port against central differences,
    as tests/test_grad.py holds the reference's: albedo enters shading
    smoothly, so autograd matches the differences tightly."""
    scene, camera, options = _case("bvh2")
    w, h = options.width, options.height
    ds, stack = _port(scene, "bvh2")
    options = options._replace(max_stack=stack)
    uni = sampling.draw_uniforms(sampling.prng_key(3), w * h, options.max_depth, "cpu")

    def f(albedo):
        ds2, cam2 = t_inverse.apply_params(ds, camera, {"albedo": albedo})
        return t_integrator.render_sample(ds2, cam2, uni, w, h, options).mean()

    albedo0 = ds.scene.materials.albedo.clone().requires_grad_(True)
    f(albedo0).backward()
    ga = albedo0.grad.numpy()
    entries = np.argwhere(np.abs(ga) > 1e-6)
    assert len(entries) > 0
    eps = 1e-3
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for mi, ci in entries[rng.permutation(len(entries))[:4]]:
            e = torch.zeros_like(albedo0)
            e[mi, ci] = eps
            fd = (float(f(albedo0 + e)) - float(f(albedo0 - e))) / (2 * eps)
            assert np.isclose(fd, ga[mi, ci], rtol=2e-2, atol=1e-6), (mi, ci, fd, ga[mi, ci])


@pytest.mark.parametrize("accel", ["brute", "bvh2", "wide", "cwbvh"])
def test_ray_queries_are_detached_at_the_dispatch(accel):
    """With rays that require grad, the closest-hit and any-hit queries
    return tensors without grad (the twins record no ray x triangle
    graph), while the hit refined from them keeps its graph."""
    scene, camera, _ = _case("disney_rr")
    ds, stack = _port(scene, accel)
    options = RenderOptions(accel=accel, max_stack=stack)
    uni = torch.from_numpy(np.random.default_rng(1).random((64, 25), dtype=np.float32))
    position = torch.tensor(camera.position, requires_grad=True)
    o, d = generate_rays(camera._replace(position=position), 8, 8, uni)
    assert o.requires_grad
    active = torch.ones(64, dtype=torch.bool)
    raw = t_integrator._closest_hit_raw(ds, o, d, active, options)
    assert not any(x.requires_grad for x in raw)
    assert int((raw[1] >= 0).sum()) > 40
    hf = t_integrator.hit_frame(ds, o, d, *raw)
    assert hf.t.requires_grad and hf.point.requires_grad
    t_max = (hf.t * 0.5).clone()
    assert t_max.requires_grad
    occ = t_integrator._occluded(ds, hf.point, d, t_max, active, options)
    assert not occ.requires_grad and occ.dtype == torch.bool


def _perturbed(scene, camera):
    rng = np.random.default_rng(4)
    p = _params(scene, camera)
    p["albedo"][:, :3] *= 0.7
    p["disney"] = rng.uniform(0.0, 1.0, p["disney"].shape).astype(np.float32)
    p["emission"][:, :3] *= 1.5
    p["vertices"] = p["vertices"] + rng.normal(0.0, 0.05, p["vertices"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("accel", ["brute", "bvh2"])
def test_apply_params_rebuilds_the_shading_table(accel):
    """The overlaid scene's (T, 50) table equals the reference's
    `_build_shade_table` of its overlaid scene, bit for bit."""
    scene, camera, _ = _case("disney_rr")
    params = _perturbed(scene, camera)
    jds2, _ = j_inverse.apply_params(j_upload(scene, accel=accel), camera,
                                     {k: jnp.asarray(v) for k, v in params.items()})
    want = np.asarray(j_integrator._build_shade_table(jds2.scene))
    ds2, cam2 = t_inverse.apply_params(t_upload(scene, accel, "cpu"), camera,
                                       convert.params_from_numpy(params, "cpu"))
    np.testing.assert_array_equal(ds2.shade_tab.numpy(), want)
    np.testing.assert_array_equal(cam2.position.numpy(), params["cam_position"])


def test_moved_vertices_are_seen_by_the_brute_query():
    """Under brute the slab follows the `vertices` parameter (detached), as
    the reference packs it from the overlaid vertices: the depth AOV of the
    moved scene equals the reference's (atol 1e-5) and differs from the
    unmoved one; the upload's slab is left as it was."""
    scene, camera, options = _case("disney_rr")
    params = _perturbed(scene, camera)
    verts = {"vertices": params["vertices"]}
    options = options._replace(width=16, height=16, aov="depth")
    uni = np.random.default_rng(2).random((256, 25), dtype=np.float32)
    jds2, _ = j_inverse.apply_params(j_upload(scene, accel="brute"), camera,
                                     {"vertices": jnp.asarray(verts["vertices"])})
    want = np.asarray(j_integrator.render_sample(jds2, camera, jnp.asarray(uni), 16, 16, options))

    ds = t_upload(scene, "brute", "cpu")
    tris9 = ds.tris9.clone()
    moved = convert.params_from_numpy(verts, "cpu")["vertices"].requires_grad_(True)
    ds2, _ = t_inverse.apply_params(ds, camera, {"vertices": moved})
    assert not ds2.tris9.requires_grad and torch.equal(ds.tris9, tris9)
    assert torch.equal(ds2.tris9, pack_tris(moved.detach(), ds.scene.tri_v))
    got = t_integrator.render_sample(ds2, camera, torch.from_numpy(uni), 16, 16, options)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    before = t_integrator.render_sample(ds, camera, torch.from_numpy(uni), 16, 16, options)
    assert float((got - before).abs().max().detach()) > 1e-2
