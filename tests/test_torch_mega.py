"""Port's wide-BVH path ≡ the reference's.

The port's `mega_closest`/`mega_anyhit` on CPU tensors run their plain
twins; the reference's run its own non-TPU path, the dense
`_xla_reference`, on the CPU.  Same numpy inputs to both, at the sizes of
tests/test_mega.py: cornell with 64-triangle groups, `soup(2000)` and
`displaced_grid(24)` with 128.  Tolerances, each with its reason:
  * host packers and uploads: byte-equal (NaN padding included);
  * traversal vs the reference: hit or miss equal, `tri` equal or t-close
    (rtol 5e-4, ties on shared edges may pick either triangle), `group`
    equal where `tri` is, and t within rtol 1e-5 + atol 1e-6.  XLA's CPU
    dot contracts o·n into fused multiply-adds and the port rounds every
    product (as the CUDA kernel does, built with --fmad=false); the
    subtraction o·n + dn then cancels, which for a hit a few hundredths
    from its origin turns an ulp of |o| into ~1e-6 of t;
  * traversal vs the port's brute-force twin (Möller–Trumbore vs
    Baldwin–Weber): tests/test_mega.py's contract, hit/miss and occlusion
    equal, t rtol 5e-4;
  * trace_paths with shared uniforms: per pixel atol 1e-5, stats equal.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu import scene as j_scene
from caitlynrenderer_tpu.accel.bvh import build_bvh, reorder_scene
from caitlynrenderer_tpu.accel.wide import build_wide
from caitlynrenderer_tpu.core.camera import generate_rays as j_generate_rays
from caitlynrenderer_tpu.core.types import RenderOptions, make_camera
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box, displaced_grid, random_triangle_soup
from caitlynrenderer_tpu.ops import traverse_mega as j_mega
from caitlynrenderer_tpu.render import integrator as j_integrator
from caitlynrenderer_tpu.utils import config
from caitlynrenderer_tpu_torch import cli, convert
from caitlynrenderer_tpu_torch import scene as t_scene
from caitlynrenderer_tpu_torch.core.camera import generate_rays as t_generate_rays
from caitlynrenderer_tpu_torch.ops import mt_brute
from caitlynrenderer_tpu_torch.ops import traverse_mega as t_mega
from caitlynrenderer_tpu_torch.render import integrator as t_integrator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")

SCENES = {
    "cornell": (lambda: cornell_box()[0], 64),
    "soup": (lambda: random_triangle_soup(2000, seed=1)[0], 128),
    "grid": (lambda: displaced_grid(resolution=24)[0], 128),
}
_CACHE = {}


def _uploads(name):
    """(scene, reference wide DeviceScene, port wide DeviceScene), built once."""
    if name not in _CACHE:
        make, kg = SCENES[name]
        sc = make()
        _CACHE[name] = (sc, j_scene.upload_scene(sc, accel="wide", wide_group_tris=kg),
                        t_scene.upload_scene(sc, "wide", "cpu", wide_group_tris=kg))
    return _CACHE[name]


def _mixed_rays(scene, n, seed):
    """tests/test_mega.py's ray set: half aimed at random triangle
    centroids (high hit rate), half fully random, from the scene's box
    grown by 1."""
    rng = np.random.default_rng(seed)
    lo = scene.vertices.min(axis=0) - 1.0
    hi = scene.vertices.max(axis=0) + 1.0
    o = rng.random((n, 3)).astype(np.float32) * (hi - lo) + lo
    d = rng.standard_normal((n, 3)).astype(np.float32)
    h = n // 2
    tid = rng.integers(0, scene.num_triangles, h)
    cen = np.asarray(scene.vertices)[np.asarray(scene.tri_v)[tid, :3]].mean(axis=1)
    d[:h] = cen - o[:h]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _wide_args(ds):
    """The wide arrays of either package's DeviceScene, in argument order."""
    return [getattr(ds, k) for k in t_scene.WIDE_FIELDS]


def _closest_both(name, o, d, active):
    _, jds, tds = _uploads(name)
    ref = j_mega.mega_closest(jnp.asarray(o), jnp.asarray(d), jnp.asarray(active),
                              *_wide_args(jds))
    got = t_mega.mega_closest(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active),
                              *_wide_args(tds))
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def _assert_closest_matches(ref, got, tag):
    (tj, trj, gj), (tt, trt, gt) = ref, got
    hit = trj >= 0
    np.testing.assert_array_equal(trt >= 0, hit, err_msg=tag)
    same = trt == trj
    assert (same | np.isclose(tt, tj, rtol=5e-4))[hit].all(), tag
    np.testing.assert_array_equal(gt[same], gj[same], err_msg=tag)
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-5, atol=1e-6, err_msg=tag)
    assert (tt[~hit] == 1e9).all() and (gt[~hit] == -1).all(), tag
    return hit


# --------------------------------------------------------------------------
# Host precompute and upload
# --------------------------------------------------------------------------


def _built(name, kg):
    sc = SCENES[name][0]()
    bvh = build_bvh(sc.vertices, sc.tri_v, max_leaf=4)
    sr = reorder_scene(sc, bvh)
    return build_wide(np.asarray(sr.vertices), np.asarray(sr.tri_v), bvh, group_tris=kg)


@pytest.mark.parametrize("name,kg", [("cornell", 64), ("soup", 128), ("grid", 128), ("soup", 8)])
def test_packers_byte_equal_reference(name, kg):
    wb = _built(name, kg)
    g = wb.group_bounds.shape[0]
    assert g % 128 != 0 and (wb.tri_index < 0).any()  # ragged G, padding rows
    np.testing.assert_array_equal(t_mega.pack_mega(wb.packed_tris, wb.tri_index),
                                  j_mega.pack_mega(wb.packed_tris, wb.tri_index))
    got = t_mega.pack_octants(wb.group_bounds, wb.tri_index[:, 0])
    ref = j_mega.pack_octants(wb.group_bounds, wb.tri_index[:, 0])
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)  # NaN padding compares equal
    if kg == 8:
        assert got[3].shape[1] > 1  # several 128-entry blocks per worklist


def test_pack_mega_degenerate_and_empty_inputs():
    tris = np.zeros((2, 3, 9), np.float32)
    tris[0, 0] = [0, 0, 0, 1, 0, 0, 0, 1, 0]
    tris[0, 1] = [0, 0, 0, 1, 1, 0, 2, 2, 0]  # colinear: zero planes
    idx = np.array([[0, 1, -1], [2, -1, -1]], np.int32)
    np.testing.assert_array_equal(t_mega.pack_mega(tris, idx), j_mega.pack_mega(tris, idx))
    empty = (np.zeros((0, 6), np.float32), np.zeros(0, np.int32))
    for a, b in zip(t_mega.pack_octants(*empty), j_mega.pack_octants(*empty)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_upload_wide_equals_reference(name):
    sc, jds, tds = _uploads(name)
    for k in t_scene.WIDE_FIELDS:
        ref = np.asarray(getattr(jds, k))
        got = getattr(tds, k).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    for k in ("vertices", "tri_v", "tri_vn", "tri_vt"):  # the BVH-reordered scene
        np.testing.assert_array_equal(getattr(tds.scene, k).numpy(),
                                      np.asarray(getattr(jds.scene, k)), err_msg=k)
    np.testing.assert_array_equal(
        tds.shade_tab.numpy(), np.asarray(j_integrator._build_shade_table(jds.scene)))
    assert tds.tris9.shape == (sc.num_triangles, 9)


def test_group_size_policy():
    assert t_scene.wide_group_size(99_460) == 256  # grid100k
    assert t_scene.wide_group_size(999_700) == 512  # grid1m
    assert t_scene.wide_group_size(20_002) == 256
    assert t_scene.wide_group_size(10**8) == 1024
    assert t_scene.wide_group_size(999_700, 64) == 64  # explicit: as given
    assert t_scene.wide_group_size(10, 0) == 1
    # The default upload builds what the reference's default builds.
    sc = random_triangle_soup(3000, seed=2)[0]
    jds = j_scene.upload_scene(sc, accel="wide")
    tds = t_scene.upload_scene(sc, "wide", "cpu")
    np.testing.assert_array_equal(tds.wb_mega.numpy(), np.asarray(jds.wb_mega))
    assert tds.wb_mega.shape[2] == 3 * 256


def test_empty_scene_uploads_placeholders_and_misses():
    sc = cornell_box()[0]
    sc = sc._replace(tri_v=sc.tri_v[:0], tri_vn=sc.tri_vn[:0], tri_vt=sc.tri_vt[:0])
    ds = t_scene.upload_scene(sc, "wide", "cpu")
    assert ds.wb_mega.shape[0] == 0 and ds.wb_group_bounds.shape == (0, 6)
    o = torch.zeros((5, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 5)
    t, tri, grp = t_mega.mega_closest(o, d, torch.ones(5, dtype=torch.bool), *_wide_args(ds))
    assert (tri == -1).all() and (grp == -1).all() and (t == 1e9).all()


# --------------------------------------------------------------------------
# Traversal against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENES))
def test_mega_closest_matches_reference(name):
    sc = _uploads(name)[0]
    o, d = _mixed_rays(sc, 512, seed=9)
    ref, got = _closest_both(name, o, d, np.ones(512, bool))
    hit = _assert_closest_matches(ref, got, name)
    assert hit.mean() > 0.5, f"{name}: ray set not hit-heavy enough"
    # The winning group holds the winning triangle.
    tds = _uploads(name)[2]
    g = tds.wb_mega.shape[0]
    starts = t_mega._group_starts(tds.wb_oct_gid, tds.wb_oct_start, g).numpy()
    ends = np.append(starts[1:], sc.num_triangles)
    assert (np.diff(starts) > 0).all()  # DFS order: lower group, lower ids
    tri, grp = got[1][hit], got[2][hit]
    assert ((tri >= starts[grp]) & (tri < ends[grp])).all()


@pytest.mark.parametrize("case", ["inactive_lanes", "n200", "all_inactive"])
def test_mega_closest_edge_cases_match_reference(case):
    name = {"inactive_lanes": "soup", "n200": "cornell", "all_inactive": "cornell"}[case]
    sc = _uploads(name)[0]
    n = 200 if case == "n200" else 256
    o, d = _mixed_rays(sc, n, seed=5)
    if case == "inactive_lanes":
        active = (np.arange(n) % 3) != 0
    else:
        active = np.full(n, case != "all_inactive")
    ref, got = _closest_both(name, o, d, active)
    hit = _assert_closest_matches(ref, got, case)
    assert not hit[~active].any()
    assert hit.any() == (case != "all_inactive")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_mega_anyhit_matches_reference(name):
    sc, jds, tds = _uploads(name)
    o, d = _mixed_rays(sc, 512, seed=13)
    rng = np.random.default_rng(4)
    # long bounds, so the centroid-aimed half occludes, and short ones
    t_max = np.where(rng.random(512) < 0.95, 30.0, rng.uniform(0, 3, 512)).astype(np.float32)
    active = rng.random(512) < 0.95
    ref = np.asarray(j_mega.mega_anyhit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                        jnp.asarray(active), *_wide_args(jds)))
    got = t_mega.mega_anyhit(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
                             torch.from_numpy(active), *_wide_args(tds)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.mean() > 0.4, f"{name}: early exit unexercised"
    assert not got[~active].any()


def test_scene_exit_bound_matches_reference():
    """Axis-aligned directions give 1/0 = inf and 0 * inf = NaN; both copies
    must turn them into the same bounds."""
    rng = np.random.default_rng(8)
    bounds = np.array([[0, 0, 0, 1, 2, 3], [-1, 0.5, 0, 0.5, 1, 1]], np.float32)
    o = rng.uniform(-2, 4, (64, 3)).astype(np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d[::4, 0] = 0.0
    d[1::4, 1:] = 0.0
    d[2::8] = [0.0, -0.0, 1.0]
    o[2::8] = [0.0, 0.5, -1.0]  # on the box's min face in x, d_x = 0: NaN
    t_lim = np.where(rng.random(64) < 0.8, 1e9, -1e9).astype(np.float32)
    ref = np.asarray(j_mega._scene_exit_bound(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_lim),
                                              jnp.asarray(bounds)))
    got = t_mega._scene_exit_bound(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(t_lim), torch.from_numpy(bounds)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == -1e9).any() and (got < 1e9).any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_mega_matches_port_brute_twin(name):
    sc, _, tds = _uploads(name)
    o, d = _mixed_rays(sc, 512, seed=21)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    act = torch.ones(512, dtype=torch.bool)
    t_m, tri_m, _ = t_mega.mega_closest(ot, dt, act, *_wide_args(tds))
    t_b, tri_b, _, _ = mt_brute.brute_closest_plain(ot, dt, act, tds.tris9)
    hit = tri_b.numpy() >= 0
    np.testing.assert_array_equal(tri_m.numpy() >= 0, hit)
    np.testing.assert_allclose(t_m.numpy()[hit], t_b.numpy()[hit], rtol=5e-4)
    same = tri_m.numpy() == tri_b.numpy()
    assert (same | np.isclose(t_m.numpy(), t_b.numpy(), rtol=5e-4))[hit].all()
    t_max = torch.full((512,), 30.0)
    np.testing.assert_array_equal(
        t_mega.mega_anyhit(ot, dt, t_max, act, *_wide_args(tds)).numpy(),
        mt_brute.brute_anyhit_plain(ot, dt, t_max, act, tds.tris9).numpy())


def test_cpu_tensors_run_the_twin_and_mixed_devices_raise():
    sc, _, tds = _uploads("cornell")
    o, d = (torch.from_numpy(x) for x in _mixed_rays(sc, 64, seed=1))
    act = torch.ones(64, dtype=torch.bool)
    t_mega.reset_launches()
    t_mega.mega_closest(o, d, act, *_wide_args(tds))
    t_mega.mega_anyhit(o, d, torch.full((64,), 3.0), act, *_wide_args(tds))
    assert t_mega.launches == {"closest": 0, "anyhit": 0, "closest_twin": 1, "anyhit_twin": 1}
    with pytest.raises(ValueError):
        t_mega.mega_closest(o, d.to("meta"), act, *_wide_args(tds))


# --------------------------------------------------------------------------
# The slice as a whole
# --------------------------------------------------------------------------


def _camera(name):
    if name == "grid":  # the root bench.py's grid camera
        return make_camera(np.array([5.0, 9.0, 11.0], np.float32),
                           np.array([5.0, 2.0, 5.0], np.float32), 50.0)
    cfg = config.load_config(TOML)
    _, translation = config.scene_from_config(cfg, os.path.dirname(TOML))
    return config.camera_from_config(cfg, translation)


_J_TRACE = jax.jit(j_integrator.trace_paths, static_argnames=("options", "with_stats"))


def _trace_both(name, tds=None, size=32, depth=3):
    sc, jds, port_ds = _uploads(name)
    camera = _camera(name)
    options = RenderOptions(width=size, height=size, max_depth=depth, accel="wide",
                            families=j_scene.scene_families(sc))
    uni = np.random.default_rng(11).random((size * size, 4 + 7 * depth), dtype=np.float32)
    oj, dj = j_generate_rays(camera, size, size, jnp.asarray(uni))
    lj, sj = _J_TRACE(jds, oj, dj, jnp.asarray(uni), options, with_stats=True)
    ot, dt = t_generate_rays(camera, size, size, torch.from_numpy(uni))
    lt, st = t_integrator.trace_paths(tds or port_ds, ot, dt, torch.from_numpy(uni), options,
                                      with_stats=True)
    return (np.asarray(lj), sj), (lt.numpy(), st)


@pytest.mark.parametrize("name", ["grid", "cornell"])
def test_trace_paths_wide_matches_reference_per_pixel(name):
    t_mega.reset_launches()
    mt_brute.reset_launches()
    (lj, sj), (lt, st) = _trace_both(name)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    assert float(lt.sum()) > 0.0
    for key in ("rays_closest", "rays_anyhit", "alive_per_bounce"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))
    assert t_mega.launches["closest_twin"] == 3 and t_mega.launches["anyhit_twin"] == 3
    assert mt_brute.launches["closest_twin"] == 0 and mt_brute.launches["anyhit_twin"] == 0


def test_convert_carries_a_reference_wide_scene():
    _, jds, _ = _uploads("grid")
    scene_np = jax.tree_util.tree_map(np.asarray, jds.scene)
    wide = {k: np.asarray(getattr(jds, k)) for k in t_scene.WIDE_FIELDS}
    tds = convert.device_scene_from_numpy(scene_np, "cpu", wide=wide)
    for k in t_scene.WIDE_FIELDS:
        np.testing.assert_array_equal(getattr(tds, k).numpy(), wide[k])
    (lj, sj), (lt, st) = _trace_both("grid", tds=tds, size=24, depth=2)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    for key in ("rays_closest", "rays_anyhit", "alive_per_bounce"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))
    with pytest.raises(ValueError, match="missing"):
        convert.device_scene_from_numpy(scene_np, "cpu", wide={"wb_mega": wide["wb_mega"]})


def test_wide_render_of_a_scene_uploaded_without_it_raises():
    sc = _uploads("cornell")[0]
    ds = t_scene.upload_scene(sc, "brute", "cpu")
    options = RenderOptions(width=4, height=4, max_depth=1, accel="wide",
                            families=j_scene.scene_families(sc))
    o = torch.zeros((16, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 16)
    with pytest.raises(ValueError, match="uploaded without"):
        t_integrator.trace_paths(ds, o, d, torch.zeros((16, 11)), options)


def test_cli_auto_picks_wide_on_a_grid(tmp_path, capsys):
    """`--accel auto` on a grid of 3,044 triangles renders through the
    binary BVH, which the port's policy takes above 2048 triangles, and
    `--accel wide` through the wide BVH, which stays on request (the
    reference's policy, and this test's name, take the wide BVH under
    auto)."""
    toml = tmp_path / "grid.toml"
    toml.write_text(
        '[scene]\nbuiltin = "grid"\nresolution = 40\n\n'
        '[camera]\nposition = [5.0, 9.0, 11.0]\nlook_at = [5.0, 2.0, 5.0]\nfov = 50.0\n'
    )
    from PIL import Image

    for accel, picked in (("auto", "bvh2"), ("wide", "wide")):
        out = tmp_path / f"grid_{accel}.png"
        rc = cli.main(["render", str(toml), "--accel", accel, "--width", "24", "--height", "24",
                       "--depth", "2", "--spp", "1", "--device", "cpu", "-o", str(out)])
        assert rc == 0 and out.exists()
        assert f"accel {picked}" in capsys.readouterr().out
        assert Image.open(out).size == (24, 24)
