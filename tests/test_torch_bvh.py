"""Port's binary-BVH accelerators ("bvh2", "sbvh") ≡ the reference's.

The port's `traverse_closest`/`traverse_anyhit` (ops/traverse_bvh.py) are
held against the reference's XLA stack machine (ops/traverse_xla.py) on
the same numpy inputs; uploads and the stack policy against the
reference's; trace_paths per pixel with shared uniforms.  Tolerances, each
with its reason:
  * uploads: node_bounds, node_meta, triangle order and tree depth equal;
  * traversal: hit or miss and occlusion equal, `tri` equal or t-close
    (rtol 5e-4), and where `tri` is equal t, u and v within 1e-6 on the
    cornell box and 1e-3 on the soup: the same Möller–Trumbore, but XLA on
    the CPU contracts multiply-adds and the port rounds every product, and
    the soup's small triangles seen from afar magnify one such rounding by
    ~10^3 (tests/test_torch_intersect.py);
  * trace_paths: per pixel atol 1e-5, stats equal.
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
from caitlynrenderer_tpu.core.camera import generate_rays as j_generate_rays
from caitlynrenderer_tpu.core.types import RenderOptions
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box, random_triangle_soup
from caitlynrenderer_tpu.ops import traverse_xla as j_xla
from caitlynrenderer_tpu.render import integrator as j_integrator
from caitlynrenderer_tpu.utils import config
from caitlynrenderer_tpu_torch import cli, convert
from caitlynrenderer_tpu_torch import scene as t_scene
from caitlynrenderer_tpu_torch.core.camera import generate_rays as t_generate_rays
from caitlynrenderer_tpu_torch.ops import traverse_bvh as t_bvh
from caitlynrenderer_tpu_torch.render import integrator as t_integrator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")

SCENES = {
    "cornell": lambda: cornell_box()[0],
    "soup": lambda: random_triangle_soup(600, seed=3)[0],
}
CASES = [("bvh2", "cornell"), ("bvh2", "soup"), ("sbvh", "cornell"), ("sbvh", "soup")]
_CACHE = {}


def _uploads(accel, name):
    """(scene, reference DeviceScene, port DeviceScene), built once."""
    if (accel, name) not in _CACHE:
        sc = SCENES[name]()
        _CACHE[accel, name] = (sc, j_scene.upload_scene(sc, accel=accel),
                               t_scene.upload_scene(sc, accel, "cpu"))
    return _CACHE[accel, name]


def _mixed_rays(scene, n, seed):
    """Half the rays aimed at random triangle centroids, half fully random,
    from the scene's box grown by 1."""
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


def _tree(ds):
    """Both packages' DeviceScene fields in traversal argument order."""
    return ds.node_bounds, ds.node_meta, ds.scene.vertices, ds.scene.tri_v


@pytest.mark.parametrize("accel,name", CASES)
def test_upload_binary_equals_reference(accel, name):
    sc, jds, tds = _uploads(accel, name)
    assert tds.accel == accel
    for k in t_scene.BVH_FIELDS:
        ref = np.asarray(getattr(jds, k))
        got = getattr(tds, k).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    for k in ("vertices", "tri_v", "tri_vn", "tri_vt"):  # the leaf-ordered scene
        np.testing.assert_array_equal(getattr(tds.scene, k).numpy(),
                                      np.asarray(getattr(jds.scene, k)), err_msg=k)
    assert tds.tree_depth == jds.tree_depth > 1
    assert t_scene.required_stack(tds) == j_scene.required_stack(jds)
    assert t_scene.required_stack(np.asarray(jds.node_meta)) == j_scene.required_stack(
        np.asarray(jds.node_meta))


@pytest.mark.parametrize("accel,name", CASES)
def test_traverse_closest_matches_reference(accel, name):
    sc, jds, tds = _uploads(accel, name)
    n = 384
    o, d = _mixed_rays(sc, n, seed=7)
    active = np.random.default_rng(2).random(n) < 0.9
    tj, trj, uj, vj = (np.asarray(x) for x in j_xla.traverse_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), *_tree(jds)))
    tt, trt, ut, vt = (x.numpy() for x in t_bvh.traverse_closest(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active), *_tree(tds),
        tds.bvh_pairs, tds.tris9))
    hit = trj >= 0
    np.testing.assert_array_equal(trt >= 0, hit)
    same = trt == trj
    assert (same | np.isclose(tt, tj, rtol=5e-4))[hit].all()
    tol = 1e-6 if name == "cornell" else 1e-3
    for a, b in ((tt, tj), (ut, uj), (vt, vj)):
        np.testing.assert_allclose(a[same & hit], b[same & hit], rtol=tol, atol=tol)
    assert (tt[~hit] == 1e9).all() and not hit[~active].any()
    assert hit.mean() > 0.3


@pytest.mark.parametrize("accel,name", CASES)
def test_traverse_anyhit_matches_reference(accel, name):
    sc, jds, tds = _uploads(accel, name)
    n = 384
    o, d = _mixed_rays(sc, n, seed=13)
    rng = np.random.default_rng(4)
    t_max = np.where(rng.random(n) < 0.8, 30.0, rng.uniform(0, 3, n)).astype(np.float32)
    active = rng.random(n) < 0.9
    ref = np.asarray(j_xla.traverse_anyhit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                           jnp.asarray(active), *_tree(jds)))
    got = t_bvh.traverse_anyhit(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(t_max), torch.from_numpy(active),
                                *_tree(tds), tds.bvh_pairs, tds.tris9).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.mean() > 0.3 and not got[~active].any()


def _options(sc, accel, size, depth, **kw):
    return RenderOptions(width=size, height=size, max_depth=depth, accel=accel,
                         families=j_scene.scene_families(sc), **kw)


def test_stack_guard_raises():
    """A stack the build can overflow raises, in the integrator before any
    query and in the walk itself; it is never clamped."""
    sc, _, tds = _uploads("bvh2", "soup")
    o, d = (torch.from_numpy(x) for x in _mixed_rays(sc, 64, seed=1))
    with pytest.raises(ValueError, match="max_stack"):
        t_integrator.trace_paths(tds, o, d, torch.zeros((64, 11)),
                                 _options(sc, "bvh2", 8, 1, max_stack=tds.tree_depth))
    with pytest.raises(ValueError, match="overflow"):
        t_bvh.traverse_closest(o, d, torch.ones(64, dtype=torch.bool), *_tree(tds),
                               tds.bvh_pairs, tds.tris9, max_stack=2)
    with pytest.raises(ValueError, match="overflow"):
        t_bvh.traverse_anyhit(o, d, torch.full((64,), 30.0), torch.ones(64, dtype=torch.bool),
                              *_tree(tds), tds.bvh_pairs, tds.tris9, max_stack=2)
    # The depth + 1 the policy asks for is enough.
    t_integrator.trace_paths(tds, o, d, torch.zeros((64, 11)),
                             _options(sc, "bvh2", 8, 1, max_stack=tds.tree_depth + 1))


def _camera():
    cfg = config.load_config(TOML)
    _, translation = config.scene_from_config(cfg, os.path.dirname(TOML))
    return config.camera_from_config(cfg, translation)


_J_TRACE = jax.jit(j_integrator.trace_paths, static_argnames=("options", "with_stats"))


def _trace_both(accel, tds=None, size=24, depth=3):
    sc, jds, port_ds = _uploads(accel, "cornell")
    camera = _camera()
    options = _options(sc, accel, size, depth)
    uni = np.random.default_rng(12).random((size * size, 4 + 7 * depth), dtype=np.float32)
    oj, dj = j_generate_rays(camera, size, size, jnp.asarray(uni))
    lj, sj = _J_TRACE(jds, oj, dj, jnp.asarray(uni), options, with_stats=True)
    ot, dt = t_generate_rays(camera, size, size, torch.from_numpy(uni))
    lt, st = t_integrator.trace_paths(tds or port_ds, ot, dt, torch.from_numpy(uni), options,
                                      with_stats=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    assert float(lt.sum()) > 0.0
    for key in ("rays_closest", "rays_anyhit", "alive_per_bounce"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))


@pytest.mark.parametrize("accel", ["bvh2", "sbvh"])
def test_trace_paths_binary_matches_reference_per_pixel(accel):
    _trace_both(accel)


def test_convert_carries_a_reference_bvh2_scene():
    _, jds, _ = _uploads("bvh2", "cornell")
    scene_np = jax.tree_util.tree_map(np.asarray, jds.scene)
    bvh = {k: np.asarray(getattr(jds, k)) for k in t_scene.BVH_FIELDS}
    tds = convert.device_scene_from_numpy(scene_np, "cpu", bvh=bvh)
    assert tds.accel == "bvh2" and tds.tree_depth == jds.tree_depth
    for k in t_scene.BVH_FIELDS:
        np.testing.assert_array_equal(getattr(tds, k).numpy(), bvh[k])
    _trace_both("bvh2", tds=tds, size=16, depth=2)
    with pytest.raises(ValueError, match="missing"):
        convert.device_scene_from_numpy(scene_np, "cpu", bvh={"node_meta": bvh["node_meta"]})


@pytest.mark.parametrize("accel", ["bvh2", "sbvh"])
def test_cli_render_binary(accel, tmp_path, capsys):
    out = tmp_path / f"{accel}.png"
    rc = cli.main(["render", TOML, "--accel", accel, "--width", "16", "--height", "16",
                   "--depth", "2", "--spp", "1", "--device", "cpu", "-o", str(out)])
    assert rc == 0 and out.exists()
    assert f"accel {accel}" in capsys.readouterr().out
