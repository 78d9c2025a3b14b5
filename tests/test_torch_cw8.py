"""Port's CWBVH path ≡ the reference's.

The port's `cw8_closest`/`cw8_anyhit` on CPU tensors run their plain
twins, which sweep every 32-triangle window densely.  They are held
against the reference's Pallas kernel itself, run through the TPU
interpreter (`pltpu.force_tpu_interpret_mode()`), against the reference's
XLA node8 walk (`ops/traverse_cwbvh.py`, its non-TPU path; the edge cases
against its dense Möller–Trumbore instead, since that walk misses exactly
axis-aligned rays), and against the port's brute-force twin.  Same numpy inputs to both packages, at the sizes
of tests/test_cwbvh.py.  Tolerances, each with its reason:
  * host packers and uploads: byte-equal;
  * twins vs the Pallas kernel: hit or miss equal, `tri` equal or t-close
    (rtol 5e-4: the TPU kernel picks its minimum on t with the low 8 bits
    replaced by the row, so near-ties may pick another triangle), `window`
    equal where `tri` is, t within rtol 1e-5 + atol 1e-6 (its sweep is a
    matmul at HIGHEST precision, the twin rounds every product), occlusion
    equal;
  * twins vs the XLA walk and the brute twin (Baldwin–Weber against
    Möller–Trumbore): tests/test_cwbvh.py's contract, hit or miss and
    occlusion equal, `tri` equal or t-close, t rtol 5e-4;
  * trace_paths with shared uniforms: per pixel atol 1e-5, stats equal.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu import scene as j_scene
from caitlynrenderer_tpu.accel.bvh import build_bvh, reorder_scene
from caitlynrenderer_tpu.accel.cwbvh import build_cwbvh
from caitlynrenderer_tpu.core.camera import generate_rays as j_generate_rays
from caitlynrenderer_tpu.core.types import RenderOptions, make_camera
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box, displaced_grid, random_triangle_soup
from caitlynrenderer_tpu.ops import intersect as j_isect
from caitlynrenderer_tpu.ops import traverse_cw8 as j_cw8
from caitlynrenderer_tpu.ops.traverse_cwbvh import cwbvh_anyhit, cwbvh_closest
from caitlynrenderer_tpu.render import integrator as j_integrator
from caitlynrenderer_tpu.utils import config
from caitlynrenderer_tpu_torch import cli, convert
from caitlynrenderer_tpu_torch import scene as t_scene
from caitlynrenderer_tpu_torch.core.camera import generate_rays as t_generate_rays
from caitlynrenderer_tpu_torch.ops import mt_brute
from caitlynrenderer_tpu_torch.ops import traverse_cw8 as t_cw8
from caitlynrenderer_tpu_torch.render import integrator as t_integrator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")

SCENES = {
    "cornell": lambda: cornell_box()[0],
    "soup": lambda: random_triangle_soup(800, seed=6)[0],  # tests/test_cwbvh.py's
    "grid": lambda: displaced_grid(resolution=24)[0],
}
_CACHE = {}


def _uploads(name):
    """(scene, reference cwbvh DeviceScene, port cwbvh DeviceScene), built once."""
    if name not in _CACHE:
        sc = SCENES[name]()
        _CACHE[name] = (sc, j_scene.upload_scene(sc, accel="cwbvh"),
                        t_scene.upload_scene(sc, "cwbvh", "cpu"))
    return _CACHE[name]


def _mixed_rays(scene, n, seed):
    """Half the rays aimed at random triangle centroids (random rays alone
    hit almost nothing), half fully random, from the scene's box grown by 1."""
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


def _cw(ds):
    return ds.cw_nodes, ds.cw_planes, ds.cw_bounds, ds.cw_depth


def _port_closest(tds, o, d, active):
    got = t_cw8.cw8_closest(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active),
                            *_cw(tds))
    return [x.numpy() for x in got]


def _port_anyhit(tds, o, d, t_max, active):
    return t_cw8.cw8_anyhit(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
                            torch.from_numpy(active), *_cw(tds)).numpy()


def _assert_tri_close(t_ref, tri_ref, t_got, tri_got, rtol, tag):
    """Hit or miss equal, the same triangle or a t-close one, t within rtol."""
    hit = tri_ref >= 0
    np.testing.assert_array_equal(tri_got >= 0, hit, err_msg=tag)
    same = tri_got == tri_ref
    assert (same | np.isclose(t_got, t_ref, rtol=5e-4))[hit].all(), tag
    np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=rtol, err_msg=tag)
    assert (t_got[~hit] == 1e9).all(), tag
    return hit, same


# --------------------------------------------------------------------------
# Host packing and upload
# --------------------------------------------------------------------------


def _built(name):
    """(cw_nodes, cw_tris) of a scene as the reference's upload builds them."""
    if name == "empty":
        return np.zeros((0, 20), np.uint32), np.zeros((0, 9), np.float32)
    sc = {"cornell": lambda: cornell_box()[0], "soup": lambda: random_triangle_soup(500, seed=1)[0],
          "grid": lambda: displaced_grid(resolution=12)[0]}[name]()
    bvh = build_bvh(sc.vertices, sc.tri_v, max_leaf=3)
    sr = reorder_scene(sc, bvh)
    cw = build_cwbvh(bvh, sr.vertices, sr.tri_v)
    tv = sr.tri_v[cw.tri_order]
    p0 = sr.vertices[tv[:, 0]]
    tris = np.concatenate([p0, sr.vertices[tv[:, 1]] - p0, sr.vertices[tv[:, 2]] - p0], axis=1)
    return cw.nodes, tris.astype(np.float32)


@pytest.mark.parametrize("name", ["cornell", "soup", "grid", "empty"])
def test_pack_cw8_byte_equal_reference(name):
    nodes, tris = _built(name)
    got = t_cw8.pack_cw8(nodes, tris)
    ref = j_cw8.pack_cw8(nodes, tris)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[1].shape == (max(1, -(-tris.shape[0] // 32)), 4, 128)
    if name == "soup":
        assert tris.shape[0] % 32 and not got[1][-1, :, 96:].any()  # padding columns


def _chain(levels):
    """A node8 tree of `levels` levels, one inner child per node."""
    nodes = np.zeros((levels, 20), np.uint32)
    nodes[:-1, 3] = np.uint32(1 << 24)  # slot 0 inner
    nodes[:-1, 4] = np.arange(1, levels, dtype=np.uint32)
    return nodes


def test_pack_cw8_depth_guard_like_reference():
    """22 levels fit the stack; 23 raise in both packages (the port with a
    ValueError, the reference with its assert)."""
    tris = np.zeros((0, 9), np.float32)
    assert t_cw8.node8_depth(_chain(22)) == 22
    for a, b in zip(t_cw8.pack_cw8(_chain(22), tris), j_cw8.pack_cw8(_chain(22), tris)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError):
        j_cw8.pack_cw8(_chain(23), tris)
    with pytest.raises(ValueError, match="depth 23"):
        t_cw8.pack_cw8(_chain(23), tris)
    with pytest.raises(ValueError, match="depth 23"):
        t_cw8.cw8_closest(torch.zeros((1, 3)), torch.ones((1, 3)), torch.ones(1, dtype=torch.bool),
                          torch.from_numpy(_chain(23).view(np.int32)), torch.zeros((1, 4, 128)),
                          torch.zeros((1, 6)), 23)
    assert t_cw8.node8_depth(np.zeros((0, 20), np.uint32)) == 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_upload_cwbvh_equals_reference(name):
    sc, jds, tds = _uploads(name)
    assert tds.accel == "cwbvh"
    np.testing.assert_array_equal(tds.cw_nodes.numpy().view(np.uint32), np.asarray(jds.cw_nodes))
    assert tds.cw_nodes.dtype == torch.int32
    for k in ("cw_planes", "cw_bounds"):
        ref = np.asarray(getattr(jds, k))
        got = getattr(tds, k).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    for k in ("vertices", "tri_v", "tri_vn", "tri_vt"):  # the cwbvh-ordered scene
        np.testing.assert_array_equal(getattr(tds.scene, k).numpy(),
                                      np.asarray(getattr(jds.scene, k)), err_msg=k)
    np.testing.assert_array_equal(tds.tris9.numpy(), np.asarray(jds.cw_tris))
    np.testing.assert_array_equal(
        tds.shade_tab.numpy(), np.asarray(j_integrator._build_shade_table(jds.scene)))
    assert tds.tree_depth == jds.tree_depth
    assert tds.cw_depth == t_cw8.node8_depth(np.asarray(jds.cw_nodes)) >= 2


# --------------------------------------------------------------------------
# Queries against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["soup", "cornell"])
def test_twins_match_pallas_kernel(name):
    """The reference's B3 itself, through the TPU interpreter."""
    sc = random_triangle_soup(300, seed=4)[0] if name == "soup" else cornell_box()[0]
    jds, tds = j_scene.upload_scene(sc, accel="cwbvh"), t_scene.upload_scene(sc, "cwbvh", "cpu")
    n = 256
    o, d = _mixed_rays(sc, n, seed=17)
    rng = np.random.default_rng(5)
    active = rng.random(n) < (0.9 if name == "cornell" else 1.0)
    t_max = np.where(rng.random(n) < 0.8, 30.0, rng.uniform(0, 3, n)).astype(np.float32)
    ja = (jds.cw_nodes4, jds.cw_planes, jds.cw_bounds)
    with pltpu.force_tpu_interpret_mode():
        tj, trj, wj = (np.asarray(x) for x in j_cw8.cw8_closest(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), *ja))
        occ_j = np.asarray(j_cw8.cw8_anyhit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                            jnp.asarray(active), *ja))
    tt, trt, wt = _port_closest(tds, o, d, active)
    hit, same = _assert_tri_close(tj, trj, tt, trt, 1e-5, name)
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(wt[same], wj[same])
    assert hit.mean() > 0.3 and not hit[~active].any()
    np.testing.assert_array_equal(_port_anyhit(tds, o, d, t_max, active), occ_j)


@pytest.mark.parametrize("name", ["cornell", "soup"])
def test_twins_match_xla_walk(name):
    """The reference's XLA node8 walk on tests/test_cwbvh.py's scenes."""
    sc, jds, tds = _uploads(name)
    n = 512
    o, d = _mixed_rays(sc, n, seed=9)
    active = np.ones(n, bool)
    tj, trj, _, _ = (np.asarray(x) for x in cwbvh_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), jds.cw_nodes, jds.cw_tris))
    tt, trt, wt = _port_closest(tds, o, d, active)
    hit, _ = _assert_tri_close(tj, trj, tt, trt, 5e-4, name)
    assert hit.mean() > 0.4
    np.testing.assert_array_equal(wt, np.where(trt >= 0, trt // 32, -1))
    t_max = np.random.default_rng(4).uniform(0, 12, n).astype(np.float32)
    occ_j = np.asarray(cwbvh_anyhit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                    jnp.asarray(active), jds.cw_nodes, jds.cw_tris))
    occ_t = _port_anyhit(tds, o, d, t_max, active)
    # Occlusion may differ only where t_max lies within the t tolerance of the hit.
    near = hit & np.isclose(tj, t_max, rtol=5e-4)
    assert ((occ_t == occ_j) | near).all()
    assert occ_t.mean() > 0.2


@pytest.mark.parametrize("name", sorted(SCENES))
def test_twins_match_port_brute_twin(name):
    sc, _, tds = _uploads(name)
    o, d = _mixed_rays(sc, 512, seed=21)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    act = torch.ones(512, dtype=torch.bool)
    t_b, tri_b, _, _ = mt_brute.brute_closest_plain(ot, dt, act, tds.tris9)
    tt, trt, _ = _port_closest(tds, o, d, act.numpy())
    _assert_tri_close(t_b.numpy(), tri_b.numpy(), tt, trt, 5e-4, name)
    t_max = torch.full((512,), 30.0)
    np.testing.assert_array_equal(
        _port_anyhit(tds, o, d, t_max.numpy(), act.numpy()),
        mt_brute.brute_anyhit_plain(ot, dt, t_max, act, tds.tris9).numpy())


@pytest.mark.parametrize("case", ["ragged", "inactive_lanes", "axis_aligned", "all_dead"])
def test_edge_cases_match_reference_brute_force(case):
    """Against the reference's dense Möller–Trumbore (ops/intersect.py), not
    its XLA node8 walk, which misses exactly axis-aligned rays (1/d = inf
    turns a zero-width quantized slab into 0 · inf = NaN)."""
    name = "cornell" if case in ("ragged", "axis_aligned") else "soup"
    sc, jds, tds = _uploads(name)
    n = 201 if case == "ragged" else 256
    o, d = _mixed_rays(sc, n, seed=3)
    rng = np.random.default_rng(6)
    if case == "axis_aligned":
        d = (np.eye(3)[rng.integers(0, 3, n)] * rng.choice([-1.0, 1.0], (n, 1))).astype(np.float32)
        o = np.where(rng.random((n, 1)) < 0.5, o, np.float32([2.78, 2.73, 2.5]))
        o = o.astype(np.float32)
    active = {"inactive_lanes": np.arange(n) % 3 != 0, "all_dead": np.zeros(n, bool)}.get(
        case, np.ones(n, bool))
    tj, trj, _, _ = (np.asarray(x) for x in j_isect.intersect_brute(
        jnp.asarray(o), jnp.asarray(d), jds.scene.vertices, jds.scene.tri_v))
    trj = np.where(active, trj, -1)  # the reference integrator masks inactive lanes so
    tj = np.where(active, tj, 1e9)
    tt, trt, wt = _port_closest(tds, o, d, active)
    hit, _ = _assert_tri_close(tj, trj, tt, trt, 5e-4, case)
    assert hit.any() == (case != "all_dead") and not hit[~active].any()
    assert (wt[~hit] == -1).all()
    t_max = np.full(n, 30.0, np.float32)
    occ = _port_anyhit(tds, o, d, t_max, active)
    np.testing.assert_array_equal(occ, hit)  # every hit lies within 30


def test_empty_scene():
    sc = _uploads("grid")[0]
    o, d = _mixed_rays(sc, 256, seed=3)
    act = np.ones(256, bool)
    empty = sc._replace(tri_v=sc.tri_v[:0], tri_vn=sc.tri_vn[:0], tri_vt=sc.tri_vt[:0])
    eds = t_scene.upload_scene(empty, "cwbvh", "cpu")
    assert eds.cw_nodes.shape == (0, 20) and eds.cw_planes.shape == (0, 4, 128)
    t, tri, win = _port_closest(eds, o, d, act)
    assert (tri == -1).all() and (win == -1).all() and (t == 1e9).all()
    assert not _port_anyhit(eds, o, d, np.full(256, 30.0, np.float32), act).any()


def test_cpu_tensors_run_the_twin_and_mixed_devices_raise():
    sc, _, tds = _uploads("cornell")
    o, d = (torch.from_numpy(x) for x in _mixed_rays(sc, 64, seed=1))
    act = torch.ones(64, dtype=torch.bool)
    t_cw8.reset_launches()
    t_cw8.cw8_closest(o, d, act, *_cw(tds))
    t_cw8.cw8_anyhit(o, d, torch.full((64,), 3.0), act, *_cw(tds))
    assert t_cw8.launches == {"closest": 0, "anyhit": 0, "closest_twin": 1, "anyhit_twin": 1}
    with pytest.raises(ValueError):
        t_cw8.cw8_closest(o, d.to("meta"), act, *_cw(tds))


@pytest.mark.parametrize("query", ["closest", "anyhit"])
@pytest.mark.parametrize("kwargs", ["stats", "stats_seeded", "seed_alone"])
def test_stats_variant_needs_cuda_tensors(query, kwargs):
    """The stats variant counts the CUDA kernel's walk: on CPU tensors it
    raises ValueError, as B2's does, and so does a t_seed without
    stats=True; nothing is launched."""
    sc, _, tds = _uploads("cornell")
    o, d = (torch.from_numpy(x) for x in _mixed_rays(sc, 64, seed=2))
    act = torch.ones(64, dtype=torch.bool)
    extra = {"stats": {"stats": True},
             "stats_seeded": {"stats": True, "t_seed": torch.full((64,), 2.0)},
             "seed_alone": {"t_seed": torch.full((64,), 2.0)}}[kwargs]
    t_cw8.reset_launches()
    with pytest.raises(ValueError, match="stats"):
        if query == "closest":
            t_cw8.cw8_closest(o, d, act, *_cw(tds), **extra)
        else:
            t_cw8.cw8_anyhit(o, d, torch.full((64,), 3.0), act, *_cw(tds), **extra)
    assert all(v == 0 for v in t_cw8.launches.values())
    assert t_cw8.stats_launches == {"closest": 0, "anyhit": 0}


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
    options = RenderOptions(width=size, height=size, max_depth=depth, accel="cwbvh",
                            families=j_scene.scene_families(sc))
    uni = np.random.default_rng(11).random((size * size, 4 + 7 * depth), dtype=np.float32)
    oj, dj = j_generate_rays(camera, size, size, jnp.asarray(uni))
    lj, sj = _J_TRACE(jds, oj, dj, jnp.asarray(uni), options, with_stats=True)
    ot, dt = t_generate_rays(camera, size, size, torch.from_numpy(uni))
    lt, st = t_integrator.trace_paths(tds or port_ds, ot, dt, torch.from_numpy(uni), options,
                                      with_stats=True)
    return (np.asarray(lj), sj), (lt.numpy(), st)


def _assert_trace_equal(ref, got):
    (lj, sj), (lt, st) = ref, got
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    assert float(lt.sum()) > 0.0
    for key in ("rays_closest", "rays_anyhit", "alive_per_bounce"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(sj[key]))


@pytest.mark.parametrize("name", ["grid", "cornell"])
def test_trace_paths_cwbvh_matches_reference_per_pixel(name):
    t_cw8.reset_launches()
    mt_brute.reset_launches()
    _assert_trace_equal(*_trace_both(name))
    assert t_cw8.launches["closest_twin"] == 3 and t_cw8.launches["anyhit_twin"] == 3
    assert all(v == 0 for v in mt_brute.launches.values())


def test_convert_carries_a_reference_cwbvh_scene():
    _, jds, _ = _uploads("grid")
    scene_np = jax.tree_util.tree_map(np.asarray, jds.scene)
    cw = {k: np.asarray(getattr(jds, k)) for k in t_scene.CW_FIELDS}
    tds = convert.device_scene_from_numpy(scene_np, "cpu", cw=cw)
    assert tds.accel == "cwbvh" and tds.cw_depth == t_cw8.node8_depth(cw["cw_nodes"])
    np.testing.assert_array_equal(tds.cw_nodes.numpy().view(np.uint32), cw["cw_nodes"])
    for k in ("cw_planes", "cw_bounds"):
        np.testing.assert_array_equal(getattr(tds, k).numpy(), cw[k])
    _assert_trace_equal(*_trace_both("grid", tds=tds, size=24, depth=2))
    with pytest.raises(ValueError, match="missing"):
        convert.device_scene_from_numpy(scene_np, "cpu", cw={"cw_nodes": cw["cw_nodes"]})
    with pytest.raises(ValueError, match="one accelerator"):
        convert.device_scene_from_numpy(scene_np, "cpu", cw=cw,
                                        wide=t_scene.empty_wide_arrays())


def test_cwbvh_render_of_a_scene_uploaded_without_it_raises():
    sc = _uploads("cornell")[0]
    options = RenderOptions(width=4, height=4, max_depth=1, accel="cwbvh",
                            families=j_scene.scene_families(sc))
    o = torch.zeros((16, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 16)
    for accel in ("brute", "wide", "bvh2"):
        ds = t_scene.upload_scene(sc, accel, "cpu")
        with pytest.raises(ValueError, match="uploaded without"):
            t_integrator.trace_paths(ds, o, d, torch.zeros((16, 11)), options)
    # ... while "brute" runs on a cwbvh upload, in its triangle order.
    ds = _uploads("cornell")[2]
    t_integrator.trace_paths(ds, o, d, torch.zeros((16, 11)), options._replace(accel="brute"))


def test_cli_render_cwbvh(tmp_path, capsys):
    out = tmp_path / "cornell.png"
    rc = cli.main(["render", TOML, "--accel", "cwbvh", "--width", "24", "--height", "24",
                   "--depth", "2", "--spp", "1", "--device", "cpu", "-o", str(out)])
    assert rc == 0 and out.exists()
    assert "accel cwbvh" in capsys.readouterr().out
    from PIL import Image

    assert Image.open(out).size == (24, 24)
