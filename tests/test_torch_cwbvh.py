"""Port's node8 walk (ops/traverse_cwbvh.py) and the integrator's
options.traversal ≡ the reference's.

The same numpy rays go to the reference's XLA walk
(caitlynrenderer_tpu/ops/traverse_cwbvh.py) and to the port's torch walk,
on the scenes of tests/test_torch_cw8.py.  Tolerances, each with its
reason:
  * the triangle slab under "cwbvh": byte-equal to the reference's
    cw_tris (both built from the same reordered triangles);
  * the walks: tests/test_cwbvh.py's contract, hit or miss equal, `tri`
    equal or t-close (rtol 5e-4), t within rtol 5e-4 (the same float32
    expressions, which XLA may fuse into multiply-adds), occlusion equal
    but where t_max lies within that tolerance of the hit;
  * trace_paths under traversal "xla" with shared uniforms: per pixel atol
    1e-5, the render tests' tolerance, and equal ray counts.
"""

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
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box, displaced_grid, random_triangle_soup
from caitlynrenderer_tpu.ops.traverse_cwbvh import cwbvh_anyhit, cwbvh_closest
from caitlynrenderer_tpu.render import integrator as j_integrator
from caitlynrenderer_tpu_torch import scene as t_scene
from caitlynrenderer_tpu_torch.core.camera import generate_rays as t_generate_rays
from caitlynrenderer_tpu_torch.core.types import make_camera
from caitlynrenderer_tpu_torch.ops import mt_brute
from caitlynrenderer_tpu_torch.ops import traverse_cw8 as t_cw8
from caitlynrenderer_tpu_torch.ops import traverse_cwbvh as t_walk
from caitlynrenderer_tpu_torch.render import integrator as t_integrator

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
    """Half the rays aimed at random triangle centroids, half fully random,
    from the scene's box grown by 1 (tests/test_torch_cw8.py's)."""
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


def _both(name, o, d, active, t_max):
    """((t, tri) and occlusion of the reference's walk, the same of the
    port's), as numpy."""
    _, jds, tds = _uploads(name)
    ja = (jnp.asarray(o), jnp.asarray(d))
    tj, trj, _, _ = (np.asarray(x) for x in cwbvh_closest(*ja, jnp.asarray(active),
                                                           jds.cw_nodes, jds.cw_tris))
    occ_j = np.asarray(cwbvh_anyhit(*ja, jnp.asarray(t_max), jnp.asarray(active), jds.cw_nodes,
                                    jds.cw_tris))
    ta = (torch.from_numpy(o), torch.from_numpy(d))
    act = torch.from_numpy(active)
    tt, trt, ut, vt = t_walk.cwbvh_closest(*ta, act, tds.cw_nodes, tds.tris9, tds.cw_depth)
    assert trt.dtype == torch.int32 and tt.dtype == ut.dtype == vt.dtype == torch.float32
    occ_t = t_walk.cwbvh_anyhit(*ta, torch.from_numpy(t_max), act, tds.cw_nodes, tds.tris9,
                                tds.cw_depth)
    return (tj, np.where(active, trj, -1)), occ_j, (tt.numpy(), trt.numpy()), occ_t.numpy()


def _assert_match(ref, occ_j, got, occ_t, t_max, tag):
    (tj, trj), (tt, trt) = ref, got
    hit = trj >= 0
    np.testing.assert_array_equal(trt >= 0, hit, err_msg=tag)
    same = trt == trj
    assert (same | np.isclose(tt, tj, rtol=5e-4))[hit].all(), tag
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=5e-4, err_msg=tag)
    assert (tt[~hit] == 1e9).all(), tag
    near = hit & np.isclose(tj, t_max, rtol=5e-4)
    assert ((occ_t == occ_j) | near).all(), tag
    return hit


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tris9_is_the_reference_cw_tris(name):
    """Under "cwbvh" the port's brute-force slab is the walk's triangle
    input: byte-equal to the reference's cw_tris, no second copy."""
    _, jds, tds = _uploads(name)
    ref = np.asarray(jds.cw_tris)
    got = tds.tris9.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_matches_reference(name):
    sc = _uploads(name)[0]
    n = 768
    o, d = _mixed_rays(sc, n, seed=11)
    rng = np.random.default_rng(2)
    active = rng.random(n) < 0.9
    t_max = rng.uniform(0, 12, n).astype(np.float32)
    ref, occ_j, got, occ_t = _both(name, o, d, active, t_max)
    hit = _assert_match(ref, occ_j, got, occ_t, t_max, name)
    assert hit.mean() > 0.3 and occ_t.mean() > 0.1 and not hit[~active].any()
    assert not occ_t[~active].any()


@pytest.mark.parametrize("case", ["ragged", "inactive_lanes", "axis_aligned", "all_dead"])
def test_edge_rays_match_reference(case):
    """test_torch_cw8.py's edge cases against the reference's walk.  Both
    walks miss every exactly axis-aligned ray: 1/d = inf makes the slab of
    a flat quantized box 0 * inf = NaN (the kernel B3 does not)."""
    name = "cornell" if case in ("ragged", "axis_aligned") else "soup"
    sc = _uploads(name)[0]
    n = 201 if case == "ragged" else 256
    o, d = _mixed_rays(sc, n, seed=3)
    rng = np.random.default_rng(6)
    if case == "axis_aligned":
        d = (np.eye(3)[rng.integers(0, 3, n)] * rng.choice([-1.0, 1.0], (n, 1))).astype(np.float32)
        o = np.where(rng.random((n, 1)) < 0.5, o, np.float32([2.78, 2.73, 2.5])).astype(np.float32)
    active = {"inactive_lanes": np.arange(n) % 3 != 0, "all_dead": np.zeros(n, bool)}.get(
        case, np.ones(n, bool))
    t_max = np.full(n, 30.0, np.float32)
    ref, occ_j, got, occ_t = _both(name, o, d, active, t_max)
    hit = _assert_match(ref, occ_j, got, occ_t, t_max, case)
    assert hit.any() == (case not in ("all_dead", "axis_aligned"))


def test_walk_agrees_with_brute_force_and_empty_scene():
    """The port's walk against its own dense Möller–Trumbore on the grid
    (hit or miss equal, tri equal or t-close); an empty tree misses."""
    sc, _, tds = _uploads("grid")
    o, d = (torch.from_numpy(x) for x in _mixed_rays(sc, 512, seed=5))
    act = torch.ones(512, dtype=torch.bool)
    tb, trb, _, _ = mt_brute.brute_closest_plain(o, d, act, tds.tris9)
    tw, trw, _, _ = t_walk.cwbvh_closest(o, d, act, tds.cw_nodes, tds.tris9, tds.cw_depth)
    hit = trb >= 0
    assert torch.equal(trw >= 0, hit) and hit.float().mean() > 0.3
    assert ((trw == trb) | torch.isclose(tw, tb, rtol=5e-4))[hit].all()
    empty = sc._replace(tri_v=sc.tri_v[:0], tri_vn=sc.tri_vn[:0], tri_vt=sc.tri_vt[:0])
    eds = t_scene.upload_scene(empty, "cwbvh", "cpu")
    t, tri, _, _ = t_walk.cwbvh_closest(o, d, act, eds.cw_nodes, eds.tris9, eds.cw_depth)
    assert (tri == -1).all() and (t == 1e9).all()
    assert not t_walk.cwbvh_anyhit(o, d, torch.full((512,), 30.0), act, eds.cw_nodes,
                                   eds.tris9, eds.cw_depth).any()


def test_bit_helpers_on_words_with_the_sign_bit():
    """findMSB, popcount and byte extraction of uint32 words that arrive as
    negative int32 values."""
    words = np.array([1, 2, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x01000000, 0xF0F00F0F],
                     np.uint32)
    x = torch.from_numpy(words.view(np.int32)).long() & 0xFFFFFFFF
    assert t_walk._find_msb(x).tolist() == [int(w).bit_length() - 1 for w in words]
    assert t_walk._popcount(x).tolist() == [bin(int(w)).count("1") for w in words]
    for i in range(4):
        assert t_walk._byte(x, i).tolist() == [(int(w) >> (8 * i)) & 0xFF for w in words]
    with pytest.raises(ValueError, match="stack slots"):
        t_walk.cwbvh_closest(torch.zeros((1, 3)), torch.ones((1, 3)),
                             torch.ones(1, dtype=torch.bool),
                             torch.zeros((1, 20), dtype=torch.int32), torch.zeros((1, 9)),
                             t_walk.STACK + 2)


def _trace_both(accel, traversal, seed):
    """trace_paths of both packages under `traversal` on the same rays and
    uniforms: 16x16 cornell, 3 bounces."""
    sc, camera = cornell_box()[0], make_camera(np.float32([2.78, 2.73, 7.5]),
                                               np.float32([2.78, 2.73, 6.5]), 40.0)
    w = h = 16
    options = RenderOptions(width=w, height=h, max_depth=3, accel=accel, traversal=traversal)
    uni = np.random.default_rng(seed).random((w * h, 4 + 7 * 3), dtype=np.float32)
    oj, dj = j_generate_rays(camera, w, h, jnp.asarray(uni))
    j_trace = jax.jit(j_integrator.trace_paths, static_argnames=("options", "with_stats"))
    lj, sj = j_trace(j_scene.upload_scene(sc, accel=accel), oj, dj, jnp.asarray(uni), options,
                     with_stats=True)
    ds = t_scene.upload_scene(sc, accel, "cpu")
    ot, dt = t_generate_rays(camera, w, h, torch.from_numpy(uni))
    lt, st = t_integrator.trace_paths(ds, ot, dt, torch.from_numpy(uni), options,
                                      with_stats=True)
    return lt.numpy(), st, np.asarray(lj), sj


@pytest.mark.parametrize("accel", ["cwbvh", "brute"])
def test_trace_paths_xla_traversal_matches_reference(accel):
    """traversal "xla" runs the reference's plain walks: the node8 walk
    under "cwbvh" (and neither B3 nor its twin, which "auto" runs), the
    dense Möller–Trumbore under "brute"."""
    t_cw8.reset_launches()
    mt_brute.reset_launches()
    lt, st, lj, sj = _trace_both(accel, "xla", seed=3)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5)
    assert int(st["rays_closest"]) == int(sj["rays_closest"])
    assert int(st["rays_anyhit"]) == int(sj["rays_anyhit"])
    assert float(np.abs(lt).mean()) > 0.01
    assert all(v == 0 for v in t_cw8.launches.values())  # before: the twin ran
    if accel == "brute":  # ops/intersect's dense test is the twin's arithmetic
        assert mt_brute.launches["closest_twin"] == 3 and mt_brute.launches["closest"] == 0


@pytest.mark.parametrize("accel", ["brute", "cwbvh", "bvh2", "wide"])
def test_pallas_traversal_needs_cuda_tensors(accel):
    """traversal "pallas" insists on the hand-written kernels: on CPU
    tensors it raises (before, the option was never read); an unknown
    traversal raises too."""
    sc = cornell_box()[0]
    ds = t_scene.upload_scene(sc, accel, "cpu")
    o = torch.zeros((4, 3))
    d = torch.nn.functional.normalize(torch.ones((4, 3)), dim=1)
    uni = torch.rand((4, 4 + 7))
    options = RenderOptions(width=2, height=2, max_depth=1, accel=accel)
    t_integrator.trace_paths(ds, o, d, uni, options)
    with pytest.raises(ValueError, match="CUDA"):
        t_integrator.trace_paths(ds, o, d, uni, options._replace(traversal="pallas"))
    with pytest.raises(ValueError, match="CUDA"):
        t_integrator.trace_aov(ds, o, d, options._replace(traversal="pallas", aov="depth"))
    with pytest.raises(ValueError, match="unknown traversal"):
        t_integrator.trace_paths(ds, o, d, uni, options._replace(traversal="tpu"))


@pytest.mark.parametrize("accel", ["brute", "cwbvh", "bvh2", "wide"])
def test_xla_traversal_refuses_cuda_tensors(accel):
    """traversal "xla" is the reference's plain walks for parity on CPU
    tensors: on a scene on the card it raises instead of walking past the
    kernels ("auto" and "pallas" pass the check there).  The scene is a
    stand-in whose triangle slab says it lies on cuda:0, so the check runs
    without a card."""
    from types import SimpleNamespace

    ds = SimpleNamespace(accel=accel, tris9=SimpleNamespace(device=torch.device("cuda", 0),
                                                            shape=(36, 9)))
    options = RenderOptions(width=2, height=2, max_depth=1, accel=accel)
    t_integrator.check_supported(ds, options)
    t_integrator.check_supported(ds, options._replace(traversal="pallas"))
    with pytest.raises(ValueError, match='"xla".*on the card'):
        t_integrator.check_supported(ds, options._replace(traversal="xla"))
