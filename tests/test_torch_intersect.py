"""Port's brute-force intersection ≡ the reference Pallas kernel.

The port's `brute_closest`/`brute_anyhit` on CPU tensors run their plain
twins; the reference's `brute_closest_pallas`/`brute_anyhit_pallas` run the
real Pallas kernel (ops/pallas_mt.py:_kernel) through the TPU interpreter
on the CPU.  Same numpy inputs to both.  Tolerance: tri and occlusion
equal on every ray; t/u/v within 1e-6 on the cornell box.

XLA's CPU backend contracts a*b + c into fused multiply-adds inside the
interpreted kernel; the port rounds every product, as the CUDA kernel does
(built with --fmad=false).  On the cornell box that changes nothing above
1e-6.  The 300-triangle soup's small triangles, seen from up to ~10 units
away, magnify one such rounding by ~10^3, so there t/u/v are held to 1e-3
against the Pallas kernel and, exactly, against a numpy float32 evaluation
of the same expressions without contraction.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)
from jax.experimental.pallas import tpu as pltpu

from caitlynrenderer_tpu.io.builtin_scenes import cornell_box, random_triangle_soup
from caitlynrenderer_tpu.ops import intersect as j_isect
from caitlynrenderer_tpu.ops.pallas_mt import brute_anyhit_pallas, brute_closest_pallas
from caitlynrenderer_tpu_torch.ops import intersect as t_isect
from caitlynrenderer_tpu_torch.ops import mt_brute

CAM = np.array([2.8, 2.75, 13.18], np.float32)


def _cornell_rays(n, seed):
    """Rays from around the cornell camera towards the box, plus rays from
    inside the box in every direction (bounce-like)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    o1 = CAM + rng.uniform(-0.5, 0.5, (half, 3))
    tgt = rng.uniform(0.0, 5.56, (half, 3))
    o2 = rng.uniform(0.2, 5.3, (n - half, 3))
    d2 = rng.standard_normal((n - half, 3))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([tgt - o1, d2]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _soup_rays(sc, n, seed):
    """Half the rays aimed at random triangles' centroids, half random."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.0, 10.0, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    k = rng.integers(0, sc.num_triangles, n // 2)
    d[: n // 2] = sc.vertices[sc.tri_v[k, :3]].mean(axis=1) - o[: n // 2]
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _case(name):
    rng = np.random.default_rng(7)
    if name == "cornell":
        sc, _ = cornell_box()
        o, d = _cornell_rays(3000, 1)
        active = np.ones(len(o), bool)
    elif name == "soup300":
        sc, _ = random_triangle_soup(298, seed=3)  # + 2 light triangles = 300
        o, d = _soup_rays(sc, 2000, 2)
        active = np.ones(len(o), bool)
    elif name == "inactive":
        sc, _ = cornell_box()
        o, d = _cornell_rays(1500, 4)
        active = rng.random(len(o)) < 0.7
    else:  # "zero_tris"
        sc, _ = cornell_box()
        sc = sc._replace(tri_v=sc.tri_v[:0])
        o, d = _cornell_rays(500, 5)
        active = np.ones(len(o), bool)
    tris9 = np.asarray(j_isect.pack_tris(jnp.asarray(sc.vertices), jnp.asarray(sc.tri_v)))
    t_max = rng.uniform(0.0, 12.0, len(o)).astype(np.float32)
    return o, d, active, tris9.astype(np.float32).reshape(-1, 9), t_max


CASES = ["cornell", "soup300", "inactive", "zero_tris"]


def _mt_numpy(o, d, active, tris9):
    """Sequential-scan oracle in numpy float32 (no contraction): the
    kernel's loop over triangles in scene order with a strict `<`."""
    f = np.float32
    best_t = np.where(active, f(1e9), f(-1e9)).astype(f)
    slot = np.full(len(o), -1, np.int32)
    bu = np.zeros(len(o), f)
    bv = np.zeros(len(o), f)
    ox, oy, oz = o.T
    dx, dy, dz = d.T
    for s, (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) in enumerate(tris9):
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv = f(1.0) / np.where(np.abs(det) < f(1e-20), f(1e-20), det)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        v = (dx * qvx + dy * qvy + dz * qvz) * inv
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        ok = (u >= 0) & (v >= 0) & (f(1.0) - u - v >= 0) & (t >= 0) & (t < best_t) & (det != 0)
        best_t = np.where(ok, t, best_t)
        slot = np.where(ok, s, slot)
        bu = np.where(ok, u, bu)
        bv = np.where(ok, v, bv)
    return np.where(slot < 0, f(1e9), best_t), slot, bu, bv


@pytest.mark.parametrize("name", CASES)
def test_brute_closest_matches_pallas_kernel(name):
    o, d, active, tris9, _ = _case(name)
    tt, trt, ut, vt = mt_brute.brute_closest(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active),
        torch.from_numpy(tris9),
    )
    if tris9.shape[0] == 0:
        # The reference kernel needs a non-empty slab; the port answers
        # "no hit" for every ray, as the reference's XLA path does.
        assert (trt.numpy() == -1).all() and (tt.numpy() == 1e9).all()
        assert (ut.numpy() == 0).all() and (vt.numpy() == 0).all()
        return
    with pltpu.force_tpu_interpret_mode():
        tj, trj, uj, vj = (np.asarray(x) for x in brute_closest_pallas(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), jnp.asarray(tris9)))
    np.testing.assert_array_equal(trt.numpy(), trj)
    assert (trj >= 0).sum() > 0.2 * len(o)  # the inputs do hit
    tol = 1e-3 if name == "soup300" else 1e-6
    for a, b in ((tt, tj), (ut, uj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol)
    if name == "soup300":
        ref = _mt_numpy(o, d, active, tris9)
        for a, b in zip((tt, trt, ut, vt), ref):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", CASES)
def test_brute_anyhit_matches_pallas_kernel(name):
    o, d, active, tris9, t_max = _case(name)
    occ = mt_brute.brute_anyhit(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        torch.from_numpy(active), torch.from_numpy(tris9),
    ).numpy()
    if tris9.shape[0] == 0:
        assert not occ.any()
        return
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(brute_anyhit_pallas(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(active),
            jnp.asarray(tris9)))
    np.testing.assert_array_equal(occ, ref)
    assert 0 < occ.sum() < len(o)


def test_cpu_tensors_run_the_twin_and_mixed_devices_raise():
    o, d, active, tris9, t_max = _case("cornell")
    args = [torch.from_numpy(x) for x in (o, d, active, tris9)]
    mt_brute.reset_launches()
    mt_brute.brute_closest(*args)
    mt_brute.brute_anyhit(args[0], args[1], torch.from_numpy(t_max), args[2], args[3])
    assert mt_brute.launches == {"closest": 0, "anyhit": 0, "closest_twin": 1, "anyhit_twin": 1}
    with pytest.raises(ValueError):
        mt_brute.brute_closest(args[0], args[1].to("meta"), args[2], args[3])


def _scene_and_hits():
    sc, _ = cornell_box()
    o, d = _cornell_rays(1000, 9)
    tri = np.asarray(j_isect.intersect_brute(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(sc.vertices), jnp.asarray(sc.tri_v))[1])
    return sc, o, d, tri


def test_intersect_brute_and_occluded_match_reference():
    sc, o, d, _ = _scene_and_hits()
    args_j = (jnp.asarray(o), jnp.asarray(d))
    args_t = (torch.from_numpy(o), torch.from_numpy(d))
    v_t, tv_t = torch.from_numpy(sc.vertices), torch.from_numpy(sc.tri_v)
    tj, trj, _, _ = (np.asarray(x) for x in j_isect.intersect_brute(
        *args_j, jnp.asarray(sc.vertices), jnp.asarray(sc.tri_v)))
    tt, trt, _, _ = t_isect.intersect_brute(*args_t, v_t, tv_t)
    np.testing.assert_array_equal(trt.numpy(), trj)
    hit = trj >= 0
    np.testing.assert_allclose(tt.numpy()[hit], tj[hit], rtol=1e-6)
    t_max = np.random.default_rng(3).uniform(0, 10, len(o)).astype(np.float32)
    oj = np.asarray(j_isect.occluded_brute(
        *args_j, jnp.asarray(t_max), jnp.asarray(sc.vertices), jnp.asarray(sc.tri_v)))
    ot = t_isect.occluded_brute(*args_t, torch.from_numpy(t_max), v_t, tv_t).numpy()
    np.testing.assert_array_equal(ot, oj)


def test_pack_tris_and_moller_trumbore_match_reference():
    sc, o, d, _ = _scene_and_hits()
    pj = np.asarray(j_isect.pack_tris(jnp.asarray(sc.vertices), jnp.asarray(sc.tri_v)))
    pt = t_isect.pack_tris(torch.from_numpy(sc.vertices), torch.from_numpy(sc.tri_v)).numpy()
    np.testing.assert_array_equal(pt, pj)
    sc, o, d, tri = _scene_and_hits()
    k = np.where(tri >= 0, tri, np.arange(len(o)) % pj.shape[0])
    tb = np.full(len(o), 1e9, np.float32)
    hj, *uvt_j = j_isect.moller_trumbore(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(pj[k, 0:3]), jnp.asarray(pj[k, 3:6]),
        jnp.asarray(pj[k, 6:9]), jnp.asarray(tb))
    ht, *uvt_t = t_isect.moller_trumbore(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pj[k, 0:3]),
        torch.from_numpy(pj[k, 3:6]), torch.from_numpy(pj[k, 6:9]), torch.from_numpy(tb))
    hit = np.asarray(hj)
    np.testing.assert_array_equal(ht.numpy(), hit)
    assert hit.sum() > 0.3 * len(o)
    # Compared where the triangle is hit: a miss far outside the triangle
    # can have a tiny det, which magnifies rounding in the reference's
    # reduction order.
    for a, b in zip(uvt_t, uvt_j):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-6, atol=1e-6)


def test_refine_hit_matches_reference():
    sc, o, d, tri = _scene_and_hits()
    rj = j_isect.refine_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tri),
                            jnp.asarray(sc.vertices), jnp.asarray(sc.tri_v))
    rt = t_isect.refine_hit(torch.from_numpy(o), torch.from_numpy(d), torch.tensor(tri),
                            torch.from_numpy(sc.vertices), torch.from_numpy(sc.tri_v))
    hit = tri >= 0
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-6, atol=1e-6)
    pk = np.asarray(j_isect.pack_tris(jnp.asarray(sc.vertices), jnp.asarray(sc.tri_v)))
    rows = pk[np.maximum(tri, 0)]
    fj = j_isect.refine_hit_tri(jnp.asarray(o), jnp.asarray(d), *(jnp.asarray(rows[:, s:s + 3])
                                                                 for s in (0, 3, 6)))
    ft = t_isect.refine_hit_tri(torch.from_numpy(o), torch.from_numpy(d),
                                *(torch.from_numpy(np.ascontiguousarray(rows[:, s:s + 3]))
                                  for s in (0, 3, 6)))
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-6, atol=1e-6)
