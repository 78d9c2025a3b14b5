"""Kernel B1's design, proved where it can be without the card.

csrc/mt_brute.cu decides most ray x triangle pairs with a pre-test that
skips the division (`mt_cull_plain` is that pre-test in torch: Pluecker
terms relative to each 256-row chunk's first vertex, with error margins
from the chunk's largest norms), confirms a lane's survivors in row order
with the exact test, gives a ray several lanes when rays are few
(`lanes_per_ray`), each lane taking every L-th row, and merges the lanes'
partial hits under the lexicographic (t, slot) minimum.  Held here:

  * the pre-test never rejects a pair that the exact test of the plain
    twins (`brute_closest_plain`, `brute_anyhit_plain`) accepts, on seeded
    inputs that reach each of its traps: random pairs, |det| < 1e-20 of
    both signs, det = 0 padding rows, numerators whose product with
    1 / det underflows to -0.0, u + v = 1 edges, t = 0, NaN and inf
    directions, scenes far from the origin, chunks of different offsets
    and scales; and on hypothesis-drawn pairs;
  * a torch emulation of the kernel (pre-test, then per-lane running
    minimum in row order, then the merge) equals the twins bit for bit, on
    ties between duplicated triangles and on random pairs, for 1, 2, 7 and
    32 lanes;
  * the twins themselves agree with the reference Pallas kernel
    (interpret mode) on the tie sets, up to which copy of a duplicated
    triangle wins (the reference may pick the second);
  * the lane count the wrapper picks.
Exact equality throughout: the emulation evaluates the twins' own
expressions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.experimental.pallas import tpu as pltpu

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu.ops.pallas_mt import brute_anyhit_pallas, brute_closest_pallas
from caitlynrenderer_tpu_torch.io.builtin_scenes import random_triangle_soup
from caitlynrenderer_tpu_torch.ops import mt_brute
from caitlynrenderer_tpu_torch.ops.intersect import INF, mt_uvt, pack_tris

F32 = np.float32


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(F32)


def _xy_triangle(scale=1.0):
    """v0 at the origin, e1 along x, e2 along y: det = -d.z * scale^2."""
    return np.array([[0, 0, 0, scale, 0, 0, 0, scale, 0]], F32)


def _case(name):
    """(o, d, tris9) float32 numpy arrays, seeded, for one trap."""
    rng = np.random.default_rng(["random", "tiny_det", "zero_rows", "underflow", "edges",
                                 "t_zero", "nan_inf", "far_edges", "chunks"].index(name))
    if name == "random":
        tris = rng.uniform(-1, 1, (64, 9)).astype(F32)
        tris[:, 0:3] = tris[:, 0:3] * 4 + 5
        return rng.uniform(0, 10, (400, 3)).astype(F32), _unit(rng.standard_normal((400, 3))), tris
    if name == "tiny_det":
        # Rays almost in the triangle's plane: det = -d.z runs from 1e-26 to
        # 1e-18 in magnitude, both signs; origins just off the plane so
        # that t = o.z / det stays below 1e9 for some.
        n = 4000
        d = np.zeros((n, 3), F32)
        d[:, 0:2] = rng.uniform(-1e-8, 1e-8, (n, 2))
        d[:, 2] = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-26, -18, n)
        o = np.zeros((n, 3), F32)
        o[:, 0:2] = rng.uniform(-5, 5, (n, 2))
        o[:, 2] = rng.uniform(-1e-11, 1e-11, n)
        return o, d, _xy_triangle()
    if name == "zero_rows":
        o, d, tris = _case("random")
        return o, d, np.concatenate([tris[:20], np.zeros((13, 9), F32), tris[20:]])
    if name == "underflow":
        # Long edges (det ~ 1e10 .. 1e20) and origins within 1e-40 of v0:
        # the numerators are so small that their products with 1 / det
        # round to +-0.0, and -0.0 passes u >= 0.
        n = 3000
        tris = np.concatenate([_xy_triangle(10.0 ** k) for k in (5, 7, 10)])
        o = (rng.choice([-1.0, 1.0], (n, 3)) * 10.0 ** rng.uniform(-44, -38, (n, 3))).astype(F32)
        return o, _unit(rng.standard_normal((n, 3))), tris
    if name == "edges":
        # Rays at points of the edge v1 -> v2 (u + v = 1) and at vertices.
        tris = rng.uniform(-1, 1, (16, 9)).astype(F32)
        n = 3000
        k = rng.integers(0, 16, n)
        s = rng.choice([0.0, 0.25, 0.5, 1.0], n)[:, None]
        target = tris[k, 0:3] + s * tris[k, 3:6] + (1 - s) * tris[k, 6:9]
        o = rng.uniform(-4, 4, (n, 3)).astype(F32)
        return o, _unit(target - o), tris
    if name == "t_zero":
        # Origins on the triangles (t = 0), directions random.
        tris = rng.uniform(-1, 1, (16, 9)).astype(F32)
        n = 3000
        k = rng.integers(0, 16, n)
        a = rng.uniform(0, 0.5, (n, 2))
        o = (tris[k, 0:3] + a[:, :1] * tris[k, 3:6] + a[:, 1:] * tris[k, 6:9]).astype(F32)
        return o, _unit(rng.standard_normal((n, 3))), tris
    if name == "far_edges":
        # The edges case far from the origin (|o|, |v0| ~ 1e4 .. 1e6 against
        # edges and distances ~1): the pre-test's numerators cancel, and its
        # margin grows with |o| + |v0|.
        o, d, tris = _case("edges")
        shift = (10.0 ** rng.uniform(4, 6, (1, 3)) * rng.choice([-1.0, 1.0], (1, 3))).astype(F32)
        target = o + 3.0 * d
        tris, o = tris.copy(), o + shift
        tris[:, 0:3] += shift
        return o.astype(F32), _unit(target + shift - o), tris
    if name == "chunks":
        # Three chunks of the kernel's staging (600 rows) at different offsets
        # and scales, one 1e3 times larger than the others: the pre-test's
        # origin and norm maxima are the chunk's.  Rays aimed at edges.
        parts = []
        for k, (scale, off) in enumerate(((1.0, 0.0), (1e3, 50.0), (0.01, -7.0))):
            t = (rng.uniform(-1, 1, (256 if k < 2 else 88, 9)) * scale).astype(F32)
            t[:, 0:3] += off
            parts.append(t)
        tris = np.concatenate(parts)
        n = 2000
        k = rng.integers(0, tris.shape[0], n)
        s = rng.choice([0.0, 0.5, 1.0], n)[:, None]
        target = tris[k, 0:3] + s * tris[k, 3:6] + (1 - s) * tris[k, 6:9]
        o = (target + rng.standard_normal((n, 3)) * np.abs(tris[k, 3:6]).max(axis=1,
                                                                          keepdims=True))
        return o.astype(F32), _unit(target - o), tris
    # nan_inf: NaN, inf and zero directions, and an inf origin
    o, d, tris = _case("random")
    d = d.copy()
    d[0::7, 0] = np.nan
    d[1::7, 1] = np.inf
    d[2::7] = 0.0
    d[3::7, 2] = -np.inf
    o = o.copy()
    o[4::7, 1] = np.inf
    return o, d, tris


CASES = ["random", "tiny_det", "zero_rows", "underflow", "edges", "t_zero", "nan_inf",
         "far_edges", "chunks"]


def _pairs(o, d, tris9):
    """(det, t, u, v, ok) of every pair in the twins' arithmetic; ok is the
    exact test against t_best = +inf (any finite t_best accepts fewer)."""
    o, d, tr = (torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, tris9))
    det, t, u, v = mt_uvt(o[:, None], d[:, None], tr[None, :, 0:3], tr[None, :, 3:6],
                          tr[None, :, 6:9])
    ok = ((u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0) & (t >= 0.0) & (t < torch.inf)
          & (det != 0.0))
    return det, t, u, v, ok


@pytest.mark.parametrize("name", CASES)
def test_pre_test_never_rejects_an_accepted_pair(name):
    o, d, tris9 = _case(name)
    det, t, u, v, ok = _pairs(o, d, tris9)
    keep = mt_brute.mt_cull_plain(torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(tris9))
    assert keep.shape == ok.shape
    assert not bool((ok & ~keep).any()), f"{int((ok & ~keep).sum())} accepted pairs culled"
    neg0 = lambda x: (x == 0) & torch.signbit(x)  # noqa: E731
    # Each case reaches its trap among the accepted pairs.
    if name == "random":
        assert int(ok.sum()) > 0 and float(keep.float().mean()) < 0.1  # it culls most pairs
    elif name == "tiny_det":
        tiny = det.abs() < 1e-20
        assert bool((ok & tiny & (det < 0)).any()) and bool((ok & tiny & (det > 0)).any())
        assert bool((ok & ~tiny).any())
    elif name == "zero_rows":
        # det = 0 rows decide no sign: they reach the exact test, which rejects them.
        assert bool(keep[:, 20:33].all()) and not bool(ok[:, 20:33].any())
        assert bool(ok[:, :20].any())
    elif name == "underflow":
        assert bool((ok & (neg0(u) | neg0(v) | neg0(t))).any())
    elif name in ("edges", "far_edges", "chunks"):
        assert bool((ok & (1.0 - u - v == 0)).any()) or name == "far_edges"
        assert int(ok.sum()) > 100 and float(keep.float().mean()) < 0.2
    elif name == "t_zero":
        assert bool((ok & (t == 0)).any())
    else:
        bad = ~torch.isfinite(torch.from_numpy(d)).all(dim=1) | (torch.from_numpy(d) == 0).all(
            dim=1)
        # NaN fails every comparison of the pre-test: the exact test rejects it.
        assert not bool(ok[bad].any()) and bool(keep[0::7].all())


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.integers(min_value=0, max_value=2**32 - 1),
       st.sampled_from([-30, -12, -3, 0, 3, 12, 30]))
def test_pre_test_never_rejects_an_accepted_pair_hypothesis(seed, exponent):
    """Pairs of every scale: coordinates 10^exponent times seeded normals,
    edges of random lengths, rays aimed near the triangles; 300 rows, so
    that two of the kernel's chunks are staged."""
    rng = np.random.default_rng(seed)
    scale = F32(10.0 ** exponent)
    tris = (rng.standard_normal((300, 9)) * scale).astype(F32)
    tris[:, 3:9] *= (10.0 ** rng.uniform(-3, 1, (300, 1))).astype(F32)
    o = (rng.standard_normal((64, 3)) * scale).astype(F32)
    k = rng.integers(0, 300, 64)
    bary = rng.uniform(-0.1, 1.1, (64, 2))
    target = tris[k, 0:3] + bary[:, :1] * tris[k, 3:6] + bary[:, 1:] * tris[k, 6:9]
    d = (target - o).astype(F32)
    d[::2] = rng.standard_normal((32, 3))
    _, _, _, _, ok = _pairs(o, d, tris)
    keep = mt_brute.mt_cull_plain(torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(tris))
    assert not bool((ok & ~keep).any())


# --------------------------------------------------------------------------
# Split slab and merge
# --------------------------------------------------------------------------


def _merge(a, b):
    """The kernel's merge of two lanes' (t, slot, u, v): the lexicographic
    (t, slot) minimum; a lane with slot -1 has no hit."""
    ta, sa, ua, va = a
    tb, sb, ub, vb = b
    take = (sb >= 0) & ((sa < 0) | (tb < ta) | ((tb == ta) & (sb < sa)))
    return tuple(torch.where(take, y, x) for x, y in zip(a, b))


def _emulate(o, d, active, tris9, lanes, t_max, order_seed=0):
    """The kernel in torch: lane g takes rows g, g + lanes, ...; a pair counts
    if the pre-test keeps it and the exact test accepts it; each lane keeps
    the first of its rows at its minimum t; the lanes are merged by the
    kernel's butterfly (powers of two) or, for other counts, in a seeded
    random order (the merge is associative and commutative).  Returns the
    closest (t, tri, u, v) and any-hit occlusion.  Every lane has rows."""
    n, count = o.shape[0], tris9.shape[0]
    t_in = torch.where(active, torch.as_tensor(t_max, dtype=torch.float32), -INF)
    parts, occ = [], torch.zeros(n, dtype=torch.bool)
    keep = mt_brute.mt_cull_plain(o, d, tris9)
    for g in range(lanes):
        rows = torch.arange(g, count, lanes)
        sub = tris9[rows]
        det, t, u, v = mt_uvt(o[:, None], d[:, None], sub[None, :, 0:3], sub[None, :, 3:6],
                              sub[None, :, 6:9])
        ok = ((u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0) & (t >= 0.0) & (t < t_in[:, None])
              & (det != 0.0) & keep[:, rows])
        occ |= ok.any(dim=1)
        best, j = torch.where(ok, t, torch.inf).min(dim=1)
        hit = ok.any(dim=1)
        slot = torch.where(hit, rows[j], -1)
        u, v = (x.gather(1, j[:, None])[:, 0] for x in (u, v))
        parts.append((torch.where(hit, best, t_in), slot, torch.where(hit, u, 0.0),
                      torch.where(hit, v, 0.0)))
    if lanes & (lanes - 1) == 0:
        off = lanes // 2
        while off:
            parts = [_merge(parts[g], parts[g ^ off]) for g in range(lanes)]
            off //= 2
        merged = parts[0]
    else:
        order = np.random.default_rng(order_seed).permutation(lanes)
        merged = parts[order[0]]
        for g in order[1:]:
            merged = _merge(merged, parts[g])
    t, slot, u, v = merged
    miss = slot < 0
    return (torch.where(miss, INF, t), slot.to(torch.int32), torch.where(miss, 0.0, u),
            torch.where(miss, 0.0, v)), occ


def _tie_set(layout, n=600, seed=5):
    """The 2048-triangle soup's first 300 triangles twice, stacked or
    interleaved, and rays aimed at their centroids (half) or random."""
    sc, _ = random_triangle_soup(300, seed=1)
    tris = pack_tris(torch.from_numpy(sc.vertices), torch.from_numpy(sc.tri_v))[:300]
    dup = (torch.cat([tris, tris]) if layout == "stacked"
           else torch.stack([tris, tris], dim=1).reshape(-1, 9)).contiguous()
    rng = np.random.default_rng(seed)
    o = rng.uniform(0, 10, (n, 3)).astype(F32)
    cen = (tris[:, 0:3] + (tris[:, 3:6] + tris[:, 6:9]) / 3.0).numpy()
    d = cen[rng.integers(0, 300, n)] - o
    d[n // 2:] = rng.standard_normal((n - n // 2, 3))
    active = rng.random(n) < 0.9
    t_max = rng.uniform(0, 12, n).astype(F32)
    return (torch.from_numpy(o), torch.from_numpy(_unit(d)), torch.from_numpy(active), dup,
            torch.from_numpy(t_max))


@pytest.mark.parametrize("lanes", [1, 2, 7, 32])
@pytest.mark.parametrize("layout", ["stacked", "interleaved", "random"])
def test_split_slab_merge_equals_the_twin(layout, lanes):
    if layout == "random":
        o, d, tris9 = (torch.from_numpy(x) for x in _case("random"))
        rng = np.random.default_rng(9)
        active = torch.from_numpy(rng.random(o.shape[0]) < 0.9)
        t_max = torch.from_numpy(rng.uniform(0, 12, o.shape[0]).astype(F32))
    else:
        o, d, active, tris9, t_max = _tie_set(layout)
    (t, tri, u, v), occ = _emulate(o, d, active, tris9, lanes, INF)
    tt, trt, ut, vt = mt_brute.brute_closest_plain(o, d, active, tris9)
    for a, b in ((t, tt), (tri, trt), (u, ut), (v, vt)):
        assert torch.equal(a, b)
    _, occ_k = _emulate(o, d, active, tris9, lanes, t_max)
    assert torch.equal(occ_k, mt_brute.brute_anyhit_plain(o, d, t_max, active, tris9))
    assert int((trt >= 0).sum()) > (10 if layout == "random" else 0.2 * o.shape[0])
    if layout != "random":
        # Every hit is on a duplicated triangle: the lower copy wins.
        copy = trt + (300 if layout == "stacked" else 1)
        assert bool((trt[trt >= 0] < copy[trt >= 0]).all())


@pytest.mark.parametrize("layout", ["stacked", "interleaved"])
def test_tie_sets_match_the_pallas_kernel(layout):
    o, d, active, tris9, t_max = _tie_set(layout)
    tt, trt, ut, vt = mt_brute.brute_closest(o, d, active, tris9)
    with pltpu.force_tpu_interpret_mode():
        tj, trj, uj, vj = (np.asarray(x) for x in brute_closest_pallas(
            jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(active.numpy()),
            jnp.asarray(tris9.numpy())))
        occ_j = np.asarray(brute_anyhit_pallas(
            jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(t_max.numpy()),
            jnp.asarray(active.numpy()), jnp.asarray(tris9.numpy())))
    # The reference's tie-break among exact duplicates is its own (it may
    # pick the second copy); the port keeps the first.  Same hit or miss,
    # and the same triangle up to which copy.
    np.testing.assert_array_equal(trt.numpy() >= 0, trj >= 0)
    rows = tris9.numpy()
    np.testing.assert_array_equal(rows[np.maximum(trt.numpy(), 0)], rows[np.maximum(trj, 0)])
    for a, b in ((tt, tj), (ut, uj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-3)  # XLA contracts FMAs
    np.testing.assert_array_equal(
        mt_brute.brute_anyhit(o, d, t_max, active, tris9).numpy(), occ_j)


@pytest.mark.parametrize("n, count, lanes", [
    (490_000, 36, 1),  # the 700x700 cornell frame
    (65_536, 2048, 4),  # 256x256 rays at the brute-force threshold
    (16_384, 999_700, 16),  # grid1m oracle batches
    (4096, 4096, 32),
    (100, 36, 2),  # few rows: at least 16 per lane
    (1, 10, 1),
])
def test_lanes_per_ray(n, count, lanes):
    got = mt_brute.lanes_per_ray(n, count)
    assert got == lanes
    assert got & (got - 1) == 0 and 1 <= got <= 32
    if got > 1:
        assert n * got <= 132 * 2048 and count >= 16 * got
    if got < 32:  # the next power of two breaks a rule
        assert 2 * got * n > 132 * 2048 or 2 * got * 16 > count
