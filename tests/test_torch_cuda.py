"""CUDA tier: the hand-written kernels (mt_brute, traverse_mega,
traverse_cw8, traverse_bvh, threefry) against their plain PyTorch twins on
the card, their stats variants against the plain launches, the golden
render through each, CUDA graphs against eager samples, and one value and
grad on the card against the CPU.

Marked `cuda`; every test skips (inside the fixture, never at import)
when torch sees no CUDA device.  Run on an NVIDIA card with
`python -m pytest tests/ -m cuda -q`.  The first test of each kernel
builds its csrc/*.cu with nvcc (a few seconds).  Tolerance: tri, group and
occlusion equal on every ray, t/u/v within 1e-6 relative (kernel and twin
evaluate the same float32 expressions, neither contracts into FMAs); B3's
window equal on every ray too; B4's t, u and v bit for bit; B5's uniforms
bit for bit (integer arithmetic and one exact subtraction).
"""

import os

import numpy as np
import pytest
import torch

from caitlynrenderer_tpu.core.types import RenderOptions
from caitlynrenderer_tpu.io.builtin_scenes import displaced_grid, random_triangle_soup
from caitlynrenderer_tpu.utils import config
from caitlynrenderer_tpu_torch.bench import bench_scene
from caitlynrenderer_tpu_torch.core import math as cm
from caitlynrenderer_tpu_torch.core.camera import generate_rays
from caitlynrenderer_tpu_torch.ops import mt_brute, traverse_bvh, traverse_cw8, traverse_mega
from caitlynrenderer_tpu_torch.ops.intersect import pack_tris
from caitlynrenderer_tpu_torch.render import progressive, sampling
from caitlynrenderer_tpu_torch.scene import (
    WIDE_FIELDS,
    required_stack,
    scene_families,
    upload_scene,
)
from test_torch_bvh_kernel import _rays as axis_parallel_rays
from test_torch_mt_cull import CASES as CULL_CASES, _case as cull_case

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")
GOLDEN = os.path.join(ROOT, "scenes", "golden", "cornell_64_cpu.npz")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cornell():
    cfg = config.load_config(TOML)
    scene, translation = config.scene_from_config(cfg, os.path.dirname(TOML))
    return scene, config.camera_from_config(cfg, translation)


def _rays(dev, n, lo, hi, seed, active_share=0.9):
    rng = np.random.default_rng(seed)
    o = torch.tensor(rng.uniform(lo, hi, (n, 3)), dtype=torch.float32, device=dev)
    d = cm.normalize(torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32, device=dev))
    active = torch.tensor(rng.random(n) < active_share, device=dev)
    t_max = torch.tensor(rng.uniform(0, hi - lo, n), dtype=torch.float32, device=dev)
    return o, d, active, t_max


def _soup_tris(dev):
    soup, _ = random_triangle_soup(2048)
    verts = torch.tensor(soup.vertices, device=dev)
    return pack_tris(verts, torch.tensor(soup.tri_v, device=dev))[-2048:].contiguous()


CASES = ["cornell_inside", "soup2048", "ragged_with_padding"]


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_twin(case, dev, cornell):
    tris9 = upload_scene(cornell[0], "brute", dev).tris9
    if case == "cornell_inside":
        o, d, active, t_max = _rays(dev, 100_000, 0.1, 5.4, 1)
    elif case == "soup2048":
        tris9 = _soup_tris(dev)
        o, d, active, t_max = _rays(dev, 20_000, 0.0, 10.0, 2)
    else:  # N not a multiple of the block, det = 0 padding rows
        tris9 = torch.cat([tris9, torch.zeros((7, 9), device=dev)]).contiguous()
        o, d, active, t_max = _rays(dev, 1001, 0.1, 5.4, 3)
    tk, trk, uk, vk = mt_brute.brute_closest(o, d, active, tris9)
    tt, trt, ut, vt = mt_brute.brute_closest_plain(o, d, active, tris9)
    occ_k = mt_brute.brute_anyhit(o, d, t_max, active, tris9)
    occ_t = mt_brute.brute_anyhit_plain(o, d, t_max, active, tris9)
    torch.cuda.synchronize()
    assert torch.equal(trk, trt)
    assert torch.equal(occ_k, occ_t)
    assert int((trt >= 0).sum()) > 0 and int(occ_t.sum()) > 0
    for a, b in ((tk, tt), (uk, ut), (vk, vt)):
        assert bool(((a - b).abs() <= 1e-6 * b.abs()).all())


@pytest.mark.parametrize("case", ["few_rays_2048", "ties_stacked", "ties_interleaved",
                                  "rays_16384_2048"])
def test_kernel_matches_twin_with_lanes_per_ray(case, dev):
    """Few rays take several lanes each (32 for 1,001 rays x 2048 rows, 16
    for 16,384 rays, the lane count of grid1m's oracle batches); duplicated
    triangles tie, and the lower copy wins in the kernel as in the twin,
    whether the copies fall in one lane's rows or in two."""
    soup = _soup_tris(dev)
    if case in ("few_rays_2048", "rays_16384_2048"):
        tris9 = soup
    elif case == "ties_stacked":
        tris9 = torch.cat([soup, soup]).contiguous()
    else:
        tris9 = torch.stack([soup, soup], dim=1).reshape(-1, 9).contiguous()
    n, lanes = (16_384, 16) if case == "rays_16384_2048" else (1001, 32)
    o, d, active, t_max = _rays(dev, n, 0.0, 10.0, 14)
    cen = soup[:, 0:3] + (soup[:, 3:6] + soup[:, 6:9]) / 3.0
    half = n // 2
    aim = cen[(torch.arange(half, device=dev) * 4) % soup.shape[0]] - o[:half]
    d = torch.cat([cm.normalize(aim), d[half:]]).contiguous()
    assert mt_brute._lanes(n, tris9.shape[0], dev) == lanes
    tk, trk, uk, vk = mt_brute.brute_closest(o, d, active, tris9)
    tt, trt, ut, vt = mt_brute.brute_closest_plain(o, d, active, tris9)
    occ_k = mt_brute.brute_anyhit(o, d, t_max, active, tris9)
    occ_t = mt_brute.brute_anyhit_plain(o, d, t_max, active, tris9)
    torch.cuda.synchronize()
    assert torch.equal(trk, trt) and torch.equal(occ_k, occ_t)
    assert int((trt >= 0).sum()) > 300 and int(occ_t.sum()) > 0
    for a, b in ((tk, tt), (uk, ut), (vk, vt)):
        assert bool(((a - b).abs() <= 1e-6 * b.abs()).all())


@pytest.mark.parametrize("name", CULL_CASES)
def test_kernel_matches_twin_on_pre_test_traps(name, dev):
    """The inputs on which the kernel's pre-test could go wrong
    (tests/test_torch_mt_cull.py's cases: |det| < 1e-20 of both signs,
    det = 0 rows, numerators whose product with 1 / det underflows to
    -0.0, u + v = 1 edges, t = 0, NaN, inf and zero directions, scenes far
    from the origin, 256-row chunks of different offsets and scales), on
    the card: the kernel equals the twins bit for bit, ~10 % of the rays
    inactive."""
    o, d, tris9 = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in cull_case(name))
    rng = np.random.default_rng(16)
    n = o.shape[0]
    active = torch.tensor(rng.random(n) < 0.9, device=dev)
    t_max = torch.tensor(rng.uniform(0, 20, n), dtype=torch.float32, device=dev)
    tk, trk, uk, vk = mt_brute.brute_closest(o, d, active, tris9)
    tt, trt, ut, vt = mt_brute.brute_closest_plain(o, d, active, tris9)
    occ_k = mt_brute.brute_anyhit(o, d, t_max, active, tris9)
    occ_t = mt_brute.brute_anyhit_plain(o, d, t_max, active, tris9)
    torch.cuda.synchronize()
    for a, b in ((trk, trt), (tk, tt), (uk, ut), (vk, vt), (occ_k, occ_t)):
        assert torch.equal(a, b)
    assert int((trt >= 0).sum()) > 0


def test_kernel_rejects_bad_inputs(dev, cornell):
    tris9 = upload_scene(cornell[0], "brute", dev).tris9
    o, d, active, t_max = _rays(dev, 64, 0.1, 5.4, 4)
    with pytest.raises(TypeError):
        mt_brute.brute_closest(o.double(), d, active, tris9)
    with pytest.raises(ValueError):
        mt_brute.brute_closest(o.t().contiguous().t(), d, active, tris9)
    with pytest.raises(ValueError):
        mt_brute.brute_anyhit(o, d, t_max[:10], active, tris9)
    with pytest.raises(ValueError):
        mt_brute.brute_closest(o.cpu(), d, active, tris9)


def test_golden_render_on_cuda(dev, cornell):
    scene, camera = cornell
    options = RenderOptions(width=64, height=64, max_depth=3, accel="brute",
                            families=scene_families(scene))
    mt_brute.reset_launches()
    captures = progressive.graph_counts["captures"]
    img, _ = progressive.render_image(upload_scene(scene, "brute", dev), camera, options,
                                      spp=48, seed=0)
    img = img.cpu().numpy()
    # 6 replays of an 8-sample graph, and the capture's warm-up sample.
    samples = 48 + progressive.graph_counts["captures"] - captures
    assert mt_brute.launches["closest"] == mt_brute.launches["anyhit"] == samples * 3
    assert mt_brute.launches["closest_twin"] == 0 and mt_brute.launches["anyhit_twin"] == 0
    err = np.abs(img - np.load(GOLDEN)["img"])
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 0.06, err.max()
    assert img[32, 4, 0] > img[32, 4, 1] and img[32, 60, 1] > img[32, 60, 0]


def _wide_case(case, dev, cornell):
    """(wide DeviceScene, o, d, active, t_max) for a B2 case."""
    if case == "soup":
        ds = upload_scene(random_triangle_soup(2000, seed=1)[0], "wide", dev, wide_group_tris=128)
        return (ds, *_rays(dev, 20_000, 0.0, 10.0, 5))
    if case == "grid":
        ds = upload_scene(displaced_grid(resolution=60)[0], "wide", dev, wide_group_tris=32)
        o, d, active, t_max = _rays(dev, 20_000, 0.0, 10.0, 6)
        d = cm.normalize(torch.where((d[:, 1] > 0)[:, None], d * torch.tensor(
            [1.0, -1.0, 1.0], device=dev), d))  # mostly downwards, onto the terrain
        return ds, o + torch.tensor([0.0, 3.0, 0.0], device=dev), d.contiguous(), active, t_max
    # cornell with 2-triangle groups: each wall quad has a flat box
    ds = upload_scene(cornell[0], "wide", dev, wide_group_tris=2)
    return (ds, *_rays(dev, 20_000, 0.1, 5.4, 7))


@pytest.mark.parametrize("case", ["soup", "grid", "cornell_flat_groups"])
def test_mega_kernel_matches_twin(case, dev, cornell):
    ds, o, d, active, t_max = _wide_case(case, dev, cornell)
    wide = [getattr(ds, k) for k in WIDE_FIELDS]
    tk, trk, gk = traverse_mega.mega_closest(o, d, active, *wide)
    tt, trt, gt = traverse_mega.mega_closest_plain(o, d, active, *wide)
    occ_k = traverse_mega.mega_anyhit(o, d, t_max, active, *wide)
    occ_t = traverse_mega.mega_anyhit_plain(o, d, t_max, active, *wide)
    torch.cuda.synchronize()
    assert torch.equal(trk, trt) and torch.equal(gk, gt)
    assert torch.equal(occ_k, occ_t)
    assert int((trt >= 0).sum()) > 0 and int(occ_t.sum()) > 0
    assert bool(((tk - tt).abs() <= 1e-6 * tt.abs()).all())


def test_mega_kernel_rejects_bad_inputs(dev, cornell):
    ds = upload_scene(cornell[0], "wide", dev, wide_group_tris=2)
    wide = [getattr(ds, k) for k in WIDE_FIELDS]
    o, d, active, t_max = _rays(dev, 64, 0.1, 5.4, 8)
    with pytest.raises(TypeError):
        traverse_mega.mega_closest(o.double(), d, active, *wide)
    with pytest.raises(ValueError):
        traverse_mega.mega_closest(o.t().contiguous().t(), d, active, *wide)
    with pytest.raises(ValueError):
        traverse_mega.mega_anyhit(o, d, t_max[:10], active, *wide)
    with pytest.raises(TypeError):
        traverse_mega.mega_closest(o, d, active.int(), *wide)
    with pytest.raises(ValueError):
        traverse_mega.mega_closest(o, d, active, *wide[:5], wide[5][:, :0])
    with pytest.raises(ValueError):
        traverse_mega.mega_closest(o.cpu(), d, active, *wide)


@pytest.fixture(scope="module")
def grid1m_bench(dev):
    """grid1m through "wide" and a 4,096-ray subset of the 256x256 bench
    camera's primary rays (every 16th pixel), with t_max for any-hit."""
    scene, camera = bench_scene("grid1m")
    ds = upload_scene(scene, "wide", dev)
    uni = sampling.pixel_uniforms(sampling.sample_key(sampling.prng_key(0), 0),
                                  torch.arange(256 * 256, dtype=torch.int32, device=dev), 4)
    o, d = generate_rays(camera, 256, 256, uni)
    o, d = o[::16].contiguous(), d[::16].contiguous()
    t_max = torch.tensor(np.random.default_rng(13).uniform(0, 20, o.shape[0]),
                         dtype=torch.float32, device=dev)
    return ds, o, d, torch.ones(o.shape[0], dtype=torch.bool, device=dev), t_max


def test_mega_kernel_matches_twin_on_grid1m_bench_rays(dev, grid1m_bench):
    ds, o, d, active, t_max = grid1m_bench
    wide = [getattr(ds, k) for k in WIDE_FIELDS]
    tk, trk, gk = traverse_mega.mega_closest(o, d, active, *wide)
    tt, trt, gt = traverse_mega.mega_closest_plain(o, d, active, *wide)
    occ_k = traverse_mega.mega_anyhit(o, d, t_max, active, *wide)
    occ_t = traverse_mega.mega_anyhit_plain(o, d, t_max, active, *wide)
    torch.cuda.synchronize()
    assert torch.equal(trk, trt) and torch.equal(gk, gt) and torch.equal(tk, tt)
    assert torch.equal(occ_k, occ_t)
    assert int((trt >= 0).sum()) > o.shape[0] // 2 and int(occ_t.sum()) > 0


@pytest.mark.parametrize("case", ["grid1m_bench", "cornell_flat_groups"])
def test_mega_stats_variant_is_the_timed_walk(case, dev, cornell, request):
    """The stats variant returns what the plain launch returns, and its
    counts hold together: a closest walk evaluates every column of each
    group it visits, an any-hit walk at most that, u/v columns are at most
    the columns, and what a ray counts, some flag shows as touched."""
    if case == "grid1m_bench":
        ds, o, d, active, t_max = request.getfixturevalue("grid1m_bench")
    else:
        ds, o, d, active, t_max = _wide_case("cornell_flat_groups", dev, cornell)
    wide = [getattr(ds, k) for k in WIDE_FIELDS]
    g, kp = ds.wb_mega.shape[0], ds.wb_mega.shape[2] // 3
    nblk = ds.wb_oct_blk.shape[1]
    traverse_mega.reset_launches()
    t, tri, grp = traverse_mega.mega_closest(o, d, active, *wide)
    ts, tris, grps, st = traverse_mega.mega_closest(o, d, active, *wide, stats=True)
    occ = traverse_mega.mega_anyhit(o, d, t_max, active, *wide)
    occs, sta = traverse_mega.mega_anyhit(o, d, t_max, active, *wide, stats=True)
    torch.cuda.synchronize()
    assert traverse_mega.launches["closest"] == 1 and traverse_mega.launches["anyhit"] == 1
    assert traverse_mega.stats_launches == {"closest": 1, "anyhit": 1}
    assert torch.equal(t, ts) and torch.equal(tri, tris) and torch.equal(grp, grps)
    assert torch.equal(occ, occs)
    for s, closest in ((st, True), (sta, False)):
        c = s["counts"].long()
        blk, ent, groups, cols, uv = c.unbind(1)
        assert c.shape == (o.shape[0], len(traverse_mega.STATS))
        if closest:
            assert torch.equal(cols, kp * groups)
        else:
            assert bool((cols <= kp * groups).all()) and bool((cols % 32 == 0).all())
        assert bool((uv <= cols).all()) and bool((groups <= ent).all())
        assert bool((ent <= 128 * blk).all()) and bool((blk <= nblk).all())
        assert int(groups.max()) <= int(s["grp_seen"].sum()) <= g
        assert int(s["blk_seen"].sum()) > 0 and int(s["ent_seen"].sum()) >= int(groups.max())
    live = st["counts"][:, 0] > 0
    assert bool((tri[~live] < 0).all())  # a ray that tested nothing hit nothing
    assert int(st["counts"][:, 2].sum()) > 0


def test_golden_render_through_wide_on_cuda(dev, cornell):
    scene, camera = cornell
    options = RenderOptions(width=64, height=64, max_depth=3, accel="wide",
                            families=scene_families(scene))
    mt_brute.reset_launches()
    traverse_mega.reset_launches()
    ds = upload_scene(scene, "wide", dev, wide_group_tris=64)
    captures = progressive.graph_counts["captures"]
    img, _ = progressive.render_image(ds, camera, options, spp=48, seed=0)
    img = img.cpu().numpy()
    samples = 48 + progressive.graph_counts["captures"] - captures  # and a warm-up
    assert traverse_mega.launches == {"closest": samples * 3, "anyhit": samples * 3,
                                      "closest_twin": 0, "anyhit_twin": 0}
    assert all(v == 0 for v in mt_brute.launches.values())
    err = np.abs(img - np.load(GOLDEN)["img"])
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 0.06, err.max()
    assert img[32, 4, 0] > img[32, 4, 1] and img[32, 60, 1] > img[32, 60, 0]


def _cw(ds):
    return ds.cw_nodes, ds.cw_planes, ds.cw_bounds, ds.cw_depth


def _cw_case(case, dev, cornell):
    """(cwbvh DeviceScene, o, d, active, t_max) for a B3 case."""
    if case == "soup":
        ds = upload_scene(random_triangle_soup(2000, seed=1)[0], "cwbvh", dev)
        return (ds, *_rays(dev, 20_000, 0.0, 10.0, 9))
    if case == "grid":
        ds = upload_scene(displaced_grid(resolution=60)[0], "cwbvh", dev)
        o, d, active, t_max = _rays(dev, 20_000, 0.0, 10.0, 10)
        d = cm.normalize(torch.where((d[:, 1] > 0)[:, None], d * torch.tensor(
            [1.0, -1.0, 1.0], device=dev), d))  # mostly downwards, onto the terrain
        return ds, o + torch.tensor([0.0, 3.0, 0.0], device=dev), d.contiguous(), active, t_max
    ds = upload_scene(cornell[0], "cwbvh", dev)  # flat wall boxes
    return (ds, *_rays(dev, 20_000, 0.1, 5.4, 11))


@pytest.mark.parametrize("case", ["soup", "grid", "cornell"])
def test_cw8_kernel_matches_twin(case, dev, cornell):
    ds, o, d, active, t_max = _cw_case(case, dev, cornell)
    tk, trk, wk = traverse_cw8.cw8_closest(o, d, active, *_cw(ds))
    tt, trt, wt = traverse_cw8.cw8_closest_plain(o, d, active, *_cw(ds))
    occ_k = traverse_cw8.cw8_anyhit(o, d, t_max, active, *_cw(ds))
    occ_t = traverse_cw8.cw8_anyhit_plain(o, d, t_max, active, *_cw(ds))
    torch.cuda.synchronize()
    assert torch.equal(trk, trt) and torch.equal(wk, wt)
    assert torch.equal(occ_k, occ_t)
    assert int((trt >= 0).sum()) > 0 and int(occ_t.sum()) > 0
    assert bool(((tk - tt).abs() <= 1e-6 * tt.abs()).all())


@pytest.mark.parametrize("case", ["soup", "grid", "cornell"])
def test_cw8_stats_variant_is_the_timed_walk(case, dev, cornell):
    """The stats variant returns what the plain launch returns, as the
    timed walk and as the oracle walk seeded with the closest t; the oracle
    walk does no more than the timed one, and the counts hold together."""
    ds, o, d, active, t_max = _cw_case(case, dev, cornell)
    traverse_cw8.reset_launches()
    t, tri, win = traverse_cw8.cw8_closest(o, d, active, *_cw(ds))
    occ = traverse_cw8.cw8_anyhit(o, d, t_max, active, *_cw(ds))
    n8, ncols = ds.cw_nodes.shape[0], 32 * ds.cw_planes.shape[0]
    walks = {}
    for seed in (None, t):
        ts, tris, wins, st = traverse_cw8.cw8_closest(o, d, active, *_cw(ds), stats=True,
                                                      t_seed=seed)
        occs, sta = traverse_cw8.cw8_anyhit(o, d, t_max, active, *_cw(ds), stats=True,
                                            t_seed=seed)
        torch.cuda.synchronize()
        assert torch.equal(t, ts) and torch.equal(tri, tris) and torch.equal(win, wins)
        assert torch.equal(occ, occs)
        for s in (st, sta):
            nodes, boxes, tested, stack = s["counts"].long().unbind(1)
            assert s["counts"].shape == (o.shape[0], len(traverse_cw8.STATS))
            assert bool((boxes <= 8 * nodes).all()) and bool((tested <= 3 * boxes).all())
            assert int(stack.max()) <= ds.cw_depth and int(s["node_seen"].sum()) <= n8
            assert s["col_seen"].shape == (ncols,) and int(s["col_seen"].max()) <= 2
        assert bool((st["counts"][tri >= 0, 2] > 0).all())  # a hit was tested
        walks[seed is None] = (st["counts"].long().sum(0), sta["counts"].long().sum(0))
    assert bool((walks[False][0][:3] <= walks[True][0][:3]).all())
    assert traverse_cw8.launches["closest"] == 1 and traverse_cw8.launches["anyhit"] == 1
    assert traverse_cw8.stats_launches == {"closest": 2, "anyhit": 2}


def test_cw8_kernel_rejects_bad_inputs(dev, cornell):
    ds = upload_scene(cornell[0], "cwbvh", dev)
    nodes, planes, bounds, depth = _cw(ds)
    o, d, active, t_max = _rays(dev, 64, 0.1, 5.4, 12)
    with pytest.raises(TypeError):
        traverse_cw8.cw8_closest(o.double(), d, active, nodes, planes, bounds, depth)
    with pytest.raises(ValueError):
        traverse_cw8.cw8_closest(o.t().contiguous().t(), d, active, nodes, planes, bounds, depth)
    with pytest.raises(ValueError):
        traverse_cw8.cw8_anyhit(o, d, t_max[:10], active, nodes, planes, bounds, depth)
    with pytest.raises(TypeError):
        traverse_cw8.cw8_closest(o, d, active, nodes.view(torch.float32), planes, bounds, depth)
    with pytest.raises(TypeError):
        traverse_cw8.cw8_closest(o, d, active.int(), nodes, planes, bounds, depth)
    with pytest.raises(ValueError):
        traverse_cw8.cw8_closest(o, d, active, nodes, planes[:, :, :96], bounds, depth)
    with pytest.raises(ValueError, match="depth"):
        traverse_cw8.cw8_closest(o, d, active, nodes, planes, bounds, traverse_cw8.MAX_DEPTH + 1)
    with pytest.raises(ValueError):
        traverse_cw8.cw8_closest(o.cpu(), d, active, nodes, planes, bounds, depth)


@pytest.mark.parametrize("accel", ["cwbvh", "bvh2", "sbvh"])
def test_golden_render_through_tree_accels_on_cuda(accel, dev, cornell):
    scene, camera = cornell
    options = RenderOptions(width=64, height=64, max_depth=3, accel=accel,
                            families=scene_families(scene))
    mods = (mt_brute, traverse_mega, traverse_cw8, traverse_bvh)
    for m in mods:
        m.reset_launches()
    captures = progressive.graph_counts["captures"]
    # render_image's default: 8 samples a launch, a CUDA graph's replay.
    img, _ = progressive.render_image(upload_scene(scene, accel, dev), camera, options,
                                      spp=48, seed=0)
    img = img.cpu().numpy()
    # A capture runs one warm-up sample.
    samples = 48 + progressive.graph_counts["captures"] - captures
    mine = traverse_cw8 if accel == "cwbvh" else traverse_bvh
    assert {k: v for k, v in mine.launches.items() if v} == {"closest": samples * 3,
                                                             "anyhit": samples * 3}
    assert all(v == 0 for m in mods if m is not mine for v in m.launches.values())
    err = np.abs(img - np.load(GOLDEN)["img"])
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 0.06, err.max()
    assert img[32, 4, 0] > img[32, 4, 1] and img[32, 60, 1] > img[32, 60, 0]


def test_value_and_grad_on_cuda_matches_cpu(dev):
    """One value and grad of the Disney floor at 32x32, 3 bounces, every
    parameter group, on the card (B1) and on the CPU (the twins), as
    chip_smoke.py's phase 18d: each gradient entry within rtol 1e-3, atol
    1e-6 max|g|, the losses within rtol 1e-5 (its checks raise)."""
    import importlib.util
    import tomllib

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(ROOT, "scenes", "cornell_disney.toml"), "rb") as f:
        cfg = tomllib.load(f)
    mt_brute.reset_launches()
    rec = smoke.grad_card_vs_cpu(dev, cfg, os.path.join(ROOT, "scenes"), 32)
    assert rec["size"] == "32x32"
    assert mt_brute.launches["closest"] == 3 and mt_brute.launches["anyhit"] == 3
    assert mt_brute.launches["closest_twin"] == 3 and mt_brute.launches["anyhit_twin"] == 3


@pytest.mark.parametrize("accel", ["brute", "cwbvh"])
def test_xla_traversal_raises_on_cuda(accel, dev, cornell):
    """traversal "xla" would walk past B1/B3 on the card: it raises, and
    neither a kernel nor a twin runs."""
    scene, camera = cornell
    options = RenderOptions(width=16, height=16, max_depth=2, accel=accel, traversal="xla",
                            families=scene_families(scene))
    mt_brute.reset_launches()
    traverse_cw8.reset_launches()
    with pytest.raises(ValueError, match='"xla"'):
        progressive.render_image(upload_scene(scene, accel, dev), camera, options, spp=1, seed=0)
    assert all(v == 0 for v in mt_brute.launches.values())
    assert all(v == 0 for v in traverse_cw8.launches.values())


@pytest.mark.parametrize("accel", ["brute", "wide", "cwbvh", "bvh2", "sbvh"])
def test_graph_equals_eager_on_cuda(accel, dev, cornell):
    """render_steps of 4 samples, replayed twice from one CUDA graph, ≡ 8
    eager render_step calls bit for bit, through B1, B2, B3 and B4 (bvh2
    and sbvh); each replay adds the graph's 3 + 3 launches a sample, the
    capture one warm-up sample, and no twin runs.  A second camera through
    the same graph ≡ its eager render too."""
    scene, camera = cornell
    options = RenderOptions(width=48, height=40, max_depth=3, accel=accel,
                            families=scene_families(scene))
    ds = upload_scene(scene, accel, dev)
    w, h = options.width, options.height
    mods = {"brute": mt_brute, "wide": traverse_mega, "cwbvh": traverse_cw8,
            "bvh2": traverse_bvh, "sbvh": traverse_bvh}
    for m in mods.values():
        m.reset_launches()
    eager = progressive.init_state(w, h, 3, dev)
    for _ in range(8):
        eager = progressive.render_step(ds, camera, eager, w, h, options)
    counts = dict(progressive.graph_counts)
    graph = progressive.init_state(w, h, 3, dev)
    for _ in range(2):
        graph = progressive.render_steps(ds, camera, graph, w, h, options, 4)
    assert graph.frame_count == 8
    assert torch.equal(graph.accum, eager.accum)
    assert progressive.graph_counts == {"captures": counts["captures"] + 1,
                                        "replays": counts["replays"] + 2}
    run = mods[accel].launches
    assert run["closest"] == run["anyhit"] == 3 * (8 + 8 + 1)
    assert run["closest_twin"] == run["anyhit_twin"] == 0
    assert all(v == 0 for m in mods.values() if m is not mods[accel] for v in m.launches.values())

    moved = camera._replace(position=camera.position + np.float32(0.3))
    want = progressive.init_state(w, h, 3, dev)
    for _ in range(4):
        want = progressive.render_step(ds, moved, want, w, h, options)
    got = progressive.render_steps(ds, moved, progressive.init_state(w, h, 3, dev), w, h,
                                   options, 4)
    assert torch.equal(got.accum, want.accum) and not torch.equal(got.accum, graph.accum)
    assert progressive.graph_counts["captures"] == counts["captures"] + 1
    progressive.clear_graphs()


def test_graph_on_a_card_that_is_not_current(dev, cornell):
    """With cuda:0 current, render_steps on cuda:1 captures its graph on
    cuda:1: two replays of 4 samples ≡ 8 eager samples bit for bit, and a
    second camera through the same graph ≡ its eager render (a graph
    captured on another card's stream would hold nothing and replay the
    capture-time result)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    scene, camera = cornell
    other = torch.device("cuda", 1)
    torch.cuda.set_device(dev)
    options = RenderOptions(width=48, height=40, max_depth=3, accel="brute",
                            families=scene_families(scene))
    ds = upload_scene(scene, "brute", other)
    mt_brute.reset_launches()
    for cam in (camera, camera._replace(position=camera.position + np.float32(0.3))):
        eager = progressive.init_state(48, 40, 3, other)
        for _ in range(8):
            eager = progressive.render_step(ds, cam, eager, 48, 40, options)
        graph = progressive.init_state(48, 40, 3, other)
        for _ in range(2):
            graph = progressive.render_steps(ds, cam, graph, 48, 40, options, 4)
        assert torch.equal(graph.accum, eager.accum)
    assert mt_brute.launches["closest"] == mt_brute.launches["anyhit"] == 3 * (32 + 1)
    assert torch.cuda.current_device() == dev.index
    progressive.clear_graphs()


def _bvh(ds):
    """B4's tree arguments: the FlatBVH and scene (the twin's), the records
    and the tris9 slab (the kernel's)."""
    return (ds.node_bounds, ds.node_meta, ds.scene.vertices, ds.scene.tri_v, ds.bvh_pairs,
            ds.tris9)


def _bvh_case(case, dev, cornell):
    """(DeviceScene, o, d, active, t_max) of a B4 case: the cornell's rays
    from inside the box and axis-parallel rays with ±0 components in the
    planes of its walls (tests/test_torch_bvh_kernel.py's `_rays`), or
    every 4th of grid100k's 65,536 bench-camera primary rays."""
    name, accel = case
    if name == "cornell":
        ds = upload_scene(cornell[0], accel, dev)
        o, d, active, t_max = _rays(dev, 20_000, 0.1, 5.4, 21)
        ao, ad, aa, at = (torch.as_tensor(x, device=dev) for x in axis_parallel_rays(ds, 3001, 5))
        return (ds, torch.cat([o, ao]).contiguous(), torch.cat([d, ad]).contiguous(),
                torch.cat([active, aa]).contiguous(), torch.cat([t_max, at]).contiguous())
    scene, camera = bench_scene("grid100k")
    ds = upload_scene(scene, accel, dev)
    uni = sampling.pixel_uniforms(sampling.sample_key(sampling.prng_key(0), 0),
                                  torch.arange(256 * 256, dtype=torch.int32, device=dev), 4)
    o, d = (x[::4].contiguous() for x in generate_rays(camera, 256, 256, uni))
    n = o.shape[0]
    t_max = torch.tensor(np.random.default_rng(22).uniform(0, 20, n), dtype=torch.float32,
                         device=dev)
    return ds, o, d, torch.ones(n, dtype=torch.bool, device=dev), t_max


@pytest.mark.parametrize("case,max_leaf", [(("cornell", "bvh2"), 4), (("cornell", "sbvh"), 2),
                                           (("grid100k", "bvh2"), 4)])
def test_bvh_kernel_matches_twin(case, max_leaf, dev, cornell):
    """B4 ≡ its twin bit for bit (t, tri, u, v, occlusion), at the build's
    leaf width and below it; its stats variant, as the timed walk and as
    the oracle walk seeded with the closest t, returns the same answers,
    and its counts hold together."""
    ds, o, d, active, t_max = _bvh_case(case, dev, cornell)
    kw = {"max_leaf": max_leaf, "max_stack": required_stack(ds)}
    traverse_bvh.reset_launches()
    got = traverse_bvh.traverse_closest(o, d, active, *_bvh(ds), **kw)
    want = traverse_bvh.traverse_closest_plain(o, d, active, *_bvh(ds)[:4], **kw)
    occ = traverse_bvh.traverse_anyhit(o, d, t_max, active, *_bvh(ds), **kw)
    occ_t = traverse_bvh.traverse_anyhit_plain(o, d, t_max, active, *_bvh(ds)[:4], **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(occ, occ_t)
    assert int((want[1] >= 0).sum()) > 0 and int(occ_t.sum()) > 0
    assert traverse_bvh.launches == {"closest": 1, "anyhit": 1, "closest_twin": 1,
                                     "anyhit_twin": 1}
    rows = {"meta_seen": ds.node_meta.shape[0], "bounds_seen": ds.node_meta.shape[0],
            "tri_seen": ds.scene.tri_v.shape[0], "vert_seen": ds.scene.vertices.shape[0]}
    for seed in (None, got[0]):
        *stat_out, st = traverse_bvh.traverse_closest(o, d, active, *_bvh(ds), **kw, stats=True,
                                                      t_seed=seed)
        occs, sta = traverse_bvh.traverse_anyhit(o, d, t_max, active, *_bvh(ds), **kw,
                                                 stats=True, t_seed=seed)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(stat_out, got)) and torch.equal(occs, occ)
        for s in (st, sta):
            inner, tris, stack = s["counts"].long().unbind(1)
            assert s["counts"].shape == (o.shape[0], len(traverse_bvh.STATS))
            assert int(stack.max()) <= kw["max_stack"] and bool((stack <= inner).all())
            for k, n_rows in rows.items():
                assert s[k].shape == (n_rows,) and int(s[k].sum()) <= n_rows
            # The root's meta is read, never its bounds; every node stood on
            # past the root was slab-tested first; the triangles tested read
            # at most three vertices each.
            assert int(s["meta_seen"][0]) == 1 and int(s["bounds_seen"][0]) == 0
            assert bool((s["meta_seen"][1:] <= s["bounds_seen"][1:]).all())
            assert 0 < int(s["vert_seen"].sum()) <= 3 * int(s["tri_seen"].sum())
        assert bool((st["counts"][got[1] >= 0, 1] > 0).all())  # a hit was tested
    assert traverse_bvh.stats_launches == {"closest": 2, "anyhit": 2}



# ---------------------------------------------------------------------------
# B5, the threefry sampler (ops/threefry.py)
# ---------------------------------------------------------------------------

# (pixel ids, max_depth) of the bit-equality sets: frames at a small size, a
# tile of a 40x40 frame in 4x4 tiles, the padded tile-major order of the
# sharded render (padding clamped to pixel 0), int32 ids at the edges of
# their range, depth 0 and 8.
B5_SETS = ["frame 48x48 depth 3", "frame 32x32 depth 4", "tile", "padded", "edge ids",
           "depth 0", "depth 8"]


def _b5_ids(name, dev):
    from caitlynrenderer_tpu_torch.parallel.render import tile_pixel_order

    if name == "tile":
        yy, xx = torch.meshgrid(torch.arange(10, dtype=torch.int32, device=dev),
                                torch.arange(10, dtype=torch.int32, device=dev), indexing="ij")
        return (10 + yy.reshape(-1)) * 40 + (20 + xx.reshape(-1)), 3
    if name == "padded":
        order, _ = tile_pixel_order(45, 31, 2, 2, 28)
        return torch.clamp(torch.tensor(order, device=dev), min=0), 3
    if name == "edge ids":
        return torch.tensor([0, 2**31 - 1, -(2**31), -1, 7], dtype=torch.int32, device=dev), 3
    size, depth = {"frame 48x48 depth 3": (48, 3), "frame 32x32 depth 4": (32, 4),
                   "depth 0": (40, 0), "depth 8": (40, 8)}[name]
    return torch.arange(size * size, dtype=torch.int32, device=dev), depth


@pytest.mark.parametrize("name", B5_SETS)
def test_threefry_kernel_equals_twin(name, dev):
    """B5's pixel kernel ≡ the twin bit for bit (compared as int32 bits),
    under int keys and under 0-d tensor views on the card (the graph's
    key form) at frames 0, 1, 2**31 - 1 and 2**32 - 1; the two key forms
    agree; the kernel launches once a call and the twin counter stays."""
    from caitlynrenderer_tpu_torch.ops import threefry
    from caitlynrenderer_tpu_torch.render import sampling

    ids, depth = _b5_ids(name, dev)
    base = sampling.prng_key(7)
    frames = torch.tensor([0, 1, 2**31 - 1, 2**32 - 1], dtype=torch.int64, device=dev)
    keys = sampling.sample_key(tuple(torch.tensor(w, dtype=torch.int64, device=dev)
                                     for w in base), frames)
    threefry.reset_launches()
    for i, frame in enumerate((0, 1, 2**31 - 1, 2**32 - 1)):
        want = sampling.pixel_uniforms_plain(sampling.sample_key(base, frame), ids, depth)
        by_int = sampling.pixel_uniforms(sampling.sample_key(base, frame), ids, depth)
        by_view = sampling.pixel_uniforms((keys[0][i], keys[1][i]), ids, depth)
        torch.cuda.synchronize()
        assert torch.equal(by_int.view(torch.int32), want.view(torch.int32))
        assert torch.equal(by_view.view(torch.int32), by_int.view(torch.int32))
    assert threefry.launches == {"pixel": 8, "lane": 0, "pixel_twin": 0, "lane_twin": 0}


@pytest.mark.parametrize("rows,depth", [(64 * 64, 3), (37, 1), (2049, 8)])
def test_threefry_lane_kernel_equals_twin(rows, depth, dev):
    """B5's lane kernel ≡ draw_uniforms' twin bit for bit, also where the
    last block is not full; a tensor key is refused, not launched."""
    from caitlynrenderer_tpu_torch.ops import threefry
    from caitlynrenderer_tpu_torch.render import sampling

    key = sampling.sample_key(sampling.prng_key(3), 5)
    tkey = tuple(torch.tensor(w, dtype=torch.int64, device=dev) for w in key)
    threefry.reset_launches()
    want = sampling.draw_uniforms_plain(key, rows, depth, dev)
    got = sampling.draw_uniforms(key, rows, depth, dev)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(TypeError, match="takes the key's words as ints"):
        sampling.draw_uniforms(tkey, rows, depth, dev)
    assert threefry.launches == {"pixel": 0, "lane": 1, "pixel_twin": 0, "lane_twin": 0}


@pytest.mark.parametrize("accel", ["brute", "wide"])
def test_graph_of_16_samples_through_b5_equals_eager(accel, dev, cornell):
    """One replay of a 16-sample graph ≡ 16 eager render_step calls bit for
    bit through B5 and B1 or B2: the graph holds 16 pixel-kernel nodes,
    the capture adds its warm-up sample's launch, and no twin runs."""
    from caitlynrenderer_tpu_torch.ops import threefry

    scene, camera = cornell
    options = RenderOptions(width=40, height=32, max_depth=3, accel=accel,
                            families=scene_families(scene))
    ds = upload_scene(scene, accel, dev)
    w, h = options.width, options.height
    progressive.clear_graphs()
    threefry.reset_launches()
    eager = progressive.init_state(w, h, 3, dev)
    for _ in range(16):
        eager = progressive.render_step(ds, camera, eager, w, h, options)
    assert threefry.launches["pixel"] == 16
    graph = progressive.render_steps(ds, camera, progressive.init_state(w, h, 3, dev), w, h,
                                     options, 16)
    torch.cuda.synchronize()
    assert torch.equal(graph.accum, eager.accum)
    (sample_graph,) = progressive._graphs.values()
    assert sample_graph.launches["threefry"] == {"pixel": 16, "lane": 0, "pixel_twin": 0,
                                                 "lane_twin": 0}
    assert threefry.launches == {"pixel": 16 + 16 + 1, "lane": 0, "pixel_twin": 0,
                                 "lane_twin": 0}
    progressive.clear_graphs()


def test_threefry_kernel_rejects_bad_inputs(dev):
    from caitlynrenderer_tpu_torch.ops import threefry

    ids = torch.arange(64, dtype=torch.int32, device=dev)
    threefry.reset_launches()
    with pytest.raises(TypeError, match="pixel_ids has dtype"):
        threefry.threefry_pixel((1, 2), ids.float(), 11)
    with pytest.raises(ValueError, match="must be contiguous"):
        threefry.threefry_pixel((1, 2), ids[::2], 11)
    with pytest.raises(TypeError, match=r"key\[0\] has dtype"):
        threefry.threefry_pixel((torch.tensor(1, dtype=torch.int32, device=dev), 2), ids, 11)
    with pytest.raises(ValueError, match=r"key\[1\] is on cpu"):
        threefry.threefry_pixel((1, torch.tensor(2, dtype=torch.int64)), ids, 11)
    with pytest.raises(ValueError, match="n_u must be at least"):
        threefry.threefry_lane((1, 2), 8, 3, dev)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        threefry.threefry_pixel((1, 2), ids.cpu(), 11)
    with pytest.raises(TypeError, match="pixel_ids has dtype torch.int64"):
        threefry.threefry_pixel((1, 2), ids.long(), 11)
    with pytest.raises(TypeError, match="takes the key's words as ints"):
        threefry.threefry_lane((torch.tensor(1, dtype=torch.int64, device=dev), 2), 8, 11, dev)
    assert all(v == 0 for v in threefry.launches.values())
