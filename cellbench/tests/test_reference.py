"""The plain reference and its frozen inputs: the scenes, the camera and
the sampler equal the program's own, the reference's BVH walk equals
brute force, and at a tiny size on the CPU the reference renders what
the program renders, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from caitlynrenderer_tpu_torch.core.types import make_camera
from caitlynrenderer_tpu_torch.io import builtin_scenes
from caitlynrenderer_tpu_torch.render import sampling

from cellbench import manifest, roofline, seeds
from cellbench.program import scene_arrays
from cellbench.reference import accel, sampler
from cellbench.scenes import builtin
from cellbench.tests.conftest import CELLS, SEED, run_on_cpu

BENCH = manifest.load()


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _same(x, y)
        elif x is None or y is None:
            assert x is None and y is None
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("spec,port", [
    ({"generator": "cornell_box"}, lambda: builtin_scenes.cornell_box()[0]),
    ({"generator": "displaced_grid", "args": {"resolution": 50}},
     lambda: builtin_scenes.displaced_grid(resolution=50)[0]),
    ({"generator": "displaced_grid", "args": {"resolution": 708}},
     lambda: builtin_scenes.displaced_grid(resolution=708)[0]),
], ids=["cornell", "grid50", "grid708"])
def test_frozen_scene_equals_the_programs(spec, port):
    _same(scene_arrays(builtin.make_scene(spec)), port())


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_frozen_camera_equals_the_programs(name):
    cam = manifest.config(BENCH, name)["camera"]
    mine = builtin.make_camera(**cam)
    theirs = make_camera(np.array(cam["position"], np.float32),
                         np.array(cam["look_at"], np.float32), cam["fov_degrees"])
    _same([mine[k] for k in builtin.CAMERA_FIELDS], theirs)


@pytest.mark.parametrize("image", [0, 3])
def test_sampler_equals_the_programs(image):
    key = sampler.base_key(seeds.image_seed(SEED, image))
    ids = torch.tensor([0, 1, 777, 489_999, 2**20 - 1], dtype=torch.int64)
    samples = torch.tensor([0, 5, 1023], dtype=torch.int64)
    got = sampler.uniforms(key, samples, ids, 6)
    for i, s in enumerate(samples.tolist()):
        want = sampling.pixel_uniforms_plain(sampling.sample_key(key, s), ids.to(torch.int32), 6)
        assert torch.equal(got[i], want)


def test_image_seeds_and_pixels_follow_the_seed():
    assert seeds.image_seed(SEED, 0) != seeds.image_seed(SEED, 1)
    assert seeds.image_seed(SEED, 0) == seeds.image_seed(SEED, 0)
    assert seeds.image_seed(-3, 0) != seeds.image_seed(3, 0)
    assert seeds.image_seed(2**40 + 1, 0) != seeds.image_seed(1, 0)
    px = seeds.check_pixels(SEED, 1000, 64)
    assert len(set(px.tolist())) == 64 and px.max() < 1000
    assert np.array_equal(px, seeds.check_pixels(SEED, 1000, 64))


def test_bvh_walk_equals_brute_force():
    sc = builtin.displaced_grid(resolution=50)
    bvh = accel.build(sc["vertices"], sc["tri_v"], "cpu")
    assert bvh.boxes is not None
    g = torch.Generator().manual_seed(3)
    n = 4096
    o = torch.rand((n, 3), generator=g) * torch.tensor([10.0, 6.0, 10.0])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    active = torch.rand(n, generator=g) < 0.9
    rows = bvh.tris9[bvh.tri_id >= 0]
    order = bvh.tri_id[bvh.tri_id >= 0]
    brute = accel.Geometry(rows[torch.argsort(order)], torch.arange(len(order)), None, 0)
    t_b, tri_b = accel.closest(brute, o, d, active)
    t_w, tri_w = accel.closest(bvh, o, d, active)
    assert torch.equal(t_b, t_w) and torch.equal(tri_b, tri_w)
    assert (tri_w >= 0).sum() > 1000
    t_max = torch.rand(n, generator=g) * 8.0
    occ_b = accel.occluded(brute, o, d, t_max, active)
    assert torch.equal(occ_b, accel.occluded(bvh, o, d, t_max, active))
    assert occ_b.any() and not occ_b.all()


@pytest.mark.parametrize("cell", CELLS)
def test_reference_renders_what_the_program_renders(tmp_path, cell):
    from cellbench.tests.conftest import tiny_bench

    result, _ = run_on_cpu(tiny_bench(tmp_path, image_spp=24), cell, seconds=0.2)
    assert result["correct"]
    assert result["checked"] and all(v["value"] == 0.0 for v in result["checked"].values())


def test_mt_bound_counts_the_needed_work():
    o = torch.tensor([[0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    tris9 = torch.tensor([[0, 0, 0, 1, 0, 0, 0, 1, 0],  # hit: reaches t
                          [0, 0, 0, 1, 0, 0, 2, 0, 0.0]])  # parallel to d: det = 0
    nbytes, ops = roofline.mt_bound(o, d, torch.tensor([True]), tris9)
    assert ops == 39 + 5 + 2 * 32 + 9
    assert nbytes == (24 + 1 + 16) + 2 * 36
    nbytes, ops = roofline.mt_bound(o, d, torch.tensor([True]), tris9, t_max=torch.tensor([5.0]))
    assert ops == 39 + 2 * 32 + 9  # any-hit stops at the first accepted triangle
    assert roofline.bound_ms(3.35e9, 0) == pytest.approx(1.0)
