"""CUDA tier: the hand-written mt_brute kernel against its plain PyTorch
twin on the card, and the golden render through the kernel.

Marked `cuda`; every test skips (inside the fixture, never at import)
when torch sees no CUDA device.  Run on an NVIDIA card with
`python -m pytest tests/ -m cuda -q`.  The first test builds
csrc/mt_brute.cu with nvcc (a few seconds).  Tolerance: tri and occlusion
equal on every ray, t/u/v within 1e-6 relative (kernel and twin evaluate
the same float32 expressions, neither contracts into FMAs).
"""

import os

import numpy as np
import pytest
import torch

from caitlynrenderer_tpu.core.types import RenderOptions
from caitlynrenderer_tpu.io.builtin_scenes import random_triangle_soup
from caitlynrenderer_tpu.utils import config
from caitlynrenderer_tpu_torch.core import math as cm
from caitlynrenderer_tpu_torch.ops import mt_brute
from caitlynrenderer_tpu_torch.ops.intersect import pack_tris
from caitlynrenderer_tpu_torch.render import progressive
from caitlynrenderer_tpu_torch.scene import scene_families, upload_scene

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
    img, _ = progressive.render_image(upload_scene(scene, "brute", dev), camera, options,
                                      spp=48, seed=0)
    img = img.cpu().numpy()
    assert mt_brute.launches["closest"] == 48 * 3 and mt_brute.launches["anyhit"] == 48 * 3
    assert mt_brute.launches["closest_twin"] == 0 and mt_brute.launches["anyhit_twin"] == 0
    err = np.abs(img - np.load(GOLDEN)["img"])
    assert err.mean() < 2e-3, err.mean()
    assert err.max() < 0.06, err.max()
    assert img[32, 4, 0] > img[32, 4, 1] and img[32, 60, 1] > img[32, 60, 0]
