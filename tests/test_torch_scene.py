"""Port's scene upload ≡ the reference's: the fused shading and light
tables bit for bit, the JAX-free copies of scene_families /
validate_scene / BRUTE_MAX_TRIS against the originals, and the port's own
auto_accel policy (brute force up to BRUTE_MAX_TRIS triangles, the binary
BVH above).  Also: the port never imports jax, and a CUDA device without a
card raises."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu import scene as j_scene
from caitlynrenderer_tpu.core.types import MaterialType
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box, random_triangle_soup
from caitlynrenderer_tpu.render import integrator as j_integrator
from caitlynrenderer_tpu_torch import scene as t_scene
from caitlynrenderer_tpu_torch.device import get_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    "cornell": lambda: cornell_box()[0],
    "disney_floor": lambda: cornell_box(floor_type=int(MaterialType.DISNEY))[0],
    "mirror_floor": lambda: cornell_box(floor_type=int(MaterialType.MIRROR))[0],
    "soup": lambda: random_triangle_soup(3000, seed=2)[0],
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shade_and_light_tables_equal_reference(name):
    sc = SCENES[name]()
    jsc = jax.tree_util.tree_map(jnp.asarray, sc)
    ds = t_scene.upload_scene(sc, "brute", "cpu")
    np.testing.assert_array_equal(
        ds.shade_tab.numpy(), np.asarray(j_integrator._build_shade_table(jsc)))
    np.testing.assert_array_equal(
        ds.light_tab.numpy(), np.asarray(j_integrator._build_light_table(jsc.lights)))
    assert ds.shade_tab.shape == (sc.num_triangles, 50)
    assert ds.tris9.shape == (sc.num_triangles, 9) and ds.tris9.is_contiguous()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_policy_copies_agree_with_reference(name):
    sc = SCENES[name]()
    assert t_scene.scene_families(sc) == j_scene.scene_families(sc)
    assert t_scene.BRUTE_MAX_TRIS == j_scene.BRUTE_MAX_TRIS
    small = sc.num_triangles <= t_scene.BRUTE_MAX_TRIS
    assert small == (name != "soup")
    assert t_scene.auto_accel(sc) == ("brute" if small else "bvh2")
    t_scene.validate_scene(sc)
    j_scene.validate_scene(sc)


def _broken(kind):
    sc, _ = cornell_box()
    if kind == "nan_vertex":
        v = sc.vertices.copy()
        v[3, 1] = np.nan
        return sc._replace(vertices=v)
    if kind == "vertex_index":
        tv = sc.tri_v.copy()
        tv[5, 0] = len(sc.vertices) + 2
        return sc._replace(tri_v=tv)
    if kind == "material_index":
        tv = sc.tri_v.copy()
        tv[0, 3] = -1
        return sc._replace(tri_v=tv)
    if kind == "tri_v_shape":
        return sc._replace(tri_v=sc.tri_v[:, :3])
    pdf = sc.lights.area_pdf.copy()  # "light_pdf"
    pdf[0, 1] = -1.0
    return sc._replace(lights=sc.lights._replace(area_pdf=pdf))


@pytest.mark.parametrize(
    "kind", ["nan_vertex", "vertex_index", "material_index", "tri_v_shape", "light_pdf"]
)
def test_validate_scene_copy_raises_like_reference(kind):
    sc = _broken(kind)
    with pytest.raises(ValueError) as ref:
        j_scene.validate_scene(sc)
    with pytest.raises(ValueError) as got:
        t_scene.upload_scene(sc, "brute", "cpu")
    assert str(got.value) == str(ref.value)


def test_unported_and_unknown_accels_raise():
    """Every accelerator of the reference uploads (none is left unported);
    an unknown one raises as in the reference."""
    sc, _ = cornell_box()
    for accel in ("brute", "bvh2", "sbvh", "wide", "cwbvh"):
        ds = t_scene.upload_scene(sc, accel, "cpu")
        assert ds.accel == accel and ds.shade_tab.shape == (sc.num_triangles, 50)
    assert t_scene.ACCELS == ("brute", "bvh2", "sbvh", "wide", "cwbvh")
    with pytest.raises(ValueError) as got:
        t_scene.upload_scene(sc, "octree", "cpu")
    with pytest.raises(ValueError):
        j_scene.upload_scene(sc, accel="octree")
    assert "octree" in str(got.value)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        assert get_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import caitlynrenderer_tpu_torch.cli, caitlynrenderer_tpu_torch.bench\n"
        "import caitlynrenderer_tpu_torch.convert, caitlynrenderer_tpu_torch.render.progressive\n"
        "import caitlynrenderer_tpu_torch.ops.traverse_mega, caitlynrenderer_tpu_torch.ops.traverse_cw8\n"
        "import caitlynrenderer_tpu_torch.ops.traverse_bvh\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
