"""The port's copies of the reference's numpy-only host layer ≡ the
originals: every builder and loader gives byte-equal arrays (np.array_equal
and the same dtype on every field).  Also: no module of the port, nor
chip_smoke.py, imports jax or anything of the JAX package, checked both by
importing every module in a fresh interpreter and by scanning the sources.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

from caitlynrenderer_tpu.accel import bvh as j_bvh
from caitlynrenderer_tpu.accel import cwbvh as j_cwbvh
from caitlynrenderer_tpu.accel import native as j_native
from caitlynrenderer_tpu.accel import sbvh as j_sbvh
from caitlynrenderer_tpu.accel import wide as j_wide
from caitlynrenderer_tpu.core import types as j_types
from caitlynrenderer_tpu.io import builtin_scenes as j_scenes
from caitlynrenderer_tpu.io import image as j_image
from caitlynrenderer_tpu.io import obj as j_obj
from caitlynrenderer_tpu.utils import config as j_config
import caitlynrenderer_tpu_torch
from caitlynrenderer_tpu_torch.accel import bvh as t_bvh
from caitlynrenderer_tpu_torch.accel import cwbvh as t_cwbvh
from caitlynrenderer_tpu_torch.accel import native as t_native
from caitlynrenderer_tpu_torch.accel import sbvh as t_sbvh
from caitlynrenderer_tpu_torch.accel import wide as t_wide
from caitlynrenderer_tpu_torch.core import types as t_types
from caitlynrenderer_tpu_torch.io import builtin_scenes as t_scenes
from caitlynrenderer_tpu_torch.io import image as t_image
from caitlynrenderer_tpu_torch.io import obj as t_obj
from caitlynrenderer_tpu_torch.utils import config as t_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "caitlynrenderer_tpu_torch")
FORBIDDEN = ("jax", "caitlynrenderer_tpu")


def assert_same(a, b, where="value"):
    """Field by field: NamedTuples and sequences element-wise, arrays with
    np.array_equal and the same dtype, anything else with ==."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        assert a._fields == b._fields, where
        for k in a._fields:
            assert_same(getattr(a, k), getattr(b, k), f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: dtype {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{where}: shape {a.shape} != {b.shape}"
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


# Small scenes of each kind: cornell (36 triangles, the numpy builder), a
# soup and a displaced grid above the native builder's 1024-triangle switch.
SCENES = {
    "cornell": lambda m: m.cornell_box(),
    "soup": lambda m: m.random_triangle_soup(1500, seed=3),
    "grid": lambda m: m.displaced_grid(resolution=30),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_builtin_scenes_equal_reference(name):
    assert_same(SCENES[name](t_scenes), SCENES[name](j_scenes), name)


def test_cornell_variants_and_sky_equal_reference():
    for floor in (j_types.MaterialType.DISNEY, j_types.MaterialType.MIRROR):
        assert_same(t_scenes.cornell_box(floor_type=int(floor)),
                    j_scenes.cornell_box(floor_type=int(floor)), floor.name)
    assert_same(t_scenes.procedural_sky(), j_scenes.procedural_sky(), "sky")
    assert_same(t_scenes.procedural_sky(16, 32, sun_dir=(0.0, 1.0, 0.0)),
                j_scenes.procedural_sky(16, 32, sun_dir=(0.0, 1.0, 0.0)), "small sky")


def test_types_copy_matches_reference():
    for cls in ("Materials", "Lights", "SceneArrays", "Camera", "RenderOptions"):
        assert getattr(t_types, cls)._fields == getattr(j_types, cls)._fields, cls
    assert t_types.RenderOptions() == j_types.RenderOptions()
    assert {m.name: int(m) for m in t_types.MaterialType} == {
        m.name: int(m) for m in j_types.MaterialType}
    assert t_types.LAMBERT_TYPES == j_types.LAMBERT_TYPES
    args = (np.array([1.0, 2.0, 3.0], np.float32), np.array([0.5, 0.0, -1.0], np.float32))
    assert_same(t_types.make_camera(*args, fov_degrees=33.0, aperture=0.1),
                j_types.make_camera(*args, fov_degrees=33.0, aperture=0.1), "camera")


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_bvh_equals_reference(name, use_native):
    sc = SCENES[name](j_scenes)[0]
    if use_native:
        assert t_native.native_available() and j_native.native_available()
    got = t_bvh.build_bvh(sc.vertices, sc.tri_v, max_leaf=4, use_native=use_native)
    want = j_bvh.build_bvh(sc.vertices, sc.tri_v, max_leaf=4, use_native=use_native)
    assert_same(got, want, "bvh")
    assert t_bvh.tree_depth(got.node_meta) == j_bvh.tree_depth(want.node_meta)
    assert_same(t_bvh.reorder_scene(sc, got), j_bvh.reorder_scene(sc, want), "ordered")


def test_native_builder_builds_in_the_port_and_honours_the_opt_out():
    """The port's library is built from its own copy of the source into
    its own build directory; CAITLYN_NO_NATIVE=1 turns it off."""
    assert t_native.native_available()
    path = t_native._library_path()
    assert os.path.dirname(path) == os.path.join(PKG, "build") and os.path.exists(path)
    with open(t_native._SRC, "rb") as f, open(os.path.join(ROOT, "native", "bvh_builder.cpp"),
                                              "rb") as g:
        assert f.read() == g.read()
    code = ("from caitlynrenderer_tpu_torch.accel import native\n"
            "assert not native.native_available()\n")
    env = dict(os.environ, CAITLYN_NO_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_sbvh_equals_reference(name):
    sc = SCENES[name](j_scenes)[0]
    got = t_sbvh.build_sbvh(sc.vertices, sc.tri_v, max_leaf=4)
    want = j_sbvh.build_sbvh(sc.vertices, sc.tri_v, max_leaf=4)
    assert_same(got, want, "sbvh")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_wide_and_cwbvh_equal_reference(name):
    sc = SCENES[name](j_scenes)[0]
    bvh = j_bvh.build_bvh(sc.vertices, sc.tri_v, max_leaf=3)
    ordered = j_bvh.reorder_scene(sc, bvh)
    assert_same(t_wide._subtree_ranges(bvh), j_wide._subtree_ranges(bvh), "ranges")
    for gt in (2, 64, 512):
        assert_same(t_wide.build_wide(ordered.vertices, ordered.tri_v, bvh, group_tris=gt),
                    j_wide.build_wide(ordered.vertices, ordered.tri_v, bvh, group_tris=gt),
                    f"wide {gt}")
    assert_same(t_cwbvh.build_cwbvh(bvh, ordered.vertices, ordered.tri_v),
                j_cwbvh.build_cwbvh(bvh, ordered.vertices, ordered.tri_v), "cwbvh")


OBJ = """\
mtllib scene.mtl
v 0 0 0
v 2 0 0
v 2 2 0
v 0 2 0
v 0 0 -2
v 2 0 -2
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 1 0
usemtl white
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl glass
f -6//2 -5//2 -1//2
usemtl lamp
f 1 5 6
f 1/1 6/2 2/3
"""

MTL = """\
newmtl white
Kd 0.7 0.7 0.7
Ns 40
map_Kd tex.png
newmtl glass
type GLASS
Ni 1.5
Ks 0.9 0.9 0.9
newmtl lamp
Kd 0 0 0
Ke 10 9 8
"""


@pytest.mark.parametrize("translate", [True, False])
def test_load_obj_equals_reference(tmp_path, translate):
    (tmp_path / "scene.obj").write_text(OBJ)
    (tmp_path / "scene.mtl").write_text(MTL)
    rng = np.random.default_rng(0)
    j_image.save_png(str(tmp_path / "tex.png"), rng.random((8, 8, 3)))
    path = str(tmp_path / "scene.obj")
    got = t_obj.load_obj(path, tex_size=16, translate_to_origin=translate)
    want = j_obj.load_obj(path, tex_size=16, translate_to_origin=translate)
    assert want[0].num_triangles == 5 and len(want[0].textures) == 1
    assert_same(got, want, "obj")


def test_png_round_trip_equals_reference(tmp_path):
    img = np.random.default_rng(1).random((5, 7, 3)).astype(np.float32)
    t_image.save_png(str(tmp_path / "t.png"), img)
    j_image.save_png(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    assert_same(t_image.load_png(str(tmp_path / "t.png")),
                j_image.load_png(str(tmp_path / "j.png")), "png")


@pytest.mark.parametrize("toml", ["cornell.toml", "cornell_disney.toml"])
def test_config_equals_reference(toml):
    path = os.path.join(ROOT, "scenes", toml)
    cfg = t_config.load_config(path)
    assert cfg == j_config.load_config(path)
    base = os.path.dirname(path)
    got, want = t_config.scene_from_config(cfg, base), j_config.scene_from_config(cfg, base)
    assert_same(got, want, "scene")
    assert_same(t_config.camera_from_config(cfg, got[1]),
                j_config.camera_from_config(cfg, want[1]), "camera")
    assert tuple(t_config.options_from_config(cfg, width=32)) == tuple(
        j_config.options_from_config(cfg, width=32))


def test_config_builtins_equal_reference():
    for scene in ({"builtin": "grid", "resolution": 12}, {"builtin": "soup", "triangles": 300},
                  {"builtin": "cornell", "floor": "mirror", "env": "sky"}):
        cfg = {"scene": scene}
        assert_same(t_config.scene_from_config(cfg), j_config.scene_from_config(cfg), str(scene))


# --------------------------------------------------------------------------
# Import isolation
# --------------------------------------------------------------------------


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(caitlynrenderer_tpu_torch.__path__,
                                                        "caitlynrenderer_tpu_torch."))


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_modules_load_nothing_of_jax_or_the_jax_package():
    mods = _port_modules()
    assert "caitlynrenderer_tpu_torch.accel.native" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if any(k == f or k.startswith(f + '.') "
        f"for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, ROOT) for p in _sources()))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and _forbidden(a.value)]
    assert not bad, f"{path} imports {bad}"
