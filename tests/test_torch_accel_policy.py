"""The accelerator policy on the paths that resolve accel "auto": a scene of
more than 2048 triangles goes to the binary BVH ("bvh2", kernel B4 on the
card), and the caller sizes B4's stack from the build.

CPU: `cli.render_setup` resolves "auto" to "bvh2" on a grid of 3,044
triangles, and `cli._upload` sizes `max_stack` from the uploaded tree,
over a config's too small one, which the integrator would refuse.  Card
(marked `cuda`, skips inside its fixture without one; `python -m pytest
tests/ -m cuda -q` on an NVIDIA card): a CUDA-graph replay of the grid under "auto" launches B4 and never
B2, and its accumulation equals the same render under an explicit "bvh2"
bit for bit.  Imports nothing of the JAX package."""

import os
from types import SimpleNamespace

import pytest
import torch

from caitlynrenderer_tpu_torch import cli
from caitlynrenderer_tpu_torch.ops import mt_brute, traverse_bvh, traverse_cw8, traverse_mega
from caitlynrenderer_tpu_torch.render import integrator, progressive
from caitlynrenderer_tpu_torch.scene import BRUTE_MAX_TRIS, required_stack, upload_scene
from caitlynrenderer_tpu_torch.utils import config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_STACK = 4  # below the grid's tree depth


def _grid_toml(tmp_path, **render):
    """A config of the 40x40-vertex grid (3,044 triangles) under accel
    "auto", with the [render] values `render`; returns its path."""
    lines = ['[scene]', 'builtin = "grid"', 'resolution = 40', '', '[camera]',
             'position = [5.0, 9.0, 11.0]', 'look_at = [5.0, 2.0, 5.0]', 'fov = 50.0', '',
             '[render]', 'accel = "auto"']
    lines += [f"{k} = {v}" for k, v in render.items()]
    path = tmp_path / "grid.toml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_upload_sizes_the_stack_from_the_tree(tmp_path):
    toml = _grid_toml(tmp_path, max_stack=SMALL_STACK, max_depth=1, width=8, height=8)
    scene, _, unsized = cli.render_setup(config.load_config(toml), str(tmp_path))
    assert scene.num_triangles == 3044 > BRUTE_MAX_TRIS
    assert unsized.accel == "bvh2" and unsized.max_stack == SMALL_STACK
    _, ds, _, options = cli._upload(SimpleNamespace(config=toml, device="cpu"))
    assert ds.accel == "bvh2" and ds.tree_depth + 1 > SMALL_STACK
    assert options.max_stack == required_stack(ds) == max(32, ds.tree_depth + 1)
    assert ds.bvh_pairs.shape[0] > 0 and ds.wb_mega.numel() == 0
    n = options.width * options.height
    o = torch.zeros((n, 3)) + torch.tensor([5.0, 9.0, 11.0])
    d = torch.nn.functional.normalize(torch.tensor([5.0, 2.0, 5.0]) - o, dim=1)
    uni = torch.rand((n, 11), generator=torch.Generator().manual_seed(3))
    traverse_bvh.reset_launches()
    integrator.trace_paths(ds, o, d, uni, options)
    assert traverse_bvh.launches["closest_twin"] == 1
    with pytest.raises(ValueError, match="max_stack"):
        integrator.trace_paths(ds, o, d, uni, unsized)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _graph_render(dev, toml, accel, spp=4, replays=2, seed=5):
    """The grid of `toml` at 64x48 under `accel`, through render_setup, the
    upload and the stack sizing `cli._upload` does, then `replays` replays
    of one CUDA graph of `spp` samples; returns (accum, options, graph)."""
    progressive.clear_graphs()
    scene, camera, options = cli.render_setup(config.load_config(toml), ROOT, width=64,
                                              height=48, accel=accel)
    ds = upload_scene(scene, options.accel, dev, max_leaf=options.max_leaf)
    options = options._replace(max_stack=required_stack(ds))
    w, h = options.width, options.height
    state = progressive.init_state(w, h, seed, dev)
    for _ in range(replays):
        state = progressive.render_steps(ds, camera, state, w, h, options, spp)
    graph, = progressive._graphs.values()
    return state.accum.clone(), options, graph


@pytest.mark.cuda
def test_auto_graph_replays_b4_and_equals_bvh2(dev, tmp_path):
    toml = _grid_toml(tmp_path, max_depth=2)
    mods = (mt_brute, traverse_bvh, traverse_cw8, traverse_mega)
    for m in mods:
        m.reset_launches()
    auto, options, graph = _graph_render(dev, toml, "auto")
    assert options.accel == "bvh2"
    runs = traverse_bvh.launches
    # the capture's warm-up sample and two replays of four, each sample
    # one closest-hit and one any-hit query a bounce
    assert runs["closest"] == runs["anyhit"] == options.max_depth * (1 + 2 * 4)
    assert runs["closest_twin"] == runs["anyhit_twin"] == 0
    assert all(v == 0 for m in mods if m is not traverse_bvh for v in m.launches.values())
    # the graph's own kernel nodes: B4's two queries a bounce, no B2 node
    per_replay = options.max_depth * 4
    assert graph.launches["traverse_bvh"] == {"closest": per_replay, "anyhit": per_replay,
                                              "closest_twin": 0, "anyhit_twin": 0}
    assert not any(graph.launches["traverse_mega"].values())
    names = [name for _, name, _ in graph.phases]
    assert any("bvh2_kernel" in n for n in names) and not any("mega_kernel" in n for n in names)
    explicit, _, _ = _graph_render(dev, toml, "bvh2")
    assert torch.equal(auto, explicit)
    assert float(auto.abs().sum()) > 0
    progressive.clear_graphs()
