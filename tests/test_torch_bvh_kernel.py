"""Kernel B4's wrapper (ops/traverse_bvh.py) on the CPU: what runs here
without a card.

  * CPU tensors go to the plain twins, counted as twin calls, never as
    kernel launches;
  * the wrapper's checks raise on a wrong dtype, a wrong shape, a
    non-contiguous input, a stack deeper than the kernel takes and a mix of
    CPU and CUDA tensors, before anything launches (the inputs are CPU
    tensors that say they lie on cuda:0);
  * the twin ≡ the reference's XLA walk (caitlynrenderer_tpu/ops/
    traverse_xla.py) where the kernel has to take care: axis-parallel rays
    with ±0 direction components (d_inv = ±inf, and NaN in the slab test
    where a box face passes through the origin), and `max_leaf` below the
    build's leaf width (the leaf's tail stays untested).  tri and occlusion
    equal on every ray; t within 1e-6 relative, u and v (in [0, 1]) within
    1e-6 relative or absolute: XLA on the CPU may contract a multiply-add
    that the port rounds twice, which moves a barycentric near 0 by ~1e-7;
  * `_build.count_kernels` counts B4's mangled names under "traverse_bvh"
    and no other kernel's;
  * the ctypes mirror of the kernel's Stats struct names its fields in the
    source's order, and each entry point takes as many arguments as
    `_SIGNATURES` gives it;
  * the integrator refuses, on the card, a tree deeper than the kernel's
    stack (MAX_STACK) before anything launches, and takes it on the CPU;
  * `upload_scene(..., bvh=tree)` with the tree its own build makes equals
    the plain upload, and refuses a tree of another scene;
  * v2's child-pair records (`pack_bvh_pairs`) on the bvh2 and sbvh trees
    of a small grid, the cornell's and a one-leaf tree: each inner node's
    record holds its children's bounds and meta bit for bit; a tree whose
    children do not start at an odd id after their parent raises, in the
    packer and at upload;
  * a numpy walk over the records and the tris9 slab alone, in v2's order
    (a stack of (left, count)), returns the twin's (t, tri, u, v) and
    occlusion bit for bit on primary and bounce rays.
The kernel itself runs on the card: tests/test_torch_cuda.py and
chip_smoke.py phase 21 hold it to the twin bit for bit.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu import scene as j_scene
from caitlynrenderer_tpu.io.builtin_scenes import cornell_box
from caitlynrenderer_tpu.ops import traverse_xla as j_xla
from caitlynrenderer_tpu_torch import scene as t_scene
# Every kernel module registers its launch counter on import.
from caitlynrenderer_tpu_torch.ops import (  # noqa: F401
    _build, mt_brute, traverse_bvh, traverse_cw8, traverse_mega)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = {}


def _uploads(accel):
    """(reference DeviceScene, port DeviceScene) of the cornell box, built
    once with the default leaf width of 4."""
    if accel not in _CACHE:
        sc = cornell_box()[0]
        _CACHE[accel] = (j_scene.upload_scene(sc, accel=accel),
                         t_scene.upload_scene(sc, accel, "cpu"))
    return _CACHE[accel]


def _tree(ds):
    """The FlatBVH and the leaf-ordered scene: the twins' tree arguments
    (both packages')."""
    return ds.node_bounds, ds.node_meta, ds.scene.vertices, ds.scene.tri_v


def _wrapper_tree(ds):
    """The wrapper's: the twin's, then the records and the tris9 slab that
    the kernel reads."""
    return _tree(ds) + (ds.bvh_pairs, ds.tris9)


def _rays(ds, n, seed):
    """(o, d, active, t_max) as numpy: rays at random points inside the
    scene's triangles (barycentrics each in [0.1, 0.45], off every edge),
    from 0.5-3 units off; a third axis-parallel, with the origin on the
    target's two other coordinates (so the ray runs in the planes of the
    cornell's axis-aligned walls and boxes) and ±0 in the zero components;
    a tenth inactive."""
    rng = np.random.default_rng(seed)
    verts = ds.scene.vertices.cpu().numpy()
    tv = ds.scene.tri_v.cpu().numpy()
    k = rng.integers(0, tv.shape[0], n)
    b1, b2 = rng.uniform(0.1, 0.45, n), rng.uniform(0.1, 0.45, n)
    v0, v1, v2 = (verts[tv[k, j]] for j in range(3))
    target = v0 + b1[:, None] * (v1 - v0) + b2[:, None] * (v2 - v0)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    axis = rng.random(n) < 1 / 3
    ax = rng.integers(0, 3, n)
    sign = rng.choice(np.array([-1.0, 1.0], np.float32), n)
    zero = np.where(rng.random((n, 3)) < 0.5, np.float32(-0.0), np.float32(0.0))
    unit = np.where(np.arange(3)[None, :] == ax[:, None], sign[:, None], zero)
    d = np.where(axis[:, None], unit, d / np.linalg.norm(d, axis=1, keepdims=True))
    o = (target - d * rng.uniform(0.5, 3.0, n)[:, None]).astype(np.float32)
    o = np.where(axis[:, None] & (np.arange(3)[None, :] != ax[:, None]), target, o)
    active = rng.random(n) < 0.9
    t_max = rng.uniform(0.2, 4.0, n).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), active, t_max


def _cpu_query(n=64):
    _, tds = _uploads("bvh2")
    o, d, active, t_max = (torch.from_numpy(x) for x in _rays(tds, n, 1))
    return o, d, active, t_max, _wrapper_tree(tds)


@pytest.mark.parametrize("query", ["closest", "anyhit"])
def test_cpu_tensors_run_the_twin(query):
    """The wrapper on CPU tensors is the twin: the same answers, one twin
    call counted, no kernel launch."""
    o, d, active, t_max, tree = _cpu_query()
    traverse_bvh.reset_launches()
    if query == "closest":
        got = traverse_bvh.traverse_closest(o, d, active, *tree)
        want = traverse_bvh.traverse_closest_plain(o, d, active, *tree[:4])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert int((got[1] >= 0).sum()) > 0
    else:
        got = traverse_bvh.traverse_anyhit(o, d, t_max, active, *tree)
        assert torch.equal(got, traverse_bvh.traverse_anyhit_plain(o, d, t_max, active,
                                                                   *tree[:4]))
        assert int(got.sum()) > 0
    assert traverse_bvh.launches == {query: 0, f"{query}_twin": 2,
                                     **{k: 0 for k in traverse_bvh.launches
                                        if not k.startswith(query)}}
    with pytest.raises(ValueError, match="CUDA"):  # the stats variant is the kernel's
        traverse_bvh.traverse_closest(o, d, active, *tree, stats=True)
    with pytest.raises(ValueError, match="stats=True"):
        traverse_bvh.traverse_closest(o, d, active, *tree, t_seed=o[:, 0].contiguous())


class _SaysCuda(torch.Tensor):
    """A CPU tensor whose `device` says cuda:0: the wrapper's checks run
    on it as on a card's tensor, and raise before any launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(x):
    return x.as_subclass(_SaysCuda)


def _bad(case, o, d, active, t_max, tree):
    """The closest (or, for t_max, any-hit) query of `case`'s bad input."""
    bounds, meta, verts, tri_v, pairs, tris9 = tree
    q = {"o": o, "d": d, "active": active, "bounds": bounds, "meta": meta, "verts": verts,
         "tri_v": tri_v, "pairs": pairs, "tris9": tris9, "t_max": t_max, "max_stack": 32}
    if case == "dtype":
        q["meta"] = meta.long()
    elif case == "shape":
        q["bounds"] = bounds[:, :5].contiguous()
    elif case == "pairs shape":
        q["pairs"] = pairs[:-1]
    elif case == "tris9 dtype":
        q["tris9"] = tris9.double()
    elif case == "non-contiguous":
        q["d"] = d.t().contiguous().t()
    elif case == "t_max shape":
        q["t_max"] = t_max[:10]
    elif case == "stack":
        q["max_stack"] = traverse_bvh.MAX_STACK + 1
    q = {k: _cuda(v) if isinstance(v, torch.Tensor) else v for k, v in q.items()}
    if case == "mix":
        q["verts"] = verts  # a plain CPU tensor among the card's
    tree = tuple(q[k] for k in ("bounds", "meta", "verts", "tri_v", "pairs", "tris9"))
    if case == "t_max shape":
        return lambda: traverse_bvh.traverse_anyhit(q["o"], q["d"], q["t_max"], q["active"],
                                                    *tree, max_stack=q["max_stack"])
    return lambda: traverse_bvh.traverse_closest(q["o"], q["d"], q["active"], *tree,
                                                 max_stack=q["max_stack"])


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "node_meta has dtype"),
    ("shape", ValueError, "node_bounds has shape"),
    ("pairs shape", ValueError, "pairs has shape"),
    ("tris9 dtype", TypeError, "tris9 has dtype"),
    ("non-contiguous", ValueError, "d must be contiguous"),
    ("t_max shape", ValueError, "t_max has shape"),
    ("stack", ValueError, "max_stack"),
    ("mix", ValueError, "must all be on the CPU or all on CUDA"),
])
def test_wrapper_rejects_bad_inputs(case, error, match):
    query = _cpu_query(32)
    traverse_bvh.reset_launches()
    with pytest.raises(error, match=match):
        _bad(case, *query)()
    assert all(v == 0 for v in traverse_bvh.launches.values())


@pytest.mark.parametrize("accel,max_leaf", [("bvh2", 4), ("sbvh", 4), ("bvh2", 1),
                                            ("sbvh", 2)])
def test_twin_equals_reference_on_axis_parallel_rays(accel, max_leaf):
    """The twin against the reference's XLA walk on the same numpy rays
    (`_rays`: a third axis-parallel with ±0 components, in the planes of
    the box faces) at the build's leaf width 4 and below it."""
    jds, tds = _uploads(accel)
    assert int(tds.node_meta[:, 1].max()) > max_leaf or max_leaf == 4
    o, d, active, t_max = _rays(tds, 600, 7 + max_leaf)
    kw = {"max_leaf": max_leaf, "max_stack": t_scene.required_stack(tds)}
    tj, trj, uj, vj = (np.asarray(x) for x in j_xla.traverse_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), *_tree(jds), **kw))
    occ_j = np.asarray(j_xla.traverse_anyhit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                                             jnp.asarray(active), *_tree(jds), **kw))
    args = [torch.from_numpy(x) for x in (o, d, active)]
    tt, trt, ut, vt = (x.numpy() for x in traverse_bvh.traverse_closest_plain(
        *args, *_tree(tds), **kw))
    occ_t = traverse_bvh.traverse_anyhit_plain(args[0], args[1], torch.from_numpy(t_max),
                                               args[2], *_tree(tds), **kw).numpy()
    np.testing.assert_array_equal(trt, trj)
    np.testing.assert_array_equal(occ_t, occ_j)
    np.testing.assert_allclose(tt, tj, rtol=1e-6, atol=0)
    for a, b in ((ut, uj), (vt, vj)):  # in [0, 1]: 1e-6 of that range as well
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    hit = trt >= 0
    axis = (d == 0).sum(axis=1) == 2
    assert hit[axis & active].mean() > 0.2 and not hit[~active].any()
    assert occ_t.mean() > 0.2 and not occ_t[~active].any()
    # Rays whose origin lies on a box face (0 * inf = NaN in the slab).
    assert (axis & ((o == tds.node_bounds.numpy()[:, None, :3]) |
                    (o == tds.node_bounds.numpy()[:, None, 3:])).any(axis=(0, 2))).any()


def test_count_kernels_counts_b4_only_under_its_module():
    """B4's template instances (query, stats, stack depth) count under
    traverse_bvh's keys; the other kernels' names count nowhere there, and
    B4's nowhere else."""
    b4 = (["_ZN12_GLOBAL__N_111bvh2_kernelILb0ELb0ELi32EEEvNS_5QueryENS_4TreeE5Stats"] * 3
          + ["_ZN12_GLOBAL__N_111bvh2_kernelILb1ELb0ELi64EEEvNS_5QueryENS_4TreeE5Stats"] * 2
          + ["_ZN12_GLOBAL__N_111bvh2_kernelILb0ELb1ELi32EEEvNS_5QueryENS_4TreeE5Stats"])
    others = (["_ZN12_GLOBAL__N_115mt_brute_kernelILb0ELi4EEEvPKfS2_PKbS2_fiiPfPiS6_S6_"] * 4
              + ["_ZN12_GLOBAL__N_111mega_kernelILb1ELb0EEEvPKfS2_PKbS2_"] * 5
              + ["_ZN12_GLOBAL__N_110cw8_kernelILb0ELb0ELi16EEEvPKf"] * 6
              + ["_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_15CUDAFunctor_addIfEE"])
    zero = {"closest_twin": 0, "anyhit_twin": 0}
    got = _build.count_kernels(b4 + others)
    assert got["traverse_bvh"] == {"closest": 4, "anyhit": 2, **zero}
    assert got["mt_brute"]["closest"] == 4 and got["traverse_mega"]["anyhit"] == 5
    assert got["traverse_cw8"]["closest"] == 6
    mine = _build.count_kernels(b4)
    assert all(v == 0 for m, row in mine.items() if m != "traverse_bvh" for v in row.values())
    assert all(v == 0 for v in _build.count_kernels(others)["traverse_bvh"].values())


def test_stats_struct_and_signatures_match_the_source():
    """ctypes cannot see the kernel's prototypes: the Stats mirror and the
    argument counts are held to csrc/traverse_bvh.cu's text."""
    with open(os.path.join(ROOT, traverse_bvh.SOURCE)) as f:
        src = f.read()
    body = re.search(r"struct Stats \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\*\s*(\w+);", body)
    assert fields == [k for k, _ in traverse_bvh._Stats._fields_]
    assert set(traverse_bvh.SEEN) < set(fields)
    for fn in ("bvh_closest", "bvh_anyhit"):
        proto = re.search(r'extern "C" int ' + fn + r"\((.*?)\)", src, re.S).group(1)
        assert len(proto.split(",")) == len(traverse_bvh._SIGNATURES[fn][1]), fn
        assert "const Stats* stats" in proto


@pytest.mark.parametrize("device,raises", [("cuda", True), ("cpu", False)])
def test_integrator_refuses_a_tree_deeper_than_the_kernel_on_the_card(device, raises):
    """A tree of depth MAX_STACK needs MAX_STACK + 1 stack entries: on the
    card (a stand-in scene whose node_meta says cuda:0) the dispatch raises
    with the limit in its message and launches nothing; on the CPU the twin
    takes any depth the options size."""
    from caitlynrenderer_tpu_torch.core.types import RenderOptions
    from caitlynrenderer_tpu_torch.render import integrator

    _, tds = _uploads("bvh2")
    deep = traverse_bvh.MAX_STACK
    meta = _cuda(tds.node_meta) if device == "cuda" else tds.node_meta
    ds = tds._replace(node_meta=meta, tree_depth=deep)
    options = RenderOptions(accel="bvh2", max_stack=deep + 1)
    o, d, active, t_max, _ = _cpu_query(16)
    traverse_bvh.reset_launches()
    if raises:
        with pytest.raises(ValueError, match=f"at most {traverse_bvh.MAX_STACK}"):
            integrator._closest_hit_raw(ds, o, d, active, options)
        with pytest.raises(ValueError, match=f"at most {traverse_bvh.MAX_STACK}"):
            integrator._occluded(ds, o, d, t_max, active, options)
        assert all(v == 0 for v in traverse_bvh.launches.values())
    else:
        integrator._closest_hit_raw(ds, o, d, active, options)
        integrator._occluded(ds, o, d, t_max, active, options)
        assert traverse_bvh.launches["closest_twin"] == 1
        assert traverse_bvh.launches["anyhit_twin"] == 1


@pytest.mark.parametrize("accel", ["bvh2", "sbvh"])
def test_upload_scene_takes_a_tree_built_ahead(accel):
    """The tree upload_scene's own build makes, handed in, gives the same
    DeviceScene, tensor for tensor (exactly; the empty wide tables are NaN
    padding, equal to themselves); a tree of another scene is refused."""
    from caitlynrenderer_tpu_torch.accel.bvh import build_bvh
    from caitlynrenderer_tpu_torch.accel.sbvh import build_sbvh

    sc = cornell_box()[0]
    tree = (build_sbvh if accel == "sbvh" else build_bvh)(sc.vertices, sc.tri_v, max_leaf=4)
    got = t_scene.upload_scene(sc, accel, "cpu", bvh=tree)
    want = _uploads(accel)[1]

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, tuple):
            return [leaf for y in x for leaf in leaves(y)]
        return [x]

    for a, b in zip(leaves(got), leaves(want), strict=True):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        else:
            assert a == b
    small = sc._replace(tri_v=sc.tri_v[:-2], tri_vn=sc.tri_vn[:-2], tri_vt=sc.tri_vt[:-2])
    with pytest.raises(ValueError, match="orders 36 triangles"):
        t_scene.upload_scene(small, accel, "cpu", bvh=tree)


# --------------------------------------------------------------------------
# The child-pair records of kernel B4 v2 (traverse_bvh.pack_bvh_pairs)
# --------------------------------------------------------------------------

_GRIDS = {}


def _grid(accel):
    """A 30x30 displaced grid (1,684 triangles; bvh2 from the native
    builder, sbvh from numpy) and the bench camera, which frames it."""
    from caitlynrenderer_tpu_torch.bench import bench_scene
    from caitlynrenderer_tpu_torch.io.builtin_scenes import displaced_grid

    if accel not in _GRIDS:
        _GRIDS[accel] = t_scene.upload_scene(displaced_grid(30)[0], accel, "cpu")
    return _GRIDS[accel], bench_scene("grid100k")[1]


def _one_leaf():
    """The cornell box under a tree of one leaf of all its 36 triangles."""
    sc = cornell_box()[0]
    return t_scene.upload_scene(sc, "bvh2", "cpu", bvh=t_scene.one_leaf_bvh(sc.num_triangles))


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("tree", ["grid bvh2", "grid sbvh", "cornell bvh2", "one leaf"])
def test_pack_bvh_pairs_records_are_the_flat_trees_rows(tree):
    """Record (left + 1) // 2 of every inner node holds its children's
    bounds and meta, node_bounds[left:left + 2] and node_meta[left:left +
    2], bit for bit; record k holds nodes 2k - 1 and 2k, the root in record
    0's second slot, zeros where no node is; upload_scene packs them under
    bvh2/sbvh, and an empty placeholder under the others."""
    if tree == "one leaf":
        ds = _one_leaf()
    elif tree == "cornell bvh2":
        ds = _uploads("bvh2")[1]
    else:
        ds = _grid(tree.split()[1])[0]
    nb, nm = ds.node_bounds, ds.node_meta
    rec = traverse_bvh.pack_bvh_pairs(nb, nm)
    assert torch.equal(_bits(rec), _bits(ds.bvh_pairs))
    nn = nm.shape[0]
    assert rec.shape == (traverse_bvh.n_records(nn), 16) and rec.dtype == torch.float32
    boxes = rec[:, :12].reshape(-1, 2, 6)
    metas = rec[:, 12:].contiguous().view(torch.int32).reshape(-1, 2, 2)
    inner = (nm[:, 1] == 0).nonzero()[:, 0]
    assert (len(inner) > 0) == (tree != "one leaf")
    for node in inner.tolist():
        left = int(nm[node, 0])
        k = (left + 1) // 2
        assert torch.equal(_bits(boxes[k]), _bits(nb[left:left + 2])), node
        assert torch.equal(metas[k], nm[left:left + 2]), node
    ids = torch.arange(2 * rec.shape[0]) - 1  # each slot's node
    slot_boxes, slot_metas = boxes.reshape(-1, 6), metas.reshape(-1, 2)
    real = (ids >= 0) & (ids < nn)
    assert torch.equal(_bits(slot_boxes[real]), _bits(nb)) and torch.equal(slot_metas[real], nm)
    assert not _bits(slot_boxes[~real]).any() and not slot_metas[~real].any()
    assert torch.equal(metas[0, 1], nm[0])
    assert t_scene.upload_scene(cornell_box()[0], "wide", "cpu").bvh_pairs.shape == (0, 16)


def _renumbered(bvh):
    """`bvh` with an unused leaf inserted at id 1: the same tree, but every
    pair of children starts at an even id."""
    from caitlynrenderer_tpu_torch.accel.bvh import FlatBVH

    meta = bvh.node_meta.copy()
    meta[meta[:, 1] == 0, 0] += 1
    meta = np.concatenate([meta[:1], [[0, 1]], meta[1:]]).astype(np.int32)
    bounds = np.concatenate([bvh.node_bounds[:1], bvh.node_bounds[:1], bvh.node_bounds[1:]])
    return FlatBVH(bounds, meta, bvh.tri_order)


@pytest.mark.parametrize("case", ["even pairs", "past the table", "before the parent", "upload"])
def test_pack_bvh_pairs_refuses_a_tree_without_odd_pairs(case):
    """A tree whose children are not pairs starting at an odd id after
    their parent raises, in the packer and at upload (the twin walks it:
    the records could not)."""
    from caitlynrenderer_tpu_torch.accel.bvh import build_bvh

    sc = cornell_box()[0]
    bvh = build_bvh(sc.vertices, sc.tri_v, max_leaf=4)
    bad = _renumbered(bvh)
    if case == "upload":
        with pytest.raises(ValueError, match="children start at 2"):
            t_scene.upload_scene(sc, "bvh2", "cpu", bvh=bad)
        return
    meta = {"even pairs": bad.node_meta,
            "past the table": np.array([[1, 0], [0, 1]], np.int32),
            "before the parent": np.array([[1, 0], [0, 1], [0, 1], [1, 0], [0, 1]],
                                          np.int32)}[case]
    bounds = torch.zeros((meta.shape[0], 6))
    with pytest.raises(ValueError, match="children start at"):
        traverse_bvh.pack_bvh_pairs(bounds, torch.from_numpy(meta))
    # The renumbered tree is the same tree to the twin.
    if case == "even pairs":
        ds = t_scene.upload_scene(sc, "bvh2", "cpu", bvh=bvh)
        o, d, active, _ = (torch.from_numpy(x) for x in _rays(ds, 200, 3))
        flat = (torch.from_numpy(bad.node_bounds), torch.from_numpy(bad.node_meta),
                ds.scene.vertices, ds.scene.tri_v)
        for a, b in zip(traverse_bvh.traverse_closest_plain(o, d, active, *flat, max_stack=32),
                        traverse_bvh.traverse_closest_plain(o, d, active, *_tree(ds),
                                                            max_stack=32)):
            assert torch.equal(a, b)


def _records_walk(records, tris9, o, d, active, t_max, max_leaf, anyhit):
    """Kernel B4 v2's walk in numpy float32, one ray at a time, over the
    packed records and the tris9 slab only: the root from record 0's second
    slot, both children of an inner node from its record (left + 1) // 2,
    near child first (right first only when near_l > near_r), the other
    pushed as its (left, count), a leaf's first min(count, max_leaf)
    triangles in index order with a strict < update (any-hit: the first
    accepted ends the ray).  Returns (t, tri, u, v) or occlusion."""
    f32 = np.float32
    boxes = records[:, :12].reshape(-1, 2, 6)
    metas = records[:, 12:].copy().view(np.int32).reshape(-1, 2, 2)
    n, nt = o.shape[0], tris9.shape[0]
    t_out = np.full(n, f32(1e9), f32)
    tri_out = np.full(n, -1, np.int32)
    u_out, v_out = np.zeros(n, f32), np.zeros(n, f32)
    occ = np.zeros(n, bool)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for i in np.flatnonzero(active):
            oi, di = o[i], d[i]
            inv = f32(1) / di
            best = [f32(1e9), -1, f32(0), f32(0)]
            stack, (left, count) = [], metas[0, 1]
            while True:
                limit = t_max[i] if anyhit else best[0]
                if count == 0:
                    k = (left + 1) // 2
                    t0 = (boxes[k, :, :3] - oi) * inv
                    t1 = (boxes[k, :, 3:] - oi) * inv
                    tn = np.minimum(t0, t1).max(axis=1)
                    tf = np.maximum(t0, t1).min(axis=1)
                    hit = (tf > 0) & (tf >= tn) & (tn < limit)
                    right_first = hit[0] and hit[1] and tn[0] > tn[1]
                    if hit[0] and hit[1]:
                        stack.append(tuple(metas[k, 0 if right_first else 1]))
                    if hit[0] and not right_first:
                        left, count = metas[k, 0]
                        continue
                    if hit[1]:
                        left, count = metas[k, 1]
                        continue
                elif count > 0:
                    idx = left + np.arange(min(count, max_leaf))
                    r = tris9[np.clip(idx, 0, nt - 1)]
                    v0, e1, e2 = r[:, 0:3], r[:, 3:6], r[:, 6:9]
                    pv = np.stack([di[1] * e2[:, 2] - di[2] * e2[:, 1],
                                   di[2] * e2[:, 0] - di[0] * e2[:, 2],
                                   di[0] * e2[:, 1] - di[1] * e2[:, 0]], axis=1)
                    det = e1[:, 0] * pv[:, 0] + e1[:, 1] * pv[:, 1] + e1[:, 2] * pv[:, 2]
                    inv_det = f32(1) / np.where(np.abs(det) < f32(1e-20), f32(1e-20), det)
                    tv = oi - v0
                    qv = np.stack([tv[:, 1] * e1[:, 2] - tv[:, 2] * e1[:, 1],
                                   tv[:, 2] * e1[:, 0] - tv[:, 0] * e1[:, 2],
                                   tv[:, 0] * e1[:, 1] - tv[:, 1] * e1[:, 0]], axis=1)
                    u = (tv[:, 0] * pv[:, 0] + tv[:, 1] * pv[:, 1] + tv[:, 2] * pv[:, 2]) * inv_det
                    v = (di[0] * qv[:, 0] + di[1] * qv[:, 1] + di[2] * qv[:, 2]) * inv_det
                    t = (e2[:, 0] * qv[:, 0] + e2[:, 1] * qv[:, 1] + e2[:, 2] * qv[:, 2]) * inv_det
                    ok = (u >= 0) & (v >= 0) & (f32(1) - u - v >= 0) & (t >= 0)
                    if anyhit and (ok & (t < limit)).any():
                        occ[i] = True
                        break
                    for j in np.flatnonzero(ok):
                        if t[j] < best[0]:
                            best = [t[j], int(idx[j]), u[j], v[j]]
                if not stack:
                    break
                left, count = stack.pop()
            t_out[i], tri_out[i], u_out[i], v_out[i] = best
    return occ if anyhit else (t_out, tri_out, u_out, v_out)


@pytest.mark.parametrize("tree", ["grid bvh2", "grid sbvh", "one leaf"])
@pytest.mark.parametrize("rays", ["primary", "bounce"])
def test_records_walk_equals_the_twin(tree, rays):
    """A numpy walk over the records and tris9 alone, in v2's order (a
    stack of (left, count)), returns the twin's (t, tri, u, v) and occlusion
    bit for bit on a 16x16 camera's primary rays and the integrator's
    bounce rays from their hits (chip_smoke.bounce_rays): the records carry
    every float and id the FlatBVH walk reads, and tris9's e1, e2 are the
    twin's own subtractions."""
    import importlib.util

    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.render import sampling

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if tree == "one leaf":
        from caitlynrenderer_tpu_torch.bench import bench_scene

        ds, camera = _one_leaf(), bench_scene("cornell")[1]
        max_leaf = ds.scene.tri_v.shape[0]
    else:
        ds, camera = _grid(tree.split()[1])
        max_leaf = 4
    side = 16
    uni = sampling.pixel_uniforms(sampling.sample_key(sampling.prng_key(0), 0),
                                  torch.arange(side * side, dtype=torch.int32), 2)
    o, d = generate_rays(camera, side, side, uni)
    active = torch.ones(side * side, dtype=torch.bool)
    kw = {"max_leaf": max_leaf, "max_stack": t_scene.required_stack(ds)}
    if rays == "bounce":
        tri = traverse_bvh.traverse_closest_plain(o, d, active, *_tree(ds), **kw)[1]
        o, d, active = smoke.bounce_rays(ds, o, d, tri, uni)
    t_max = torch.from_numpy(np.random.default_rng(5).uniform(0.5, 20, o.shape[0]).astype(
        np.float32))
    want = traverse_bvh.traverse_closest_plain(o, d, active, *_tree(ds), **kw)
    occ = traverse_bvh.traverse_anyhit_plain(o, d, t_max, active, *_tree(ds), **kw)
    args = [x.numpy() for x in (ds.bvh_pairs, ds.tris9, o, d, active, t_max)]
    got = _records_walk(*args, max_leaf, anyhit=False)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.int32), b.numpy().view(np.int32))
    np.testing.assert_array_equal(_records_walk(*args, max_leaf, anyhit=True), occ.numpy())
    assert int((want[1] >= 0).sum()) > 0.2 * int(active.sum()) and int(active.sum()) > 100
    assert 0 < int(occ.sum()) < int(active.sum())
