"""Samples per launch on the CPU: what render/progressive.py captures into
a CUDA graph on the card, held against the eager path and the reference.

A graph cannot read the host, so its samples take their key from a frame
counter on the device, their rays from a camera of device tensors, and
every branch of the integrator must run without a host read.  Here:
  * the sampler with tensor keys ≡ the int keys ≡ jax.random, bit for bit;
  * a camera of tensors ≡ the numpy camera's rays, bit for bit;
  * `progressive.accumulate` (the captured body) on CPU tensors ≡ the
    render_step loop, bit for bit (the same float32 operations in the same
    order), on brute, wide, cwbvh, bvh2 and sbvh with the Lambert, Disney,
    glass and mirror families, Russian roulette, the env map and the AOVs;
    and the same body under a guard that makes every host read of a
    tensor, and every tensor made from host data, raise (lifted inside the
    kernels' twins, which stand for the kernels here: the binary walk's
    twin reads its live lane count on the host, its kernel B4 does not);
  * render_image's chunking ≡ the reference's, and its image within the
    render tests' parity tolerance (mean |d| < 1e-3, max < 0.06);
  * the CLI under "bvh2" and "sbvh" launching the samples in the
    reference CLI's chunks, main loop and turntable;
  * the launch counters' registry, and the count of a graph's kernel
    nodes by mangled name that a replay adds to them.
The graph itself runs on the card: tests/test_torch_cuda.py and
chip_smoke.py's phase 20.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# Small tensors: one intra-op thread per test process keeps parallel test
# workers from oversubscribing the CPU.
torch.set_num_threads(1)

from caitlynrenderer_tpu import cli as j_cli
from caitlynrenderer_tpu.core.types import RenderOptions as j_RenderOptions
from caitlynrenderer_tpu.render import progressive as j_progressive
from caitlynrenderer_tpu.render import sampling as j_sampling
from caitlynrenderer_tpu.scene import upload_scene as j_upload
from caitlynrenderer_tpu_torch import cli
from caitlynrenderer_tpu_torch.cli import render_setup
from caitlynrenderer_tpu_torch.core.camera import (
    camera_tensors,
    copy_camera,
    generate_rays,
    has_lens,
)
from caitlynrenderer_tpu_torch.core.types import make_camera
from caitlynrenderer_tpu_torch.ops import _build, mt_brute, traverse_bvh, traverse_cw8, traverse_mega
from caitlynrenderer_tpu_torch.render import progressive, sampling
from caitlynrenderer_tpu_torch.render.integrator import render_sample
from caitlynrenderer_tpu_torch.scene import upload_scene
from caitlynrenderer_tpu_torch.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(ROOT, "scenes", "cornell.toml")
FRAMES = [0, 1, 12345, 2**31 - 2, 2**31 - 1]


def _key_tensors(key):
    return tuple(torch.tensor(k, dtype=torch.int64) for k in key)


@pytest.mark.parametrize("frame", FRAMES)
def test_tensor_key_sampler_equals_int_key_and_jax(frame):
    """sample_key with a device frame counter and pixel_uniforms (and
    draw_uniforms) with a tensor key: the int path's and jax.random's
    numbers, bit for bit; several frames in one sample_key call, each
    frame's key."""
    base = sampling.prng_key(7)
    want = sampling.sample_key(base, frame)
    got = sampling.sample_key(_key_tensors(base), torch.tensor(frame, dtype=torch.int64))
    assert (int(got[0]), int(got[1])) == want
    j_key = j_sampling.sample_key(jax.random.PRNGKey(7), jnp.int32(frame))
    assert tuple(int(x) for x in np.asarray(j_key)) == want
    frames = torch.tensor([frame, frame + 1, frame + 2**32], dtype=torch.int64)
    k1, k2 = sampling.sample_key(_key_tensors(base), frames)
    assert [(int(a), int(b)) for a, b in zip(k1, k2)] == [
        sampling.sample_key(base, f) for f in (frame, frame + 1, frame)]

    ids = torch.arange(37, dtype=torch.int32)
    u_int = sampling.pixel_uniforms(want, ids, 3)
    u_t = sampling.pixel_uniforms(got, ids, 3)
    assert torch.equal(u_t, u_int)
    u_j = j_sampling.pixel_uniforms(j_key, jnp.arange(37, dtype=jnp.int32), 3)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    assert torch.equal(sampling.draw_uniforms(got, 37, 2, "cpu"),
                       sampling.draw_uniforms(want, 37, 2, "cpu"))


@pytest.mark.parametrize("aperture", [0.0, 0.25])
def test_tensor_camera_rays_equal_numpy_camera(aperture):
    """generate_rays of a camera of tensors (lens given) ≡ the numpy
    camera's, with and without a thin lens; copy_camera moves another
    camera into the same tensors."""
    w, h = 9, 7
    uni = torch.from_numpy(np.random.default_rng(1).random((w * h, 4), dtype=np.float32))
    cams = [make_camera([2.8, 2.75, 13.0], [2.8, 2.75, 12.0], 40.0, focal_dist=9.0,
                        aperture=aperture),
            make_camera([1.0, 3.0, 11.0], [2.5, 2.0, 5.0], 55.0, focal_dist=4.0,
                        aperture=aperture)]
    tcam = camera_tensors(cams[0], "cpu")
    for cam in cams:
        copy_camera(tcam, cam)
        want = generate_rays(cam, w, h, uni)
        got = generate_rays(tcam, w, h, uni, lens=has_lens(cam))
        assert has_lens(cam) == (aperture > 0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if aperture > 0:  # the lens moves the origins
        assert not torch.equal(want[0], generate_rays(cams[1]._replace(aperture=np.float32(0)),
                                                      w, h, uni)[0])


def _cornell_cfg(**scene):
    cfg = config.load_config(TOML)
    return {**cfg, "scene": {**cfg["scene"], **scene}}


# (accel, scene keys, render keys, option overrides)
BODY_CASES = {
    "brute lambert": ("brute", {}, {}, {}),
    "brute disney": ("brute", {"floor": "disney"}, {}, {}),
    "brute glass": ("brute", {"floor": "glass"}, {}, {}),
    "brute mirror, russian roulette": ("brute", {"floor": "mirror"}, {}, {"rr_start": 1}),
    "brute aov depth": ("brute", {}, {}, {"aov": "depth"}),
    "wide lambert": ("wide", {}, {}, {}),
    "wide env map": ("wide", {"env": "sky"}, {"use_env_map": True}, {}),
    "wide disney, russian roulette": ("wide", {"floor": "disney"}, {}, {"rr_start": 0}),
    "wide aov normal": ("wide", {}, {}, {"aov": "normal"}),
    "cwbvh lambert": ("cwbvh", {}, {}, {}),
    "cwbvh glass": ("cwbvh", {"floor": "glass"}, {}, {}),
    "cwbvh aov albedo": ("cwbvh", {}, {}, {"aov": "albedo"}),
    "bvh2 lambert": ("bvh2", {}, {}, {}),
    "sbvh disney": ("sbvh", {"floor": "disney"}, {}, {}),
}


def _body_setup(name):
    """(scene, camera, options) of a BODY_CASES case at 8x6, 3 bounces."""
    accel, scene_kw, render_kw, over = BODY_CASES[name]
    cfg = _cornell_cfg(**scene_kw)
    cfg["render"] = {**cfg["render"], **render_kw}
    scene, camera, options = render_setup(cfg, os.path.dirname(TOML), width=8, height=6,
                                          max_depth=3, accel=accel)
    return scene, camera, options._replace(**over)


def _body_case(name):
    scene, camera, options = _body_setup(name)
    return upload_scene(scene, options.accel, "cpu"), camera, options


def _eager_and_body(name, guard=None):
    """(3 render_step calls, accumulate of 3 samples) from a state 2
    samples in, seed 5; the body optionally under `guard`."""
    ds, camera, options = _body_case(name)
    w, h = options.width, options.height
    state = progressive.init_state(w, h, 5, "cpu")
    for _ in range(2):
        state = progressive.render_step(ds, camera, state, w, h, options)
    eager = state
    for _ in range(3):
        eager = progressive.render_step(ds, camera, eager, w, h, options)
    frame = torch.tensor(state.frame_count, dtype=torch.int64)
    key, tcam, lens = _key_tensors(state.base_key), camera_tensors(camera, "cpu"), has_lens(camera)
    with guard if guard is not None else contextlib.nullcontext():
        body = progressive.accumulate(ds, tcam, state.accum, frame, key, w, h, options, 3, lens)
    return eager.accum, body


@pytest.mark.parametrize("name", list(BODY_CASES))
def test_captured_body_equals_render_step_loop(name):
    eager, body = _eager_and_body(name)
    assert body.abs().sum() > 0
    assert torch.equal(body, eager)


# Reads of a tensor on the host, and stores into its elements (on the card
# a scalar is copied from the host, a mask is read there): each waits for
# the stream, which a CUDA graph cannot capture.
_HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "nonzero",
               "cpu", "numpy", "__setitem__")
# The twins stand for the kernels on CPU tensors; a kernel reads nothing on
# the host, so the guard is lifted inside them.
_TWINS = ((mt_brute, "brute_closest_plain"), (mt_brute, "brute_anyhit_plain"),
          (traverse_mega, "mega_closest_plain"), (traverse_mega, "mega_anyhit_plain"),
          (traverse_cw8, "cw8_closest_plain"), (traverse_cw8, "cw8_anyhit_plain"),
          (traverse_bvh, "traverse_closest_plain"), (traverse_bvh, "traverse_anyhit_plain"))


class HostSyncGuard:
    """While entered, a host read of a tensor or a store into its elements
    (`_HOST_READS`) and a tensor made from host data (torch.tensor, torch.from_numpy,
    torch.as_tensor of anything but a tensor: on the card, a copy from the
    host) raise AssertionError; lifted inside the twins."""

    def __init__(self, monkeypatch):
        self.depth = 0
        for name in _HOST_READS:
            monkeypatch.setattr(torch.Tensor, name, self._guarded(name, getattr(torch.Tensor, name)))
        for name in ("tensor", "from_numpy"):
            monkeypatch.setattr(torch, name, self._guarded(f"torch.{name}", getattr(torch, name)))
        as_tensor = torch.as_tensor
        guarded_as_tensor = self._guarded("torch.as_tensor of host data", as_tensor)
        monkeypatch.setattr(torch, "as_tensor", lambda x, *a, **k: (
            as_tensor if isinstance(x, torch.Tensor) else guarded_as_tensor)(x, *a, **k))
        for mod, name in _TWINS:
            monkeypatch.setattr(mod, name, self._lifted(getattr(mod, name)))

    def _guarded(self, name, fn):
        def guarded(*args, **kwargs):
            if self.depth > 0:
                raise AssertionError(f"{name}: a host read or a copy from the host in the "
                                     "captured body")
            return fn(*args, **kwargs)
        return guarded

    def _lifted(self, fn):
        def lifted(*args, **kwargs):
            saved, self.depth = self.depth, 0
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth = saved
        return lifted

    def __enter__(self):
        self.depth += 1
        return self

    def __exit__(self, *exc):
        self.depth -= 1


@pytest.mark.parametrize("name", list(BODY_CASES))
def test_captured_body_reads_nothing_on_the_host(name, monkeypatch):
    guard = HostSyncGuard(monkeypatch)
    eager, body = _eager_and_body(name, guard)
    assert torch.equal(body, eager)


def test_host_sync_guard_catches_host_reads(monkeypatch):
    """The guard sees what capture would refuse: the lens read from a
    camera of tensors, the numpy camera's copy to the device, a
    data-dependent branch, a scalar stored into an element; and not the
    twins' own reads."""
    ds, camera, options = _body_case("brute lambert")
    uni = sampling.pixel_uniforms((1, 2), torch.arange(48, dtype=torch.int32), 3)
    tcam = camera_tensors(camera, "cpu")
    guard = HostSyncGuard(monkeypatch)
    with guard, pytest.raises(AssertionError, match="__float__"):
        render_sample(ds, tcam, uni, 8, 6, options)  # lens not given: reads the aperture
    with guard, pytest.raises(AssertionError, match="as_tensor"):
        render_sample(ds, camera, uni, 8, 6, options, lens=False)
    with guard, pytest.raises(AssertionError, match="__bool__"):
        bool(uni.sum() > 0)
    with guard, pytest.raises(AssertionError, match="__setitem__"):
        torch.zeros(3)[1] = -1.0
    with guard:
        render_sample(ds, tcam, uni, 8, 6, options, lens=False)
        mt_brute.brute_closest_plain(uni[:, :3], uni[:, 1:4], uni[:, 0] > 0.5, ds.tris9)


@pytest.mark.parametrize("spl", [1, 3, 8])
def test_render_image_chunks_as_the_reference(spl, monkeypatch):
    """render_image(spp=10, spp_per_launch=spl): the reference's chunks
    (render_steps of min(spl, spp) samples, the remainder one render_step
    each), 10 samples, and the image within the parity tolerance of the
    reference's render_image with the same spl."""
    scene, camera, options = _body_setup("brute lambert")
    options = j_RenderOptions(**options._replace(width=16, height=12)._asdict())
    chunks = {"port": [], "ref": []}

    def spy(side, fn):
        def steps(*args):
            chunks[side].append(int(args[-1]))
            return fn(*args)
        return steps

    monkeypatch.setattr(progressive, "render_steps", spy("port", progressive.render_steps))
    monkeypatch.setattr(j_progressive, "render_steps", spy("ref", j_progressive.render_steps))
    got, state = progressive.render_image(upload_scene(scene, "brute", "cpu"), camera, options,
                                          spp=10, seed=2, spp_per_launch=spl)
    want, j_state = j_progressive.render_image(j_upload(scene, accel="brute"), camera, options,
                                               spp=10, seed=2, spp_per_launch=spl)
    assert chunks["port"] == chunks["ref"] == [min(spl, 10)] * (10 // min(spl, 10))
    assert state.frame_count == int(j_state.frame_count) == 10
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.mean() < 1e-3, err.mean()
    assert err.max() < 0.06, err.max()


def _chunk_spy(module, record, *, steps_only=False):
    """Wrappers of module.render_steps and render_step (a launch of one)
    that append each launch's sample count to `record`; with steps_only
    they advance the frame count and render nothing."""
    real_steps, real_step = module.render_steps, module.render_step

    def steps(ds, camera, state, w, h, options, n):
        record.append(int(n))
        if steps_only:
            return state._replace(frame_count=state.frame_count + n)
        return real_steps(ds, camera, state, w, h, options, n)

    def step(ds, camera, state, w, h, options):
        record.append(1)
        if steps_only:
            return state._replace(frame_count=state.frame_count + 1)
        return real_step(ds, camera, state, w, h, options)

    return steps, step


@pytest.mark.parametrize("accel", ["bvh2", "sbvh"])
@pytest.mark.parametrize("extra,launches", [
    ([], [1] * 8),  # --spp 8 under the default 64 a launch: one at a time
    (["--spp", "64"], [64]),
    (["--spp", "64", "--spp-per-launch", "1"], [1] * 64),
    (["--turntable", "2"], [8, 8]),  # each frame's 8 samples in one launch
    (["--turntable", "2", "--spp-per-launch", "1"], [1] * 16),
])
def test_cli_renders_binary_bvh_in_the_reference_chunks(tmp_path, monkeypatch, accel, extra,
                                                        launches):
    """cli render --accel bvh2|sbvh renders every case, launching its
    samples in the chunks the reference CLI launches on the same argv (the
    main loop's --spp-per-launch chunks with a tail of single samples, the
    turntable's min(spl, samples left) a frame); the reference's launches
    are counted with its samples stubbed out, the port's render."""
    seen = {"port": [], "ref": []}
    # The port's CLI launches through render_steps only (which loops
    # render_step on CPU tensors).
    monkeypatch.setattr(progressive, "render_steps", _chunk_spy(progressive, seen["port"])[0])
    steps, step = _chunk_spy(j_progressive, seen["ref"], steps_only=True)
    monkeypatch.setattr(j_progressive, "render_steps", steps)
    monkeypatch.setattr(j_progressive, "render_step", step)
    argv = ["render", TOML, "--accel", accel, "--width", "6", "--height", "4", "--depth", "1",
            "--spp", "8", *extra]
    out = tmp_path / "out.png"
    assert cli.main([*argv, "--device", "cpu", "-o", str(out)]) == 0
    assert j_cli.main([*argv, "-o", str(tmp_path / "ref.png")]) == 0
    assert seen["port"] == seen["ref"] == launches
    frames = [tmp_path / f"out_{k:03d}.png" for k in range(2)] if "--turntable" in extra else [out]
    assert all(f.exists() for f in frames)


def test_launch_counters_are_registered():
    """Each kernel module's counter is registered under its name, with a
    twin key for each kernel key; a snapshot, a reset to it and an added
    replay act on the wrappers' own dicts."""
    mods = {"mt_brute": mt_brute, "traverse_mega": traverse_mega, "traverse_cw8": traverse_cw8,
            "traverse_bvh": traverse_bvh}
    for name, mod in mods.items():
        counts, kernels = _build.COUNTERS[name]
        assert counts is mod.launches
        assert set(counts) == {"closest", "anyhit", "closest_twin", "anyhit_twin"}
        assert set(kernels) == {"closest", "anyhit"}
    saved = _build.launch_counts()
    _build.add_launches({"traverse_cw8": {"anyhit": 5}})
    assert traverse_cw8.launches["anyhit"] == saved["traverse_cw8"]["anyhit"] + 5
    _build.set_launch_counts(saved)
    assert _build.launch_counts() == saved


def test_count_kernels_by_mangled_name():
    """A graph's kernel nodes, by mangled name: each kernel's template
    instances (lanes, stack depth, stats) count under its key, other
    kernels under none."""
    names = (["_ZN12_GLOBAL__N_115mt_brute_kernelILb0ELi4EEEvPKfS2_PKbS2_fiiPfPiS6_S6_"] * 3
             + ["_ZN12_GLOBAL__N_115mt_brute_kernelILb1ELi8EEEvPKfS2_S2_PKbS2_iiPb"] * 2
             + ["_ZN12_GLOBAL__N_111mega_kernelILb0ELb0EEEvPKfS2_PKbS2_"] * 4
             + ["_ZN12_GLOBAL__N_111mega_kernelILb1ELb1EEEvPKfS2_PKbS2_"]
             + ["_ZN12_GLOBAL__N_110cw8_kernelILb1ELb0ELi16EEEvPKf"] * 6
             + ["_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_15CUDAFunctor_addIfEE"] * 9)
    got = _build.count_kernels(names)
    zero = {"closest_twin": 0, "anyhit_twin": 0}
    assert got["mt_brute"] == {"closest": 3, "anyhit": 2, **zero}
    assert got["traverse_mega"] == {"closest": 4, "anyhit": 1, **zero}
    assert got["traverse_cw8"] == {"closest": 0, "anyhit": 6, **zero}
