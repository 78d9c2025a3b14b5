"""Kernel B5 (csrc/threefry.cu, ops/threefry.py) without the card.

The kernel cannot run here, so its arithmetic and indexing are held to
the plain twins (render/sampling.py's `pixel_uniforms_plain`,
`draw_uniforms_plain`) and to jax.random through a numpy uint32 model of
its threads: each block folds the keys of its tile's pixels, then each
thread walks its elements of the tile (every 256th) by the kernel's
division-free steps, one threefry an element, rotations as funnel shifts.
The model reads its constants (block and tile sizes, the rotation table,
the parity constant, 1.0f's bits and the mantissa shift) from the CUDA
source, and those constants are held to the twin's.  Equality is bit for
bit: the arithmetic is integer but for one exact subtraction.

Also: on CPU tensors the sampler runs the twins and moves only their
counters; the kernel's entry refuses CPU tensors, bad ids and a key
tensor of the wrong dtype or device (on CPU tensors that say cuda:0, so
the checks run and raise before any launch).  The card's own runs are in
tests/test_torch_cuda.py and chip_smoke.py's phase 22.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from caitlynrenderer_tpu.render import sampling as j_sampling
from caitlynrenderer_tpu_torch.ops import _build, threefry
from caitlynrenderer_tpu_torch.parallel.render import tile_pixel_order
from caitlynrenderer_tpu_torch.render import sampling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, threefry.SOURCE)) as _f:
    SOURCE = _f.read()


def _constant(name):
    """An integer constexpr of the CUDA source, its expression evaluated
    over the constants before it."""
    expr = re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE).group(1)
    expr = re.sub(r"\b(0x[0-9A-Fa-f]+|\d+)u\b", r"\1", expr).replace("/", "//")
    names = {k: _constant(k) for k in re.findall(r"\bk[A-Z]\w*", expr)}
    return int(eval(expr, {}, names))  # noqa: S307 - the repo's own source


ROTATIONS = tuple(tuple(int(x) for x in m)
                  for m in re.findall(r"four_rounds<(\d+), (\d+), (\d+), (\d+)>\(x0", SOURCE))
PARITY, ONE = _constant("kParity"), _constant("kOne")
SHIFT, BLOCK, TILE = _constant("kMantissaShift"), _constant("kBlock"), _constant("kTile")
MIN_U, TILE_PIXELS = _constant("kMinUniforms"), _constant("kTilePixels")


def test_kernel_constants_are_the_twins():
    assert ROTATIONS == sampling._ROTATIONS
    assert (PARITY, ONE, SHIFT) == (sampling._PARITY, sampling._ONE, sampling._MANTISSA_SHIFT)
    assert PARITY == 0x1BD11BDA and ONE == 0x3F800000 and SHIFT == 9
    assert MIN_U == threefry.MIN_UNIFORMS == sampling.uniforms_per_sample(0)
    assert (BLOCK, TILE, TILE_PIXELS) == (256, 2048, 513)
    # Kernel names: the counter's fragments, each matching one kernel only.
    kernels = re.findall(r"__global__ void __launch_bounds__\(kBlock\)\s+(\w+)\(", SOURCE)
    assert kernels == ["threefry_pixel_kernel", "threefry_lane_kernel"]
    assert _build.COUNTERS["threefry"][1] == {"pixel": kernels[0], "lane": kernels[1]}


# ---------------------------------------------------------------------------
# The numpy model of the kernel's threads
# ---------------------------------------------------------------------------


def _rotl(x, r):  # __funnelshift_l(x, x, r)
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def model_threefry(k1, k2, x1):
    """threefry2x32(k1, k2, 0, x1) on uint32 arrays, as the kernel's
    `threefry2x32` writes it."""
    k1, k2, x1 = (np.asarray(v, np.uint32) for v in (k1, k2, x1))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(PARITY))
    x0 = ks[0] + np.zeros_like(x1)
    x1 = x1 + ks[1]
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def model_uniform(b0, b1):
    bits = ((b0 ^ b1) >> np.uint32(SHIFT)) | np.uint32(ONE)
    return bits.view(np.float32) - np.float32(1.0)


def model_pixel(k1, k2, ids, n_u, grid=3):
    """threefry_pixel_kernel on `grid` blocks: block b takes tiles b, b +
    grid, ...; per tile, the keys of its pixels, then each thread's
    elements by the kernel's steps.  Every element is written once."""
    ids = np.asarray(ids)
    total = ids.shape[0] * n_u
    out = np.full(total, np.nan, np.float32)
    tid = np.arange(BLOCK)
    step_p, step_j = BLOCK // n_u, BLOCK % n_u
    for t in range(-(-total // TILE)):
        e0, e1 = t * TILE, min(t * TILE + TILE, total)
        p0 = e0 // n_u
        pixels = (e1 - 1) // n_u - p0 + 1
        assert pixels <= TILE_PIXELS
        keys = model_threefry(k1, k2, ids[p0 : p0 + pixels].astype(np.uint32))
        lo = e0 - p0 * n_u + tid
        p, j = lo // n_u, lo % n_u
        e = e0 + tid
        while (live := e < e1).any():
            assert np.isnan(out[e[live]]).all()
            assert (p0 + p[live] == e[live] // n_u).all() and (j[live] == e[live] % n_u).all()
            b = model_threefry(keys[0][p[live]], keys[1][p[live]], j[live].astype(np.uint32))
            out[e[live]] = model_uniform(*b)
            p, j, e = p + step_p, j + step_j, e + BLOCK
            carry = j >= n_u
            j, p = np.where(carry, j - n_u, j), np.where(carry, p + 1, p)
    assert not np.isnan(out).any()
    return out.reshape(-1, n_u)


def model_lane(k1, k2, rows, n_u):
    e = np.arange(rows * n_u, dtype=np.int64)
    return model_uniform(*model_threefry(k1, k2, (e & 0xFFFFFFFF).astype(np.uint32))).reshape(
        rows, n_u)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _padded_ids():
    """A 2x2-tiled 45x31 frame's order on a 4-row mesh, padded with -1, as
    parallel/render.py clamps it for the sampler (padding traces pixel 0)."""
    order, _ = tile_pixel_order(45, 31, 2, 2, 4 * 7)
    return np.maximum(order, 0)


ID_SETS = {
    "edges": np.array([0, 2**31 - 1, 1, 2**31 - 2, 0, 0, 7, 2**31 - 1], np.int32),
    "padded": _padded_ids(),
    "ragged": np.arange(1, 1 + 2 * TILE // MIN_U + 3, dtype=np.int32) * 4099 % (2**31 - 1),
}
KEYS = [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (0, 0xFFFFFFFF), (0x9E3779B9, 12345)]


@pytest.mark.parametrize("depth", [0, 1, 3, 8])
@pytest.mark.parametrize("ids", list(ID_SETS))
@pytest.mark.parametrize("key", KEYS)
def test_model_of_the_pixel_kernel_equals_twin_and_jax(key, ids, depth):
    pids = ID_SETS[ids]
    n_u = sampling.uniforms_per_sample(depth)
    got = model_pixel(*key, pids, n_u)
    twin = sampling.pixel_uniforms_plain(key, torch.from_numpy(pids), depth)
    np.testing.assert_array_equal(_bits(got), _bits(twin.numpy()))
    if depth in (0, 3):  # jax.random on the reference's own path
        ref = j_sampling.pixel_uniforms(jnp.asarray(key, jnp.uint32), jnp.asarray(pids), depth)
        np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_model_takes_int64_ids_by_their_low_word():
    """The twin, the CPU's path, takes ids of any integer type: int64 ids
    are read by their low 32 bits, the value the kernel (int32 ids only)
    reads from an int32 id of the same low word."""
    pids = np.array([0, 1, 2**31 - 1, 2**32 + 5, -1, 2**40 + 2**31], np.int64)
    got = model_pixel(3, 4, pids.astype(np.uint32), 25)
    twin = sampling.pixel_uniforms_plain((3, 4), torch.from_numpy(pids), 3)
    np.testing.assert_array_equal(_bits(got), _bits(twin.numpy()))


@pytest.mark.parametrize("rows,depth", [(37, 1), (1, 0), (301, 3), (65, 8)])
@pytest.mark.parametrize("key", KEYS[:3])
def test_model_of_the_lane_kernel_equals_twin_and_jax(key, rows, depth):
    n_u = sampling.uniforms_per_sample(depth)
    assert rows * n_u % BLOCK != 0  # the last block is not full
    got = model_lane(*key, rows, n_u)
    twin = sampling.draw_uniforms_plain(key, rows, depth, "cpu")
    np.testing.assert_array_equal(_bits(got), _bits(twin.numpy()))
    ref = j_sampling.draw_uniforms(jnp.asarray(key, jnp.uint32), rows, depth)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_model_key_from_the_frame_counter_at_the_word_edges():
    """The keys a graph folds from its frame counter at frames 2**31 - 1 and
    2**32 - 1: the model under the int key ≡ the twin under the tensor key
    ≡ jax.random."""
    base = sampling.prng_key(7)
    pids = np.arange(40, dtype=np.int32)
    for frame in (0, 1, 2**31 - 1, 2**32 - 1):
        k = sampling.sample_key(base, frame)
        tk = sampling.sample_key(tuple(torch.tensor(w, dtype=torch.int64) for w in base),
                                 torch.tensor(frame, dtype=torch.int64))
        got = model_pixel(*k, pids, 25)
        twin = sampling.pixel_uniforms_plain(tk, torch.from_numpy(pids), 3)
        np.testing.assert_array_equal(_bits(got), _bits(twin.numpy()))
        jk = jax.random.fold_in(jax.random.PRNGKey(7), np.uint32(frame))
        ref = j_sampling.pixel_uniforms(jk, jnp.asarray(pids), 3)
        np.testing.assert_array_equal(_bits(got), _bits(ref))


# ---------------------------------------------------------------------------
# Dispatch and the kernel entry's checks
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_the_twins_and_count_them():
    threefry.reset_launches()
    ids = torch.arange(50, dtype=torch.int32)
    key = (5, 6)
    tkey = tuple(torch.tensor(w, dtype=torch.int64) for w in key)
    assert torch.equal(sampling.pixel_uniforms(key, ids, 2),
                       sampling.pixel_uniforms_plain(key, ids, 2))
    assert torch.equal(sampling.pixel_uniforms(tkey, ids, 2),
                       sampling.pixel_uniforms_plain(key, ids, 2))
    for device in ("cpu", torch.device("cpu")):
        assert torch.equal(sampling.draw_uniforms(key, 9, 1, device),
                           sampling.draw_uniforms_plain(key, 9, 1, "cpu"))
    assert threefry.launches == {"pixel": 0, "lane": 0, "pixel_twin": 2, "lane_twin": 2}


class _SaysCuda(torch.Tensor):
    """A CPU tensor whose `device` says cuda:0: the wrapper's checks run
    on it as on a card's tensor, and raise before any launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(x):
    return x.as_subclass(_SaysCuda)


CUDA0 = torch.device("cuda", 0)


@pytest.mark.parametrize("case,error,match", [
    ("cpu ids", ValueError, "CUDA tensors only"),
    ("cpu lane", ValueError, "CUDA tensors only"),
    ("float ids", TypeError, "pixel_ids has dtype"),
    ("2-d ids", ValueError, "pixel_ids must be 1-d"),
    ("strided ids", ValueError, "pixel_ids must be contiguous"),
    ("n_u", ValueError, "n_u must be at least 4"),
    ("int32 key", TypeError, r"key\[1\] has dtype"),
    ("cpu key", ValueError, r"key\[0\] is on cpu"),
    ("1-d key", ValueError, r"key\[0\] has shape"),
    ("int64 ids", TypeError, "pixel_ids has dtype torch.int64, expected torch.int32"),
    ("lane tensor key", TypeError, "takes the key's words as ints"),
    ("lane cpu key", TypeError, "takes the key's words as ints"),
    ("negative rows", ValueError, "rows must be non-negative"),
    ("mixed sampler", ValueError, "must all be on the CPU or all on CUDA"),
])
def test_kernel_entry_refuses_bad_inputs(case, error, match):
    ids = torch.arange(64, dtype=torch.int32)
    good = _cuda(torch.tensor(3, dtype=torch.int64))
    calls = {
        "cpu ids": lambda: threefry.threefry_pixel((1, 2), ids, 11),
        "cpu lane": lambda: threefry.threefry_lane((1, 2), 4, 11, "cpu"),
        "float ids": lambda: threefry.threefry_pixel((1, 2), _cuda(ids.float()), 11),
        "2-d ids": lambda: threefry.threefry_pixel((1, 2), _cuda(ids.reshape(8, 8)), 11),
        "strided ids": lambda: threefry.threefry_pixel((1, 2), _cuda(ids[::2]), 11),
        "n_u": lambda: threefry.threefry_pixel((1, 2), _cuda(ids), 3),
        "int32 key": lambda: threefry.threefry_pixel(
            (good, _cuda(torch.tensor(3, dtype=torch.int32))), _cuda(ids), 11),
        "cpu key": lambda: threefry.threefry_pixel(
            (torch.tensor(3, dtype=torch.int64), 2), _cuda(ids), 11),
        "1-d key": lambda: threefry.threefry_pixel(
            (_cuda(torch.tensor([3], dtype=torch.int64)), good), _cuda(ids), 11),
        "int64 ids": lambda: threefry.threefry_pixel((1, 2), _cuda(ids.long()), 11),
        "lane tensor key": lambda: threefry.threefry_lane((good, 2), 4, 11, CUDA0),
        "lane cpu key": lambda: threefry.threefry_lane(
            (1, torch.tensor(3, dtype=torch.int64)), 4, 11, CUDA0),
        "negative rows": lambda: threefry.threefry_lane((1, 2), -1, 11, CUDA0),
        "mixed sampler": lambda: sampling.pixel_uniforms(
            (torch.tensor(3, dtype=torch.int64), 2), _cuda(ids), 1),
    }
    threefry.reset_launches()
    with pytest.raises(error, match=match):
        calls[case]()
    assert all(v == 0 for v in threefry.launches.values())
