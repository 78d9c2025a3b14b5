"""Threefry-2x32 uniforms on the card: kernel B5 (csrc/threefry.cu), the
counterpart of caitlynrenderer_tpu/render/sampling.py:46 `pixel_uniforms`
and :34 `draw_uniforms`.

`threefry_pixel` and `threefry_lane` launch the kernel on CUDA tensors and
raise on anything else; render/sampling.py routes its `pixel_uniforms` and
`draw_uniforms` here for the card and to its plain twins
(`pixel_uniforms_plain`, `draw_uniforms_plain`, the same integer
arithmetic in int64 torch ops) for the CPU, with no fallback from one to
the other.  The kernel equals the twins bit for bit.

A key is a pair of words.  `threefry_pixel` takes each as a Python int
(passed by value, its low 32 bits) or a 0-d int64 tensor on the ids' card,
which the kernel reads there: a CUDA graph replays with whatever key was
written into it before the replay, and nothing is read back to the host.
`threefry_lane`'s callers hold their keys on the host: it takes ints only.

`launches` counts the kernel's launches, and under the twin keys the calls
that sampling's dispatch routes to the twins, so a run can show which path
it took.
"""

from __future__ import annotations

import ctypes

import torch

from caitlynrenderer_tpu_torch.ops import _build

SOURCE = "caitlynrenderer_tpu_torch/csrc/threefry.cu"
REPLACES = "caitlynrenderer_tpu/render/sampling.py:46"
REPLACES_LANE = "caitlynrenderer_tpu/render/sampling.py:34"

launches = _build.launch_counter("threefry", {"pixel": "threefry_pixel_kernel",
                                              "lane": "threefry_lane_kernel"})

_MASK = 0xFFFFFFFF
MIN_UNIFORMS = 4  # uniforms a pixel-sample: 4 + 7 * max_depth

_SIGNATURES = {
    # k1_word, k2_word, k1, k2, ids, n, n_u, out, device, stream
    "threefry_pixel": (ctypes.c_int, [ctypes.c_void_p] * 2 + [ctypes.c_uint32] * 2
                       + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p]),
    # k1, k2, total, out, device, stream
    "threefry_lane": (ctypes.c_int, [ctypes.c_uint32] * 2
                      + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    "threefry_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _key_args(key, dev):
    """The C entry's (k1_word, k2_word, k1, k2): a tensor word by its
    pointer on the card (value 0), an int word by value (pointer null)."""
    words, values = [], []
    for name, w in zip(("key[0]", "key[1]"), key):
        if isinstance(w, torch.Tensor):
            _build.check_tensor(name, w, torch.int64, (), dev)
            words.append(w.data_ptr())
            values.append(0)
        else:
            words.append(None)
            values.append(int(w) & _MASK)
    return (*words, *values)


def _check_uniforms(n_u: int) -> None:
    if n_u < MIN_UNIFORMS:
        raise ValueError(f"n_u must be at least {MIN_UNIFORMS}, got {n_u}")


def _require_cuda(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the threefry kernel runs on CUDA tensors only, got {dev}")


def threefry_pixel(key, pixel_ids, n_u: int) -> torch.Tensor:
    """(N, n_u) f32: row i is `uniform(fold_in(key, pixel_ids[i]), (n_u,))`.
    pixel_ids: (N,) contiguous int32 on a CUDA device, read as they are."""
    dev = pixel_ids.device
    _require_cuda(dev)
    _check_uniforms(n_u)
    if pixel_ids.dim() != 1:
        raise ValueError(f"pixel_ids must be 1-d, got shape {tuple(pixel_ids.shape)}")
    n = pixel_ids.shape[0]
    _build.check_tensor("pixel_ids", pixel_ids, torch.int32, (n,), dev)
    args = _key_args(key, dev)
    out = torch.empty((n, n_u), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.load("threefry", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.threefry_pixel(*args, pixel_ids.data_ptr(), n, n_u, out.data_ptr(), dev.index,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(rc, lib.threefry_error_string, "threefry_pixel")
    launches["pixel"] += 1
    return out


def threefry_lane(key, rows: int, n_u: int, device) -> torch.Tensor:
    """(rows, n_u) f32 on CUDA `device`: `uniform(key, (rows, n_u))`,
    element e drawn from counter e (its low 32 bits).  key: a pair of
    ints."""
    dev = torch.device(device)
    _require_cuda(dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _check_uniforms(n_u)
    if rows < 0:
        raise ValueError(f"rows must be non-negative, got {rows}")
    if any(isinstance(w, torch.Tensor) for w in key):
        raise TypeError("threefry_lane takes the key's words as ints, not tensors")
    args = [int(w) & _MASK for w in key]
    out = torch.empty((rows, n_u), dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    lib = _build.load("threefry", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.threefry_lane(*args, rows * n_u, out.data_ptr(), dev.index,
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(rc, lib.threefry_error_string, "threefry_lane")
    launches["lane"] += 1
    return out
