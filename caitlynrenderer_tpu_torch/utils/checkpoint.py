"""Checkpoint and resume of render and optimization state (counterpart of
caitlynrenderer_tpu/utils/checkpoint.py).

Both are numpy .npz files with the reference's keys and dtypes, so a file
written by either package loads in the other: a render state holds
`accum` (H*W, 3) f32, `frame_count` int32 and `base_key` uint32[2];
parameters are stored under "p__<name>" and optimizer extras under
"x__<name>".  A file is written beside its path and moved over it, so an
interrupted save leaves the previous checkpoint whole.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from caitlynrenderer_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from caitlynrenderer_tpu_torch.render.progressive import RenderState


def _savez_replace(path: str, arrays: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)  # numpy appends ".npz"
    os.replace(tmp + ".npz", path)


def save_render_state(path: str, state: RenderState) -> None:
    _savez_replace(path, state_to_numpy(state))


def load_render_state(path: str, device) -> RenderState:
    with np.load(path) as z:
        return state_from_numpy(z["accum"], z["frame_count"], z["base_key"], device)


def save_params(path: str, params: Dict[str, torch.Tensor], extra: Dict[str, Any] = None) -> None:
    """Save an optimization parameter dict (and optimizer scalars)."""
    flat = {f"p__{k}": v for k, v in params_to_numpy(params).items()}
    if extra:
        flat.update({f"x__{k}": np.asarray(v) for k, v in extra.items()})
    _savez_replace(path, flat)


def load_params(path: str, device):
    """(params, extra): the parameters as f32 tensors on `device`, the
    extras as tensors of their stored dtype."""
    with np.load(path) as z:
        params = params_from_numpy({k[3:]: z[k] for k in z.files if k.startswith("p__")}, device)
        extra = {k[3:]: torch.as_tensor(z[k], device=device)
                 for k in z.files if k.startswith("x__")}
    return params, extra
