"""Inverse rendering: optimize scene parameters against a target image
(counterpart of caitlynrenderer_tpu/grad/inverse.py).

Radiance differentiates in torch autograd with respect to the camera, the
vertices and the material parameters through the detached-traversal
estimator of render/integrator.py: the ray queries (and with them the
hand-written kernels) run without a graph, and every shading quantity is
recomputed differentiably from the hit triangle's shading-table rows.  As
in the reference, visibility and silhouette gradients are zero (no edge
sampling) and the discrete sampling decisions (light pick, lobe pick,
Russian roulette) are detached.

Adam is written out as the reference writes it (bias-corrected moments,
then p - lr * mhat / (sqrt(vhat) + eps)), not torch.optim.Adam, whose
order of rounding differs, so that one step can be held against the
reference.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from caitlynrenderer_tpu_torch.core.types import Camera, RenderOptions
from caitlynrenderer_tpu_torch.render import sampling
from caitlynrenderer_tpu_torch.render.integrator import render_sample
from caitlynrenderer_tpu_torch.scene import DeviceScene, replace_scene

Params = Dict[str, torch.Tensor]


def apply_params(ds: DeviceScene, camera: Camera, params: Params):
    """Overlay optimizable parameters onto the scene and the camera.

    Supported keys: albedo (M,4) | disney (M,4) | emission (M,4) |
    vertices (V,3) | cam_position (3,) | cam_fov ().  The shading table is
    rebuilt from the overlaid scene (and for vertices the brute-force
    slab, scene.replace_scene)."""
    sc = ds.scene
    mats = sc.materials._replace(**{k: params[k] for k in ("albedo", "disney", "emission")
                                    if k in params})
    sc = sc._replace(materials=mats)
    if "vertices" in params:
        sc = sc._replace(vertices=params["vertices"])
    ds = replace_scene(ds, sc)
    if "cam_position" in params:
        camera = camera._replace(position=params["cam_position"])
    if "cam_fov" in params:
        camera = camera._replace(fov=params["cam_fov"])
    return ds, camera


def project_params(params: Params) -> Params:
    """Project the parameters back to their physical domains after a step:
    albedo RGB in [0, 1], Disney parameters in [0, 1], emission RGB >= 0.
    Outside them the BSDF produces NaNs that would poison Adam's moments.
    Material column 3 is the type/flag word and is never touched."""
    out = dict(params)
    if "albedo" in out:
        a = out["albedo"]
        out["albedo"] = torch.cat([torch.clamp(a[:, :3], 0.0, 1.0), a[:, 3:]], dim=1)
    if "disney" in out:
        out["disney"] = torch.clamp(out["disney"], 0.0, 1.0)
    if "emission" in out:
        e = out["emission"]
        out["emission"] = torch.cat([torch.clamp(e[:, :3], min=0.0), e[:, 3:]], dim=1)
    return out


def make_loss(ds: DeviceScene, camera: Camera, target, width: int, height: int,
              options: RenderOptions):
    """loss(params, key): the mean squared error of one 1-spp render
    against `target` ((H*W, 3) radiance on the scene's device), its
    uniforms drawn from `key` (an int pair, render/sampling.py)."""

    def loss_fn(params: Params, key):
        ds2, cam2 = apply_params(ds, camera, params)
        uniforms = sampling.draw_uniforms(key, width * height, options.max_depth, ds.device)
        img = render_sample(ds2, cam2, uniforms, width, height, options)
        return torch.mean((img - target) ** 2)

    return loss_fn


class AdamState(NamedTuple):
    step: int
    mu: Params
    nu: Params


def adam_init(params: Params) -> AdamState:
    return AdamState(step=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def adam_update(grads: Params, state: AdamState, params: Params, lr=1e-2, b1=0.9, b2=0.999,
                eps=1e-8):
    """One Adam step in the reference's arithmetic (f32 throughout, the
    bias corrections from a float32 step count).  Returns (params, state)."""
    step = state.step + 1
    mu = {k: b1 * m + (1 - b1) * grads[k] for k, m in state.mu.items()}
    nu = {k: b2 * v + (1 - b2) * grads[k] * grads[k] for k, v in state.nu.items()}
    t = torch.tensor(float(step), dtype=torch.float32)
    new_params = {}
    for k, p in params.items():
        mhat = mu[k] / (1 - b1 ** t.to(p.device))
        vhat = nu[k] / (1 - b2 ** t.to(p.device))
        new_params[k] = p - lr * mhat / (torch.sqrt(vhat) + eps)
    return new_params, AdamState(step=step, mu=mu, nu=nu)


def optimize(ds: DeviceScene, camera: Camera, target, params: Params, width: int, height: int,
             options: RenderOptions, steps: int = 100, lr: float = 1e-2, seed: int = 0,
             callback=None):
    """Adam-optimize `params` to match `target`; step i draws its uniforms
    from fold_in(prng_key(seed), i).  callback(i, loss, params) runs after
    every step.  Returns (params, losses): the parameters detached, the
    losses as Python floats."""
    loss_fn = make_loss(ds, camera, target, width, height, options)
    params = {k: v.detach() for k, v in params.items()}
    opt_state = adam_init(params)
    key = sampling.prng_key(seed)
    losses = []
    for i in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, sampling.fold_in(key, i))
        # An empty parameter set only evaluates the loss.
        grads = (torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
                 if leaves else ())
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        with torch.no_grad():
            params, opt_state = adam_update(grads, opt_state, params, lr=lr)
            params = project_params(params)
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1], params)
    return params, losses
