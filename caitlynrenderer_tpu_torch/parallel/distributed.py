"""Process wiring, the mesh of every rank, image assembly and the scaling
report (counterpart of caitlynrenderer_tpu/parallel/distributed.py).

One process per rank, each on its own device, wired by
`torch.distributed.init_process_group`: under a launcher (`torchrun`, or
anything that sets RANK, WORLD_SIZE and MASTER_ADDR) from its
environment, or from explicit arguments.  A process with neither stays a
single process, and the same code paths run on the 1 × 1 mesh.

    torchrun --nproc_per_node 4 -m caitlynrenderer_tpu_torch.cli render \\
        scenes/cornell.toml --mesh 2x2 -o out.png
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from caitlynrenderer_tpu_torch.device import get_device, synchronize
from caitlynrenderer_tpu_torch.parallel.mesh import SINGLE, Mesh, all_reduce_sum, make_mesh

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def launched() -> bool:
    """True when a launcher has set this process's rank in its environment
    (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)."""
    return all(k in os.environ for k in _LAUNCHER_ENV)


def rank_device(name: str = "cuda") -> torch.device:
    """This rank's device: "cuda" without an index is cuda:LOCAL_RANK (0 in a
    plain process); anything else as named.  Raises, through
    device.get_device, for a card that is not there: more ranks on a host
    than cards are never silently doubled up."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        name = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return get_device(name)


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     device="cuda", timeout: Optional[timedelta] = None) -> Tuple[int, int]:
    """Wire this process into its process group; returns (rank, world size).

    With no arguments it initializes only under a launcher (`launched`);
    elsewhere it is a no-op returning (0, 1).  Explicit init_method,
    world_size or rank force it (init_method defaults to "env://").  The
    backend defaults to NCCL for a CUDA `device` and gloo for the CPU; a
    CUDA device with an index is made the current one first.  Idempotent: once wired, a
    call returns the group's (rank, world size)."""
    if not dist.is_initialized():
        explicit = init_method is not None or world_size is not None or rank is not None
        if not explicit and not launched():
            return 0, 1
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        kwargs = {"init_method": init_method or "env://"}
        if world_size is not None:
            kwargs["world_size"] = world_size
        if rank is not None:
            kwargs["rank"] = rank
        if timeout is not None:
            kwargs["timeout"] = timeout
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), **kwargs)
    return dist.get_rank(), dist.get_world_size()


def make_multihost_mesh(sp: Optional[int] = None) -> Mesh:
    """(dp × sp) mesh of every rank, consecutive ranks in a row.  sp defaults
    to 2 where the ranks of a host (LOCAL_WORLD_SIZE) are even, so that a
    row's sum stays within a host; dp spans hosts."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if sp is None:
        sp = 2 if local % 2 == 0 and local > 1 else 1
    if n % sp != 0:
        raise ValueError(f"sp={sp} does not divide {n} ranks")
    return make_mesh((n // sp, sp))


def assemble_image(state, mesh: Mesh, width: int, height: int, options) -> np.ndarray:
    """The resolved display image (H, W, 3) as numpy, on every rank."""
    from caitlynrenderer_tpu_torch.parallel.render import gather_image

    return gather_image(state, mesh, width, height, options).cpu().numpy()


def scaling_report(ds, camera, options, width: int, height: int, spp: int = 2) -> dict:
    """Rays per second per rank on one rank alone against the whole mesh
    (dp = world size, sp = 1), and their ratio, the scaling efficiency.
    Rays are the closest-hit and any-hit queries the integrator issues
    for one sample of every pixel, counted by its stats.  Every rank must
    call it; rank 0 measures alone while the others wait.  On a single
    rank the mesh is that rank: it is measured once and the efficiency is
    1.0 by construction."""
    from caitlynrenderer_tpu_torch.core.camera import generate_rays
    from caitlynrenderer_tpu_torch.parallel.render import init_sharded_state, sharded_render_step
    from caitlynrenderer_tpu_torch.render import sampling
    from caitlynrenderer_tpu_torch.render.integrator import trace_paths

    dev = ds.device
    uni = sampling.draw_uniforms(sampling.prng_key(0), width * height, options.max_depth, dev)
    o, d = generate_rays(camera, width, height, uni)
    with torch.no_grad():
        _, stats = trace_paths(ds, o, d, uni, options, with_stats=True)
    rays_per_sample = int(stats["rays_closest"]) + int(stats["rays_anyhit"])

    def measure(mesh):
        st = init_sharded_state(mesh, width, height, 0, dev)
        with torch.no_grad():
            st = sharded_render_step(ds, camera, st, mesh, width, height, options)  # warm-up
            synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(spp):
                st = sharded_render_step(ds, camera, st, mesh, width, height, options)
            synchronize(dev)
        return rays_per_sample * spp / (time.perf_counter() - t0) / (mesh.dp * mesh.sp)

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    r1 = measure(SINGLE) if rank == 0 else 0.0
    rn = r1
    if world > 1:
        # The others wait in this sum until rank 0 has measured alone.
        r1 = float(all_reduce_sum(torch.tensor([r1], dtype=torch.float64, device=dev),
                                  dist.group.WORLD)[0])
        rn = measure(make_mesh((world, 1)))
        rn = float(all_reduce_sum(torch.tensor([rn], dtype=torch.float64, device=dev),
                                  dist.group.WORLD)[0]) / world
    return {
        "devices": world,
        "rays_per_sample": rays_per_sample,
        "rays_per_sec_per_chip_1": r1,
        "rays_per_sec_per_chip_n": rn,
        "scaling_efficiency": rn / r1,
    }
