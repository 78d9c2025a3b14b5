"""The (dp × sp) mesh of ranks for sharded rendering (counterpart of
caitlynrenderer_tpu/parallel/mesh.py).

  dp: the pixel axis, each row of the mesh traces its own block of pixels;
  sp: independent sample streams of the same pixels, summed over the row.

One process per rank, one device each, wired by torch.distributed
(parallel/distributed.py).  Rank r sits at dp_idx = r // sp, sp_idx = r % sp,
so consecutive ranks (the cards of one host under a launcher) share a row:
the layout of the reference's multi-host mesh.  A process with no process
group is the 1 × 1 mesh and takes the same code with no collective.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


def factor_mesh(n: int) -> Tuple[int, int]:
    """Split n ranks into (dp, sp): sample-parallel gets a factor of 2 when
    available, the rest shards pixels."""
    if n % 2 == 0 and n > 1:
        return n // 2, 2
    return n, 1


class Mesh(NamedTuple):
    """dp, sp:    the mesh's shape
    rank:      this process's rank in it
    group:     the process group of the whole mesh, None without one
    sp_group:  the group of this rank's row, None where sp is 1 or there is
               no process group (its sum is then the identity)
    """

    dp: int
    sp: int
    rank: int
    group: Optional[object]
    sp_group: Optional[object]

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def dp_idx(self) -> int:
        return self.rank // self.sp

    @property
    def sp_idx(self) -> int:
        return self.rank % self.sp


SINGLE = Mesh(dp=1, sp=1, rank=0, group=None, sp_group=None)


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The mesh of every rank of the process group, `shape` (dp, sp) or
    factor_mesh(world size).  Without a process group: the 1 × 1 mesh.
    Every rank must call it (it creates the rows' groups)."""
    if not dist.is_initialized():
        if shape not in (None, (1, 1)):
            raise ValueError(f"mesh {shape} needs {shape[0] * shape[1]} ranks; this process "
                             "has no process group (parallel.distributed.init_distributed)")
        return SINGLE
    world, rank = dist.get_world_size(), dist.get_rank()
    dp, sp = factor_mesh(world) if shape is None else shape
    if dp * sp != world:
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks, the process group has {world}")
    sp_group = None
    if sp > 1:
        # new_group is collective: every rank creates every row's group.
        for row in range(dp):
            g = dist.new_group(list(range(row * sp, (row + 1) * sp)))
            if row == rank // sp:
                sp_group = g
    return Mesh(dp=dp, sp=sp, rank=rank, group=dist.group.WORLD, sp_group=sp_group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of `t` over `group`, in place; the identity where group is None."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t
