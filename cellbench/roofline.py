"""The yardstick of the kernels' roofline shares: the card's peaks and the
work a query needs, computed from its inputs alone.

A share is the least time the card could take for the work, the larger of
operations over the FP32 peak and bytes over the memory peak, divided by
the kernel's measured device time.  Peaks are NVIDIA's data sheet figures
for one H100 SXM at its full 700 W.
"""

from __future__ import annotations

import torch

from cellbench.reference import accel

PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_FP32 = 67e12  # FP32 outside the tensor cores, FLOP/s

# FP32 operations of Möller–Trumbore in its cheapest per-pair form, the
# Plücker form.  Once a triangle (MT_TRI_OPS): n = e2 x e1, p1 = v0 x e1,
# p2 = v0 x e2 (9 each), c2 = e2 . p1 (5).  Once a live ray (MT_RAY_OPS):
# m = o x d.  A pair, up to the first test that rejects it (MT_STAGE_OPS):
# det = d . n (5); u's numerator e2 . m + d . p2 (11 more); v's,
# e1 . m + d . p1, and u + v (12 more); t's numerator o . n + c2 (6 more),
# the division, u, v and t scaled by it (4) and 1 - (u + v) (1).
MT_TRI_OPS, MT_RAY_OPS = 32, 9
MT_STAGE_OPS = (5, 16, 28, 39)


def bound_ms(nbytes: float, flops: float) -> float:
    """The least milliseconds of the work: the larger of bytes over the
    memory rate and FP32 operations over the FP32 rate."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3


def mt_bound(o, d, active, tris9, t_max=None):
    """(bytes, operations) a brute-force query of rays (o, d) against the
    (T, 9) v0 | e1 | e2 rows needs: rays in and results out, the rows read
    once; a pair MT_STAGE_OPS up to the first of the tests (det, u, v, t)
    that rejects it, over every triangle of a live closest-hit ray and up
    to the first accepted one of an occluded any-hit ray (`t_max` given);
    MT_TRI_OPS a triangle and MT_RAY_OPS a live ray."""
    n, s = o.shape[0], tris9.shape[0]
    stage_ops = torch.tensor(MT_STAGE_OPS, dtype=torch.float64, device=o.device)
    v0, e1, e2 = tris9[None, :, 0:3], tris9[None, :, 3:6], tris9[None, :, 6:9]
    col = torch.arange(s, device=o.device)
    ops = 0.0
    step = max(1, (1 << 24) // max(s, 1))
    for r0 in range(0, n, step):
        sl = slice(r0, r0 + step)
        det, t, u, v = accel.mt(o[sl, None], d[sl, None], v0, e1, e2)
        stage = torch.where(~(det.abs() > 0), 0, torch.where(~(u >= 0), 1, torch.where(
            ~((v >= 0) & (1.0 - u - v >= 0)), 2, 3)))
        need = active[sl, None].expand(-1, s)
        if t_max is not None:
            ok = (stage == 3) & (t >= 0) & (t < t_max[sl, None])
            first = torch.where(ok.any(dim=1), ok.int().argmax(dim=1), s - 1)
            need = need & (col[None, :] <= first[:, None])
        ops += float((stage_ops[stage] * need).sum())
    ops += MT_TRI_OPS * s + MT_RAY_OPS * int(active.sum())
    nbytes = n * (24 + 1 + (4 + 1 if t_max is not None else 16)) + s * 36
    return nbytes, ops
