"""Structured metrics and logging (counterpart of
caitlynrenderer_tpu/utils/metrics.py): BVH build statistics, wall time per
named pass with a derived rays/s, one-line JSON log records through the
stdlib logger, and a profiler trace around a block."""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

logger = logging.getLogger("caitlynrenderer_tpu_torch")


def bvh_build_stats(bvh) -> Dict[str, Any]:
    """Build-quality record of a FlatBVH (or an SBVH's gather-list tree)."""
    from caitlynrenderer_tpu_torch.accel.bvh import sah_cost

    leaf = bvh.is_leaf()
    counts = bvh.node_meta[leaf, 1]
    n_refs = int(counts.sum())
    return {
        "nodes": int(bvh.num_nodes),
        "leaves": int(leaf.sum()),
        "max_leaf_size": int(counts.max()) if len(counts) else 0,
        "mean_leaf_size": float(counts.mean()) if len(counts) else 0.0,
        "sah_cost": round(sah_cost(bvh), 3),
        "refs": n_refs,
        "duplication_ratio": round(n_refs / max(len(bvh.tri_order), 1), 4)
        if len(bvh.tri_order) != n_refs
        else 1.0,
    }


@dataclass
class StepTimer:
    """Wall time per named pass, with a rays/s derived summary.  A span
    times the host: end it after `torch.cuda.synchronize()` to time the
    card's work.

        timer = StepTimer()
        with timer.span("trace"):
            ...
            torch.cuda.synchronize()
        timer.count("rays", n)
    """

    spans: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name: str, n: int):
        self.counts[name] = self.counts.get(name, 0) + int(n)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: round(v * 1e3, 3) for k, v in self.spans.items()}
        out.update(self.counts)
        total = sum(self.spans.values())
        if "rays" in self.counts and total > 0:
            out["rays_per_sec"] = round(self.counts["rays"] / total, 1)
        return out


def log_record(kind: str, record: Dict[str, Any]) -> None:
    """One structured JSON log line."""
    logger.info("%s %s", kind, json.dumps(record, sort_keys=True))


@contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block (CPU, and CUDA where a card is
    visible), written as `log_dir`/trace.json (Chrome trace format, for
    Perfetto).  No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
