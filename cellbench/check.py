"""The output check that decides `correct`: what the timed path produced,
held against the plain reference at the same pixels, samples and keys.

Answers compared, once the window has closed, at `check.pixels` pixels
drawn from the seed:
- the accumulation the run left (the samples of its current image);
- the last display image that reached host memory (a completed image in
  an offline mix, the last frame shown in an interactive one).
The reference (the configuration's own, `manifest.reference`) traces
every one of those pixels' samples under the image's key and adds them
in the program's order.

Numbers, each against its limit in the configuration's `check.limits`:
- `accum_rel_l1`: sum |program - reference| / sum |reference| over the
  compared pixels' accumulated radiance;
- `accum_worst_pixel`: the largest such ratio of one pixel (its three
  channels), over the median pixel's where that is larger;
- `image_rel_l1`: the first number on the display image's values.
"""

from __future__ import annotations

import numpy as np
import torch

from cellbench import manifest, seeds
from cellbench.reference import sampler

NUMBERS = ("accum_rel_l1", "accum_worst_pixel", "image_rel_l1")


def rel_l1(p, r) -> float:
    return float(np.abs(p - r).sum() / max(float(np.abs(r).sum()), 1e-30))


def worst_pixel(p, r) -> float:
    """The largest gap of one pixel, sum |p - r| over its channels, over
    the reference's sum |r| of that pixel or of the median pixel,
    whichever is larger (a pixel the reference sees dark would otherwise
    magnify rounding)."""
    num = np.abs(p - r).sum(axis=1)
    ref = np.abs(r).sum(axis=1)
    den = np.maximum(ref, max(float(np.median(ref)), 1e-30))
    return float((num / den).max())


class Reference:
    """The reference of one configuration at one seed on `device`: the
    module the configuration names (`tracer` where it names none), its
    arithmetic in `dtype`."""

    def __init__(self, cfg: dict, sc: dict, cam: dict, seed: int, device,
                 dtype=torch.float32):
        self.cfg, self.cam, self.seed = cfg, cam, seed
        self.tracer = manifest.reference(cfg)
        self.tracer.refuse_camera(cam)
        self.scene = self.tracer.load_scene(sc, device, dtype)
        self.pixels = seeds.check_pixels(seed, cfg["width"] * cfg["height"],
                                         cfg["check"]["pixels"])
        self.ids = torch.as_tensor(self.pixels, dtype=torch.int64, device=device)
        self._acc = {}

    def accum(self, image: int, samples: int) -> np.ndarray:
        """(P, 3): the compared pixels' accumulation of `samples` samples
        of image number `image`."""
        if (image, samples) not in self._acc:
            key = sampler.base_key(seeds.image_seed(self.seed, image))
            cfg = self.cfg
            self._acc[(image, samples)] = self.tracer.accumulate(
                self.scene, self.cam, cfg["width"], cfg["height"], cfg["max_depth"], key, samples,
                self.ids)
        return self._acc[(image, samples)].cpu().numpy()

    def display(self, image: int, samples: int) -> np.ndarray:
        """(P, 3): the compared pixels' display values, resolved on the
        reference's device."""
        self.accum(image, samples)
        return self.tracer.display(self._acc[(image, samples)], samples).cpu().numpy()

    def display_rows(self, img: np.ndarray) -> np.ndarray:
        """The compared pixels' rows of a display image (row 0 at the top)."""
        w, h = self.cfg["width"], self.cfg["height"]
        return img[h - 1 - self.pixels // w, self.pixels % w]


def compare(ref: Reference, answers: dict) -> dict:
    """{number: value} of the answers: "accum" (image, samples, (P, 3)
    rows at ref.pixels) and "display" (image, samples, (H, W, 3) image),
    either absent when the run produced none."""
    out = {}
    if "accum" in answers:
        image, samples, rows = answers["accum"]
        r = ref.accum(image, samples)
        out["accum_rel_l1"] = rel_l1(rows, r)
        out["accum_worst_pixel"] = worst_pixel(rows, r)
    if "display" in answers:
        image, samples, img = answers["display"]
        out["image_rel_l1"] = rel_l1(ref.display_rows(img), ref.display(image, samples))
    return out


def judge(values: dict, limits: dict):
    """(correct, [(number, value, limit)]): correct when every number is
    finite and at most its limit."""
    rows = [(k, values[k], limits[k]) for k in NUMBERS if k in values]
    ok = bool(rows) and all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
